"""Seconds a job spent assembling the haplotype string pairs of CLUSTER's
resident insertion route (the span `cluster.ins_pairs` of the program's
--profile record: the reference-padded strings of every near pair, before
the card computes their distances), summed over the traced jobs, over
their count.  Nothing to read where a job's record has no such span."""

UNIT = "s/job"
SPAN = "cluster.ins_pairs"


def read(trace):
    values = [job.get("spans", {}).get(SPAN) for job in trace["stages"]]
    if not values or None in values:
        return None
    return sum(values) / len(values)
