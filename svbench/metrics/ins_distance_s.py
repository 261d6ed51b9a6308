"""Seconds a job spent in the edit distances of CLUSTER's resident
insertion route (the span `cluster.ins_distances` of the program's
--profile record: the call that packs, uploads and launches every near
pair's wavefront, its result left on the card), summed over the traced
jobs, over their count.  Nothing to read where a job's record has no such
span."""

UNIT = "s/job"
SPAN = "cluster.ins_distances"


def read(trace):
    values = [job.get("spans", {}).get(SPAN) for job in trace["stages"]]
    if not values or None in values:
        return None
    return sum(values) / len(values)
