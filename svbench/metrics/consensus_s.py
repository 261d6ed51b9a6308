"""Seconds a job spent in COMBINE's insertion consensus pool, from its
creation to its last result (the span `combine.consensus` of the
program's --profile record), summed over the traced jobs, over their
count.  Nothing to read where a job's record has no such span."""

UNIT = "s/job"
SPAN = "combine.consensus"


def read(trace):
    values = [job.get("spans", {}).get(SPAN) for job in trace["stages"]]
    if not values or None in values:
        return None
    return sum(values) / len(values)
