"""Seconds a job's thread spent in COLLECT turning fetched device results
into signatures (the span `collect.emit` of the program's --profile
record, self time: a re-run's fetch inside it is left out), summed over
the traced jobs, over their count.  Nothing to read where a job's record
has no such span."""

UNIT = "s/job"
SPAN = "collect.emit"


def read(trace):
    values = [job.get("spans", {}).get(SPAN) for job in trace["stages"]]
    if not values or None in values:
        return None
    return sum(values) / len(values)
