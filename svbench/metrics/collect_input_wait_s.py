"""Seconds a job's thread spent in COLLECT waiting for the next batch of
input (the span `collect.input_wait` of the program's --profile record:
the streaming reader thread's queue, or the one-shot scan session's next
rows), summed over the traced jobs, over their count.  Nothing to read
where a job's record has no such span."""

UNIT = "s/job"
SPAN = "collect.input_wait"


def read(trace):
    values = [job.get("spans", {}).get(SPAN) for job in trace["stages"]]
    if not values or None in values:
        return None
    return sum(values) / len(values)
