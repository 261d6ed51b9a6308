"""Seconds a job's host spent waiting on the card for results: every
`<stage>.fetch` span of the program's --profile record (its one fetch of
device tensors, in whichever stage ran it) summed, over the traced jobs,
over their count.  Nothing to read where a job's record has no fetch
span."""

UNIT = "s/job"


def read(trace):
    values = []
    for job in trace["stages"]:
        fetches = [seconds for name, seconds in job.get("spans", {}).items()
                   if name.endswith(".fetch")]
        if not fetches:
            return None
        values.append(sum(fetches))
    if not values:
        return None
    return sum(values) / len(values)
