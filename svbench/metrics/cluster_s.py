"""Seconds a job spent in CLUSTER: the program's own stage clock (its
--profile StageTimer, host wall clock) summed over the traced jobs, over
their count."""

UNIT = "s/job"


def read(trace):
    stages = [job.get("cluster") for job in trace["stages"]]
    if not stages or None in stages:
        return None
    return sum(stages) / len(stages)
