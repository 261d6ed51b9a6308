"""How busy COMBINE's consensus pool kept its threads: a job's seconds of
work on the pool's threads (the span `combine.consensus_cluster`, summed
over the clusters) over its threads (the count `consensus.workers`) times
the pool's wall (the span `combine.consensus`), in %, averaged over the
traced jobs.  Below 100% the pool waits on a straggler or runs short of
clusters.  Nothing to read where a job's record lacks any of the three."""

UNIT = "%"


def read(trace):
    values = []
    for job in trace["stages"]:
        spans = job.get("spans", {})
        work = spans.get("combine.consensus_cluster")
        wall = spans.get("combine.consensus")
        workers = job.get("counts", {}).get("consensus.workers")
        if work is None or not wall or not workers:
            return None
        values.append(100.0 * work / (workers * wall))
    if not values:
        return None
    return sum(values) / len(values)
