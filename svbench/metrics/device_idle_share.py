"""The share of one whole job's wall time in which the card ran nothing:
1 - (union of the kernel, copy and memset intervals of a torch.profiler
trace of the job) / the job's wall time."""

UNIT = "%"


def read(trace):
    if not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
