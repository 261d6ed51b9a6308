"""Nanoseconds a DP cell of COMBINE's POA graph aligner: a job's seconds
in the consensus seed (the span `combine.poa` of the program's --profile
record, summed over the pool's threads) over the cells the seed computed
(the count `consensus.poa_cells`, every band rung and full matrix
included), averaged over the traced jobs.  Nothing to read where a job's
record lacks either, or computed no cell."""

UNIT = "ns/cell"


def read(trace):
    values = []
    for job in trace["stages"]:
        seconds = job.get("spans", {}).get("combine.poa")
        cells = job.get("counts", {}).get("consensus.poa_cells")
        if seconds is None or not cells:
            return None
        values.append(seconds * 1e9 / cells)
    if not values:
        return None
    return sum(values) / len(values)
