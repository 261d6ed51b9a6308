"""The benchmark's arithmetic: the card's published rates, the least time
a kernel call's own data needs, and the union of device intervals.

The bound is a frozen copy of the arithmetic that chip_smoke.py applies
to the same calls (`agglomerate_bound_ms`); the union
is scripts/profile_port.py's.  They read only a call's inputs and outputs,
so a later implementation of the same function is held to the same work."""

from __future__ import annotations

import numpy as np

# NVIDIA H100 SXM (the data sheet's dense rates, at 700 W): 132 SMs at
# 1.98 GHz, 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of HBM
SMS = 132
CLOCK_HZ = 1.98e9
FLOAT32_FLOPS_PER_SECOND = 67e12
HBM_BYTES_PER_SECOND = 3.35e12
# 4-byte shared-memory loads: 32 lanes an SM and clock
SHARED_LOADS_PER_SECOND = SMS * 32 * CLOCK_HZ
LANE_INSTRUCTIONS_PER_SECOND = FLOAT32_FLOPS_PER_SECOND / 2

# one cell of a fused agglomeration's distance matrix: two differences and
# two absolute values, the larger span and its floor of 1, three
# conversions, two divisions, one sum, the same-read comparison and its
# select
AGGLOMERATE_BUILD_OPS_PER_CELL = 14

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def agglomerate_bound_ms(counts, pad, fused):
    """The least time the card could take for one agglomeration call whose
    partitions hold `counts` valid slots, the largest of: each input read
    and each output written once, over the memory rate; the shared-memory
    loads of the cheapest known algorithm (a minimum kept a row: a step
    over m live slots reads two rows and reduces m minima, 3 * sum(m for m
    in 2..n) loads a partition of n slots); on the fused entry,
    AGGLOMERATE_BUILD_OPS_PER_CELL operations a cell of the upper triangle
    over the lanes' issue rate.  Returns (ms, "bytes" or "operations")."""
    batch = len(counts)
    counts = [int(count) for count in counts]
    loads = sum(3 * (n * (n + 1) // 2 - 1) for n in counts if n >= 2)
    ops_ms = loads / SHARED_LOADS_PER_SECOND * 1e3
    moved = batch * (12 * (pad - 1) + 4)
    if fused:
        moved += batch * (17 * pad + 5) + batch * (pad + 2)
        cells = sum(n * (n - 1) // 2 for n in counts)
        ops_ms = max(ops_ms, AGGLOMERATE_BUILD_OPS_PER_CELL * cells
                     / LANE_INSTRUCTIONS_PER_SECOND * 1e3)
    else:
        moved += batch * (4 * pad * pad + pad)
    bytes_ms = moved / HBM_BYTES_PER_SECOND * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


def union_seconds(intervals):
    """Length of the union of (start, end) intervals in microseconds, in
    seconds."""
    total = 0.0
    reach = None
    for start, end in sorted(intervals):
        if reach is None or start > reach:
            total += end - start
            reach = end
        elif end > reach:
            total += end - reach
            reach = end
    return total / 1e6


def device_intervals(events):
    """(start, end, name) in microseconds of every kernel, copy and memset
    event of a Chrome trace's event list."""
    return [(event["ts"], event["ts"] + event["dur"], event.get("name", ""))
            for event in events
            if event.get("ph") == "X" and event.get("cat") in DEVICE_CATEGORIES]


def idle_gaps(intervals, marks, top=10):
    """The `top` longest gaps between device intervals, each named by the
    host's marks ((start, end, name)) that cover the gap's middle, the
    innermost (shortest) first; (name, seconds), longest first."""
    gaps = []
    reach = None
    for start, end, _ in sorted(intervals):
        if reach is not None and start > reach:
            gaps.append((reach, start))
        reach = end if reach is None else max(reach, end)
    gaps.sort(key=lambda gap: gap[0] - gap[1])
    named = []
    for start, end in gaps[:top]:
        middle = (start + end) / 2
        covering = sorted((mark_end - mark_start, name)
                          for mark_start, mark_end, name in marks
                          if mark_start <= middle <= mark_end)
        named.append([covering[0][1] if covering else "outside every stage",
                      (end - start) / 1e6])
    return named
