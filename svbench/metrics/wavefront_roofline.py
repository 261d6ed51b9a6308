"""The wavefront kernel's share of its roofline: over every launch of the
banded edit distance that CLUSTER made in the traced jobs (the dispatcher
`banded_distance`, called once a launch by the resident insertion route),
the least time each launch's pairs need (`bound_ms`) summed, over the
launches' device time summed (CUDA events around each call).  Nothing to
read where no launch ran.

The bound is a frozen copy of chip_smoke.py's `wavefront_bound_ms` on the
same inputs, with its per-pair count of band cells (`_band_cells`, a sum
over the rows) in closed form, which counts the same cells without a
(pairs, rows) temporary."""

import numpy as np

UNIT = "%"
NAME = "wavefront_roofline"
# the entry timed, in the module where the route looks it up
TIMED = {"svim_tpu_torch.ops.wavefront_kernel": ("banded_distance",)}

# one DP cell: three candidates, their minimum, the match test (5 int32
# operations) at 64 int32 lanes an SM and clock on 132 SMs at 1.98 GHz;
# 3.35 TB/s of HBM (NVIDIA H100 SXM, the data sheet's rates at 700 W)
OPS_PER_CELL = 5
INT32_OPS_PER_SECOND = 132 * 64 * 1.98e9
HBM_BYTES_PER_SECOND = 3.35e12


def _upper_cells(m, n, w):
    """Cells 1 <= i <= m, 1 <= j <= n with 0 <= j - i <= w, per pair (w >= 0):
    diagonal d = j - i holds max(0, min(m, n - d)) cells."""
    full = np.where(n >= m, np.minimum(w, n - m) + 1, 0)
    low = np.maximum(0, n - m + 1)
    high = np.minimum(w, n - 1)
    count = np.maximum(0, high - low + 1)
    return m * full + count * (2 * n - low - high) // 2


def band_cells(a_lens, b_lens, widths):
    """Cells 1 <= i <= m, 1 <= j <= n with |i - j| <= w, per pair; none
    where w < 0."""
    m = np.asarray(a_lens, dtype=np.int64)
    n = np.asarray(b_lens, dtype=np.int64)
    w = np.asarray(widths, dtype=np.int64)
    safe = np.maximum(w, 0)
    cells = (_upper_cells(m, n, safe) + _upper_cells(n, m, safe)
             - np.minimum(m, n))
    return np.where(w < 0, 0, cells)


def wavefront_bound_ms(a_lens, b_lens, values, length, band):
    """The least time the card could take for one launch on these inputs:
    bytes (both code matrices and length vectors read once, the result
    written once) over the memory rate, or the DP cells this data needs
    times OPS_PER_CELL over the int32 rate.  A pair whose distance k is
    within the band needs the cells |i - j| <= k; any other pair within
    reach of the band needs the whole band; a pair with |m - n| > W none.
    Returns (ms, "bytes" or "operations", cells)."""
    a_lens = np.asarray(a_lens, dtype=np.int64)
    b_lens = np.asarray(b_lens, dtype=np.int64)
    values = np.asarray(values, dtype=np.int64)
    widths = np.where(values <= band, values,
                      np.minimum(band, np.maximum(a_lens, b_lens)))
    widths = np.where(np.abs(a_lens - b_lens) > band, -1, widths)
    cells = int(band_cells(a_lens, b_lens, widths).sum())
    batch = len(a_lens)
    bytes_ms = (2 * batch * length + 12 * batch) / HBM_BYTES_PER_SECOND * 1e3
    ops_ms = cells * OPS_PER_CELL / INT32_OPS_PER_SECOND * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations", cells
    return bytes_ms, "bytes", cells


def keep(entry, arguments, result):
    """What the bound reads of one launch, taken on the device without a
    wait: both length vectors, the distances, the padded length and the
    band."""
    return (arguments["a_lens"].clone(), arguments["b_lens"].clone(),
            result.clone(), int(arguments["a_codes"].shape[1]),
            int(arguments["band"]))


def bound_ms(kept):
    a_lens, b_lens, values, length, band = kept
    return wavefront_bound_ms(a_lens.cpu().numpy(), b_lens.cpu().numpy(),
                              values.cpu().numpy(), length, band)[0]


def read(trace):
    calls = trace["calls"].get(NAME)
    if not calls:
        return None
    return 100.0 * sum(bound for _, bound in calls) / sum(ms for ms, _ in calls)
