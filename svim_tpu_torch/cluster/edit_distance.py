"""Exact Levenshtein distance on the host, and the batched routing.

Counterpart of svim_tpu/cluster/edit_distance.py.  The host implementations
(native Myers bit-parallel through svim_tpu_torch.native, the big-integer
Myers recurrence, the O(nm) reference) are svim_tpu's, copied.
`batch_edit_distances` routes "wavefront" to the port's wavefront driver
(CUDA kernel on a card, plain PyTorch on the CPU); "auto" and "python" are
host routes.
"""

from __future__ import annotations

def edit_distance(pattern: str, text: str) -> int:
    """Global (Needleman-Wunsch) edit distance between two strings (native
    Myers bit-parallel)."""
    from svim_tpu_torch.native import aligner

    return aligner.edit_distance(pattern, text)


def batch_edit_distances(pairs, backend: str = "auto", band_hints=None,
                         device=None):
    """Exact edit distances for many (a, b) pairs.

    backend: "auto" (native thread-pooled batch: trim + greedy O(n + d^2)
    frontier + Myers bit-parallel fallback), "wavefront" (the batched
    device kernel, on `device` or the device `select_device` picks), or
    "python".  band_hints: optional proven per-pair distance upper bounds
    (caps the greedy frontier / the device kernel's banded pass)."""
    if backend == "wavefront":
        from svim_tpu_torch.ops.wavefront_kernel import batched_edit_distance
        from svim_tpu_torch.utils.device import select_device

        return batched_edit_distance(
            pairs, select_device() if device is None else device,
            initial_band=128, band_hints=band_hints)
    if backend == "python":
        return [edit_distance_py(a, b) for a, b in pairs]
    if len(pairs) >= 8:
        from svim_tpu_torch.native import aligner

        return aligner.edit_distance_batch(pairs, band_hints=band_hints)
    return [edit_distance(a, b) for a, b in pairs]


def edit_distance_py(pattern: str, text: str) -> int:
    """Big-integer Myers recurrence (portable fallback)."""
    m = len(pattern)
    if m == 0:
        return len(text)
    if len(text) == 0:
        return m
    # iterate over the shorter string as the pattern: fewer mask bits
    if m > len(text):
        pattern, text = text, pattern
        m = len(pattern)

    peq = {}
    for i, ch in enumerate(pattern):
        peq[ch] = peq.get(ch, 0) | (1 << i)

    mask = (1 << m) - 1
    high = 1 << (m - 1)
    pv = mask
    mv = 0
    score = m
    for ch in text:
        eq = peq.get(ch, 0)
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = mv | (~(xh | pv) & mask)
        mh = pv & xh
        if ph & high:
            score += 1
        elif mh & high:
            score -= 1
        ph = ((ph << 1) | 1) & mask
        mh = (mh << 1) & mask
        pv = mh | (~(xv | ph) & mask)
        mv = ph & xv
    return score


def edit_distance_dp(a: str, b: str) -> int:
    """Reference O(nm) dynamic program, used to validate the bit-parallel
    implementations in tests."""
    if len(a) < len(b):
        a, b = b, a
    previous = list(range(len(b) + 1))
    for i, ca in enumerate(a, start=1):
        current = [i] + [0] * len(b)
        for j, cb in enumerate(b, start=1):
            current[j] = min(previous[j] + 1,
                             current[j - 1] + 1,
                             previous[j - 1] + (ca != cb))
        previous = current
    return previous[len(b)]
