"""Batched exact Levenshtein distance via banded anti-diagonal wavefronts.

Counterpart of svim_tpu/ops/wavefront_kernel.py.  Every cell of a wavefront
depends only on the previous two fronts, so a batch of pairs advances with
(B, 2W+1) ops per anti-diagonal.  A band half-width W bounds the front; the
result is exact whenever the true distance fits the band, and entries above
W mean "band too small, retry" (the host drivers below double the band or
bucket pairs by proven hints).

Three layers:
  * `banded_distance_torch` — the plain PyTorch version, a line-for-line
    port of the jnp `banded_distance` (K = 2W+1); runs on any device.
  * `banded_distance_cuda` — the wrapper of the hand-written CUDA kernel
    (csrc/wavefront.cu, one CTA per pair), bit-identical to the plain
    version, counted in `LAUNCHES`.
  * `banded_distance` — the dispatcher: a CPU tensor takes the plain
    version, a CUDA tensor the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

INF = 1 << 20

LAUNCHES = 0   # kernel launches by banded_distance_cuda (chip_smoke reads it)


def banded_distance_torch(a_codes, a_lens, b_codes, b_lens, band: int):
    """Exact distances for pairs whose edit distance <= band.

    a_codes, b_codes: (B, L) integer character codes (padding arbitrary);
    a_lens, b_lens: (B,) true lengths; band: band half-width W.
    Returns (B,) int32; entries > band mean "band too small, retry"."""
    batch, length = a_codes.shape
    device = a_codes.device
    k_width = 2 * band + 1
    e_offsets = torch.arange(k_width, dtype=torch.int32, device=device) - band
    k_index = torch.arange(k_width, dtype=torch.int32, device=device)[None, :]
    m = a_lens.to(torch.int32)
    n = b_lens.to(torch.int32)

    inf_column = torch.full((batch, 1), INF, dtype=torch.int32, device=device)
    front_prev2 = torch.full((batch, k_width), INF, dtype=torch.int32,
                             device=device)
    front_prev2[:, band] = 0  # D(0,0) at wavefront 0
    front_prev = torch.full((batch, k_width), INF, dtype=torch.int32,
                            device=device)
    if band >= 1:
        # wavefront 1: D(1,0)=1 (e=+1) and D(0,1)=1 (e=-1) where in range
        front_prev[:, band + 1] = torch.where(m >= 1, 1, INF)
        front_prev[:, band - 1] = torch.where(n >= 1, 1, INF)

    answer = torch.where(m + n == 0, 0, INF).to(torch.int32)
    final_k = band + (m - n)  # wavefront index of D(m, n)
    final_in_band = (final_k >= 0) & (final_k < k_width)
    answer = torch.where((m + n == 1) & final_in_band, 1, answer)
    final_index = final_k.clamp(0, k_width - 1).to(torch.int64)[:, None]

    # the answer of a pair is read at its own wavefront m+n: later fronts
    # change nothing (the jnp loop runs to 2L; the Pallas kernel to max m+n)
    d_stop = int((m + n).max()) if batch else 0
    prev2, prev = front_prev2, front_prev
    for d in range(2, d_stop + 1):
        # cell coordinates along the front (floor division, as in jnp)
        i = (d + e_offsets[None, :]) // 2
        j = (d - e_offsets[None, :]) // 2
        in_range = ((i >= 1) & (i <= m[:, None])
                    & (j >= 1) & (j <= n[:, None]))
        i_idx = (i - 1).clamp(0, length - 1).to(torch.int64).expand(
            batch, k_width)
        j_idx = (j - 1).clamp(0, length - 1).to(torch.int64).expand(
            batch, k_width)
        ca = torch.gather(a_codes, 1, i_idx)
        cb = torch.gather(b_codes, 1, j_idx)
        substitution = (ca != cb).to(torch.int32)

        from_insert = torch.cat([inf_column, prev[:, :-1]], dim=1) + 1
        from_delete = torch.cat([prev[:, 1:], inf_column], dim=1) + 1
        from_match = prev2 + substitution
        front = torch.minimum(torch.minimum(from_insert, from_delete),
                              from_match)

        # boundary injections: D(0, d) = d and D(d, 0) = d while d fits band
        is_top = k_index == band - d      # e = -d  (i == 0)
        is_left = k_index == band + d     # e = +d  (j == 0)
        front = torch.where(is_top & (d <= n[:, None]), d, front)
        front = torch.where(is_left & (d <= m[:, None]), d, front)
        front = torch.where(in_range | is_top | is_left, front, INF)

        finished = (d == m + n) & final_in_band
        final_value = torch.gather(front, 1, final_index)[:, 0]
        answer = torch.where(finished, final_value, answer)
        prev2, prev = prev, front
    return answer


_library = None
_max_shared_bytes = None


def _kernel_library():
    global _library, _max_shared_bytes
    if _library is None:
        from svim_tpu_torch.ops._build import load

        library = load("wavefront")
        library.wavefront_banded_distance.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        library.wavefront_banded_distance.restype = ctypes.c_int
        library.wavefront_max_shared_bytes.argtypes = []
        library.wavefront_max_shared_bytes.restype = ctypes.c_int
        _max_shared_bytes = library.wavefront_max_shared_bytes()
        if _max_shared_bytes <= 0:
            raise RuntimeError("cannot query the per-block shared-memory "
                               "limit of the CUDA device")
        _library = library
    return _library


def uses_shared_fronts(band: int) -> bool:
    """True when three fronts of 2*band+1 int32 cells fit the opt-in
    shared-memory limit (else the kernel keeps them in global scratch)."""
    _kernel_library()
    return 3 * (2 * band + 1) * 4 <= _max_shared_bytes


def banded_distance_cuda(a_codes, a_lens, b_codes, b_lens, band: int):
    """banded_distance on the card through csrc/wavefront.cu.

    a_codes, b_codes: (B, L) uint8 contiguous CUDA tensors; a_lens, b_lens:
    (B,) int32 contiguous on the same device.  Returns (B,) int32 on that
    device, equal to banded_distance_torch entry for entry."""
    global LAUNCHES
    device = a_codes.device
    if device.type != "cuda":
        raise ValueError("banded_distance_cuda needs CUDA tensors")
    for name, tensor, dtype, dims in (("a_codes", a_codes, torch.uint8, 2),
                                      ("b_codes", b_codes, torch.uint8, 2),
                                      ("a_lens", a_lens, torch.int32, 1),
                                      ("b_lens", b_lens, torch.int32, 1)):
        if tensor.device != device:
            raise ValueError("{0} is on {1}, expected {2}".format(
                name, tensor.device, device))
        if tensor.dtype != dtype or tensor.dim() != dims:
            raise ValueError("{0} must be a {1}-d {2} tensor, got {3}-d "
                             "{4}".format(name, dims, dtype, tensor.dim(),
                                          tensor.dtype))
        if not tensor.is_contiguous():
            raise ValueError("{0} must be contiguous".format(name))
    batch, length = a_codes.shape
    if b_codes.shape != a_codes.shape or a_lens.shape != (batch,) \
            or b_lens.shape != (batch,):
        raise ValueError("shape mismatch: a_codes {0}, b_codes {1}, a_lens "
                         "{2}, b_lens {3}".format(
                             tuple(a_codes.shape), tuple(b_codes.shape),
                             tuple(a_lens.shape), tuple(b_lens.shape)))
    if band < 0 or length < 1:
        raise ValueError("need band >= 0 and length >= 1")
    out = torch.empty(batch, dtype=torch.int32, device=device)
    if batch == 0:
        return out
    with torch.cuda.device(device):
        library = _kernel_library()
        scratch = None
        if not uses_shared_fronts(band):
            scratch = torch.empty((batch, 3, 2 * band + 1), dtype=torch.int32,
                                  device=device)
        code = library.wavefront_banded_distance(
            a_codes.data_ptr(), a_lens.data_ptr(), b_codes.data_ptr(),
            b_lens.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            batch, length, band, torch.cuda.current_stream(device).cuda_stream)
    if code != 0:
        raise RuntimeError("wavefront kernel launch failed: CUDA error "
                           "{0}".format(code))
    LAUNCHES += 1
    return out


def banded_distance(a_codes, a_lens, b_codes, b_lens, band: int):
    """Dispatcher: CPU tensors -> plain version, CUDA tensors -> kernel."""
    if a_codes.device.type == "cpu":
        return banded_distance_torch(a_codes, a_lens, b_codes, b_lens, band)
    if a_codes.device.type == "cuda":
        return banded_distance_cuda(a_codes, a_lens, b_codes, b_lens, band)
    raise ValueError("no wavefront kernel for device {0}".format(
        a_codes.device))


# --- host drivers -------------------------------------------------------------


def _encode(strings, length):
    """Raw bytes, zero-padded to `length` (exact comparison incl. N etc.)."""
    out = np.zeros((len(strings), length), dtype=np.uint8)
    for row, text in enumerate(strings):
        raw = np.frombuffer(text.encode(), dtype=np.uint8)
        out[row, :len(raw)] = raw
    return out


def _pow2_at_least(value: int, floor: int) -> int:
    result = floor
    while result < value:
        result *= 2
    return result


def _pow4_at_least(value: int, floor: int) -> int:
    result = floor
    while result < value:
        result *= 4
    return result


# The kernel runs one CTA per pair, so a launch wants many pairs in flight;
# 8192 pairs keep every SM busy and bound the padded codes at 2 x 8192 x L
# bytes.  The plain version on the CPU holds several (B, 2W+1) int32
# temporaries per step, so its batch is capped by cells instead.
CUDA_PAIRS_PER_LAUNCH = 8192
CPU_BATCH_CHUNK = 1024
CPU_MAX_CELLS_PER_STEP = 1 << 18


def _chunk_size(band: int, device) -> int:
    if device.type == "cuda":
        return CUDA_PAIRS_PER_LAUNCH
    chunk = CPU_BATCH_CHUNK
    while chunk > 64 and chunk * (2 * band + 1) > CPU_MAX_CELLS_PER_STEP:
        chunk //= 2
    return chunk


def _run_chunk(chunk, length, band, device):
    """One banded_distance call over string pairs -> device int32 tensor."""
    a_codes = torch.from_numpy(_encode([a for a, _ in chunk], length))
    b_codes = torch.from_numpy(_encode([b for _, b in chunk], length))
    a_lens = torch.tensor([len(a) for a, _ in chunk], dtype=torch.int32)
    b_lens = torch.tensor([len(b) for _, b in chunk], dtype=torch.int32)
    return banded_distance(a_codes.to(device), a_lens.to(device),
                           b_codes.to(device), b_lens.to(device), band)


def batched_edit_distance_resident(pairs, band_hints, device):
    """Exact edit distances that STAY ON `device` (device-resident INS
    route).  Requires PROVEN per-pair upper bounds (`band_hints`): each pow4
    band bucket then resolves in one pass, with no host band-doubling loop,
    so the per-bucket outputs scatter into one int32 tensor (input order)
    without visiting the host."""
    count = len(pairs)
    host_fill = np.zeros(count, dtype=np.int32)
    groups = {}
    for idx, (a, b) in enumerate(pairs):
        if len(a) == 0 or len(b) == 0:
            host_fill[idx] = max(len(a), len(b))
            continue
        band = _pow4_at_least(int(band_hints[idx]) + 1, 64)
        groups.setdefault(band, []).append(idx)
    out = torch.from_numpy(host_fill).to(device)
    for band, indices in sorted(groups.items()):
        subset = [pairs[i] for i in indices]
        length = _pow2_at_least(max(max(len(a), len(b)) for a, b in subset),
                                512)
        band_eff = min(band, length)
        chunk_size = _chunk_size(band_eff, device)
        for chunk_start in range(0, len(subset), chunk_size):
            chunk = subset[chunk_start:chunk_start + chunk_size]
            values = _run_chunk(chunk, length, band_eff, device)
            chunk_idx = torch.as_tensor(
                indices[chunk_start:chunk_start + len(chunk)],
                dtype=torch.int64).to(device)
            out[chunk_idx] = values
    return out


def batched_edit_distance(pairs, device, initial_band: int = 64,
                          band_hints=None):
    """Exact edit distances for a list of (a, b) string pairs on `device`,
    with band doubling until all pairs resolve (lengths bucketed pow2 from
    512, bands capped at the length).

    band_hints: optional per-pair PROVEN upper bounds on the distance; a
    narrow first pass resolves the bulk, then pairs are grouped by pow4 hint
    band and each group resolves in one pass."""
    if not pairs:
        return []
    results = np.full(len(pairs), -1, dtype=np.int64)
    pending = []
    for idx, (a, b) in enumerate(pairs):
        if len(a) == 0 or len(b) == 0:
            results[idx] = max(len(a), len(b))
        else:
            pending.append(idx)
    band = initial_band

    def run(subset_indices, band):
        subset = [pairs[idx] for idx in subset_indices]
        length = max(max(len(a), len(b)) for a, b in subset)
        length = _pow2_at_least(max(length, 1), 512)
        band = min(band, length)  # a wider band than the strings is degenerate
        chunk_size = _chunk_size(band, device)
        answers = np.empty(len(subset), dtype=np.int64)
        for chunk_start in range(0, len(subset), chunk_size):
            chunk = subset[chunk_start:chunk_start + chunk_size]
            answers[chunk_start:chunk_start + len(chunk)] = _run_chunk(
                chunk, length, band, device).cpu().numpy()
        return answers, length

    if band_hints is not None and pending:
        # hints are PROVEN upper bounds but usually loose, so a cheap narrow
        # first pass resolves the bulk before the hint-sized groups run
        answers, _length = run(pending, band)
        first_leftovers = []
        for position, idx in enumerate(pending):
            if answers[position] <= band:
                results[idx] = int(answers[position])
            else:
                first_leftovers.append(idx)
        groups = {}
        for idx in first_leftovers:
            hint_band = _pow4_at_least(int(band_hints[idx]) + 1, initial_band)
            groups.setdefault(hint_band, []).append(idx)
        leftovers = []
        for hint_band, indices in sorted(groups.items()):
            answers, _length = run(indices, hint_band)
            for position, idx in enumerate(indices):
                if answers[position] <= hint_band:
                    results[idx] = int(answers[position])
                else:  # hint was not a true bound; fall through to doubling
                    leftovers.append(idx)
        pending = leftovers
        band = max(groups) * 2 if groups else band

    while pending:
        answers, length = run(pending, band)
        still_pending = []
        for position, idx in enumerate(pending):
            if answers[position] <= band:
                results[idx] = int(answers[position])
            else:
                still_pending.append(idx)
        pending = still_pending
        band *= 2
        if pending and band > 2 * length:
            # distance can never exceed max length; one final full-width pass
            answers, _ = run(pending, band)
            for position, idx in enumerate(pending):
                results[idx] = int(answers[position])
            pending = []
    return results.tolist()
