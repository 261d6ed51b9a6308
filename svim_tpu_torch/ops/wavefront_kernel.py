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
  * `banded_distance_cuda` — the wrapper of the hand-written CUDA kernels
    (csrc/wavefront.cu: one warp per pair with the fronts in registers,
    narrow bands tried first inside the kernel; for bands too wide for
    that, a ladder of narrow bands in warps, then strips of rows a CTA a
    pair on the pairs it left open), equal to the plain version entry for
    entry, also above the band; counted in `LAUNCHES`.
  * `banded_distance` — the dispatcher: a CPU tensor takes the plain
    version, a CUDA tensor the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from svim_tpu_torch.ops._build import check_launch
from svim_tpu_torch.state import to_host
from svim_tpu_torch.utils import timing

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
_strip_static_bytes = None
WARP_KERNEL_MAX_SLOTS = 32 * 33   # slots of a front one warp holds in registers
STRIP_ROWS = 32 * 32              # rows of a strip (32 lanes, 32 rows a lane)
STRIP_MAX_WARPS = 8
STRIP_COUNTER_INTS = 64           # scratch ints before the strip kernel's rows
VARIANTS = ("warp", "strip", "strip_unstaged")
# LAUNCHES by the code path each launch took (kernel_variant's names)
VARIANT_LAUNCHES = dict.fromkeys(VARIANTS, 0)


def _kernel_library():
    global _library, _max_shared_bytes, _strip_static_bytes
    if _library is None:
        from svim_tpu_torch.ops._build import load

        library = load("wavefront")
        pointer, integer = ctypes.c_void_p, ctypes.c_int
        library.wavefront_banded_distance_warp.argtypes = [
            pointer, pointer, pointer, pointer, pointer, integer, integer,
            integer, integer, integer, pointer]
        library.wavefront_banded_distance_warp.restype = integer
        library.wavefront_banded_distance_strip.argtypes = [
            pointer, pointer, pointer, pointer, pointer, pointer, integer,
            integer, integer, integer, integer, integer, integer, integer,
            pointer]
        library.wavefront_banded_distance_strip.restype = integer
        library.wavefront_strip_grid.argtypes = [integer] * 4
        library.wavefront_strip_grid.restype = integer
        for name in ("wavefront_max_shared_bytes",
                     "wavefront_strip_static_bytes", "wavefront_uses_dpx"):
            getattr(library, name).argtypes = []
            getattr(library, name).restype = integer
        _max_shared_bytes = library.wavefront_max_shared_bytes()
        if _max_shared_bytes <= 0:
            raise RuntimeError("cannot query the per-block shared-memory "
                               "limit of the CUDA device")
        _strip_static_bytes = library.wavefront_strip_static_bytes()
        _library = library
    return _library


def uses_dpx() -> bool:
    """True when the built kernel folds add and min with Hopper's DPX
    instruction (the toolkit declares __viaddmin_s32)."""
    return bool(_kernel_library().wavefront_uses_dpx())


def kernel_variant(length: int, band: int) -> str:
    """The code path a launch of this shape takes: "warp" (fronts in
    registers, one warp per pair, strings staged in shared memory),
    "strip" (the ladder of narrow bands in warps, then strips of rows a
    CTA a pair, strings staged) or "strip_unstaged" (the same with the
    strings read from global memory, where two of them do not fit shared
    memory)."""
    _kernel_library()
    if min(band, length) + 1 <= WARP_KERNEL_MAX_SLOTS \
            and 2 * length <= _max_shared_bytes:
        return "warp"
    if 2 * length <= _max_shared_bytes - _strip_static_bytes:
        return "strip"
    return "strip_unstaged"


def _warps_per_cta(batch: int, length: int, staged: bool = True) -> int:
    """Pairs a CTA of the warp kernel: four where the batch fills the card
    several times over and their staged strings fit, else fewer, so that a
    small batch spreads over as many SMs as it has pairs."""
    warps = 4 if batch >= 2048 else 1
    while staged and warps > 1 and warps * 2 * length > _max_shared_bytes:
        warps //= 2
    return warps


def _ladder_stages(length: int) -> bool:
    """Whether the strip layout's ladder stages its strings: where four
    warps' strings fit one SM's shared memory; above that (L > 29,056 on
    the H100) reading them from global memory lets more warps run at once
    than staging would."""
    return 4 * 2 * length <= _max_shared_bytes


def _strip_warps(length: int) -> int:
    """Warps a CTA of the strip kernel: one a strip of the longest string,
    at most STRIP_MAX_WARPS."""
    return max(1, min(STRIP_MAX_WARPS, -(-length // STRIP_ROWS)))


def banded_distance_cuda(a_codes, a_lens, b_codes, b_lens, band: int,
                         variant=None):
    """banded_distance on the card through csrc/wavefront.cu.

    a_codes, b_codes: (B, L) uint8 contiguous CUDA tensors; a_lens, b_lens:
    (B,) int32 contiguous on the same device.  Returns (B,) int32 on that
    device, equal to banded_distance_torch entry for entry.  `variant`
    forces one of VARIANTS instead of the one `kernel_variant` picks (the
    kernel checks); it raises when the shape does not fit that variant."""
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
        if variant is None:
            variant = kernel_variant(length, band)
        stream = torch.cuda.current_stream(device).cuda_stream
        pointers = (a_codes.data_ptr(), a_lens.data_ptr(), b_codes.data_ptr(),
                    b_lens.data_ptr(), out.data_ptr())
        if variant == "warp":
            slots = min(band, length) + 1
            if slots > WARP_KERNEL_MAX_SLOTS or 2 * length > _max_shared_bytes:
                raise ValueError("L={0}, W={1} does not fit the warp "
                                 "kernel".format(length, band))
            slots_per_lane = 3 if slots <= 96 else 9 if slots <= 288 else 33
            code = library.wavefront_banded_distance_warp(
                *pointers, batch, length, band, slots_per_lane,
                _warps_per_cta(batch, length), stream)
        elif variant in ("strip", "strip_unstaged"):
            stage = int(variant == "strip")
            if stage and 2 * length > _max_shared_bytes - _strip_static_bytes:
                raise ValueError("L={0} does not fit staged strings".format(
                    length))
            warps = _strip_warps(length)
            grid = library.wavefront_strip_grid(batch, length, warps, stage)
            if grid < 1:
                raise RuntimeError("the strip kernel fits no CTA on {0} at "
                                   "L={1}".format(device, length))
            scratch = torch.empty(STRIP_COUNTER_INTS + grid * (length + 1),
                                  dtype=torch.int32, device=device)
            ladder_stage = int(stage and _ladder_stages(length))
            code = library.wavefront_banded_distance_strip(
                *pointers, scratch.data_ptr(), batch, length, band,
                _warps_per_cta(batch, length, staged=bool(ladder_stage)),
                ladder_stage, warps, grid, stage, stream)
        else:
            raise ValueError("unknown variant {0!r}".format(variant))
    check_launch("wavefront", code)
    LAUNCHES += 1
    VARIANT_LAUNCHES[variant] += 1
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


def _encode(strings, length, out=None):
    """Raw bytes, zero-padded to `length` (exact comparison incl. N etc.),
    as one (len(strings), length) uint8 matrix, with no Python loop over
    the strings: numpy converts the list to fixed-width byte strings, which
    is this matrix.  `out`, when given, is the matrix to overwrite."""
    count = len(strings)
    try:
        fixed = np.array(strings, dtype="S{0}".format(length))
        longest = max(map(len, strings), default=0)
    except UnicodeEncodeError:   # characters outside ASCII: their UTF-8 bytes
        raw = [text.encode() for text in strings]
        fixed = np.array(raw, dtype="S{0}".format(length))
        longest = max(map(len, raw))
    if longest > length:   # the conversion above would have cut it
        raise ValueError("a string of {0} bytes does not fit length "
                         "{1}".format(longest, length))
    codes = fixed.view(np.uint8).reshape(count, length)
    if out is None:
        return codes
    out[...] = codes
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


# The kernel runs one warp (wide bands: a ladder of warps, then CTAs) per
# pair, so a launch wants many pairs in flight; 8192 pairs keep every SM
# busy and bound the padded codes at 2 x 8192 x L bytes.  The plain version on the CPU holds several (B, 2W+1) int32
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


def _pack_chunk(chunk, length, device):
    """The four kernel inputs of a list of string pairs on `device`, from
    one host buffer (codes of a, codes of b, lengths of a, lengths of b;
    pinned for a card) that goes up in a single copy."""
    count = len(chunk)
    codes_bytes = count * length
    lens_offset = -(-2 * codes_bytes // 16) * 16   # int32 views need alignment
    # every byte the kernel reads is written below
    host = torch.empty(lens_offset + 8 * count, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    view = host.numpy()
    _encode([a for a, _ in chunk], length,
            out=view[:codes_bytes].reshape(count, length))
    _encode([b for _, b in chunk], length,
            out=view[codes_bytes:2 * codes_bytes].reshape(count, length))
    lens = view[lens_offset:].view(np.int32)
    lens[:count] = np.fromiter((len(a) for a, _ in chunk), dtype=np.int32,
                               count=count)
    lens[count:] = np.fromiter((len(b) for _, b in chunk), dtype=np.int32,
                               count=count)
    packed = host.to(device, non_blocking=True)
    device_lens = packed[lens_offset:].view(torch.int32)
    return (packed[:codes_bytes].view(count, length), device_lens[:count],
            packed[codes_bytes:2 * codes_bytes].view(count, length),
            device_lens[count:])


def covered_cells(length: int, band: int) -> int:
    """DP cells 1 <= i, j <= length with |i - j| <= band: what one pair of
    a launch at this padded length and band covers."""
    if band >= length - 1:
        return length * length
    return length * (2 * band + 1) - band * (band + 1)


def _run_chunk(chunk, length, band, device):
    """One banded_distance call over string pairs -> device int32 tensor;
    the running job counts its pairs (`wavefront.pairs`) and the cells
    their band and padded length cover (`wavefront.cells`)."""
    timing.count("wavefront.pairs", len(chunk))
    timing.count("wavefront.cells", len(chunk) * covered_cells(length, band))
    return banded_distance(*_pack_chunk(chunk, length, device), band)


class HaplotypePairs:
    """String pairs held as byte segments of one shared blob: each side of
    pair k is three pieces, blob[start:start + length] for the (start,
    length) columns 0-1, 2-3 and 4-5 of parts[k, side], one after the
    other (an insertion's haplotype: the reference before it, the inserted
    sequence, the reference after it).  The card assembles a launch's code
    matrices from the blob itself, so no string of a pair is built on the
    host.  Iterating gives the pairs as strings, for what reads them so."""

    __slots__ = ("blob", "parts")

    def __init__(self, blob, parts):
        self.blob = np.array(blob, dtype=np.uint8)   # writable, for torch
        self.parts = np.asarray(parts, dtype=np.int64).reshape(-1, 2, 6)

    @classmethod
    def from_strings(cls, pairs):
        """Each string of `pairs` as one segment (its UTF-8 bytes)."""
        pieces = [text.encode() for pair in pairs for text in pair]
        lengths = np.fromiter(map(len, pieces), dtype=np.int64,
                              count=len(pieces))
        parts = np.zeros((len(pieces), 6), dtype=np.int64)
        parts[1:, 0] = np.cumsum(lengths[:-1])
        parts[:, 1] = lengths
        return cls(np.frombuffer(b"".join(pieces), dtype=np.uint8), parts)

    def __len__(self):
        return len(self.parts)

    def lengths(self):
        """(pairs, 2) bytes of each side."""
        return self.parts[:, :, 1::2].sum(axis=2)

    def __iter__(self):
        blob = self.blob
        for pair in self.parts.tolist():
            yield tuple(b"".join(blob[start:start + length].tobytes()
                                 for start, length in zip(side[0::2],
                                                          side[1::2])).decode()
                        for side in pair)


def _segment_codes(blob, parts, length):
    """The (B, length) uint8 code matrix and (B,) int32 lengths of one side
    of B pairs, gathered from `blob` (a tensor on the launch's device) by
    the (B, 6) segment columns, zero past each string's end."""
    parts = torch.from_numpy(np.ascontiguousarray(parts)).to(blob.device)
    column = torch.arange(length, device=blob.device)[None, :]
    first = parts[:, 1:2]
    second = first + parts[:, 3:4]
    total = second + parts[:, 5:6]
    index = torch.where(column < first, parts[:, 0:1] + column,
                        torch.where(column < second,
                                    parts[:, 2:3] + column - first,
                                    parts[:, 4:5] + column - second))
    codes = blob[index.clamp_(0, max(blob.numel() - 1, 0))]
    codes.masked_fill_(column >= total, 0)
    return codes, total[:, 0].to(torch.int32)


def _run_segments(blob, parts, length, band):
    """One banded_distance call over the pairs of `parts` ((B, 2, 6)
    segment columns into the device tensor `blob`), counted as _run_chunk
    counts."""
    timing.count("wavefront.pairs", len(parts))
    timing.count("wavefront.cells", len(parts) * covered_cells(length, band))
    a_codes, a_lens = _segment_codes(blob, parts[:, 0], length)
    b_codes, b_lens = _segment_codes(blob, parts[:, 1], length)
    return banded_distance(a_codes, a_lens, b_codes, b_lens, band)


def batched_edit_distance_resident(pairs, band_hints, device):
    """Exact edit distances that STAY ON `device` (device-resident INS
    route) of the HaplotypePairs `pairs`.  Requires PROVEN
    per-pair upper bounds (`band_hints`): each pow4 band bucket then
    resolves in one pass, with no host band-doubling loop, so the
    per-bucket outputs scatter into one int32 tensor (input order) without
    visiting the host.  The blob goes up once; each launch's codes are
    gathered from it on the device."""
    lengths = pairs.lengths()
    empty = (lengths == 0).any(axis=1)
    host_fill = np.where(empty, lengths.max(axis=1), 0).astype(np.int32)
    out = torch.from_numpy(host_fill).to(device)
    if empty.all():
        return out
    hints = np.asarray(band_hints, dtype=np.int64) + 1
    bands = np.full(len(pairs), 64, dtype=np.int64)
    while (short := bands < hints).any():
        bands[short] *= 4
    blob = torch.from_numpy(pairs.blob).to(device)
    for band in np.unique(bands[~empty]).tolist():
        indices = np.flatnonzero((bands == band) & ~empty)
        length = _pow2_at_least(int(lengths[indices].max()), 512)
        band_eff = min(band, length)
        chunk_size = _chunk_size(band_eff, device)
        for chunk_start in range(0, len(indices), chunk_size):
            chunk = indices[chunk_start:chunk_start + chunk_size]
            values = _run_segments(blob, pairs.parts[chunk], length, band_eff)
            out[torch.from_numpy(chunk).to(device)] = values
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
            answers[chunk_start:chunk_start + len(chunk)] = to_host(
                _run_chunk(chunk, length, band, device))
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
