"""Batched average-linkage agglomeration over padded partitions.

Counterpart of svim_tpu/ops/linkage_kernel.py.  Each partition is a fixed
(P, P) float32 distance matrix (P in {32, 128}), given (matrix route) or
built from integer coordinate columns (fused route), and P-1 dependent
argmin+update steps turn it into a merge sequence.

Three layers for each of the two entry points, on the pattern of
ops/wavefront_kernel.py and ops/distance_kernel.py:
  * `agglomerate_batched_plain`, `span_position_agglomerate_batched_plain`
    - the plain PyTorch versions: the batch dimension written out where the
    JAX package used vmap, the steps a Python loop of `max(valid count) -
    1` rounds of torch ops.  They run on any device and equal the JAX
    package's outputs bit for bit on the CPU.
  * `agglomerate_batched_cuda`, `span_position_agglomerate_batched_cuda` -
    the wrappers of the hand-written CUDA kernel (csrc/agglomerate.cu: a
    minimum kept a row, one CTA a partition with a thread a row, or a warp
    a partition when P <= 32; the matrix resident in shared memory for all
    its steps, each partition running its own step count), bit-identical
    to the plain versions, counted in `LAUNCHES`.
  * `agglomerate_batched`, `span_position_agglomerate_batched` - the
    dispatchers the CLUSTER stage calls: CPU tensors take the plain
    version, CUDA tensors the kernel.  Nothing falls back: a kernel that
    fails to build or to launch raises.

Outputs match the JAX kernels: the merge sequence (slot pairs + heights)
and the minimum relative tie gap, from which the host rebuilds scipy's Z
and cuts it with fcluster (device_cluster.labels_from_merges).

The resident INS route's matrices have the same three layers:
`ins_matrices_from_pairs_plain` (torch ops and two scatters),
`ins_matrices_from_pairs_cuda` (csrc/ins_matrices.cu: one launch, a CTA a
partition finds its pairs by a warp search, assembles the matrix in shared
memory and writes it once; counted in `INS_LAUNCHES`) and the dispatcher
`ins_matrices_from_pairs`.  Both routes take the pair columns in partition
order only (see `check_pair_order`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from svim_tpu_torch.ops._build import check_launch, check_tensors, route

BIG = 3.0e38
# merges with height >= CUTOFF are padding (no real pair left)
MERGE_CUTOFF = 1.0e30
# relative gap below which float32 cannot safely arbitrate a comparison that
# scipy performs in float64 (same value as the JAX package)
TIE_EPS = 3.0e-4
WALL = 99999.0
BND_NORM = 3000.0  # hardcoded in the reference (SVIM_clustering.py:91)
BND_RECIPROCAL = float(np.float32(1.0) / np.float32(BND_NORM))

# per-partition distance-formula codes for the fused route
KIND_SPAN_POSITION = 0   # DEL / INV / DUP_TAN  (SVIM_clustering.py:48-63)
KIND_DUP_INT = 1         # source center + destination start + span (:78-86)
KIND_BND = 2             # (|pos1 delta| + |pos2 delta|) / 3000 (:87-94)

LAUNCHES = 0   # kernel launches by the two agglomeration *_cuda wrappers
INS_LAUNCHES = 0   # calls of ins_matrices_from_pairs_cuda that launched
INS_KERNELS_PER_CALL = 1   # device kernels such a call launches


def _scalar(value, like):
    """A 0-d float32 tensor on `like`'s device: float32 arithmetic against a
    device tensor, never a host scalar (CUDA turns division by a host
    scalar into multiplication by its reciprocal)."""
    return torch.tensor(value, dtype=torch.float32, device=like.device)


def _fused_multiply_add(a, b, c):
    """a*b + c rounded once to float32, as the reference computes the
    size-weighted row average: XLA contracts s_lo*d_lo + s_hi*d_hi into
    fma(s_lo, d_lo, s_hi*d_hi).  The float32 product is exact in float64,
    so one float64 add and one rounding reproduce the fused result."""
    return (a.to(torch.float64) * b.to(torch.float64)
            + c.to(torch.float64)).to(torch.float32)


def _agglomerate(d, steps: int):
    """(B, P, P) float32 distances (BIG on the diagonal / invalid slots)
    -> (merge_lo, merge_hi, heights: (B, P-1), min_rel_gap: (B,)).

    Runs `steps` argmin+average-update steps per partition; steps whose
    global minimum is >= MERGE_CUTOFF emit (-1, -1, BIG) padding rows.
    min_rel_gap is the smallest (second_best - best) / max(best, 1) over
    real merge steps — 0 for an exact tie."""
    batch, p, _ = d.shape
    device = d.device
    rows = torch.arange(batch, device=device)
    index = torch.arange(p, dtype=torch.int32, device=device)
    eye = torch.eye(p, dtype=torch.bool, device=device)
    big = _scalar(BIG, d)
    one = _scalar(1.0, d)

    valid = (d < MERGE_CUTOFF).any(dim=2) | (d < MERGE_CUTOFF).any(dim=1)
    sizes = valid.to(torch.float32)
    merges_lo = torch.full((batch, p - 1), -1, dtype=torch.int32, device=device)
    merges_hi = torch.full((batch, p - 1), -1, dtype=torch.int32, device=device)
    heights = torch.full((batch, p - 1), BIG, dtype=torch.float32,
                         device=device)
    min_gap = torch.full((batch,), BIG, dtype=torch.float32, device=device)
    for step in range(steps):
        # first minimum in row-major order, as jnp.argmin
        flat = torch.argmin(d.reshape(batch, p * p), dim=1)
        i = (flat // p).to(torch.int32)
        j = (flat % p).to(torch.int32)
        lo = torch.minimum(i, j)
        hi = torch.maximum(i, j)
        lo_l = lo.long()
        hi_l = hi.long()
        best = d[rows, lo_l, hi_l]
        real = best < MERGE_CUTOFF

        # runner-up over every other pair (the symmetric twin of (lo, hi) is
        # masked out); an exact tie elsewhere gives gap 0
        is_lo = index[None, :] == lo[:, None]
        is_hi = index[None, :] == hi[:, None]
        pair_mask = ((is_lo[:, :, None] & is_hi[:, None, :])
                     | (is_hi[:, :, None] & is_lo[:, None, :]))
        second = torch.where(pair_mask, big, d).amin(dim=(1, 2))
        gap = (second - best) / torch.maximum(best, one)
        min_gap = torch.where(real & (second < MERGE_CUTOFF),
                              torch.minimum(min_gap, gap), min_gap)

        size_lo = sizes[rows, lo_l]
        size_hi = sizes[rows, hi_l]
        row_lo = d[rows, lo_l, :]
        row_hi = d[rows, hi_l, :]
        merged_row = (_fused_multiply_add(size_lo[:, None], row_lo,
                                          size_hi[:, None] * row_hi)
                      / (size_lo + size_hi)[:, None])
        keep_big = (row_lo >= MERGE_CUTOFF) | (row_hi >= MERGE_CUTOFF)
        merged_row = torch.where(keep_big, big, merged_row)

        real_col = real[:, None]
        column_lo = d[rows, :, lo_l]
        new_d = d.clone()
        new_d[rows, lo_l, :] = torch.where(real_col, merged_row, row_lo)
        new_d[rows, :, lo_l] = torch.where(real_col, merged_row, column_lo)
        row_mask = is_hi[:, :, None] | is_hi[:, None, :] | eye[None]
        d = torch.where(real[:, None, None] & row_mask, big, new_d)

        new_sizes = sizes.clone()
        new_sizes[rows, lo_l] = torch.where(real, size_lo + size_hi, size_lo)
        new_sizes[rows, hi_l] = torch.where(real, torch.zeros_like(size_hi),
                                            size_hi)
        sizes = new_sizes
        merges_lo[:, step] = torch.where(real, lo, -1)
        merges_hi[:, step] = torch.where(real, hi, -1)
        heights[:, step] = torch.where(real, best, big)
    return merges_lo, merges_hi, heights, min_gap


def _steps(valid) -> int:
    if valid.numel() == 0:
        return 0
    return max(int(valid.sum(dim=1).max()) - 1, 0)


def agglomerate_batched_plain(distances, valid):
    """(B, P, P) float32 distances + (B, P) bool valid -> per-partition merge
    sequences (merge_lo, merge_hi, heights: (B, P-1)) and min relative tie
    gap (B,).  Invalid slots never participate."""
    p = distances.shape[1]
    pair_valid = valid[:, :, None] & valid[:, None, :]
    eye = torch.eye(p, dtype=torch.bool, device=distances.device)[None]
    d = torch.where(pair_valid & ~eye, distances.to(torch.float32),
                    _scalar(BIG, distances))
    return _agglomerate(d, _steps(valid))


def check_pair_order(pair_part, pair_i, pair_j, batch):
    """Raises ValueError unless the pair columns come in partition order:
    the key pair_i == pair_j ? +inf : pair_part does not decrease, i.e. the
    real pairs grouped by ascending partition, then the padding pairs
    (i == j) and nothing after them.  ins_matrices_from_pairs takes only
    such columns (csrc/ins_matrices.cu traps on others); the resident
    dispatch builds them so.  A host sync on a card's tensors: the plain
    version and the tests call it, the kernel's wrapper does not."""
    key = torch.where(pair_i == pair_j,
                      torch.full_like(pair_part, batch, dtype=torch.int64),
                      pair_part.long())
    if bool((key[1:] < key[:-1]).any()):
        raise ValueError("the INS pair columns are not in partition order "
                         "(real pairs by ascending partition, then the "
                         "padding)")


def ins_matrices_from_pairs_plain(starts, spans, pair_part, pair_i, pair_j,
                                  pair_ed, pos_norm, ed_norm):
    """Device-resident INS distance matrices (SVIM_clustering.py:64-77).

    starts/spans: (B, P) int32 partition columns.  pair_*: flat near-pair
    lists (enumerated on host in the exact f64 order distance_matrix uses);
    pair_ed comes straight from the wavefront kernel and never visits the
    host.  Far pairs get position + span distance; near pairs get position +
    ed/max_span/ed_norm.  Diagonal/invalid slots are left arbitrary —
    agglomerate_batched masks them.  Padding pairs (i == j) point at the
    masked diagonal, (0, 0, 0) as the host pads.  A pair outside the (B, P)
    matrices raises ValueError, and so do columns out of partition order
    (check_pair_order; the kernel traps on either).  The JAX function takes
    pairs in any order; the port takes them as the host builds them."""
    batch, p = starts.shape
    if bool(((pair_part < 0) | (pair_part >= batch) | (pair_i < 0)
             | (pair_i >= p) | (pair_j < 0) | (pair_j >= p)).any()):
        raise ValueError("a pair lies outside the ({0}, {1}, {1}) INS "
                         "matrices".format(batch, p))
    check_pair_order(pair_part, pair_i, pair_j, batch)
    pos_norm = _scalar(pos_norm, starts)
    ed_norm = _scalar(ed_norm, starts)
    one = _scalar(1.0, starts)
    delta = (starts[:, :, None] - starts[:, None, :]).abs()  # int32: exact
    pos = delta.to(torch.float32) / pos_norm
    spans_f = spans.to(torch.float32)
    max_span = torch.maximum(spans_f[:, :, None], spans_f[:, None, :])
    span_d = ((spans_f[:, :, None] - spans_f[:, None, :]).abs()
              / torch.maximum(max_span, one))
    mat = pos + span_d
    part = pair_part.long()
    first = pair_i.long()
    second = pair_j.long()
    # the reference writes ed / max(max_span, 1) / ed_norm, which XLA's
    # simplifier turns into one division by the product: (a / b) / c ->
    # a / (b * c)
    ed_term = (pos[part, first, second]
               + pair_ed.to(torch.float32)
               / (torch.maximum(max_span[part, first, second], one)
                  * ed_norm))
    mat[part, first, second] = ed_term
    mat[part, second, first] = ed_term
    return mat


def _span_position_fused(starts, ends, dest, reads, valid, norm, threshold,
                         wall_flag, kind):
    """Batched device distance matrices + same-read dedup for the fused
    route.  All inputs are (B, P) except wall_flag, kind: (B,).  Returns
    (d, dropped, has_wall, dedup_ambiguous) with d ready to agglomerate."""
    p = starts.shape[1]
    device = starts.device
    norm = _scalar(norm, starts)
    threshold = _scalar(threshold, starts)
    big = _scalar(BIG, starts)
    one = _scalar(1.0, starts)
    centers = torch.div(starts + ends, 2, rounding_mode="floor")
    spans = ends - starts
    delta_center = (centers[:, :, None] - centers[:, None, :]).abs()
    delta_span = (spans[:, :, None] - spans[:, None, :]).abs()
    max_span = torch.clamp(torch.maximum(spans[:, :, None], spans[:, None, :]),
                           min=1)
    span_position = (delta_center.to(torch.float32) / norm
                     + delta_span.to(torch.float32)
                     / max_span.to(torch.float32))
    delta_dest = (dest[:, :, None] - dest[:, None, :]).abs().to(torch.float32)
    dup_int = span_position + delta_dest / norm
    delta_start = (starts[:, :, None] - starts[:, None, :]).abs().to(
        torch.float32)
    # the reference divides by the compile-time constant 3000, which XLA
    # turns into a multiplication by its float32 reciprocal
    bnd = (delta_start + delta_dest) * _scalar(BND_RECIPROCAL, starts)
    kind = kind[:, None, None]
    distance = torch.where(kind == KIND_BND, bnd,
                           torch.where(kind == KIND_DUP_INT, dup_int,
                                       span_position))

    eye = torch.eye(p, dtype=torch.bool, device=device)[None]
    pair_valid = valid[:, :, None] & valid[:, None, :] & ~eye
    same_read = (reads[:, :, None] == reads[:, None, :]) & pair_valid

    # reference dedup rule (SVIM_clustering.py:145-151): drop j when some
    # i < j from the same read is within the cut threshold
    slots = torch.arange(p, device=device)
    row_lt = (slots[:, None] < slots[None, :])[None]
    close = distance <= threshold
    wall = wall_flag[:, None]
    dropped = wall & (same_read & close & row_lt).any(dim=1)
    # float32 cannot arbitrate a dedup comparison this close to the cut
    near_cut = ((distance - threshold).abs()
                < TIE_EPS * torch.maximum(distance, one))
    dedup_ambiguous = wall_flag & (same_read & near_cut).flatten(1).any(dim=1)
    alive = valid & ~dropped
    pair_alive = alive[:, :, None] & alive[:, None, :] & ~eye
    surviving_same_read = same_read & pair_alive & wall[:, :, None]
    has_wall = surviving_same_read.flatten(1).any(dim=1)
    d = torch.where(surviving_same_read, _scalar(WALL, starts), distance)
    d = torch.where(pair_alive, d, big)
    return d, dropped, has_wall, dedup_ambiguous


def span_position_agglomerate_batched_plain(starts, ends, reads, valid, norm,
                                            threshold, wall_same_read, dest,
                                            kind):
    """(B, P) int32 coordinate batch -> per-partition merge sequences plus
    dedup/diagnostic outputs: (merges_lo, merges_hi, heights, min_gap,
    dropped, has_wall, dedup_ambiguous).

    `wall_same_read` is a (B,) bool tensor (True = apply the same-read
    dedup rule + wall; False = INV semantics) and `kind` a (B,) int32
    distance-formula code, so partitions of different types batch into one
    call.  `dest` carries the second coordinate column (DUP_INT destination
    start / BND pos2); ignored for kind 0."""
    d, dropped, has_wall, dedup_ambiguous = _span_position_fused(
        starts, ends, dest, reads, valid, norm, threshold, wall_same_read,
        kind)
    merges_lo, merges_hi, heights, min_gap = _agglomerate(d, _steps(valid))
    return (merges_lo, merges_hi, heights, min_gap, dropped, has_wall,
            dedup_ambiguous)


# --- the hand-written kernel (csrc/agglomerate.cu) ----------------------------

_library = None


def _kernel_library():
    global _library
    if _library is None:
        from svim_tpu_torch.ops._build import load

        library = load("agglomerate")
        pointer = ctypes.c_void_p
        library.agglomerate_max_slots.argtypes = []
        library.agglomerate_max_slots.restype = ctypes.c_int
        library.agglomerate_matrix.argtypes = (
            [pointer, pointer, ctypes.c_int, ctypes.c_int] + [pointer] * 5)
        library.agglomerate_matrix.restype = ctypes.c_int
        library.agglomerate_fused.argtypes = (
            [pointer] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                             ctypes.c_float] + [pointer] * 8)
        library.agglomerate_fused.restype = ctypes.c_int
        _library = library
    return _library


def _merge_outputs(batch, p, device):
    """Uninitialised (merges_lo, merges_hi, heights, min_gap): the kernel
    writes every element."""
    return (torch.empty((batch, p - 1), dtype=torch.int32, device=device),
            torch.empty((batch, p - 1), dtype=torch.int32, device=device),
            torch.empty((batch, p - 1), dtype=torch.float32, device=device),
            torch.empty((batch,), dtype=torch.float32, device=device))


def _check_slots(library, p):
    if not 2 <= p <= library.agglomerate_max_slots():
        raise ValueError("the agglomeration kernel takes 2 <= P <= {0} slots "
                         "(a partition's matrix stays in one CTA's shared "
                         "memory), got P={1}".format(
                             library.agglomerate_max_slots(), p))


def _launched(code):
    global LAUNCHES
    check_launch("agglomeration", code)
    LAUNCHES += 1


def agglomerate_batched_cuda(distances, valid):
    """agglomerate_batched on the card through csrc/agglomerate.cu.

    distances: (B, P, P) float32 contiguous CUDA tensor; valid: (B, P) bool
    on the same device.  Returns (merges_lo, merges_hi, heights, min_gap)
    on that device, equal to agglomerate_batched_plain bit for bit.  One
    launch, no host synchronisation."""
    device = distances.device
    if device.type != "cuda":
        raise ValueError("agglomerate_batched_cuda needs CUDA tensors")
    if distances.dim() != 3 or distances.shape[1] != distances.shape[2]:
        raise ValueError("distances must be (B, P, P), got {0}".format(
            tuple(distances.shape)))
    batch, p, _ = distances.shape
    check_tensors((("distances", distances, torch.float32, (batch, p, p)),
                   ("valid", valid, torch.bool, (batch, p))), device)
    library = _kernel_library()
    _check_slots(library, p)
    outputs = _merge_outputs(batch, p, device)
    if batch == 0:
        return outputs
    with torch.cuda.device(device):
        _launched(library.agglomerate_matrix(
            distances.data_ptr(), valid.data_ptr(), batch, p,
            *(tensor.data_ptr() for tensor in outputs),
            torch.cuda.current_stream(device).cuda_stream))
    return outputs


def span_position_agglomerate_batched_cuda(starts, ends, reads, valid, norm,
                                           threshold, wall_same_read, dest,
                                           kind):
    """span_position_agglomerate_batched on the card through
    csrc/agglomerate.cu: the distance matrices are built in shared memory
    and never reach device memory.

    starts, ends, reads, dest: (B, P) int32 contiguous CUDA tensors; valid:
    (B, P) bool; wall_same_read: (B,) bool; kind: (B,) int32; norm and
    threshold: numbers, rounded to float32.  Returns the seven outputs of
    span_position_agglomerate_batched_plain, bit for bit.  One launch, no
    host synchronisation."""
    device = starts.device
    if device.type != "cuda":
        raise ValueError("span_position_agglomerate_batched_cuda needs CUDA "
                         "tensors")
    if starts.dim() != 2:
        raise ValueError("starts must be (B, P), got {0}".format(
            tuple(starts.shape)))
    batch, p = starts.shape
    check_tensors(
        [(name, tensor, torch.int32, (batch, p)) for name, tensor in (
            ("starts", starts), ("ends", ends), ("dest", dest),
            ("reads", reads))]
        + [("valid", valid, torch.bool, (batch, p)),
           ("wall_same_read", wall_same_read, torch.bool, (batch,)),
           ("kind", kind, torch.int32, (batch,))], device)
    library = _kernel_library()
    _check_slots(library, p)
    outputs = _merge_outputs(batch, p, device) + (
        torch.empty((batch, p), dtype=torch.bool, device=device),
        torch.empty((batch,), dtype=torch.bool, device=device),
        torch.empty((batch,), dtype=torch.bool, device=device))
    if batch == 0:
        return outputs
    with torch.cuda.device(device):
        _launched(library.agglomerate_fused(
            starts.data_ptr(), ends.data_ptr(), dest.data_ptr(),
            reads.data_ptr(), valid.data_ptr(), wall_same_read.data_ptr(),
            kind.data_ptr(), batch, p, float(norm), float(threshold),
            *(tensor.data_ptr() for tensor in outputs),
            torch.cuda.current_stream(device).cuda_stream))
    return outputs


# --- the hand-written kernel of the resident INS matrices (csrc/ins_matrices.cu)

_ins_library = None


def _ins_kernel_library():
    global _ins_library
    if _ins_library is None:
        from svim_tpu_torch.ops._build import load

        library = load("ins_matrices")
        pointer = ctypes.c_void_p
        library.ins_matrices.argtypes = (
            [pointer] * 6 + [ctypes.c_int] * 3
            + [ctypes.c_float, ctypes.c_float, pointer, pointer])
        library.ins_matrices.restype = ctypes.c_int
        _ins_library = library
    return _ins_library


def ins_matrices_from_pairs_cuda(starts, spans, pair_part, pair_i, pair_j,
                                 pair_ed, pos_norm, ed_norm):
    """ins_matrices_from_pairs on the card through csrc/ins_matrices.cu.

    starts, spans: (B, P) int32 contiguous CUDA tensors; pair_part, pair_i,
    pair_j, pair_ed: (Q,) int32 on the same device; the norms: numbers,
    rounded to float32.  Returns the (B, P, P) float32 matrices, equal to
    ins_matrices_from_pairs_plain bit for bit off the diagonal (a padding
    pair (0, 0, 0) leaves its diagonal cell as the cell formula gives it).
    P is at most 4,096 (the C entry refuses more and check_launch raises).
    The pair columns must come in partition order (check_pair_order): on
    columns out of that order, or a pair outside the matrices, the kernel
    traps (the launch fails; the next synchronising call raises).
    One launch on the current stream (INS_KERNELS_PER_CALL), no host
    synchronisation; counted in `INS_LAUNCHES`."""
    global INS_LAUNCHES
    device = starts.device
    if device.type != "cuda":
        raise ValueError("ins_matrices_from_pairs_cuda needs CUDA tensors")
    if starts.dim() != 2 or pair_part.dim() != 1:
        raise ValueError("starts must be (B, P) and the pair columns (Q,), "
                         "got {0} and {1}".format(tuple(starts.shape),
                                                  tuple(pair_part.shape)))
    batch, p = starts.shape
    pairs = pair_part.shape[0]
    check_tensors(
        [("starts", starts, torch.int32, (batch, p)),
         ("spans", spans, torch.int32, (batch, p))]
        + [(name, tensor, torch.int32, (pairs,)) for name, tensor in (
            ("pair_part", pair_part), ("pair_i", pair_i), ("pair_j", pair_j),
            ("pair_ed", pair_ed))], device)
    library = _ins_kernel_library()
    matrices = torch.empty((batch, p, p), dtype=torch.float32, device=device)
    if batch == 0 or p == 0:
        return matrices
    with torch.cuda.device(device):
        check_launch("ins_matrices", library.ins_matrices(
            starts.data_ptr(), spans.data_ptr(), pair_part.data_ptr(),
            pair_i.data_ptr(), pair_j.data_ptr(), pair_ed.data_ptr(), batch,
            p, pairs, float(pos_norm), float(ed_norm), matrices.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream))
    INS_LAUNCHES += 1
    return matrices




def agglomerate_batched(distances, valid):
    """Dispatcher of the matrix route: CPU tensors -> plain version, CUDA
    tensors -> kernel (see agglomerate_batched_plain for the contract).
    Distances of another float type are rounded to float32 first, on either
    device."""
    distances = distances.to(torch.float32)
    return route(distances, "agglomeration", agglomerate_batched_plain,
                 agglomerate_batched_cuda)(distances, valid)


def ins_matrices_from_pairs(starts, spans, pair_part, pair_i, pair_j,
                            pair_ed, pos_norm, ed_norm):
    """Dispatcher of the resident INS matrices: CPU tensors -> plain
    version, CUDA tensors -> kernel (see ins_matrices_from_pairs_plain for
    the contract)."""
    return route(starts, "INS matrix", ins_matrices_from_pairs_plain,
                 ins_matrices_from_pairs_cuda)(
        starts, spans, pair_part, pair_i, pair_j, pair_ed, pos_norm, ed_norm)


def span_position_agglomerate_batched(starts, ends, reads, valid, norm,
                                      threshold, wall_same_read, dest, kind):
    """Dispatcher of the fused route: CPU tensors -> plain version, CUDA
    tensors -> kernel (see span_position_agglomerate_batched_plain for the
    contract)."""
    return route(starts, "agglomeration",
                 span_position_agglomerate_batched_plain,
                 span_position_agglomerate_batched_cuda)(
        starts, ends, reads, valid, norm, threshold, wall_same_read, dest,
        kind)
