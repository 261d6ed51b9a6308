"""Batched genotyping: reference-support counts as an interval join
(PyTorch).

Counterpart of svim_tpu/ops/genotype_kernel.py: for every candidate, a
fixed-size window of the coordinate-sorted, doubled-coordinate alignment
table is read and the reference's qualification chain applied (in-window
test, support-read exclusion by binary search, the 500-alignment cap in
coordinate order, the per-type span test), then DISTINCT supporting read
ids are counted.  All arithmetic is int32 on pre-doubled coordinates, so
counts equal the host join's exactly (SVIM_genotyping.py:34-94).

Three layers, on the pattern of ops/linkage_kernel.py:
  * `genotype_support_batched_plain` - the plain PyTorch version: the
    windows gathered as (candidates, slice_len) tensors, `searchsorted`,
    `cumsum` and a row sort, in blocks of candidates that bound those
    temporaries to MAX_GATHER_CELLS cells; it equals the JAX program on the
    CPU.
  * `genotype_support_batched_cuda` - the wrapper of the hand-written CUDA
    kernel (csrc/genotype_support.cu: a warp a candidate walking its
    window 4 x 32 rows a step, a row's rank and list slot from two ballots,
    stopping at the 500th qualifying row, the supporting ids sorted by a
    warp's bitonic network; no block barrier), equal to the plain version,
    one launch a call and no host synchronisation; counted in `LAUNCHES`.
  * `genotype_support_batched` - the dispatcher: CPU tensors take the
    plain version, CUDA tensors the kernel.  Nothing falls back.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from svim_tpu_torch.ops._build import check_launch, check_tensors, route
from svim_tpu_torch.parallel.mesh import gather_shards, shard_batch
from svim_tpu_torch.state import to_host

ALIGNMENT_CAP = 500   # SVIM_genotyping.py:56
WINDOW = 1000         # SVIM_genotyping.py:49
INT_MAX = 2**31 - 1
INT_MIN = -2**31
MAX_WINDOW_ROWS = 8192  # candidates needing a wider table slice fall back
# candidates per gather of the plain version: bounds its (C, slice_len)
# temporaries
MAX_GATHER_CELLS = 1 << 24

LAUNCHES = 0   # calls of genotype_support_batched_cuda that launched
KERNELS_PER_CALL = 1   # device kernels such a call launches


def _windows(lo, width, window_start2, support_sorted, starts2, ends2, ids,
             slice_len: int):
    """The candidates' table windows, as jax.lax.dynamic_slice cuts them
    (the start clamped so that the slice stays in the table): (w_starts2,
    w_ends2, w_ids, qualifying), each (C, slice_len).  A row qualifies when
    it lies in the slice, ends past the window start and is not a support
    read."""
    index = torch.arange(slice_len, dtype=torch.int32, device=lo.device)
    first = lo.clamp(0, max(starts2.shape[0] - slice_len, 0))
    rows = (first[:, None] + index[None, :]).long()
    w_starts2 = starts2[rows]
    w_ends2 = ends2[rows]
    w_ids = ids[rows]
    in_slice = index[None, :] < width[:, None]

    # in-window: alignment end past the window start (starts are < window
    # stop by construction of hi) — SVIM_genotyping.py:49 fetch semantics
    in_window = w_ends2 > window_start2[:, None]

    # support-read exclusion via binary search in the candidate's sorted
    # support-id list (padded with INT_MAX)
    positions = torch.searchsorted(support_sorted, w_ids)
    positions = torch.clamp(positions, max=support_sorted.shape[1] - 1)
    is_support = torch.gather(support_sorted, 1, positions) == w_ids
    return w_starts2, w_ends2, w_ids, in_slice & in_window & ~is_support


def _support_counts(lo, width, window_start2, start2, end2, min_overlap2,
                    type_class, support_sorted, starts2, ends2, ids,
                    slice_len: int):
    w_starts2, w_ends2, w_ids, qualifying = _windows(
        lo, width, window_start2, support_sorted, starts2, ends2, ids,
        slice_len)
    # the 500 cap counts qualifying alignments in coordinate order
    rank = torch.cumsum(qualifying.to(torch.int32), dim=1)
    capped = qualifying & (rank <= ALIGNMENT_CAP)

    # span tests (doubled coordinates; margins 100 -> 200)
    start2 = start2[:, None]
    end2 = end2[:, None]
    min_overlap2 = min_overlap2[:, None]
    spans_del_inv = (((w_starts2 < end2 - min_overlap2) & (w_ends2 > end2 + 200))
                     | ((w_starts2 < start2 - 200)
                        & (w_ends2 > start2 + min_overlap2)))
    spans_ins = (w_starts2 < start2 - 200) & (w_ends2 > end2 + 200)
    supports = torch.where(type_class[:, None] == 0, spans_del_inv,
                           spans_ins) & capped

    # distinct read ids among supporters: sort then count boundaries
    masked_ids = torch.where(supports, w_ids, torch.full_like(w_ids, INT_MAX))
    ordered = torch.sort(masked_ids, dim=1).values
    previous = torch.cat([torch.full_like(ordered[:, :1], INT_MIN),
                          ordered[:, :-1]], dim=1)
    return ((ordered != INT_MAX) & (ordered != previous)).sum(
        dim=1, dtype=torch.int32)


def genotype_support_batched_plain(lo, width, window_start2, start2, end2,
                                   min_overlap2, type_class, support_sorted,
                                   starts2, ends2, ids, slice_len: int):
    """(C,) int32 candidate params + (C, S) sorted support ids + padded
    table columns -> (C,) int32 reference-support counts, in blocks of
    candidates of at most MAX_GATHER_CELLS window cells."""
    chunk = max(1, MAX_GATHER_CELLS // max(slice_len, 1))
    columns = (lo, width, window_start2, start2, end2, min_overlap2,
               type_class, support_sorted)
    if lo.shape[0] <= chunk:
        return _support_counts(*columns, starts2, ends2, ids, slice_len)
    return torch.cat([
        _support_counts(*(column[first:first + chunk] for column in columns),
                        starts2, ends2, ids, slice_len)
        for first in range(0, lo.shape[0], chunk)])


_library = None


def _kernel_library():
    global _library
    if _library is None:
        from svim_tpu_torch.ops._build import load

        library = load("genotype_support")
        pointer = ctypes.c_void_p
        library.genotype_support.argtypes = (
            [pointer] * 8 + [ctypes.c_int, ctypes.c_int] + [pointer] * 3
            + [ctypes.c_int, ctypes.c_int, pointer, pointer])
        library.genotype_support.restype = ctypes.c_int
        _library = library
    return _library


def genotype_support_batched_cuda(lo, width, window_start2, start2, end2,
                                  min_overlap2, type_class, support_sorted,
                                  starts2, ends2, ids, slice_len: int):
    """genotype_support_batched on the card through
    csrc/genotype_support.cu.

    The seven candidate columns: (C,) int32 contiguous CUDA tensors;
    support_sorted: (C, S) int32 with S >= 1, each row sorted; starts2,
    ends2, ids: (T,) int32 with T >= slice_len; all on one device.  Returns
    the (C,) int32 counts of genotype_support_batched_plain on that device.
    One launch on the current stream (KERNELS_PER_CALL), no host
    synchronisation; none when C = 0."""
    global LAUNCHES
    device = lo.device
    if device.type != "cuda":
        raise ValueError("genotype_support_batched_cuda needs CUDA tensors")
    if support_sorted.dim() != 2 or starts2.dim() != 1:
        raise ValueError("support_sorted must be (C, S) and the table "
                         "columns (T,), got {0} and {1}".format(
                             tuple(support_sorted.shape),
                             tuple(starts2.shape)))
    candidates, s = support_sorted.shape
    table_rows = starts2.shape[0]
    columns = (("lo", lo), ("width", width), ("window_start2", window_start2),
               ("start2", start2), ("end2", end2),
               ("min_overlap2", min_overlap2), ("type_class", type_class))
    check_tensors(
        [(name, tensor, torch.int32, (candidates,))
         for name, tensor in columns]
        + [("support_sorted", support_sorted, torch.int32, (candidates, s))]
        + [(name, tensor, torch.int32, (table_rows,)) for name, tensor in (
            ("starts2", starts2), ("ends2", ends2), ("ids", ids))], device)
    if s < 1 or not 1 <= slice_len <= table_rows or table_rows >= 2**31:
        raise ValueError("the genotype kernel needs S >= 1 and 1 <= "
                         "slice_len <= T < 2^31 table rows, got S={0}, "
                         "slice_len={1}, T={2}".format(s, slice_len,
                                                       table_rows))
    library = _kernel_library()
    counts = torch.empty((candidates,), dtype=torch.int32, device=device)
    if candidates == 0:
        return counts
    with torch.cuda.device(device):
        check_launch("genotype_support", library.genotype_support(
            *(tensor.data_ptr() for _, tensor in columns),
            support_sorted.data_ptr(), candidates, s, starts2.data_ptr(),
            ends2.data_ptr(), ids.data_ptr(), table_rows, slice_len,
            counts.data_ptr(), torch.cuda.current_stream(device).cuda_stream))
    LAUNCHES += 1
    return counts


def genotype_support_batched(lo, width, window_start2, start2, end2,
                             min_overlap2, type_class, support_sorted,
                             starts2, ends2, ids, slice_len: int):
    """Dispatcher: CPU tensors -> genotype_support_batched_plain, CUDA
    tensors -> genotype_support_batched_cuda (same contract: (C,) int32
    candidate params + (C, S) sorted support ids + padded table columns ->
    (C,) int32 reference-support counts)."""
    return route(lo, "genotype_support", genotype_support_batched_plain,
                 genotype_support_batched_cuda)(
        lo, width, window_start2, start2, end2, min_overlap2, type_class,
        support_sorted, starts2, ends2, ids, slice_len)


def _round_up_pow2(value: int, floor: int) -> int:
    result = floor
    while result < value:
        result *= 2
    return result


class DeviceGenotypeTable:
    """Doubled-coordinate concatenated per-contig table, padded for
    clamp-free window gathers, plus per-contig row segments."""

    __slots__ = ("starts2", "ends2", "ids", "segments")

    def __init__(self, per_tid, pad_rows: int):
        starts_parts = []
        ends_parts = []
        id_parts = []
        self.segments = {}
        base = 0
        for tid, (starts, ends, name_ids, max_span) in sorted(per_tid.items()):
            n = len(starts)
            starts_parts.append(starts.astype(np.int64) * 2)
            ends_parts.append(ends.astype(np.int64) * 2)
            id_parts.append(name_ids)
            self.segments[tid] = (base, n, starts, max_span)
            base += n
        starts_parts.append(np.full(pad_rows, INT_MAX, dtype=np.int64))
        ends_parts.append(np.full(pad_rows, INT_MIN, dtype=np.int64))
        id_parts.append(np.full(pad_rows, INT_MAX, dtype=np.int64))
        self.starts2 = np.concatenate(starts_parts).astype(np.int32)
        self.ends2 = np.concatenate(ends_parts).astype(np.int32)
        self.ids = np.concatenate(id_parts).astype(np.int32)


def genotype_ref_support_device(jobs, per_tid, device, num_shards: int = 1):
    """Reference-support counts for genotyping jobs on `device` (the
    candidate axis cut over `num_shards` shards when it divides).

    Each job is (tid, start, end, type_class, support_id_list,
    contig_length) with type_class 0 for DEL/INV and 1 for INS/DUP_INT
    (end == start there).  Returns a list of int counts, or None entries for
    jobs the kernel cannot serve (window slice too wide, contigs past 2^30
    bp whose doubled positions would overflow int32) — the caller runs those
    through the host join."""
    if not jobs:
        return []
    # positions are doubled into int32: contigs past 2^30 bp would overflow
    if any(length is not None and length > 2**30
           for *_head, length in jobs):
        return [None] * len(jobs)

    results = [None] * len(jobs)
    pending = []
    for job_index, (tid, start, end, type_class, support_ids,
                    contig_length) in enumerate(jobs):
        entry = per_tid.get(tid) if tid is not None and tid >= 0 else None
        if entry is None:
            results[job_index] = 0
            continue
        pending.append((job_index, tid, start, end, type_class, support_ids,
                        contig_length))
    if not pending:
        return results

    bases = {}
    base = 0
    for tid, (seg_starts, _ends, _ids, _max_span) in sorted(per_tid.items()):
        bases[tid] = base
        base += len(seg_starts)

    slice_len = 64
    rows = []
    for (job_index, tid, start, end, type_class, support_ids,
         contig_length) in pending:
        seg_starts, _seg_ends, _seg_ids, max_span = per_tid[tid]
        window_start = max(0, start - WINDOW)
        window_stop = min(contig_length, end + WINDOW)
        hi = int(np.searchsorted(seg_starts, window_stop, side="left"))
        lo = int(np.searchsorted(seg_starts, window_start - max_span,
                                 side="left"))
        width = hi - lo
        if width > MAX_WINDOW_ROWS:
            continue  # stays None -> host fallback
        slice_len = max(slice_len, width)
        rows.append((job_index, bases[tid] + lo, width, window_start, start,
                     end, type_class, support_ids))
    if not rows:
        return results

    slice_len = _round_up_pow2(slice_len, 64)
    # pad the table by slice_len so lo + slice_len never runs off the end
    table = DeviceGenotypeTable(per_tid, pad_rows=slice_len)

    c = len(rows)
    s_pad = _round_up_pow2(max(1, max(len(r[7]) for r in rows)), 8)
    columns = np.zeros((c, 7), dtype=np.int32)
    support_sorted = np.full((c, s_pad), INT_MAX, dtype=np.int32)
    for row_index, (_job, row_lo, row_width, row_ws, row_start, row_end,
                    row_class, support_ids) in enumerate(rows):
        # minimum_overlap = min((end-start)/2, 2000), doubled => integer
        columns[row_index] = (row_lo, row_width, 2 * row_ws, 2 * row_start,
                              2 * row_end, min(row_end - row_start, 4000),
                              row_class)
        if support_ids:
            support_sorted[row_index, :len(support_ids)] = np.sort(
                np.asarray(support_ids, dtype=np.int32))

    # --num_shards cuts the candidate axis over the shard devices; each
    # device holds its own copy of the table and takes one call
    tables = {}
    shard_counts = []
    for shard_columns, shard_support in shard_batch(
            num_shards, device, columns, support_sorted):
        target = shard_columns.device
        if target not in tables:
            tables[target] = tuple(
                torch.from_numpy(column).to(target)
                for column in (table.starts2, table.ends2, table.ids))
        shard_counts.append((genotype_support_batched(
            *shard_columns.T.contiguous(), shard_support, *tables[target],
            slice_len),))
    counts = to_host(gather_shards(shard_counts, device)[0])
    for row_index, row in enumerate(rows):
        results[row[0]] = int(counts[row_index])
    return results
