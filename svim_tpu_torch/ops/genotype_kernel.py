"""Batched genotyping: reference-support counts as an interval join
(PyTorch).

Counterpart of svim_tpu/ops/genotype_kernel.py: for every candidate, a
fixed-size window of the coordinate-sorted, doubled-coordinate alignment
table is gathered and the reference's qualification chain applied
(in-window test, support-read exclusion by binary search, the
500-alignment cap in coordinate order, the per-type span test), then
DISTINCT supporting read ids are counted after a sort.  All arithmetic is
int32 on pre-doubled coordinates, so counts equal the host join's exactly
(SVIM_genotyping.py:34-94).
"""

from __future__ import annotations

import numpy as np
import torch

ALIGNMENT_CAP = 500   # SVIM_genotyping.py:56
WINDOW = 1000         # SVIM_genotyping.py:49
INT_MAX = 2**31 - 1
INT_MIN = -2**31
MAX_WINDOW_ROWS = 8192  # candidates needing a wider table slice fall back
# candidates per gather: bounds the (C, slice_len) temporaries
MAX_GATHER_CELLS = 1 << 24


def genotype_support_batched(lo, width, window_start2, start2, end2,
                             min_overlap2, type_class, support_sorted,
                             starts2, ends2, ids, slice_len: int):
    """(C,) int32 candidate params + (C, S) sorted support ids + padded
    table columns -> (C,) int32 reference-support counts."""
    index = torch.arange(slice_len, dtype=torch.int32, device=lo.device)
    rows = (lo[:, None] + index[None, :]).long()
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

    qualifying = in_slice & in_window & ~is_support
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


def genotype_ref_support_device(jobs, per_tid, device):
    """Reference-support counts for genotyping jobs on `device`.

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
    columns = np.zeros((7, c), dtype=np.int32)
    support_sorted = np.full((c, s_pad), INT_MAX, dtype=np.int32)
    for row_index, (_job, row_lo, row_width, row_ws, row_start, row_end,
                    row_class, support_ids) in enumerate(rows):
        # minimum_overlap = min((end-start)/2, 2000), doubled => integer
        columns[:, row_index] = (row_lo, row_width, 2 * row_ws, 2 * row_start,
                                 2 * row_end, min(row_end - row_start, 4000),
                                 row_class)
        if support_ids:
            support_sorted[row_index, :len(support_ids)] = np.sort(
                np.asarray(support_ids, dtype=np.int32))

    columns = torch.from_numpy(columns).to(device)
    support_sorted = torch.from_numpy(support_sorted).to(device)
    starts2 = torch.from_numpy(table.starts2).to(device)
    ends2 = torch.from_numpy(table.ends2).to(device)
    ids = torch.from_numpy(table.ids).to(device)
    chunk = max(1, MAX_GATHER_CELLS // slice_len)
    counts = torch.cat([
        genotype_support_batched(*columns[:, first:first + chunk],
                                 support_sorted[first:first + chunk],
                                 starts2, ends2, ids, slice_len)
        for first in range(0, c, chunk)]).cpu().numpy()
    for row_index, row in enumerate(rows):
        results[row[0]] = int(counts[row_index])
    return results
