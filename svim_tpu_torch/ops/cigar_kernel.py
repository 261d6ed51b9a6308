"""Vectorized CIGAR indel scan + per-alignment geometry (PyTorch).

Counterpart of svim_tpu/ops/cigar_kernel.py::collect_scan on int32 BAM
words (length << 4 | op, padded with 0), including the synthetic op codes
of host-side CIGAR compaction: 9 = reference advance, 10 = read advance
(see the JAX module's docstring).  One call returns the geometry columns
and the indel events >= min_sv_size, compacted in (row, op) order with
their true count — torch.nonzero sizes its output, so there is no event
bound and no retry.
"""

from __future__ import annotations

import torch


def _decode(cigar_words):
    """BAM word encoding -> (ops, lens), int32."""
    cigar_words = cigar_words.to(torch.int32)
    return cigar_words & 0xF, cigar_words >> 4


def _scan(ops, lens, min_sv_size: int):
    is_match = (ops == 0) | (ops == 7) | (ops == 8)
    zero = torch.zeros_like(lens)
    ref_advance = torch.where(is_match | (ops == 2) | (ops == 9), lens, zero)
    read_advance = torch.where(is_match | (ops == 1) | (ops == 4)
                               | (ops == 10), lens, zero)
    pos_ref = torch.cumsum(ref_advance, dim=1, dtype=torch.int32) - ref_advance
    pos_read = (torch.cumsum(read_advance, dim=1, dtype=torch.int32)
                - read_advance)
    large = lens >= min_sv_size
    del_mask = (ops == 2) & large
    ins_mask = (ops == 1) & large
    return del_mask, ins_mask, pos_ref, pos_read


def _geometry(ops, lens, ref_start):
    """Per-alignment geometry, pysam semantics: reference_end (M/D/N/=/X),
    inferred read length incl. hard clips, query-alignment bounds (soft clips
    only), and hard-clip presence."""
    zero = torch.zeros_like(lens)
    is_match = (ops == 0) | (ops == 7) | (ops == 8)
    ref_consuming = is_match | (ops == 2) | (ops == 3) | (ops == 9)
    query_consuming = is_match | (ops == 1) | (ops == 4) | (ops == 10)
    soft = (ops == 4) & (lens > 0)
    hard = (ops == 5) & (lens > 0)

    def row_sum(mask):
        return torch.where(mask, lens, zero).sum(dim=1, dtype=torch.int32)

    ref_end = ref_start + row_sum(ref_consuming)
    query_len = row_sum(query_consuming)
    read_len = query_len + row_sum(hard)

    clip_like = soft | (ops == 5) | (lens == 0)
    nonclip = (~clip_like).to(torch.int32)
    leading = torch.cumsum(nonclip, dim=1) == 0
    trailing = torch.flip(torch.cumsum(torch.flip(nonclip, dims=(1,)), dim=1),
                          dims=(1,)) == 0
    trailing_only = trailing & ~leading
    qa_start = row_sum(leading & soft)
    qa_end = query_len - row_sum(trailing_only & soft)
    has_hard_clip = hard.any(dim=1)
    return ref_end, read_len, qa_start, qa_end, has_hard_clip


def _compact_events(ops, lens, min_sv_size: int):
    """Events in (row, op) order: (rows, pos_ref, pos_read, lengths,
    is_insertion, count)."""
    del_mask, ins_mask, pos_ref, pos_read = _scan(ops, lens, min_sv_size)
    k = ops.shape[1]
    flat_idx = torch.nonzero((del_mask | ins_mask).reshape(-1)).reshape(-1)
    rows = torch.div(flat_idx, k, rounding_mode="floor")
    cols = flat_idx % k
    count = torch.tensor(flat_idx.numel(), dtype=torch.int32)
    return (rows.to(torch.int32), pos_ref[rows, cols], pos_read[rows, cols],
            lens[rows, cols], ins_mask[rows, cols], count)


def collect_scan(cigar_words, ref_start, min_sv_size: int):
    """Fused COLLECT pass: (N, K) int32 words + (N,) int32 alignment starts
    -> (ref_end, read_len, qa_start, qa_end, has_hard_clip, rows, pos_ref,
    pos_read, lengths, is_insertion, count), all on the input's device
    except `count` (a host int32 scalar tensor: the compaction knows it)."""
    ops, lens = _decode(cigar_words)
    geometry = _geometry(ops, lens, ref_start.to(torch.int32))
    return geometry + _compact_events(ops, lens, min_sv_size)
