"""Vectorized CIGAR indel scan + per-alignment geometry (PyTorch).

Counterpart of svim_tpu/ops/cigar_kernel.py::collect_scan on int32 BAM
words (length << 4 | op, padded with 0), including the synthetic op codes
of host-side CIGAR compaction: 9 = reference advance, 10 = read advance
(see the JAX module's docstring).  One call returns the geometry columns
and the indel events >= min_sv_size, compacted in (row, op) order into a
table of `max_events` entries, with their true count on the device: the
caller re-runs with a larger bound when the count says the table
overflowed, as svim_tpu's does.

Three layers, on the pattern of ops/linkage_kernel.py:
  * `collect_scan_plain` - the plain PyTorch version (four cumsums, masked
    sums, a `torch.nonzero`, which waits for the device); it equals the
    JAX program on the CPU.
  * `collect_scan_cuda` - the wrapper of the hand-written CUDA kernel
    (csrc/collect_scan.cu: one cooperative launch of a persistent grid,
    the rows' geometry and event counts, one grid barrier, then the events
    in (row, op) order), equal to the plain version bit for bit, enqueued
    without a host synchronisation; counted in `LAUNCHES`.
  * `collect_scan` - the dispatcher: CPU tensors take the plain version,
    CUDA tensors the kernel.  Nothing falls back.
"""

from __future__ import annotations

import ctypes

import torch

from svim_tpu_torch.ops._build import check_launch, check_tensors

LAUNCHES = 0   # calls of collect_scan_cuda that launched the kernel
KERNELS_PER_CALL = 1   # device kernels such a call launches


def round_up_pow2(value: int) -> int:
    """The event-table size for `value` events: a power of two, at least
    1024 (svim_tpu's _round_up_pow2)."""
    result = 1024
    while result < value:
        result *= 2
    return result


def event_bound(rows: int) -> int:
    """The first event bound of a batch of `rows` reads, as svim_tpu's
    dispatch sizes it."""
    return round_up_pow2(max(1024, 4 * rows))


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


def _event_table(max_events: int, device):
    """(rows, pos_ref, pos_read, lengths, is_insertion) as the fill of an
    empty table: rows -1, the other columns 0."""
    def column(fill, dtype):
        return torch.full((max_events,), fill, dtype=dtype, device=device)

    return (column(-1, torch.int32), column(0, torch.int32),
            column(0, torch.int32), column(0, torch.int32),
            column(False, torch.bool))


def _compact_events(ops, lens, min_sv_size: int, max_events: int):
    """The first max_events events in (row, op) order and the true count:
    (rows, pos_ref, pos_read, lengths, is_insertion, count); entries past
    the count are the fill of _event_table."""
    del_mask, ins_mask, pos_ref, pos_read = _scan(ops, lens, min_sv_size)
    k = ops.shape[1]
    flat_idx = torch.nonzero((del_mask | ins_mask).reshape(-1)).reshape(-1)
    count = torch.tensor(flat_idx.numel(), dtype=torch.int32,
                         device=ops.device)
    flat_idx = flat_idx[:max_events]
    rows = torch.div(flat_idx, k, rounding_mode="floor")
    cols = flat_idx % k
    table = _event_table(max_events, ops.device)
    kept = flat_idx.numel()
    for column, values in zip(table, (rows, pos_ref[rows, cols],
                                      pos_read[rows, cols], lens[rows, cols],
                                      ins_mask[rows, cols])):
        column[:kept] = values
    return table + (count,)


def collect_scan_plain(cigar_words, ref_start, min_sv_size: int,
                       max_events: int):
    """Fused COLLECT pass: (N, K) int32 words + (N,) int32 alignment starts
    -> (ref_end, read_len, qa_start, qa_end, has_hard_clip, rows, pos_ref,
    pos_read, lengths, is_insertion, count).  The geometry columns are (N,);
    the event columns (max_events,), holding the first min(count,
    max_events) events in (row, op) order, rows -1 and the other columns 0
    after them; `count` is the true event count, a 0-d int32 tensor on the
    input's device."""
    ops, lens = _decode(cigar_words)
    geometry = _geometry(ops, lens, ref_start.to(torch.int32))
    return geometry + _compact_events(ops, lens, min_sv_size, max_events)


_library = None


def _kernel_library():
    global _library
    if _library is None:
        from svim_tpu_torch.ops._build import load

        library = load("collect_scan")
        pointer = ctypes.c_void_p
        library.collect_scan.argtypes = (
            [pointer, pointer, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int] + [pointer] * 12)
        library.collect_scan.restype = ctypes.c_int
        library.collect_scan_scratch_words.argtypes = [ctypes.c_int]
        library.collect_scan_scratch_words.restype = ctypes.c_int
        _library = library
    return _library


def collect_scan_cuda(cigar_words, ref_start, min_sv_size: int,
                      max_events: int):
    """collect_scan on the card through csrc/collect_scan.cu.

    cigar_words: (N, K) int32 contiguous CUDA tensor; ref_start: (N,) int32
    on the same device.  Returns the outputs of collect_scan_plain, bit for
    bit, on that device.  One launch on the current stream
    (KERNELS_PER_CALL), no host synchronisation; none when N = 0."""
    global LAUNCHES
    device = cigar_words.device
    if device.type != "cuda":
        raise ValueError("collect_scan_cuda needs CUDA tensors")
    if cigar_words.dim() != 2:
        raise ValueError("cigar_words must be (N, K), got {0}".format(
            tuple(cigar_words.shape)))
    n, k = cigar_words.shape
    check_tensors((("cigar_words", cigar_words, torch.int32, (n, k)),
                   ("ref_start", ref_start, torch.int32, (n,))), device)
    if not 0 <= max_events < 2**31 or not -2**31 <= min_sv_size < 2**31:
        raise ValueError("max_events {0} or min_sv_size {1} outside int32"
                         .format(max_events, min_sv_size))
    library = _kernel_library()
    geometry = tuple(torch.empty((n,), dtype=torch.int32, device=device)
                     for _ in range(4)) + (
        torch.empty((n,), dtype=torch.bool, device=device),)
    if n == 0:
        return geometry + _event_table(max_events, device) + (
            torch.zeros((), dtype=torch.int32, device=device),)
    events = tuple(torch.empty((max_events,), dtype=torch.int32,
                               device=device) for _ in range(4)) + (
        torch.empty((max_events,), dtype=torch.bool, device=device),)
    count = torch.empty((), dtype=torch.int32, device=device)
    # each row's event count, then each CTA's total (written before read)
    scratch = torch.empty((library.collect_scan_scratch_words(n),),
                          dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        check_launch("collect_scan", library.collect_scan(
            cigar_words.data_ptr(), ref_start.data_ptr(), n, k,
            int(min_sv_size), int(max_events),
            *(tensor.data_ptr() for tensor in geometry + events),
            count.data_ptr(), scratch.data_ptr(),
            torch.cuda.current_stream(device).cuda_stream))
    LAUNCHES += 1
    return geometry + events + (count,)


def collect_scan(cigar_words, ref_start, min_sv_size: int, max_events: int):
    """Dispatcher: CPU tensors -> collect_scan_plain, CUDA tensors ->
    collect_scan_cuda (same contract).  Words and starts of another integer
    type are cast to int32 first, on either device."""
    cigar_words = cigar_words.to(torch.int32)
    ref_start = ref_start.to(torch.int32)
    if cigar_words.device.type == "cpu":
        return collect_scan_plain(cigar_words, ref_start, min_sv_size,
                                  max_events)
    if cigar_words.device.type == "cuda":
        return collect_scan_cuda(cigar_words, ref_start, min_sv_size,
                                 max_events)
    raise ValueError("no collect_scan kernel for device {0}".format(
        cigar_words.device))
