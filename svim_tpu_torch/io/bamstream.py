"""Streaming BAM scanner: bounded-memory COLLECT for inputs over 96 MiB.

Counterpart of svim_tpu/io/bamstream.py (stream_bam, _stream_bam_fused,
_stream_bam_carve, _pack_columns, _pack_rows, collect_streaming).  The
compressed file is mmapped, BGZF blocks inflate window by window (native
parallel inflate), records are carved across window boundaries, and each
window's rows become packed batches.  The BGZF and record parsing is
svim_tpu's, copied; the batch builders differ: svim_tpu's ship their
CIGARs to JAX.

Batches are built on the prefetch thread without touching the device: the
host->device copy happens on the consumer thread, in
collect.packed.dispatch_collect_scan, so it is ordered on the same stream
as the kernels that read it.
"""

from __future__ import annotations

import gzip
import mmap
import struct
from typing import Iterator, List, Optional, Tuple

import numpy as np

from svim_tpu_torch.io.bamscan import LazySequences, LazyStrings, build_packed
from svim_tpu_torch.io.packing import bucket_size
from svim_tpu_torch.io.sam import AlignmentHeader

# target decompressed window size; read at call time, so tests
# can shrink it
WINDOW_UNCOMPRESSED = 128 * 1024 * 1024

BATCHES = 0   # batches consumed by collect_streaming (chip_smoke reads it)
WINDOWS = 0   # windows of inflated stream read by the streaming scans

FUNMAP = 0x4
FSECONDARY = 0x100
ROW_BUCKETS = (1024, 2048, 4096, 8192, 16384)


def _row_bucket(n: int) -> int:
    for bucket in ROW_BUCKETS:
        if n <= bucket:
            return bucket
    return n


def scan_bgzf_blocks(data) -> Iterator[Tuple[int, int, int]]:
    """Yield (offset, compressed_size, uncompressed_size) per BGZF member."""
    offset = 0
    size = len(data)
    while offset + 18 <= size:
        if data[offset] != 0x1F or data[offset + 1] != 0x8B:
            raise ValueError("not a BGZF stream at offset {0}".format(offset))
        (xlen,) = struct.unpack_from("<H", data, offset + 10)
        extra = offset + 12
        extra_end = extra + xlen
        bsize = None
        while extra + 4 <= extra_end:
            s1, s2, slen = data[extra], data[extra + 1], struct.unpack_from(
                "<H", data, extra + 2)[0]
            if s1 == 0x42 and s2 == 0x43 and slen == 2:
                bsize = struct.unpack_from("<H", data, extra + 4)[0] + 1
            extra += 4 + slen
        if bsize is None:
            raise ValueError("BGZF member without BC subfield")
        if offset + bsize > size:
            raise ValueError(
                "truncated or corrupt BGZF stream: member at offset {0} "
                "claims {1} bytes but only {2} remain".format(
                    offset, bsize, size - offset))
        (isize,) = struct.unpack_from("<I", data, offset + bsize - 4)
        yield offset, bsize, isize
        offset += bsize


def _decompress_window(data, blocks, prefix=b"") -> bytes:
    """Inflate a BGZF block range into a buffer that starts with `prefix`
    (the carried partial record from the previous window) — one small
    prefix copy instead of concatenating carry + the whole inflated
    window.  The native inflate returns None for a window it cannot take
    (a member it does not parse, a corrupt payload); only then does gzip
    inflate it, and raise on corrupt data.  A native library that fails to
    build or load raises here."""
    from svim_tpu_torch import native

    start = blocks[0][0]
    end = blocks[-1][0] + blocks[-1][1]
    window = bytes(data[start:end])
    out = native.bgzf_decompress_with_prefix(window, prefix)
    if out is not None:
        return out
    return prefix + gzip.decompress(window)


class StreamedBatch:
    """One packed batch plus its SA tags (same contract the fused COLLECT
    pass consumes)."""

    __slots__ = ("packed", "sa_tags", "row_offset", "n_real")

    def __init__(self, packed, sa_tags, row_offset, n_real):
        self.packed = packed
        self.sa_tags = sa_tags
        self.row_offset = row_offset  # global row index of this batch's row 0
        self.n_real = n_real          # rows beyond this are padding


class GenotypeTable:
    """Whole-file per-record columns for genotyping region queries."""

    __slots__ = ("ref_id", "ref_start", "ref_end", "mapq", "names")

    def __init__(self, ref_id, ref_start, ref_end, mapq, names):
        self.ref_id = ref_id
        self.ref_start = ref_start
        self.ref_end = ref_end
        self.mapq = mapq
        self.names = names


def peek_bam_header(path: str):
    """Decode just enough leading BGZF blocks to parse the header (cheap
    sort-order dispatch without touching the record stream)."""
    with open(path, "rb") as handle:
        data = handle.read(8 * 1024 * 1024)
    buffer = b""
    for offset, bsize, _isize in scan_bgzf_blocks(data):
        if offset + bsize > len(data):
            break
        buffer += gzip.decompress(bytes(data[offset:offset + bsize]))
        end = _try_header_end(buffer)
        if end is not None:
            header, _ = _parse_header(buffer)
            return header
    raise ValueError("could not parse BAM header from the leading blocks")


_TAG_SIZES = {ord("c"): 1, ord("C"): 1, ord("s"): 2, ord("S"): 2,
              ord("i"): 4, ord("I"): 4, ord("f"): 4, ord("A"): 1}


def _find_sa_py(buffer, p, end) -> Optional[str]:
    if buffer.find(b"SAZ", p, end) < 0:
        return None
    while p + 3 <= end:
        value_type = buffer[p + 2]
        if buffer[p] == 0x53 and buffer[p + 1] == 0x41 and value_type == 0x5A:
            nul = buffer.index(b"\x00", p + 3, end)
            return buffer[p + 3:nul].decode()
        p += 3
        if value_type in _TAG_SIZES:
            p += _TAG_SIZES[value_type]
        elif value_type in (0x5A, 0x48):
            p = buffer.index(b"\x00", p, end) + 1
        elif value_type == 0x42:
            sub = buffer[p]
            (count,) = struct.unpack_from("<i", buffer, p + 1)
            p += 5 + count * _TAG_SIZES[sub]
        else:
            return None
    return None


def _try_header_end(buffer) -> Optional[int]:
    if len(buffer) < 12 or buffer[:4] != b"BAM\x01":
        if buffer[:4] != b"BAM\x01":
            raise ValueError("not a BAM stream")
        return None
    (l_text,) = struct.unpack_from("<i", buffer, 4)
    offset = 8 + l_text
    if offset + 4 > len(buffer):
        return None
    (n_ref,) = struct.unpack_from("<i", buffer, offset)
    offset += 4
    for _ in range(n_ref):
        if offset + 4 > len(buffer):
            return None
        (l_name,) = struct.unpack_from("<i", buffer, offset)
        offset += 4 + l_name + 4
    if offset > len(buffer):
        return None
    return offset


def _parse_header(buffer):
    (l_text,) = struct.unpack_from("<i", buffer, 4)
    text = buffer[8:8 + l_text].split(b"\x00", 1)[0].decode()
    offset = 8 + l_text
    (n_ref,) = struct.unpack_from("<i", buffer, offset)
    offset += 4
    references, lengths = [], []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", buffer, offset)
        offset += 4
        references.append(buffer[offset:offset + l_name - 1].decode())
        offset += l_name
        lengths.append(struct.unpack_from("<i", buffer, offset)[0])
        offset += 4
    header = AlignmentHeader.from_text(text)
    if not header.references:
        header = AlignmentHeader(header.hd, references, lengths, text)
    return header, offset


def _prefetch(iterator, depth: int = 2):
    """Run `iterator` on a background thread with a bounded queue: the BGZF
    decompress + record carve of batch N+1/N+2 overlaps the device pass and
    host materialization of batch N (window buffers are immutable bytes, so
    already-yielded batches stay valid).  Exceptions propagate."""
    import queue
    import threading

    sentinel = object()
    q = queue.Queue(maxsize=depth)

    def worker():
        try:
            for item in iterator:
                q.put(item)
            q.put(sentinel)
        except BaseException as error:  # noqa: BLE001 - re-raised on the consumer
            q.put(error)

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    while True:
        item = q.get()
        if item is sentinel:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def stream_bam(path: str, min_mapq: int, batch_reads: int = 4096,
               min_sv_size: int = 0):
    """Yield the header, then StreamedBatch objects (host columns only).

    With the native library each window runs the fused inflate+count pass;
    without it the carve path runs, and with no carver a pure-Python walk."""
    from svim_tpu_torch import native

    # batches copy what they keep out of the map (window bytes, inflated
    # buffers), so it closes when the stream ends
    with open(path, "rb") as handle, mmap.mmap(
            handle.fileno(), 0, access=mmap.ACCESS_READ) as data:
        if native.get_library() is not None:
            yield from _stream_bam_fused(data, min_mapq, batch_reads,
                                         min_sv_size)
        else:
            yield from _stream_bam_carve(data, min_mapq, batch_reads,
                                         min_sv_size)


def _pad_column(values, n_pad, dtype, fill=0):
    out = np.full(n_pad, fill, dtype=dtype)
    out[:len(values)] = values
    return out


def _batch_from_columns(buffer, cigar_words, ref_id, pos, mapq, flag,
                        name_off, name_len, seq_off, seq_len, sa_off, sa_len,
                        row_offset) -> StreamedBatch:
    """StreamedBatch from row slices of a scan's columns (the fused window
    scan, the carve path and the one-shot scan session): rows padded to
    their bucket, names/sequences/SA tags decoded lazily from `buffer`."""
    n_real = len(ref_id)
    n_pad = _row_bucket(n_real)
    padded_words = np.zeros((n_pad, cigar_words.shape[1]), dtype=np.int32)
    padded_words[:n_real] = cigar_words
    packed = build_packed(
        _pad_column(ref_id, n_pad, np.int32, -1),
        _pad_column(pos, n_pad, np.int32),
        _pad_column(mapq, n_pad, np.int32), _pad_column(flag, n_pad, np.int32),
        padded_words,
        LazyStrings(buffer, _pad_column(name_off, n_pad, np.int64, -1),
                    _pad_column(name_len, n_pad, np.int64)),
        LazySequences(buffer, _pad_column(seq_off, n_pad, np.int64),
                      _pad_column(seq_len, n_pad, np.int64)))
    sa_tags = LazyStrings(buffer, _pad_column(sa_off, n_pad, np.int64, -1),
                          _pad_column(sa_len, n_pad, np.int64),
                          none_when_negative=True)
    return StreamedBatch(packed, sa_tags, row_offset, n_real)


def _stream_bam_fused(data, min_mapq: int, batch_reads: int,
                      min_sv_size: int):
    """Window-fused streaming scan: per window one native pass inflates the
    blocks behind the carried partial record and counts/compacts its
    records; rows then fill by memcpy from the scan cache."""
    from svim_tpu_torch import native

    block_iter = scan_bgzf_blocks(data)
    pending_blocks = []
    pending_out = 0

    def next_raw():
        global WINDOWS
        nonlocal pending_blocks, pending_out
        for block in block_iter:
            pending_blocks.append(block)
            pending_out += block[2]
            if pending_out >= WINDOW_UNCOMPRESSED:
                break
        if not pending_blocks:
            return None
        WINDOWS += 1
        raw = bytes(data[pending_blocks[0][0]:
                         pending_blocks[-1][0] + pending_blocks[-1][1]])
        pending_blocks = []
        pending_out = 0
        return raw

    carry = b""
    walk_start = -1   # window 0 parses the header behind the frontier
    header = None
    row_offset = 0
    while True:
        raw = next_raw()
        if raw is None:
            if carry:
                raise ValueError("truncated BAM record at end of stream")
            if header is None:
                raise ValueError("empty BAM stream")
            return
        scanned = native.bam_scan_fused_window(raw, carry, walk_start,
                                               min_mapq, min_sv_size)
        if scanned is None:
            if header is None:
                # e.g. a header spanning several windows: the carve path
                # takes the whole stream
                yield from _stream_bam_carve(data, min_mapq, batch_reads,
                                             min_sv_size)
                return
            raise ValueError("truncated or corrupt BGZF BAM window")
        # buffer is a pooled mmap: bytes at >= out_size are stale, so always
        # slice by out_size, never len(buffer)
        buffer, out_size, n, max_ops, body_offset, consumed = scanned
        if header is None:
            if not out_size:
                raise ValueError("empty BAM stream")
            header, _parsed_offset = _parse_header(buffer)
            yield header
        if n:
            result = native.bamscan_native(
                buffer, min_mapq, bucket_size, min_sv_size,
                counted=(n, max_ops, body_offset), body_offset=body_offset,
                size=out_size)
            if result is None:
                raise ValueError("window scan failed")
            (_text, _refs, _lens, cigar_words, ref_id, pos, mapq, flag,
             name_off, name_len, seq_off, seq_len, sa_off, sa_len) = result
            for start in range(0, n, batch_reads):
                rows = slice(start, min(start + batch_reads, n))
                yield _batch_from_columns(
                    buffer, cigar_words[rows], ref_id[rows], pos[rows],
                    mapq[rows], flag[rows], name_off[rows], name_len[rows],
                    seq_off[rows], seq_len[rows], sa_off[rows], sa_len[rows],
                    row_offset + start)
            row_offset += n
        carry = bytes(buffer[consumed:out_size])
        # drop this frame's reference so the pool can recycle the buffer
        # once the batches that hold it are released
        buffer = None
        walk_start = 0


def _stream_bam_carve(data, min_mapq: int, batch_reads: int,
                      min_sv_size: int):
    """Incremental carve/compact streaming scan (a header spanning windows,
    or no fused window pass)."""
    from svim_tpu_torch import native

    block_iter = scan_bgzf_blocks(data)
    pending_blocks = []
    pending_out = 0

    def next_window(prefix=b"") -> Optional[bytes]:
        global WINDOWS
        nonlocal pending_blocks, pending_out
        for block in block_iter:
            pending_blocks.append(block)
            pending_out += block[2]
            if pending_out >= WINDOW_UNCOMPRESSED:
                break
        if not pending_blocks:
            return None
        WINDOWS += 1
        window = _decompress_window(data, pending_blocks, prefix)
        pending_blocks = []
        pending_out = 0
        return window

    buffer = next_window()
    if buffer is None:
        raise ValueError("empty BAM stream")
    while _try_header_end(buffer) is None:   # the header may span windows
        more = next_window(prefix=bytes(buffer))
        if more is None:
            raise ValueError("truncated BAM header")
        buffer = more
    header, position = _parse_header(buffer)
    yield header

    row_offset = 0
    rows: List[tuple] = []   # pure-Python walk: one tuple per kept record
    max_ops = 1
    pending_columns: List[dict] = []   # carve results for the current batch
    pending_count = 0

    def flush():
        nonlocal rows, max_ops, row_offset
        if not rows:
            return None
        batch = _pack_rows(rows, max_ops, buffer, row_offset, min_sv_size)
        row_offset += len(rows)
        rows = []
        max_ops = 1
        return batch

    def flush_columns():
        nonlocal pending_columns, pending_count, max_ops, row_offset
        if not pending_count:
            return None
        if len(pending_columns) == 1:
            columns = pending_columns[0]
        else:
            columns = {key: np.concatenate([c[key] for c in pending_columns])
                       for key in pending_columns[0]}
        batch = _pack_columns(columns, max_ops, buffer, row_offset,
                              min_sv_size)
        row_offset += pending_count
        pending_columns = []
        pending_count = 0
        max_ops = 1
        return batch

    carver = native.bam_carve_window if native.get_library() else None

    def roll_window():
        """Carry the trailing partial record into a fresh window; False at
        the end of the stream."""
        nonlocal buffer, position
        carry = bytes(buffer[position:])
        nxt = next_window(prefix=carry)
        if nxt is None:
            if carry:
                raise ValueError("truncated BAM record")
            return False
        buffer = nxt
        position = 0
        return True

    while True:
        carved = None
        if carver is not None:
            carved = carver(buffer, position, min_mapq,
                            batch_reads - pending_count)
        if carved is not None:
            columns, consumed, _exhausted = carved
            count = len(columns["ref_id"])
            if count:
                pending_columns.append(columns)
                pending_count += count
                max_ops = max(max_ops, int(columns["n_cigar"].max()))
            position = consumed
            if pending_count >= batch_reads:
                yield flush_columns()
                continue   # budget reset; keep carving this window
            # under budget: the window is exhausted or ends in a partial
            # record — emit what is pending (it references this buffer)
            flushed = flush_columns()
            if flushed is not None:
                yield flushed
            if not roll_window():
                return
            continue

        # pure-Python walk (no native library)
        if position + 4 > len(buffer) or position + 4 + struct.unpack_from(
                "<i", buffer, position)[0] > len(buffer):
            flushed = flush()
            if flushed is not None:
                yield flushed
            if not roll_window():
                return
            continue
        (block_size,) = struct.unpack_from("<i", buffer, position)
        record_offset = position + 4
        (ref_id, pos, l_read_name, mapq, _bin, n_cigar_op, flag, l_seq,
         _nr, _np, _tl) = struct.unpack_from("<iiBBHHHiiii", buffer,
                                             record_offset)
        if (flag & (FUNMAP | FSECONDARY)) == 0 and mapq >= min_mapq:
            p = record_offset + 32
            name = buffer[p:p + l_read_name - 1].decode()
            p += l_read_name
            cigar_offset = p
            p += 4 * n_cigar_op
            seq_offset = p
            p += (l_seq + 1) // 2 + l_seq
            sa = _find_sa_py(buffer, p, record_offset + block_size)
            rows.append((ref_id, pos, mapq, flag, name, cigar_offset,
                         n_cigar_op, seq_offset, l_seq, sa))
            max_ops = max(max_ops, n_cigar_op)
            if len(rows) >= batch_reads:
                yield flush()
        position += 4 + block_size


def _cigar_batch(buffer, cigar_offsets, op_counts, max_ops, min_sv_size):
    """(rows, K) int32 CIGAR words of the given records read from the window
    buffer, compacted when min_sv_size > 0 (native batch compaction, or
    compact_cigar_row per row)."""
    n_real = len(op_counts)
    if min_sv_size > 0 and n_real:
        from svim_tpu_torch import native

        compact = native.cigar_compact_rows(buffer, cigar_offsets, op_counts,
                                            min_sv_size, bucket_size)
        if compact is not None:
            return compact
    from svim_tpu_torch.io.packing import compact_cigar_row

    cigar_words = np.zeros((n_real, bucket_size(max_ops)), dtype=np.int32)
    for row in range(n_real):
        n_cigar = int(op_counts[row])
        if not n_cigar:
            continue
        words = np.frombuffer(buffer, dtype="<i4", count=n_cigar,
                              offset=int(cigar_offsets[row]))
        if min_sv_size > 0:
            compacted_row = compact_cigar_row(words, min_sv_size)
            if compacted_row is not None:
                cigar_words[row, :len(compacted_row)] = compacted_row
                continue
        cigar_words[row, :n_cigar] = words
    return cigar_words


def _pack_columns(columns, max_ops, buffer, row_offset,
                  min_sv_size: int = 0) -> StreamedBatch:
    """StreamedBatch straight from carve column arrays."""
    cigar_words = _cigar_batch(buffer, columns["cigar_off"],
                               columns["n_cigar"], max_ops, min_sv_size)
    return _batch_from_columns(
        buffer, cigar_words, *(columns[key] for key in (
            "ref_id", "pos", "mapq", "flag", "name_off", "name_len",
            "seq_off", "seq_len", "sa_off", "sa_len")), row_offset)


def _pack_rows(rows, max_ops, buffer, row_offset,
               min_sv_size: int = 0) -> StreamedBatch:
    """StreamedBatch from the pure-Python walk's record tuples."""
    n_real = len(rows)
    n_pad = _row_bucket(n_real)
    (ref_id, pos, mapq, flag, names, cigar_offsets, op_counts, seq_off,
     seq_len, sa) = zip(*rows)
    words = _cigar_batch(buffer, list(cigar_offsets), list(op_counts),
                         max_ops, min_sv_size)
    cigar_words = np.zeros((n_pad, words.shape[1]), dtype=np.int32)
    cigar_words[:n_real] = words
    padding = [None] * (n_pad - n_real)
    packed = build_packed(
        _pad_column(ref_id, n_pad, np.int32, -1),
        _pad_column(pos, n_pad, np.int32), _pad_column(mapq, n_pad, np.int32),
        _pad_column(flag, n_pad, np.int32), cigar_words,
        list(names) + padding,
        LazySequences(buffer, _pad_column(seq_off, n_pad, np.int64),
                      _pad_column(seq_len, n_pad, np.int64)))
    return StreamedBatch(packed, list(sa) + padding, row_offset, n_real)


def collect_streaming(path: str, options, device):
    """Streaming COLLECT: bounded-memory scan -> per-batch passes on
    `device`, every batch appending to one SoAState.

    Returns (header, GenotypeTable, SignatureSoA, twins), the shape of
    svim_tpu's collect_streaming(..., soa=True)."""
    from svim_tpu_torch.collect.packed import (
        GenotypeColumns,
        SoAState,
        dispatch_collect_scan,
        signatures_from_packed_soa,
    )

    stream = _prefetch(stream_bam(path, options.min_mapq, options.batch_reads,
                                  min_sv_size=options.min_sv_size), depth=2)
    header = next(stream)
    state = SoAState()
    columns = GenotypeColumns()

    def consume(batch, dispatched):
        global BATCHES
        signatures_from_packed_soa(batch.packed, batch.sa_tags, header,
                                   options, device, dispatched=dispatched,
                                   state=state,
                                   row_tag_offset=batch.row_offset)
        columns.add(batch.packed, batch.n_real)
        BATCHES += 1

    # two-deep pipeline: batch N+1's device pass is dispatched before batch
    # N is fetched and its events materialize on the host
    in_flight = None
    for batch in stream:
        dispatched = dispatch_collect_scan(batch.packed, options, device)
        if in_flight is not None:
            consume(*in_flight)
        in_flight = (batch, dispatched)
    if in_flight is not None:
        consume(*in_flight)
    table = columns.table()
    soa, twins = state.finalize()
    return header, table, soa, twins
