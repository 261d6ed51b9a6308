"""Byte-range BAM ingestion for multi-host runs.

Each host reads only its contiguous compressed block range of a shared BAM —
the multi-host analog of htslib's .bai-chunked access, built instead on
BGZF's self-describing block structure:

  * a header-only walk over the BSIZE fields yields all block offsets
    without inflating anything;
  * blocks split contiguously across processes by compressed size;
  * record boundaries inside a range are recovered by a validated chain
    scan (BAM records straddle BGZF block edges, so a range's first whole
    record must be located; validation chains block_size/refID/pos/l_read_name
    consistency across several consecutive records, which no false offset
    survives);
  * every process computes its OWN end boundary as the deterministic first
    record of the NEXT range (inflating a small overhang), so no
    cross-process handshake is needed and ranges tile the record stream
    exactly: concatenating per-process results in rank order reproduces the
    serial file order byte-for-byte.

Reference analog: SVIM_COLLECT.py:133 iterates one process over the whole
file; the multi-host design (SURVEY.md §7.1 step 7) shards that scan.
"""

from __future__ import annotations

import gzip
import struct
from typing import List, Optional, Tuple

_BGZF_MAGIC = b"\x1f\x8b\x08\x04"
_MAX_RECORD_BYTES = 1 << 26  # spec-sane upper bound on one BAM record


def bgzf_block_offsets(compressed: bytes) -> List[int]:
    """Compressed offsets of every BGZF block, plus the end offset.

    Walks only the 18-byte block headers (BSIZE chaining) — no inflation."""
    offsets: List[int] = []
    pos = 0
    total = len(compressed)
    while pos < total:
        if compressed[pos:pos + 4] != _BGZF_MAGIC:
            raise ValueError("not a BGZF block at offset {0}".format(pos))
        (xlen,) = struct.unpack_from("<H", compressed, pos + 10)
        p = pos + 12
        end = p + xlen
        bsize = None
        while p + 4 <= end:
            si1, si2 = compressed[p], compressed[p + 1]
            (slen,) = struct.unpack_from("<H", compressed, p + 2)
            if si1 == 66 and si2 == 67 and slen == 2:
                (bsize,) = struct.unpack_from("<H", compressed, p + 4)
            p += 4 + slen
        if bsize is None:
            raise ValueError("BGZF block without BC subfield at {0}".format(pos))
        offsets.append(pos)
        pos += bsize + 1
    offsets.append(total)
    return offsets


def _inflate(compressed: bytes) -> bytes:
    """Inflate a concatenation of whole BGZF blocks."""
    try:
        from svim_tpu_torch import native
        data = native.bgzf_decompress_parallel(compressed)
        if data is not None:
            return bytes(data)
    except Exception:
        pass
    return gzip.decompress(compressed)


def parse_header_end(data: bytes) -> Optional[Tuple[int, int]]:
    """(first_record_offset, n_ref) if `data` holds the complete BAM header,
    else None (caller inflates more blocks)."""
    if len(data) >= 4 and data[:4] != b"BAM\x01":
        raise ValueError("not a BAM stream")
    if len(data) < 12:
        # magic matches (or is incomplete): merely too short, inflate more
        return None
    offset = 4
    (l_text,) = struct.unpack_from("<i", data, offset)
    offset += 4 + l_text
    if offset + 4 > len(data):
        return None
    (n_ref,) = struct.unpack_from("<i", data, offset)
    offset += 4
    for _ in range(n_ref):
        if offset + 4 > len(data):
            return None
        (l_name,) = struct.unpack_from("<i", data, offset)
        offset += 4 + l_name + 4
    if offset > len(data):
        return None
    return offset, n_ref


def _validate_record_chain(data: bytes, offset: int, n_ref: int,
                           need: int = 6) -> bool:
    """True if `offset` plausibly starts a chain of BAM records.

    Accepts when `need` consecutive records validate, or when fewer do but
    the chain runs cleanly off the end of the buffer (a record may straddle
    the buffer edge — only reachable after >=1 full validated record)."""
    unpack = struct.unpack_from
    total = len(data)
    checked = 0
    p = offset
    while checked < need:
        if p == total:
            return checked > 0
        if p + 36 > total:
            return checked > 0
        (block_size,) = unpack("<i", data, p)
        if block_size < 34 or block_size > _MAX_RECORD_BYTES:
            return False
        (ref_id, pos, l_read_name, _mapq, _bin, n_cigar_op, _flag,
         l_seq) = unpack("<iiBBHHHi", data, p + 4)
        if not (-1 <= ref_id < n_ref) or not (-1 <= pos < (1 << 31) - 1):
            return False
        if l_read_name < 1 or l_seq < 0:
            return False
        (next_ref, next_pos) = unpack("<ii", data, p + 24)
        if not (-1 <= next_ref < n_ref) or not (-1 <= next_pos < (1 << 31) - 1):
            return False
        if block_size < 32 + l_read_name + 4 * n_cigar_op + (l_seq + 1) // 2 + l_seq:
            return False
        p += 4 + block_size
        if p > total:
            return checked > 0
        checked += 1
    return True


def find_record_start(data: bytes, n_ref: int, search_from: int = 0,
                      need: int = 6) -> Optional[int]:
    """First byte offset >= search_from that starts a validated record chain.

    None when the buffer is too short to contain/confirm a boundary (the
    caller extends it with the next block)."""
    total = len(data)
    # require enough lookahead that validation is meaningful: either several
    # records' worth of bytes or (for short tails) the true end of file
    for candidate in range(search_from, total):
        if candidate + 36 > total:
            return None
        if _validate_record_chain(data, candidate, n_ref, need):
            return candidate
    return None


class BamRangePlan:
    """Shared per-file facts every process derives identically."""

    def __init__(self, bam_path: str):
        with open(bam_path, "rb") as handle:
            self.compressed = handle.read()
        self.block_offsets = bgzf_block_offsets(self.compressed)
        # inflate blocks from the start until the header parses
        data = b""
        self.header_blocks = 0
        while True:
            if self.header_blocks >= len(self.block_offsets) - 1:
                raise ValueError("BAM ends inside its header")
            lo = self.block_offsets[self.header_blocks]
            hi = self.block_offsets[self.header_blocks + 1]
            data += _inflate(self.compressed[lo:hi])
            self.header_blocks += 1
            parsed = parse_header_end(data)
            if parsed is not None:
                self.first_record_offset, self.n_ref = parsed
                break
        self.header_bytes = data[:self.first_record_offset]
        # total inflated size of blocks [0, header_blocks) — the inflated
        # offset where a rank's own block range begins when the header
        # blocks are prepended to its stream (collect_soa_pipelined_range)
        self.header_inflated_len = len(data)

    def block_range(self, num_processes: int, process_id: int) -> Tuple[int, int]:
        """Contiguous block range [lo, hi) for a process, balanced by
        compressed size.  Process 0 always starts at block 0."""
        offsets = self.block_offsets
        total = offsets[-1]
        n_blocks = len(offsets) - 1
        import bisect

        def boundary(rank):
            if rank <= 0:
                return 0
            if rank >= num_processes:
                return n_blocks
            target = total * rank // num_processes
            return min(n_blocks, bisect.bisect_left(offsets, target, 0, n_blocks))

        return boundary(process_id), boundary(process_id + 1)

    def _range_first_record(self, block_index: int) -> Optional[int]:
        """Uncompressed offset (within the range's inflated stream) of the
        first whole record at/after block `block_index`; None at EOF.

        Deterministic in block_index only, so the process owning the range
        and the neighbor computing its own end agree without communication."""
        n_blocks = len(self.block_offsets) - 1
        if block_index >= n_blocks:
            return None
        data = b""
        j = block_index
        while True:
            if j >= n_blocks:
                # trailing bytes never resolved into a record boundary: the
                # remaining stream is the tail of a record owned upstream
                return None
            lo, hi = self.block_offsets[j], self.block_offsets[j + 1]
            data += _inflate(self.compressed[lo:hi])
            j += 1
            found = find_record_start(data, self.n_ref)
            if found is not None:
                return found
            if len(data) > 2 * _MAX_RECORD_BYTES:
                raise ValueError("no record boundary found in range starting "
                                 "at block {0}".format(block_index))

    def local_records(self, num_processes: int, process_id: int) -> bytes:
        """The exact record bytes owned by a process: from its range's first
        whole record up to the next range's first whole record."""
        b_lo, b_hi = self.block_range(num_processes, process_id)
        if b_lo >= b_hi:
            return b""
        lo, hi = self.block_offsets[b_lo], self.block_offsets[b_hi]
        data = _inflate(self.compressed[lo:hi])
        if b_lo == 0:
            my_first = self.first_record_offset
        else:
            # Run the SAME incremental procedure the left neighbor uses to
            # compute this boundary (_range_first_record(b_lo)), never a
            # one-shot scan over the full range: the incremental scan can
            # accept a candidate on weaker evidence (chain running off a
            # short buffer), and any asymmetry would make adjacent ranks
            # disagree about the boundary, silently losing or duplicating
            # record bytes.  Identical-by-construction beats
            # identical-by-argument here.
            my_first = self._range_first_record(b_lo)
            if my_first is None or my_first >= len(data):
                # whole range is the interior of one giant record (the first
                # boundary at/after b_lo lies at/after b_hi, so the next rank
                # owns it)
                return b""
        n_blocks = len(self.block_offsets) - 1
        if b_hi >= n_blocks:
            return data[my_first:]
        next_first = self._range_first_record(b_hi)
        if next_first is None:
            # everything after this range is a straddling tail we own
            tail_lo = self.block_offsets[b_hi]
            return data[my_first:] + _inflate(self.compressed[tail_lo:])
        if next_first == 0:
            return data[my_first:]
        tail = b""
        j = b_hi
        while len(tail) < next_first:
            t_lo, t_hi = self.block_offsets[j], self.block_offsets[j + 1]
            tail += _inflate(self.compressed[t_lo:t_hi])
            j += 1
        return data[my_first:] + tail[:next_first]


def scan_bam_range(bam_path: str, num_processes: int, process_id: int,
                   min_mapq: int = 0, min_sv_size: int = 0):
    """scan_bam restricted to one process's record range.

    Returns (header, PackedAlignments, sa_tags) exactly like
    io.bamscan.scan_bam, containing only the locally-owned records."""
    from svim_tpu_torch.io.bamscan import scan_bam_bytes

    plan = BamRangePlan(bam_path)
    records = plan.local_records(num_processes, process_id)
    return scan_bam_bytes(plan.header_bytes + records, min_mapq, min_sv_size)
