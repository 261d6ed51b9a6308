"""A plain reader of coordinate-sorted BGZF BAM files (the SAM/BAM
specification, section 4): the blocks inflated by a pool of threads (zlib
lets go of the interpreter lock), the records decoded one by one."""

from __future__ import annotations

import re
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

SEQ_LETTERS = "=ACMGRSVTWYHKDBN"
_NIBBLE_TABLE = np.frombuffer(SEQ_LETTERS.encode(), dtype=np.uint8)
_CIGAR_OPS = "MIDNSHP=X"
_CIGAR_TEXT = re.compile(r"(\d+)([MIDNSHP=X])")
_RECORD = struct.Struct("<iiiBBHHHiiii")
_TAG_SIZES = {ord("A"): 1, ord("c"): 1, ord("C"): 1, ord("s"): 2,
              ord("S"): 2, ord("i"): 4, ord("I"): 4, ord("f"): 4}
_ARRAY_SIZES = {ord("c"): 1, ord("C"): 1, ord("s"): 2, ord("S"): 2,
                ord("i"): 4, ord("I"): 4, ord("f"): 4}
GROUP_BLOCKS = 512   # BGZF blocks a thread inflates at a time


def _block_offsets(data):
    """(offset, size) of every BGZF member of `data`."""
    offsets = []
    position = 0
    end = len(data)
    while position < end:
        if data[position:position + 4] != b"\x1f\x8b\x08\x04":
            raise ValueError("not a BGZF member at byte {0}".format(position))
        extra = struct.unpack_from("<H", data, position + 10)[0]
        size = None
        field = position + 12
        while field < position + 12 + extra:
            sub_id = data[field:field + 2]
            sub_len = struct.unpack_from("<H", data, field + 2)[0]
            if sub_id == b"BC":
                size = struct.unpack_from("<H", data, field + 4)[0] + 1
            field += 4 + sub_len
        if size is None:
            raise ValueError("BGZF member without BSIZE at {0}".format(position))
        offsets.append((position, size, extra))
        position += size
    return offsets


def _inflate_group(data, group):
    parts = []
    for position, size, extra in group:
        payload = data[position + 12 + extra:position + size - 8]
        parts.append(zlib.decompress(payload, -15))
    return b"".join(parts)


def inflated_chunks(path, threads=8):
    """The inflated BAM stream as chunks of GROUP_BLOCKS members, in order."""
    with open(path, "rb") as handle:
        data = handle.read()
    offsets = _block_offsets(data)
    groups = [offsets[low:low + GROUP_BLOCKS]
              for low in range(0, len(offsets), GROUP_BLOCKS)]
    with ThreadPoolExecutor(max_workers=threads) as pool:
        futures = [pool.submit(_inflate_group, data, group)
                   for group in groups[:2 * threads]]
        for index in range(len(groups)):
            chunk = futures[index].result()
            futures[index] = None
            ahead = index + 2 * threads
            if ahead < len(groups):
                futures.append(pool.submit(_inflate_group, data, groups[ahead]))
            yield chunk


def decode_sequence(packed, start, stop):
    """Bases [start, stop) of a BAM 4-bit sequence field."""
    if stop <= start:
        return ""
    codes = np.frombuffer(packed, dtype=np.uint8,
                          count=(stop + 1) // 2 - start // 2,
                          offset=start // 2)
    nibbles = np.empty(2 * len(codes), dtype=np.uint8)
    nibbles[0::2] = codes >> 4
    nibbles[1::2] = codes & 15
    first = start - 2 * (start // 2)
    return _NIBBLE_TABLE[nibbles[first:first + stop - start]].tobytes().decode()


def parse_cigar_text(text):
    """CIGAR text -> (ops, lengths) arrays."""
    pairs = _CIGAR_TEXT.findall(text)
    return (np.array([_CIGAR_OPS.index(op) for _, op in pairs], dtype=np.int64),
            np.array([int(length) for length, _ in pairs], dtype=np.int64))


def _string_tags(blob):
    """Tags of type Z in a record's tag bytes, by name."""
    tags = {}
    position = 0
    end = len(blob)
    while position + 3 <= end:
        name = blob[position:position + 2].decode()
        kind = blob[position + 2]
        position += 3
        if kind in (ord("Z"), ord("H")):
            stop = blob.index(b"\x00", position)
            if kind == ord("Z"):
                tags[name] = blob[position:stop].decode()
            position = stop + 1
        elif kind == ord("B"):
            sub = blob[position]
            count = struct.unpack_from("<i", blob, position + 1)[0]
            position += 5 + count * _ARRAY_SIZES[sub]
        else:
            position += _TAG_SIZES[kind]
    return tags


class Header:
    def __init__(self, references, lengths, text):
        self.references = tuple(references)
        self.lengths = tuple(lengths)
        self.text = text
        self._tid = {name: index for index, name in enumerate(references)}

    def get_tid(self, name):
        return self._tid.get(name, -1)

    def getrname(self, tid):
        return self.references[tid]


class Record:
    """One BAM record: its fixed fields, the CIGAR's words, the packed
    sequence and its Z tags."""

    __slots__ = ("query_name", "flag", "reference_id", "reference_start",
                 "mapping_quality", "words", "l_seq", "packed_seq", "tags")

    @property
    def ops(self):
        return (self.words & 15).astype(np.int64)

    @property
    def lengths(self):
        return (self.words >> 4).astype(np.int64)

    def query_sequence(self):
        return decode_sequence(self.packed_seq, 0, self.l_seq)


def records(path, threads=8):
    """(header, iterator of Record) of a BAM file."""
    chunks = inflated_chunks(path, threads)
    buffer = b""
    for chunk in chunks:
        buffer += chunk
        if len(buffer) >= 12:
            l_text = struct.unpack_from("<i", buffer, 4)[0]
            if len(buffer) >= 12 + l_text + 4:
                break
    if buffer[:4] != b"BAM\x01":
        raise ValueError("{0} is not a BAM file".format(path))
    l_text = struct.unpack_from("<i", buffer, 4)[0]
    text = buffer[8:8 + l_text].decode()
    position = 8 + l_text
    while True:
        try:
            n_ref = struct.unpack_from("<i", buffer, position)[0]
            references, lengths = [], []
            cursor = position + 4
            for _ in range(n_ref):
                l_name = struct.unpack_from("<i", buffer, cursor)[0]
                references.append(buffer[cursor + 4:cursor + 3 + l_name].decode())
                lengths.append(struct.unpack_from("<i", buffer, cursor + 4 + l_name)[0])
                cursor += 8 + l_name
            break
        except struct.error:
            buffer += next(chunks)
    header = Header(references, lengths, text)
    return header, _iterate(buffer[cursor:], chunks)


def _iterate(buffer, chunks):
    position = 0
    for chunk in _with_end(chunks):
        if chunk is not None:
            buffer = buffer[position:] + chunk
            position = 0
        while position + 4 <= len(buffer):
            block_size = struct.unpack_from("<i", buffer, position)[0]
            if position + 4 + block_size > len(buffer):
                break
            yield _decode(buffer, position)
            position += 4 + block_size
    if position != len(buffer):
        raise ValueError("BAM stream ends inside a record")


def _with_end(chunks):
    yield from chunks
    yield None


def _decode(buffer, position):
    (block_size, ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
     _next_ref, _next_pos, _tlen) = _RECORD.unpack_from(buffer, position)
    record = Record()
    cursor = position + 36
    record.query_name = buffer[cursor:cursor + l_read_name - 1].decode()
    cursor += l_read_name
    record.words = np.frombuffer(buffer, dtype=np.uint32, count=n_cigar,
                                 offset=cursor)
    cursor += 4 * n_cigar
    record.packed_seq = buffer[cursor:cursor + (l_seq + 1) // 2]
    cursor += (l_seq + 1) // 2 + l_seq
    record.tags = _string_tags(buffer[cursor:position + 4 + block_size])
    record.flag = flag
    record.reference_id = ref_id
    record.reference_start = pos
    record.mapping_quality = mapq
    record.l_seq = l_seq
    return record
