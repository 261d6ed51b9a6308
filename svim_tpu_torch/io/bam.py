"""BAM (BGZF-compressed binary SAM) decoding and encoding.

From-scratch replacement for htslib's BAM layer.  BGZF is a multi-member gzip
stream, so decompression goes through zlib; record fields follow the SAM spec
section 4.2.  A native C++ fast path (svim_tpu_torch/native/bamio.cpp) decodes
straight into packed numpy arrays for the TPU COLLECT path; this module is the
portable reference implementation and the writer used by tests.
"""

from __future__ import annotations

import gzip
import struct
import zlib
from typing import List

from svim_tpu_torch.io.sam import AlignmentHeader, AlignmentRecord

SEQ_CODES = "=ACMGRSVTWYHKDBN"
_CODE_FOR_BASE = {b: i for i, b in enumerate(SEQ_CODES)}
CIGAR_OPS = "MIDNSHP=X"

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


def read_bam(filename: str):
    """Decode a whole BAM file -> (AlignmentHeader, [AlignmentRecord])."""
    try:
        with gzip.open(filename, "rb") as handle:
            data = handle.read()
        return parse_bam_bytes(data)
    except (EOFError, OSError, struct.error, IndexError) as error:
        raise ValueError("truncated or corrupt BAM file {0}: {1}".format(
            filename, error)) from error


def parse_bam_bytes(data: bytes):
    if data[:4] != b"BAM\x01":
        raise ValueError("not a BAM stream (bad magic)")
    offset = 4
    (l_text,) = struct.unpack_from("<i", data, offset)
    offset += 4
    text = data[offset:offset + l_text].split(b"\x00", 1)[0].decode()
    offset += l_text
    (n_ref,) = struct.unpack_from("<i", data, offset)
    offset += 4
    references: List[str] = []
    lengths: List[int] = []
    for _ in range(n_ref):
        (l_name,) = struct.unpack_from("<i", data, offset)
        offset += 4
        references.append(data[offset:offset + l_name - 1].decode())
        offset += l_name
        (l_ref,) = struct.unpack_from("<i", data, offset)
        offset += 4
        lengths.append(l_ref)
    header = AlignmentHeader.from_text(text)
    if not header.references:
        header = AlignmentHeader(header.hd, references, lengths, text)

    records: List[AlignmentRecord] = []
    total = len(data)
    while offset < total:
        (block_size,) = struct.unpack_from("<i", data, offset)
        offset += 4
        records.append(_parse_record(data, offset, block_size))
        offset += block_size
    return header, records


def _parse_record(data: bytes, offset: int, block_size: int) -> AlignmentRecord:
    (ref_id, pos, l_read_name, mapq, _bin, n_cigar_op, flag, l_seq,
     next_ref_id, next_pos, tlen) = struct.unpack_from("<iiBBHHHiiii", data, offset)
    p = offset + 32
    read_name = data[p:p + l_read_name - 1].decode()
    p += l_read_name
    cigartuples = None
    if n_cigar_op > 0:
        raw = struct.unpack_from("<{0}I".format(n_cigar_op), data, p)
        cigartuples = [(c & 0xF, c >> 4) for c in raw]
    p += 4 * n_cigar_op
    query_sequence = None
    if l_seq > 0:
        seq_bytes = data[p:p + (l_seq + 1) // 2]
        chars = []
        for byte in seq_bytes:
            chars.append(SEQ_CODES[byte >> 4])
            chars.append(SEQ_CODES[byte & 0xF])
        query_sequence = "".join(chars[:l_seq])
    p += (l_seq + 1) // 2
    query_qualities = None
    if l_seq > 0:
        qual = data[p:p + l_seq]
        if qual[0] != 0xFF:
            query_qualities = list(qual)
    p += l_seq
    tags = _parse_tags(data, p, offset + block_size)
    return AlignmentRecord(
        query_name=read_name, flag=flag, reference_id=ref_id, reference_start=pos,
        mapping_quality=mapq, cigartuples=cigartuples, query_sequence=query_sequence,
        query_qualities=query_qualities, next_reference_id=next_ref_id,
        next_reference_start=next_pos, template_length=tlen, tags=tags)


_TAG_FMT = {"c": "<b", "C": "<B", "s": "<h", "S": "<H", "i": "<i", "I": "<I", "f": "<f"}
_TAG_SIZE = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}


def _parse_tags(data: bytes, p: int, end: int):
    tags = {}
    while p < end:
        tag = data[p:p + 2].decode()
        value_type = chr(data[p + 2])
        p += 3
        if value_type == "A":
            tags[tag] = (chr(data[p]), "A")
            p += 1
        elif value_type in _TAG_FMT:
            (value,) = struct.unpack_from(_TAG_FMT[value_type], data, p)
            tags[tag] = (value, value_type)
            p += _TAG_SIZE[value_type]
        elif value_type in ("Z", "H"):
            nul = data.index(b"\x00", p)
            tags[tag] = (data[p:nul].decode(), value_type)
            p = nul + 1
        elif value_type == "B":
            sub_type = chr(data[p])
            (count,) = struct.unpack_from("<i", data, p + 1)
            size = _TAG_SIZE[sub_type]
            values = list(struct.unpack_from("<{0}{1}".format(count, _TAG_FMT[sub_type][1]), data, p + 5))
            tags[tag] = (values, "B" + sub_type)
            p += 5 + count * size
        else:
            raise ValueError("unknown tag type {0}".format(value_type))
    return tags


# ------------------------------------------------------------------------------------
# Writer (used by tests and the alignment-caching stage)
# ------------------------------------------------------------------------------------

def bgzf_compress(data: bytes, level: int = 6) -> bytes:
    """Compress bytes into a BGZF stream (64 KiB blocks + EOF marker)."""
    out = bytearray()
    for start in range(0, len(data), 0xFF00):
        chunk = data[start:start + 0xFF00]
        compressor = zlib.compressobj(level, zlib.DEFLATED, -15)
        payload = compressor.compress(chunk) + compressor.flush()
        bsize = len(payload) + 25 + 1
        header = struct.pack("<BBBBIBBHBBHH",
                             0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
                             ord("B"), ord("C"), 2, bsize - 1)
        footer = struct.pack("<II", zlib.crc32(chunk) & 0xFFFFFFFF, len(chunk))
        out += header + payload + footer
    out += BGZF_EOF
    return bytes(out)


def _encode_record(rec: AlignmentRecord) -> bytes:
    name = rec.query_name.encode() + b"\x00"
    cigar = rec.cigartuples or []
    cigar_bytes = struct.pack("<{0}I".format(len(cigar)),
                              *[(length << 4) | op for op, length in cigar])
    seq = rec.query_sequence or ""
    l_seq = len(seq)
    seq_bytes = bytearray()
    for i in range(0, l_seq, 2):
        hi = _CODE_FOR_BASE.get(seq[i].upper(), 15)
        lo = _CODE_FOR_BASE.get(seq[i + 1].upper(), 15) if i + 1 < l_seq else 0
        seq_bytes.append((hi << 4) | lo)
    if rec.query_qualities is not None:
        qual_bytes = bytes(rec.query_qualities)
    else:
        qual_bytes = b"\xff" * l_seq
    tag_bytes = bytearray()
    for tag, (value, value_type) in rec.tags.items():
        tag_bytes += tag.encode()
        if value_type is None:
            value_type = "i" if isinstance(value, int) else ("Z" if isinstance(value, str) else "f")
        tag_bytes += value_type.encode()
        if value_type == "A":
            tag_bytes += value.encode()
        elif value_type in _TAG_FMT:
            tag_bytes += struct.pack(_TAG_FMT[value_type], value)
        elif value_type in ("Z", "H"):
            tag_bytes += value.encode() + b"\x00"
        else:
            raise ValueError("unsupported tag type for writing: {0}".format(value_type))
    body = struct.pack("<iiBBHHHiiii",
                       rec.reference_id, rec.reference_start, len(name),
                       rec.mapping_quality, 0, len(cigar), rec.flag, l_seq,
                       rec.next_reference_id, rec.next_reference_start,
                       rec.template_length)
    body += name + cigar_bytes + bytes(seq_bytes) + qual_bytes + bytes(tag_bytes)
    return struct.pack("<i", len(body)) + body


def write_bam(filename: str, header: AlignmentHeader, records) -> None:
    text = header.text
    if text and not text.endswith("\n"):
        text += "\n"
    payload = bytearray(b"BAM\x01")
    text_bytes = text.encode()
    payload += struct.pack("<i", len(text_bytes)) + text_bytes
    payload += struct.pack("<i", len(header.references))
    for name, length in zip(header.references, header.lengths):
        name_bytes = name.encode() + b"\x00"
        payload += struct.pack("<i", len(name_bytes)) + name_bytes
        payload += struct.pack("<i", length)
    for rec in records:
        payload += _encode_record(rec)
    with open(filename, "wb") as out:
        out.write(bgzf_compress(bytes(payload)))
