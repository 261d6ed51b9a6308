"""COLLECT, plainly: every record of the BAM walked in file order, as SVIM
v2.0.0's coordinate-sorted COLLECT does (SVIM_COLLECT.py:132-167): a
supplementary record gives its CIGAR indels; a primary gives its CIGAR
indels and then the signatures of its segments, its SA tag supplying the
other segments (SVIM_COLLECT.py:44-93, SVIM_inter.py).  The CIGAR walk is a
cumulative sum (SVIM_intra.py:8-51).  Also returns the columns that
GENOTYPE reads: every mapped, non-secondary record at the minimum mapping
quality, with its reference interval and read name."""

from __future__ import annotations

import numpy as np

from svbench.reference.bam import decode_sequence, parse_cigar_text, records
from svbench.reference.inter import analyze_read_segments
from svbench.reference.signatures import SignatureDeletion, SignatureInsertion

_FUNMAP, _FREVERSE, _FSECONDARY, _FSUPPLEMENTARY = 0x4, 0x10, 0x100, 0x800
# (reference advances, read advances) by op M I D N S H P = X; N advances
# neither in SVIM's walk, as in SVIM_intra.py
_REF_WALK = np.array([1, 0, 1, 0, 0, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0])
_READ_WALK = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0])
_REF_SPAN = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0])
_QUERY_SPAN = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0])


class Alignment:
    """The accessors of one alignment that SVIM's segment analysis reads."""

    def __init__(self, query_name, flag, reference_id, reference_start,
                 ops, lengths, sequence_of):
        self.query_name = query_name
        self.flag = flag
        self.reference_id = reference_id
        self.reference_start = reference_start
        self.ops = ops
        self.lengths = lengths
        self._sequence_of = sequence_of
        self._sequence = None
        self.reference_end = reference_start + int(
            (lengths * _REF_SPAN[ops]).sum())
        query_length = int((lengths * _QUERY_SPAN[ops]).sum())
        self.read_length = query_length + int(lengths[ops == 5].sum())
        start = 0
        for op, length in zip(ops.tolist(), lengths.tolist()):
            if op == 4:
                start += length
            elif op != 5:
                break
        end = query_length
        for op, length in zip(ops[::-1].tolist(), lengths[::-1].tolist()):
            if op == 4:
                end -= length
            elif op != 5:
                break
        self.query_alignment_start = start
        self.query_alignment_end = end

    @property
    def is_reverse(self):
        return bool(self.flag & _FREVERSE)

    @property
    def cigarstring(self):
        return "".join("{0}{1}".format(length, "MIDNSHP=X"[op])
                       for op, length in zip(self.ops.tolist(),
                                             self.lengths.tolist()))

    def infer_read_length(self):
        return self.read_length

    @property
    def query_sequence(self):
        if self._sequence is None:
            self._sequence = self._sequence_of()
        return self._sequence


def _indel_events(batch, min_length):
    """SVIM_intra.py's walk over the CIGARs of a batch of records at once,
    as cumulative sums: per record, [(op, offset on the reference, offset
    on the read, length)] of its DEL and INS of at least `min_length`, in
    CIGAR order; and each record's reference span.  Ops from N on advance
    neither walk (their table entries are 0)."""
    counts = np.array([len(record.words) for record in batch], dtype=np.int64)
    words = np.concatenate([record.words for record in batch])
    ops = words & 15
    lengths = (words >> 4).astype(np.int64)
    first = np.concatenate([[0], np.cumsum(counts)[:-1]])
    ref_steps = lengths * _REF_WALK[ops]
    read_steps = lengths * _READ_WALK[ops]
    ref_total = np.concatenate([[0], np.cumsum(ref_steps)])
    read_total = np.concatenate([[0], np.cumsum(read_steps)])
    span_total = np.concatenate([[0], np.cumsum(lengths * _REF_SPAN[ops])])
    spans = span_total[first + counts] - span_total[first]
    hits = np.flatnonzero(((ops == 1) | (ops == 2)) & (lengths >= min_length))
    # each record's walk starts at 0: the sums before its first op removed
    owner = np.searchsorted(first, hits, side="right") - 1
    ref_before = ref_total[hits] - ref_total[first[owner]]
    read_before = read_total[hits] - read_total[first[owner]]
    events = [[] for _ in batch]
    for index, op, on_ref, on_read, length in zip(
            owner.tolist(), ops[hits].tolist(), ref_before.tolist(),
            read_before.tolist(), lengths[hits].tolist()):
        events[index].append((op, on_ref, on_read, length))
    return events, spans


def _indel_signatures(contig, record, events):
    signatures = []
    for op, on_ref, on_read, length in events:
        pos_ref = record.reference_start + on_ref
        if op == 2:
            signatures.append(SignatureDeletion(
                contig, pos_ref, pos_ref + length, "cigar", record.query_name))
        else:
            sequence = decode_sequence(record.packed_seq, on_read,
                                       min(record.l_seq, on_read + length))
            signatures.append(SignatureInsertion(
                contig, pos_ref, pos_ref + length, "cigar", record.query_name,
                sequence))
    return signatures


def _other_alignments(record, header):
    """The segments of the read's SA tag (SVIM_COLLECT.py:44-93); none where
    the primary is hard clipped."""
    tag = record.tags.get("SA")
    if tag is None or (record.lengths[record.ops == 5] > 0).any():
        return []
    others = []
    for element in tag.split(";"):
        if element == "":
            continue
        fields = element.split(",")
        if len(fields) != 6:
            continue
        rname, pos, strand, cigar, mapq, _nm = fields
        mapq = int(mapq)
        if not 0 <= mapq <= 255:
            mapq = 0
        ops, lengths = parse_cigar_text(cigar)
        other = Alignment(record.query_name, 2048 if strand == "+" else 2064,
                          header.get_tid(rname), int(pos) - 1, ops, lengths,
                          record.query_sequence)
        other.mapping_quality = mapq
        others.append(other)
    return others


class GenotypeColumns:
    """Per eligible record: reference id, start, end and read-name id."""

    def __init__(self):
        self.ref_id, self.start, self.end, self.name = [], [], [], []
        self.name_ids = {}

    def add(self, record, end):
        self.ref_id.append(record.reference_id)
        self.start.append(record.reference_start)
        self.end.append(end)
        self.name.append(self.name_ids.setdefault(record.query_name,
                                                  len(self.name_ids)))

    def arrays(self):
        return tuple(np.asarray(column, dtype=np.int64) for column in
                     (self.ref_id, self.start, self.end, self.name))


BATCH = 2048   # records whose CIGARs are walked together


def _batches(stream, options):
    """The stream's records that SVIM reads (mapped, not secondary, at the
    minimum mapping quality), in batches."""
    batch = []
    for record in stream:
        flag = record.flag
        if flag & _FUNMAP or flag & _FSECONDARY or \
                record.mapping_quality < options.min_mapq:
            continue
        batch.append(record)
        if len(batch) == BATCH:
            yield batch
            batch = []
    if batch:
        yield batch


def collect(bam_path, options, threads=8):
    """(header, signatures in SVIM's order, genotype columns, records
    read)."""
    header, stream = records(bam_path, threads)
    counted = _Counted(stream)
    signatures = []
    columns = GenotypeColumns()
    for batch in _batches(counted, options):
        events, spans = _indel_events(batch, options.min_sv_size)
        for record, record_events, span in zip(batch, events, spans.tolist()):
            contig = header.references[record.reference_id]
            columns.add(record, record.reference_start + span)
            signatures.extend(_indel_signatures(contig, record, record_events))
            if record.flag & _FSUPPLEMENTARY:
                continue
            good = [other for other in _other_alignments(record, header)
                    if other.mapping_quality >= options.min_mapq]
            if not good:
                # the primary alone has no pair of segments to read
                continue
            primary = Alignment(record.query_name, record.flag,
                                record.reference_id, record.reference_start,
                                record.ops, record.lengths,
                                record.query_sequence)
            segment_signatures, _twins = analyze_read_segments(
                primary, good, header, options)
            signatures.extend(segment_signatures)
    return header, signatures, columns, counted.count


class _Counted:
    """An iterator that counts what passes through it."""

    def __init__(self, iterator):
        self.iterator = iterator
        self.count = 0

    def __iter__(self):
        for item in self.iterator:
            self.count += 1
            yield item
