"""Per-read SV evidence records and cluster records.

Behavioral contract follows the reference data model
(SVIM v2.0.0, src/svim/SVSignature.py): six signature kinds keyed for
gap-cut partitioning, plus uni-/bi-local cluster records with BED/VCF
serialization.  Implemented slot-based and hash-friendly so flat tables of
these records can be packed into struct-of-array tensors (see
svim_tpu_torch.collect.packing) without touching the semantics.
"""

from __future__ import annotations

import logging

INF = float("inf")


class Signature:
    """Base per-read SV evidence (reference: SVSignature.py:3-38)."""

    __slots__ = ("contig", "start", "end", "signature", "read")
    type: str = None

    def __init__(self, contig, start, end, signature, read):
        self.contig = contig
        self.start = start
        self.end = end
        self.signature = signature
        self.read = read
        if self.end < self.start:
            logging.warning("Signature with invalid coordinates (end < start): " + self.as_string())

    def get_source(self):
        return (self.contig, self.start, self.end)

    def get_key(self):
        contig, start, end = self.get_source()
        return (self.type, contig, end)

    def downstream_distance_to(self, signature2):
        """Distance >= 0 between this signature's end and the start of signature2."""
        this_contig, this_start, this_end = self.get_source()
        other_contig, other_start, other_end = signature2.get_source()
        if self.type == signature2.type and this_contig == other_contig:
            return max(0, other_start - this_end)
        return INF

    def as_string(self, sep="\t"):
        contig, start, end = self.get_source()
        return sep.join(["{0}", "{1}", "{2}", "{3}", "{4}"]).format(
            contig, start, end, "{0};{1}".format(self.type, self.signature), self.read)


class SignatureDeletion(Signature):
    """A region (contig:start-end) deleted in the sample (reference: SVSignature.py:41-52)."""

    __slots__ = ()
    type = "DEL"

    def __init__(self, contig, start, end, signature, read):
        assert end >= start
        # start: 0-based first deleted base; end: one past the last deleted base
        self.contig, self.start, self.end = contig, start, end
        self.signature, self.read = signature, read


class SignatureInsertion(Signature):
    """A region of length end-start inserted at contig:start (reference: SVSignature.py:55-82)."""

    __slots__ = ("sequence",)
    type = "INS"

    def __init__(self, contig, start, end, signature, read, sequence):
        assert end >= start
        # start: 0-based base after the insertion; end: start + insertion length
        self.contig, self.start, self.end = contig, start, end
        self.signature, self.read = signature, read
        self.sequence = sequence

    def get_key(self):
        # INS keys on start (not end) for partitioning
        contig, start, end = self.get_source()
        return (self.type, contig, start)

    def downstream_distance_to(self, signature2):
        # INS uses start-to-start downstream distance
        this_contig, this_start, this_end = self.get_source()
        other_contig, other_start, other_end = signature2.get_source()
        if self.type == signature2.type and this_contig == other_contig:
            return max(0, other_start - this_start)
        return INF


class SignatureInversion(Signature):
    """A region (contig:start-end) inverted in the sample (reference: SVSignature.py:84-101)."""

    __slots__ = ("direction",)
    type = "INV"

    def __init__(self, contig, start, end, signature, read, direction):
        assert end >= start
        self.contig, self.start, self.end = contig, start, end
        self.signature, self.read = signature, read
        self.direction = direction  # left_fwd | left_rev | right_fwd | right_rev | all

    def as_string(self, sep="\t"):
        contig, start, end = self.get_source()
        return sep.join(["{0}", "{1}", "{2}", "{3}", "{4}"]).format(
            contig, start, end, "{0};{1};{2}".format(self.type, self.direction, self.signature), self.read)


class SignatureInsertionFrom(Signature):
    """A region (contig1:start-end) inserted at contig2:pos (interspersed duplication
    evidence; reference: SVSignature.py:104-155)."""

    __slots__ = ("contig2", "pos")
    type = "DUP_INT"

    def __init__(self, contig1, start, end, contig2, pos, signature, read):
        assert end >= start
        self.contig, self.start, self.end = contig1, start, end
        self.contig2, self.pos = contig2, pos
        self.signature, self.read = signature, read

    @property
    def contig1(self):
        return self.contig

    def get_destination(self):
        source_contig, source_start, source_end = self.get_source()
        return (self.contig2, self.pos, self.pos + (source_end - source_start))

    def get_key(self):
        source_contig, source_start, source_end = self.get_source()
        dest_contig, dest_start, dest_end = self.get_destination()
        return (self.type, dest_contig, source_contig, dest_start)

    def downstream_distance_to(self, signature2):
        # keyed and gap-cut on destination start
        this_dest = self.get_destination()
        other_dest = signature2.get_destination()
        if (self.type == signature2.type
                and this_dest[0] == other_dest[0]
                and self.get_source()[0] == signature2.get_source()[0]):
            return max(0, other_dest[1] - this_dest[1])
        return INF

    def as_string(self, sep="\t"):
        source_contig, source_start, source_end = self.get_source()
        dest_contig, dest_start, dest_end = self.get_destination()
        return sep.join(["{0}:{1}-{2}", "{3}:{4}-{5}", "{6}", "{7}"]).format(
            source_contig, source_start, source_end, dest_contig, dest_start, dest_end,
            "{0};{1}".format(self.type, self.signature), self.read)


class SignatureDuplicationTandem(Signature):
    """A region (contig:start-end) tandemly duplicated `copies` times
    (reference: SVSignature.py:158-188)."""

    __slots__ = ("copies", "fully_covered")
    type = "DUP_TAN"

    def __init__(self, contig, start, end, copies, fully_covered, signature, read):
        assert end >= start
        self.contig, self.start, self.end = contig, start, end
        self.copies = copies
        self.fully_covered = fully_covered
        self.signature, self.read = signature, read

    def get_destination(self):
        source_contig, source_start, source_end = self.get_source()
        return (source_contig, source_end, source_end + self.copies * (source_end - source_start))

    def as_string(self, sep="\t"):
        source_contig, source_start, source_end = self.get_source()
        dest_contig, dest_start, dest_end = self.get_destination()
        return sep.join(["{0}:{1}-{2}", "{3}:{4}-{5}", "{6}", "{7}"]).format(
            source_contig, source_start, source_end, dest_contig, dest_start, dest_end,
            "{0};{1};{2}".format(self.type, self.signature, self.copies), self.read)


class SignatureTranslocation(Signature):
    """Two connected positions contig1:pos1 / contig2:pos2 with directions.

    The two breakpoints are stored canonically ordered: the lower (contig, pos)
    first, flipping both directions when swapped (reference: SVSignature.py:191-233).
    """

    __slots__ = ("contig2", "pos2", "direction1", "direction2")
    type = "BND"

    def __init__(self, contig1, pos1, direction1, contig2, pos2, direction2, signature, read):
        if contig1 < contig2 or (contig1 == contig2 and pos1 < pos2):
            self.contig, self.start = contig1, pos1
            self.direction1 = direction1
            self.contig2, self.pos2 = contig2, pos2
            self.direction2 = direction2
        else:
            self.contig, self.start = contig2, pos2
            self.direction1 = "fwd" if direction2 == "rev" else "rev"
            self.contig2, self.pos2 = contig1, pos1
            self.direction2 = "fwd" if direction1 == "rev" else "rev"
        self.end = self.start + 1
        self.signature, self.read = signature, read

    @property
    def contig1(self):
        return self.contig

    @property
    def pos1(self):
        return self.start

    def get_source(self):
        return (self.contig, self.start, self.start + 1)

    def get_destination(self):
        return (self.contig2, self.pos2, self.pos2 + 1)

    def get_key(self):
        return (self.type, self.contig, self.start)

    def as_string(self, sep="\t"):
        source_contig, source_start, source_end = self.get_source()
        dest_contig, dest_start, dest_end = self.get_destination()
        return sep.join(["{0}:{1}-{2}", "{3}:{4}-{5}", "{6}", "{7}"]).format(
            source_contig, source_start, source_end, dest_contig, dest_start, dest_end,
            "{0};{1}".format(self.type, self.signature), self.read)


class SignatureClusterUniLocal(Signature):
    """Cluster of signatures with one genomic location (reference: SVSignature.py:236-264)."""

    __slots__ = ("score", "std_span", "std_pos", "size", "members", "type")

    def __init__(self, contig, start, end, score, size, members, type, std_span, std_pos):
        self.contig, self.start, self.end = contig, start, end
        self.score = score
        self.std_span = std_span
        self.std_pos = std_pos
        self.size = size
        self.members = members
        self.type = type

    def get_bed_entry(self):
        return "{0}\t{1}\t{2}\t{3}\t{4}\t{5}".format(
            self.contig, self.start, self.end,
            "{0};{1};{2};{3}".format(self.type, self.size, self.std_span, self.std_pos),
            self.score, "[" + "][".join([ev.as_string("|") for ev in self.members]) + "]")

    def get_vcf_entry(self):
        if self.type in ("DEL", "INS", "INV"):
            return "{0}\t{1}\t{2}\t{3}\t{4}\t{5}\t{6}\t{7}".format(
                self.contig, self.start + 1, ".", "N", "<" + self.type + ">", ".", "PASS",
                "SVTYPE={0};END={1};SVLEN={2};STD_SPAN={3};STD_POS={4}".format(
                    self.type, self.end, self.end - self.start, self.std_span, self.std_pos))
        return None

    def get_length(self):
        return self.end - self.start


class SignatureClusterBiLocal(Signature):
    """Cluster of signatures with source and destination locations
    (reference: SVSignature.py:266-311)."""

    __slots__ = ("source_contig", "source_start", "source_end",
                 "dest_contig", "dest_start", "dest_end",
                 "score", "std_span", "std_pos", "size", "members", "type",
                 "direction1", "direction2")

    def __init__(self, source_contig, source_start, source_end,
                 dest_contig, dest_start, dest_end, score, size, members, type,
                 std_span, std_pos):
        self.source_contig, self.source_start, self.source_end = source_contig, source_start, source_end
        self.dest_contig, self.dest_start, self.dest_end = dest_contig, dest_start, dest_end
        self.score = score
        self.std_span = std_span
        self.std_pos = std_pos
        self.size = size
        self.members = members
        self.type = type
        self.direction1 = None
        self.direction2 = None

    # base-class source accessors route through source_*
    @property
    def contig(self):
        return self.source_contig

    @property
    def start(self):
        return self.source_start

    @property
    def end(self):
        return self.source_end

    def get_source(self):
        return (self.source_contig, self.source_start, self.source_end)

    def get_destination(self):
        return (self.dest_contig, self.dest_start, self.dest_end)

    def get_key(self):
        return (self.type, self.source_contig, self.source_start)

    def get_bed_entries(self):
        source_entry = "{0}\t{1}\t{2}\t{3}\t{4}\t{5}".format(
            self.source_contig, self.source_start, self.source_end,
            "{0}_source;{1}:{2}-{3};{4};{5};{6}".format(
                self.type, self.dest_contig, self.dest_start, self.dest_end,
                self.size, self.std_span, self.std_pos),
            self.score, "[" + "][".join([ev.as_string("|") for ev in self.members]) + "]")
        dest_entry = "{0}\t{1}\t{2}\t{3}\t{4}\t{5}".format(
            self.dest_contig, self.dest_start, self.dest_end,
            "{0}_dest;{1}:{2}-{3};{4}".format(
                self.type, self.source_contig, self.source_start, self.source_end, self.size),
            self.score, "[" + "][".join([ev.as_string("|") for ev in self.members]) + "]")
        return (source_entry, dest_entry)

    def get_vcf_entry(self):
        if self.type == "DUP_TAN":
            return "{0}\t{1}\t{2}\t{3}\t{4}\t{5}\t{6}\t{7}".format(
                self.source_contig, self.source_start + 1, ".", "N", "<DUP:TANDEM>", ".", "PASS",
                "SVTYPE={0};END={1};SVLEN={2};STD_SPAN={3};STD_POS={4}".format(
                    "DUP:TANDEM", self.source_end, self.source_end - self.source_start,
                    self.std_span, self.std_pos))
        return None

    def get_source_length(self):
        return self.source_end - self.source_start

    def get_destination_length(self):
        return self.dest_end - self.dest_start
