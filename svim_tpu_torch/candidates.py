"""Final SV candidate records and their VCF/BED serialization.

Byte-compatible with the reference emitters (SVIM v2.0.0, src/svim/SVCandidate.py):
DEL/INV/INS/DUP:TANDEM/DUP:INT/BND records, genotype FORMAT columns, PacBio ZMW
counting, dual DUP representations and the 4 BND bracket notations.  The
shared INFO/FORMAT assembly lives in helpers instead of being repeated per
class.
"""

from __future__ import annotations

INF = float("inf")


def _zmw_count(read_ids):
    """Count distinct PacBio ZMWs among read names `movie/zmw/range`
    (reference: SVCandidate.py:106-114). Returns None when any name is not
    PacBio-shaped."""
    zmw_list = set()
    for read_id in read_ids:
        fields = read_id.split("/")
        if len(fields) != 3:
            return None
        zmw_list.add("/".join(fields[0:2]))
    return len(zmw_list)


def _info_suffix(members, insertion_sequences=False, read_names=False, zmws=False):
    """Optional SEQS= / READS= / ZMWS= INFO fields shared by all candidate types."""
    parts = []
    if insertion_sequences:
        parts.append(";SEQS={0}".format(",".join(member.sequence for member in members)))
    read_ids = [member.read for member in members]
    if read_names:
        parts.append(";READS={0}".format(",".join(read_ids)))
    if zmws:
        count = _zmw_count(read_ids)
        if count is not None:
            parts.append(";ZMWS={0}".format(count))
    return "".join(parts)


def _support(members):
    return len(set(sig.read for sig in members))


class Candidate:
    """Base SV candidate (reference: SVCandidate.py:1-57)."""

    type = None

    def __init__(self, source_contig, source_start, source_end, members, score,
                 std_span, std_pos, support_fraction=".", genotype="./.",
                 ref_reads=None, alt_reads=None):
        self.source_contig = source_contig
        self.source_start = source_start
        self.source_end = source_end
        self.members = members
        self.score = score
        self.std_span = std_span
        self.std_pos = std_pos
        self.support_fraction = support_fraction
        self.genotype = genotype
        self.ref_reads = ref_reads
        self.alt_reads = alt_reads

    def get_source(self):
        return (self.source_contig, self.source_start, self.source_end)

    def get_key(self):
        contig, start, end = self.get_source()
        return (self.type, contig, end)

    def downstream_distance_to(self, candidate2):
        this_contig, this_start, this_end = self.get_source()
        other_contig, other_start, other_end = candidate2.get_source()
        if self.type == candidate2.type and this_contig == other_contig:
            return max(0, other_start - this_end)
        return INF

    def get_std_span(self, ndigits=2):
        return round(self.std_span, ndigits) if self.std_span else "."

    def get_std_pos(self, ndigits=2):
        return round(self.std_pos, ndigits) if self.std_pos else "."

    # -- shared VCF column assembly -------------------------------------------------

    def _dp_string(self):
        if self.ref_reads is not None and self.alt_reads is not None:
            return str(self.ref_reads + self.alt_reads)
        return "."

    def _filters(self, extra=()):
        filters = []
        if self.genotype == "0/0":
            filters.append("hom_ref")
        filters.extend(extra)
        return "PASS" if len(filters) == 0 else ";".join(filters)

    def _samples(self):
        return "{gt}:{dp}:{ref},{alt}".format(
            gt=self.genotype, dp=self._dp_string(),
            ref=self.ref_reads if self.ref_reads is not None else ".",
            alt=self.alt_reads if self.alt_reads is not None else ".")

    def _vcf_line(self, chrom, pos, ref, alt, info, extra_filters=(), format="GT:DP:AD", samples=None):
        return "{chrom}\t{pos}\t{id}\t{ref}\t{alt}\t{qual}\t{filter}\t{info}\t{format}\t{samples}".format(
            chrom=chrom, pos=pos, id="PLACEHOLDERFORID", ref=ref, alt=alt,
            qual=int(self.score), filter=self._filters(extra_filters), info=info,
            format=format, samples=samples if samples is not None else self._samples())

    def get_bed_entry(self):
        return "{0}\t{1}\t{2}\t{3}\t{4}\t{5}\t{6}".format(
            self.source_contig, self.source_start, self.source_end,
            "{0};{1};{2}".format(self.type, self.get_std_span(), self.get_std_pos()),
            self.score, ".", "[" + "][".join([ev.as_string("|") for ev in self.members]) + "]")

    def get_vcf_entry(self, *a, **kw):
        raise NotImplementedError


class CandidateDeletion(Candidate):
    """Deletion candidate (reference: SVCandidate.py:60-125).  VCF POS is the
    base before the deletion per VCF convention; SVLEN is negative."""

    type = "DEL"

    def __init__(self, source_contig, source_start, source_end, members, score,
                 std_span, std_pos, **kw):
        super().__init__(source_contig, max(0, source_start), source_end,
                         members, score, std_span, std_pos, **kw)

    def get_vcf_entry(self, sequence_alleles=False, reference=None, read_names=False, zmws=False):
        contig, start, end = self.get_source()
        if sequence_alleles:
            ref_allele = reference.fetch(contig, max(0, start - 1), end).upper()
            alt_allele = reference.fetch(contig, max(0, start - 1), start).upper()
        else:
            ref_allele, alt_allele = "N", "<" + self.type + ">"
        info = "SVTYPE={0};END={1};SVLEN={2};SUPPORT={3};STD_SPAN={4};STD_POS={5}".format(
            self.type, end, start - end, _support(self.members),
            self.get_std_span(), self.get_std_pos())
        info += _info_suffix(self.members, read_names=read_names, zmws=zmws)
        return self._vcf_line(contig, max(1, start), ref_allele, alt_allele, info)


class CandidateInversion(Candidate):
    """Inversion candidate (reference: SVCandidate.py:128-194).  ALT is the
    reverse complement of the reference allele."""

    type = "INV"
    _COMPLEMENT = {"A": "T", "C": "G", "G": "C", "T": "A"}

    def __init__(self, source_contig, source_start, source_end, members, score,
                 std_span, std_pos, **kw):
        super().__init__(source_contig, max(0, source_start), source_end,
                         members, score, std_span, std_pos, **kw)

    def get_vcf_entry(self, sequence_alleles=False, reference=None, read_names=False, zmws=False):
        contig, start, end = self.get_source()
        if sequence_alleles:
            ref_allele = reference.fetch(contig, start, end).upper()
            alt_allele = "".join(self._COMPLEMENT.get(base.upper(), base.upper())
                                 for base in reversed(ref_allele))
        else:
            ref_allele, alt_allele = "N", "<" + self.type + ">"
        info = "SVTYPE={0};END={1};SUPPORT={2};STD_SPAN={3};STD_POS={4}".format(
            self.type, end, _support(self.members), self.get_std_span(), self.get_std_pos())
        info += _info_suffix(self.members, read_names=read_names, zmws=zmws)
        return self._vcf_line(contig, start + 1, ref_allele, alt_allele, info)


class CandidateNovelInsertion(Candidate):
    """Novel insertion candidate carrying the consensus sequence
    (reference: SVCandidate.py:197-271)."""

    type = "INS"

    def __init__(self, dest_contig, dest_start, dest_end, sequence, members, score,
                 std_span, std_pos, **kw):
        super().__init__(dest_contig, max(0, dest_start), dest_end, members, score,
                         std_span, std_pos, **kw)
        self.sequence = sequence

    # destination aliases (the insertion point is the only locus)
    @property
    def dest_contig(self):
        return self.source_contig

    @property
    def dest_start(self):
        return self.source_start

    @property
    def dest_end(self):
        return self.source_end

    def get_destination(self):
        return (self.source_contig, self.source_start, self.source_end)

    def get_bed_entry(self):
        contig, start, end = self.get_destination()
        return "{0}\t{1}\t{2}\t{3}\t{4}\t{5}\t{6}".format(
            contig, start, end,
            "{0};{1};{2}".format(self.type, self.get_std_span(), self.get_std_pos()),
            self.score, ".", "[" + "][".join([ev.as_string("|") for ev in self.members]) + "]")

    def get_vcf_entry(self, sequence_alleles=False, reference=None,
                      insertion_sequences=False, read_names=False, zmws=False):
        contig, start, end = self.get_destination()
        if sequence_alleles and self.sequence != "":
            ref_allele = reference.fetch(contig, max(0, start - 1), max(0, start - 1) + 1).upper()
            alt_allele = ref_allele + self.sequence
        else:
            ref_allele, alt_allele = "N", "<" + self.type + ">"
        info = "SVTYPE={0};END={1};SVLEN={2};SUPPORT={3};STD_SPAN={4};STD_POS={5}".format(
            self.type, start, end - start, _support(self.members),
            self.get_std_span(), self.get_std_pos())
        info += _info_suffix(self.members, insertion_sequences=insertion_sequences,
                             read_names=read_names, zmws=zmws)
        return self._vcf_line(contig, max(1, start), ref_allele, alt_allele, info)


class CandidateDuplicationTandem(Candidate):
    """Tandem duplication candidate with dual DUP:TANDEM / INS representation
    (reference: SVCandidate.py:274-422)."""

    type = "DUP_TAN"

    def __init__(self, source_contig, source_start, source_end, copies, fully_covered,
                 members, score, std_span, std_pos, **kw):
        super().__init__(source_contig, max(0, source_start), source_end, members,
                         score, std_span, std_pos, **kw)
        self.copies = copies
        self.fully_covered = fully_covered

    def get_destination(self):
        source_contig, source_start, source_end = self.get_source()
        return (source_contig, source_end,
                source_end + self.copies * (source_end - source_start))

    def get_bed_entries(self, sep="\t"):
        source_contig, source_start, source_end = self.get_source()
        dest_contig, dest_start, dest_end = self.get_destination()
        members_str = "[" + "][".join([ev.as_string("|") for ev in self.members]) + "]"
        source_entry = sep.join(["{0}", "{1}", "{2}", "{3}", "{4}", "{5}", "{6}"]).format(
            source_contig, source_start, source_end,
            "tan_dup_source;>{0}:{1}-{2};{3};{4}".format(
                dest_contig, dest_start, dest_end, self.get_std_span(), self.get_std_pos()),
            self.score, ".", members_str)
        dest_entry = sep.join(["{0}", "{1}", "{2}", "{3}", "{4}", "{5}", "{6}"]).format(
            dest_contig, dest_start, dest_end,
            "tan_dup_dest;<{0}:{1}-{2};{3};{4}".format(
                source_contig, source_start, source_end, self.get_std_span(), self.get_std_pos()),
            self.score, ".", members_str)
        return (source_entry, dest_entry)

    def get_vcf_entry_as_ins(self, sequence_alleles=False, reference=None,
                             read_names=False, zmws=False):
        source_contig, source_start, source_end = self.get_source()
        dest_contig, dest_start, dest_end = self.get_destination()
        if sequence_alleles:
            ref_allele = reference.fetch(source_contig, source_start, source_end).upper()
            alt_allele = ref_allele * (self.copies + 1)
        else:
            ref_allele, alt_allele = "N", "<" + self.type + ">"
        info = "SVTYPE={0};END={1};SVLEN={2};SUPPORT={3};STD_SPAN={4};STD_POS={5}".format(
            "INS", source_end, dest_end - dest_start, _support(self.members),
            self.get_std_span(), self.get_std_pos())
        info += _info_suffix(self.members, read_names=read_names, zmws=zmws)
        extra = () if self.fully_covered else ("not_fully_covered",)
        return self._vcf_line(source_contig, source_start + 1, ref_allele, alt_allele,
                              info, extra_filters=extra)

    def get_vcf_entry_as_dup(self, read_names=False, zmws=False):
        contig, start, end = self.source_contig, self.source_start, self.source_end
        svtype = "DUP:TANDEM"
        info = "SVTYPE={0};END={1};SVLEN={2};SUPPORT={3};STD_SPAN={4};STD_POS={5}".format(
            svtype, end, end - start, _support(self.members),
            self.get_std_span(), self.get_std_pos())
        info += _info_suffix(self.members, read_names=read_names, zmws=zmws)
        extra = () if self.fully_covered else ("not_fully_covered",)
        samples = "{gt}:{cn}:{dp}:{ref},{alt}".format(
            gt=self.genotype, cn=self.copies + 1, dp=self._dp_string(),
            ref=self.ref_reads if self.ref_reads is not None else ".",
            alt=self.alt_reads if self.alt_reads is not None else ".")
        return self._vcf_line(contig, start + 1, "N", "<" + svtype + ">", info,
                              extra_filters=extra, format="GT:CN:DP:AD", samples=samples)


class CandidateDuplicationInterspersed(Candidate):
    """Interspersed duplication candidate, optionally flagged CUTPASTE
    (reference: SVCandidate.py:425-570)."""

    type = "DUP_INT"

    def __init__(self, source_contig, source_start, source_end, dest_contig,
                 dest_start, dest_end, members, score, std_span, std_pos,
                 cutpaste=False, **kw):
        super().__init__(source_contig, max(0, source_start), source_end, members,
                         score, std_span, std_pos, **kw)
        self.dest_contig = dest_contig
        self.dest_start = max(0, dest_start)
        self.dest_end = dest_end
        self.cutpaste = cutpaste

    def get_destination(self):
        return (self.dest_contig, self.dest_start, self.dest_end)

    def get_bed_entries(self, sep="\t"):
        source_contig, source_start, source_end = self.get_source()
        dest_contig, dest_start, dest_end = self.get_destination()
        members_str = "[" + "][".join([ev.as_string("|") for ev in self.members]) + "]"
        flag = "origin potentially deleted" if self.cutpaste else "."
        source_entry = sep.join(["{0}", "{1}", "{2}", "{3}", "{4}", "{5}", "{6}"]).format(
            source_contig, source_start, source_end,
            "int_dup_source;>{0}:{1}-{2};{3};{4}".format(
                dest_contig, dest_start, dest_end, self.get_std_span(), self.get_std_pos()),
            self.score, flag, members_str)
        dest_entry = sep.join(["{0}", "{1}", "{2}", "{3}", "{4}", "{5}", "{6}"]).format(
            dest_contig, dest_start, dest_end,
            "int_dup_dest;<{0}:{1}-{2};{3};{4}".format(
                source_contig, source_start, source_end, self.get_std_span(), self.get_std_pos()),
            self.score, flag, members_str)
        return (source_entry, dest_entry)

    def get_vcf_entry_as_ins(self, sequence_alleles=False, reference=None,
                             read_names=False, zmws=False):
        source_contig, source_start, source_end = self.get_source()
        dest_contig, dest_start, dest_end = self.get_destination()
        if sequence_alleles:
            ref_allele = reference.fetch(dest_contig, max(0, dest_start - 1),
                                         max(0, dest_start - 1) + 1).upper()
            alt_allele = ref_allele + reference.fetch(source_contig, source_start, source_end).upper()
        else:
            ref_allele, alt_allele = "N", "<" + self.type + ">"
        info = "SVTYPE={0};{1}END={2};SVLEN={3};SUPPORT={4};STD_SPAN={5};STD_POS={6}".format(
            "INS", "CUTPASTE;" if self.cutpaste else "", dest_start, dest_end - dest_start,
            _support(self.members), self.get_std_span(), self.get_std_pos())
        info += _info_suffix(self.members, read_names=read_names, zmws=zmws)
        return self._vcf_line(dest_contig, max(1, dest_start), ref_allele, alt_allele, info)

    def get_vcf_entry_as_dup(self, read_names=False, zmws=False):
        contig, start, end = self.get_source()
        svtype = "DUP:INT"
        info = "SVTYPE={0};{1}END={2};SVLEN={3};SUPPORT={4};STD_SPAN={5};STD_POS={6}".format(
            svtype, "CUTPASTE;" if self.cutpaste else "", end, end - start,
            _support(self.members), self.get_std_span(), self.get_std_pos())
        info += _info_suffix(self.members, read_names=read_names, zmws=zmws)
        return self._vcf_line(contig, start + 1, "N", "<" + svtype + ">", info)


class CandidateBreakend(Candidate):
    """Breakend candidate with the 4 BND bracket notations and a symmetric
    reverse record (reference: SVCandidate.py:573-737)."""

    type = "BND"

    def __init__(self, source_contig, source_start, source_direction, dest_contig,
                 dest_start, dest_direction, members, score, std_pos1, std_pos2, **kw):
        super().__init__(source_contig, max(0, source_start), max(0, source_start) + 1,
                         members, score, None, None, **kw)
        self.source_direction = source_direction
        self.dest_contig = dest_contig
        self.dest_start = max(0, dest_start)
        self.dest_direction = dest_direction
        self.std_pos1 = std_pos1
        self.std_pos2 = std_pos2

    def get_source(self):
        return (self.source_contig, self.source_start)

    def get_destination(self):
        return (self.dest_contig, self.dest_start)

    def get_std_pos1(self, ndigits=2):
        return round(self.std_pos1, ndigits) if self.std_pos1 else "."

    def get_std_pos2(self, ndigits=2):
        return round(self.std_pos2, ndigits) if self.std_pos2 else "."

    @staticmethod
    def _alt_string(source_direction, dest_direction, contig, pos):
        """BND bracket notation for a (source_direction, dest_direction) pair
        (reference: SVCandidate.py:643-650)."""
        if source_direction == "fwd" and dest_direction == "fwd":
            return "N[{0}:{1}[".format(contig, pos)
        if source_direction == "fwd" and dest_direction == "rev":
            return "N]{0}:{1}]".format(contig, pos)
        if source_direction == "rev" and dest_direction == "rev":
            return "]{0}:{1}]N".format(contig, pos)
        return "[{0}:{1}[N".format(contig, pos)

    def get_bed_entries(self, sep="\t"):
        source_contig, source_start = self.get_source()
        dest_contig, dest_start = self.get_destination()
        members_str = "[" + "][".join([ev.as_string("|") for ev in self.members]) + "]"
        source_entry = sep.join(["{0}", "{1}", "{2}", "{3}", "{4}", "{5}"]).format(
            source_contig, source_start, source_start + 1,
            "bnd;>{0}:{1};{2};{3}".format(dest_contig, dest_start,
                                          self.get_std_pos1(), self.get_std_pos2()),
            self.score, members_str)
        dest_entry = sep.join(["{0}", "{1}", "{2}", "{3}", "{4}", "{5}"]).format(
            dest_contig, dest_start, dest_start + 1,
            "bnd;<{0}:{1};{2};{3}".format(source_contig, source_start,
                                          self.get_std_pos1(), self.get_std_pos2()),
            self.score, members_str)
        return (source_entry, dest_entry)

    def _bnd_vcf_entry(self, chrom, pos, alt_string, std_first, std_second,
                       read_names, zmws):
        info = "SVTYPE={0};SUPPORT={1};STD_POS1={2};STD_POS2={3}".format(
            self.type, _support(self.members), std_first, std_second)
        info += _info_suffix(self.members, read_names=read_names, zmws=zmws)
        return self._vcf_line(chrom, pos + 1, "N", alt_string, info)

    def get_vcf_entry(self, read_names=False, zmws=False):
        source_contig, source_start = self.get_source()
        dest_contig, dest_start = self.get_destination()
        alt_string = self._alt_string(self.source_direction, self.dest_direction,
                                      dest_contig, dest_start + 1)
        return self._bnd_vcf_entry(source_contig, source_start, alt_string,
                                   self.get_std_pos1(), self.get_std_pos2(),
                                   read_names, zmws)

    def get_vcf_entry_reverse(self, read_names=False, zmws=False):
        # the mirrored record swaps the roles of the two breakpoints; its
        # bracket notation equals the forward table applied to the flipped
        # (dest, source) direction pair (SVCandidate.py:693-700)
        source_contig, source_start = self.get_destination()
        dest_contig, dest_start = self.get_source()
        flip = {"fwd": "rev", "rev": "fwd"}
        alt_string = self._alt_string(flip[self.dest_direction], flip[self.source_direction],
                                      dest_contig, dest_start + 1)
        return self._bnd_vcf_entry(source_contig, source_start, alt_string,
                                   self.get_std_pos2(), self.get_std_pos1(),
                                   read_names, zmws)
