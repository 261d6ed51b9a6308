"""SA-tag reconstruction in the port (svim_tpu_torch.collect.collect.
retrieve_other_alignments over svim_tpu_torch.io) against svim_tpu's on the
same inputs: the twin of tests/test_satag.py.  Supplementary alignments
rebuilt from a primary's SA tag must match the real supplementary records
and svim_tpu's reconstruction field for field; a hard-clipped primary and a
primary without an SA tag give none.  The split reads of the sample
workload (an SA:Z partner on the second contig) go through both packages'
reconstruction too."""

import json
import random

import pytest

from svim_tpu.collect.collect import (
    retrieve_other_alignments as jax_retrieve,
)
from svim_tpu.io.sam import AlignmentFile as JaxAlignmentFile
from svim_tpu.io.sam import AlignmentHeader as JaxAlignmentHeader
from svim_tpu.io.sam import parse_sam_line as jax_parse_sam_line
from svim_tpu_torch import workloads
from svim_tpu_torch.collect.collect import retrieve_other_alignments
from svim_tpu_torch.io.sam import (
    AlignmentFile,
    AlignmentHeader,
    parse_sam_line,
)

HEADER = ("@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:1000000\n"
          "@SQ\tSN:chr2\tLN:800000\n")


def _make_chimeric_sam(tmp_path):
    """One read split into a primary + two supplementary alignments with
    mutually consistent SA tags."""
    rng = random.Random(7)
    seq = "".join(rng.choice("ACGT") for _ in range(3000))
    prim_cigar = "1000M2000S"
    sup1_cigar = "1000S1000M1000S"
    sup2_cigar = "2000S1000M"
    sa_of_primary = "chr1,50001,+,{0},60,5;chr2,70001,+,{1},55,3;".format(
        sup1_cigar, sup2_cigar)
    lines = [
        "read1\t0\tchr1\t10001\t60\t{0}\t*\t0\t0\t{1}\t*\tSA:Z:{2}".format(
            prim_cigar, seq, sa_of_primary),
        "read1\t2048\tchr1\t50001\t60\t{0}\t*\t0\t0\t{1}\t*\tNM:i:5".format(
            sup1_cigar, seq),
        "read1\t2048\tchr2\t70001\t55\t{0}\t*\t0\t0\t{1}\t*\tNM:i:3".format(
            sup2_cigar, seq),
    ]
    path = tmp_path / "chimeric.sam"
    path.write_text(HEADER + "\n".join(lines) + "\n")
    return str(path)


def _fields(alignment):
    return (alignment.query_name, alignment.flag, alignment.reference_id,
            alignment.reference_start, alignment.mapping_quality,
            alignment.cigarstring, alignment.query_sequence,
            alignment.get_tag("NM") if alignment.has_tag("NM") else None)


def _primaries(alignments):
    return [alignment for alignment in alignments
            if not alignment.is_supplementary and not alignment.is_secondary]


def test_sa_reconstruction_matches_real_supplementaries(tmp_path):
    path = _make_chimeric_sam(tmp_path)
    bam = AlignmentFile(path)
    alignments = list(bam.fetch(until_eof=True))
    primary = _primaries(alignments)
    supplementary = [aln for aln in alignments if aln.is_supplementary]
    assert len(primary) == 1 and len(supplementary) == 2
    reconstructed = retrieve_other_alignments(primary[0], bam)
    assert len(reconstructed) == 2
    for rec, actual in zip(
            sorted(reconstructed,
                   key=lambda a: (a.reference_id, a.reference_start)),
            sorted(supplementary,
                   key=lambda a: (a.reference_id, a.reference_start))):
        assert rec.query_name == actual.query_name
        assert rec.is_supplementary and not rec.is_reverse
        assert rec.reference_id == actual.reference_id
        assert rec.reference_start == actual.reference_start
        assert rec.mapping_quality in (60, 55)
        assert rec.cigarstring == actual.cigarstring
        assert rec.get_tag("NM") == actual.get_tag("NM")
    jax_bam = JaxAlignmentFile(path)
    jax_primary = _primaries(jax_bam.fetch(until_eof=True))
    assert [_fields(rec) for rec in reconstructed] == [
        _fields(rec) for rec in jax_retrieve(jax_primary[0], jax_bam)]


@pytest.mark.parametrize("line", [
    "read2\t0\tchr1\t100\t60\t10H100M\t*\t0\t0\t*\t*\t"
    "SA:Z:chr1,500,+,100M,60,0;",
    "read3\t0\tchr1\t100\t60\t100M\t*\t0\t0\t*\t*"],
    ids=["hard_clipped_primary", "no_sa_tag"])
def test_primaries_that_return_nothing(line):
    class _Bam:
        def __init__(self, header):
            self.header = header

        def get_tid(self, name):
            return self.header.get_tid(name)

    header = AlignmentHeader.from_text(HEADER)
    jax_header = JaxAlignmentHeader.from_text(HEADER)
    assert retrieve_other_alignments(parse_sam_line(line, header),
                                     _Bam(header)) == []
    assert jax_retrieve(jax_parse_sam_line(line, jax_header),
                        _Bam(jax_header)) == []


def test_the_sample_split_reads_reconstruct_as_in_svim_tpu(tmp_path):
    bam, _genome = workloads.sample_workload(
        str(tmp_path), 5, contig_length=1_000_000, partner_length=500_000,
        depth=8, ins_sizes=(50, 300))
    alignments = AlignmentFile(bam)
    jax_alignments = JaxAlignmentFile(bam)
    split = 0
    for record, jax_record in zip(alignments.fetch(until_eof=True),
                                  jax_alignments.fetch(until_eof=True)):
        ours = retrieve_other_alignments(record, alignments)
        theirs = jax_retrieve(jax_record, jax_alignments)
        assert [_fields(rec) for rec in ours] == [_fields(rec)
                                                 for rec in theirs]
        if record.has_tag("SA"):
            split += 1
            (partner,) = ours
            assert partner.reference_id == 1 and partner.is_supplementary
            assert partner.cigarstring == "{0}S{1}M".format(
                len(record.query_sequence) - workloads.SAMPLE_SPLIT_SPAN,
                workloads.SAMPLE_SPLIT_SPAN)
    with open(tmp_path / workloads.SAMPLE_FILE) as handle:
        assert split == json.load(handle)["split_reads"] > 10
