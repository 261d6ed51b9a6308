"""Seeded input workloads that drive the port end to end.

- `golden_workload`: the simulated two-contig sample whose variants.vcf is
  pinned in tests/golden/variants.golden.vcf (the SimConfig of
  tests/test_golden_vcf.py), written by the host simulator (sim.py).
- `bench_workload`: bench.py's synthetic long-read sample (ONT-like reads
  of 3,000 CIGAR ops, DEL and INS loci at 24x coverage, split reads on 1 in
  12 background reads) at a given read count; the same bytes as
  `bench.make_workload` with SVIM_BENCH_READS set to that count.

Both write a coordinate-sorted BGZF BAM and a FASTA genome and return
(bam_path, genome_path).  Three rewrites of a BAM serve the port's other
input paths:

- `reblock_stored`: the same BAM as level-0 (stored) BGZF, so its size on
  disk is its inflated size and a 25 MB BAM crosses the 96 MiB streaming
  threshold with the same records;
- `sam_text`: the records as a SAM text file;
- `queryname_bam`: the records grouped by read name (SO:queryname), with
  each SA-tag entry of a primary written as a real supplementary record.
"""

from __future__ import annotations

import os
import random
import zlib

import numpy as np

from svim_tpu_torch.collect.collect import retrieve_other_alignments
from svim_tpu_torch.io import bam as bamio
from svim_tpu_torch.io.bamstream import scan_bgzf_blocks
from svim_tpu_torch.io.sam import AlignmentFile, AlignmentHeader, parse_sam_line

# the SimConfig of tests/test_golden_vcf.py
GOLDEN_SIM = dict(seed=42, genome_length=900_000, second_contig_length=250_000,
                  coverage=9, n_del=3, n_ins=3, n_inv=2, n_tan=2, n_dup_int=2,
                  n_bnd=2, n_background=50)

READ_LENGTH_OPS = 3000   # CIGAR ops per read
COVERAGE = 24            # reads supporting each SV locus


def golden_workload(directory):
    from svim_tpu_torch.sim import SimConfig, simulate

    genome, bam, _truth = simulate(directory, SimConfig(**GOLDEN_SIM))
    return bam, genome


def _noisy_cigar(rng, sv=None):
    """ONT-like CIGAR: many 1-8 bp indels; optionally one embedded SV op.
    Returns (cigar, seq_len, ref_len, sv_seq_pos, ref_before_sv)."""
    parts = []
    seq_len = 0
    ref_len = 0
    sv_seq_pos = -1
    ref_before_sv = -1
    half = READ_LENGTH_OPS // 2
    sv_at = rng.randint(half // 4, 3 * half // 4) if sv else -1
    for k in range(half):
        m = rng.randint(3, 15)
        parts.append("{0}M".format(m))
        seq_len += m
        ref_len += m
        if k == sv_at:
            op, length = sv
            parts.append("{0}{1}".format(length, op))
            ref_before_sv = ref_len
            if op == "I":
                sv_seq_pos = seq_len
                seq_len += length
            else:
                ref_len += length
            continue
        op = rng.choice("ID")
        length = rng.randint(1, 8)
        parts.append("{0}{1}".format(length, op))
        if op == "I":
            seq_len += length
        else:
            ref_len += length
    parts.append("20M")
    return ("".join(parts), seq_len + 20, ref_len + 20, sv_seq_pos,
            ref_before_sv)


def bench_workload(directory, reads):
    """DEL and INS loci (one per 85 reads, at least 8 each) of COVERAGE
    reads sharing one breakpoint, then background reads with indel noise,
    1 in 12 of them split to chr2."""
    n_del_loci = max(8, reads // 85)
    n_ins_loci = max(8, reads // 85)
    genome_span = max(12_000_000, reads * 6_000)
    rng = random.Random(1234)
    header = AlignmentHeader.from_text(
        "@HD\tVN:1.6\tSO:coordinate\n"
        "@SQ\tSN:chr1\tLN:200000000\n@SQ\tSN:chr2\tLN:150000000\n")
    records = []

    def add_read(start, cigar, seq, tags=""):
        line = "read{0}\t0\tchr1\t{1}\t60\t{2}\t*\t0\t0\t{3}\t*{4}".format(
            len(records), start + 1, cigar, seq, tags)
        records.append(parse_sam_line(line, header))

    for _ in range(n_del_loci):
        locus_pos = rng.randint(100_000, genome_span)
        size = rng.randint(60, 800)
        for _ in range(COVERAGE):
            cigar, seq_len, _, _, ref_before = _noisy_cigar(
                rng, sv=("D", size + rng.randint(-3, 3)))
            add_read(locus_pos - ref_before + rng.randint(-10, 10), cigar,
                     "A" * seq_len)

    for _ in range(n_ins_loci):
        locus_pos = rng.randint(100_000, genome_span)
        size = rng.randint(60, 500)
        motif = "".join(rng.choice("ACGT") for _ in range(size))
        for _ in range(COVERAGE):
            noisy = list(motif)
            for _ in range(rng.randint(0, 4)):
                noisy[rng.randrange(len(noisy))] = rng.choice("ACGT")
            insert = "".join(noisy)
            cigar, seq_len, _, sv_pos, ref_before = _noisy_cigar(
                rng, sv=("I", len(insert)))
            seq = ("A" * sv_pos + insert
                   + "A" * (seq_len - sv_pos - len(insert)))
            add_read(locus_pos - ref_before + rng.randint(-10, 10), cigar, seq)

    for i in range(max(0, reads - len(records))):
        cigar, seq_len, _, _, _ = _noisy_cigar(rng)
        tags = ""
        if i % 12 == 0:
            tags = "\tSA:Z:chr2,{0},+,{1}S{2}M,60,0;".format(
                rng.randint(1, 100000000), seq_len - 500, 500)
        add_read(rng.randint(0, genome_span), cigar, "A" * seq_len, tags)

    records.sort(key=lambda record: record.reference_start)
    bam_path = os.path.join(directory, "bench.bam")
    bamio.write_bam(bam_path, header, records)

    genome_path = os.path.join(directory, "genome.fa")
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    chunk = genome_span // 60 + 1
    genome = bases[np.random.default_rng(5).integers(0, 4, size=chunk * 60)]
    with open(genome_path, "wb") as handle:
        # chr1 covers every locus, so INS clustering fetches real windows
        handle.write(b">chr1\n")
        for row in genome.reshape(chunk, 60):
            handle.write(row.tobytes() + b"\n")
        handle.write(b">chr2\n" + b"ACGT" * 2500 + b"\n")
    return bam_path, genome_path


def reblock_stored(bam, out):
    """Rewrite a BGZF BAM as level-0 BGZF (stored deflate blocks): the same
    records and the same inflated stream.  Returns `out`.

    Inflates member by member: gzip.decompress copies the rest of the
    stream after each member, quadratic over a BAM's thousands of blocks."""
    with open(bam, "rb") as handle:
        data = handle.read()
    view = memoryview(data)
    inflated = b"".join(
        zlib.decompress(view[offset:offset + size], 31)
        for offset, size, _isize in scan_bgzf_blocks(data))
    with open(out, "wb") as handle:
        handle.write(bamio.bgzf_compress(inflated, level=0))
    return out


def _header_text(header, sort_order):
    return "".join(["@HD\tVN:1.6\tSO:{0}\n".format(sort_order)] + [
        "@SQ\tSN:{0}\tLN:{1}\n".format(name, length)
        for name, length in zip(header.references, header.lengths)])


def _sam_tag(name, value, value_type):
    if value_type is None:
        value_type = ("i" if isinstance(value, int)
                      else "Z" if isinstance(value, str) else "f")
    if value_type in "cCsSI":   # BAM's integer widths are SAM's `i`
        value_type = "i"
    return "{0}:{1}:{2}".format(name, value_type, value)


def _sam_line(record, header):
    def contig(tid):
        return header.get_reference_name(tid) if tid >= 0 else "*"

    qualities = ("*" if record.query_qualities is None
                 else "".join(chr(q + 33) for q in record.query_qualities))
    fields = [record.query_name, str(record.flag),
              contig(record.reference_id), str(record.reference_start + 1),
              str(record.mapping_quality),
              record.cigarstring if record.cigartuples else "*",
              contig(record.next_reference_id),
              str(record.next_reference_start + 1),
              str(record.template_length), record.query_sequence or "*",
              qualities]
    fields += [_sam_tag(name, value, value_type)
               for name, (value, value_type) in record.tags.items()]
    return "\t".join(fields) + "\n"


def sam_text(bam, out):
    """Write the records of `bam` as SAM text, coordinate-sorted as they
    come.  Returns `out`."""
    alignments = AlignmentFile(bam)
    with open(out, "w") as handle:
        handle.write(_header_text(alignments.header, "coordinate"))
        for record in alignments.fetch(until_eof=True):
            handle.write(_sam_line(record, alignments.header))
    return out


def queryname_bam(bam, out):
    """Write the records of `bam` grouped by read name (a stable sort by
    name, SO:queryname), each primary followed by a real supplementary
    record for every entry of its SA tag.  Returns `out`."""
    alignments = AlignmentFile(bam)
    records = []
    for record in alignments.fetch(until_eof=True):
        records.append(record)
        if not (record.is_supplementary or record.is_secondary):
            records.extend(retrieve_other_alignments(record, alignments))
    records.sort(key=lambda record: record.query_name)
    header = AlignmentHeader.from_text(_header_text(alignments.header,
                                                    "queryname"))
    bamio.write_bam(out, header, records)
    return out
