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

`chunked_scan` delivers a one-shot scan's rows in fixed chunks, so that a
small input drives the mid-scan consume and clustering path.

`stub_aligners` puts executable stand-ins for ngmlr, minimap2, samtools and
gunzip on PATH, so that `reads` mode runs where no aligner is installed:
the aligner stubs emit a prepared SAM stream, the samtools stub sorts it
into a real BGZF BAM with this package's io layer.
"""

from __future__ import annotations

import contextlib
import os
import random
import stat
import sys
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


@contextlib.contextmanager
def chunked_scan(chunk):
    """While active, the native scan session hands the one-shot COLLECT
    loop its rows in `chunk`-sized claims, as a walker slower than the
    consumer would.  A small file otherwise arrives in one claim (the
    session gives a caller everything scanned so far), and one claim never
    reaches the mid-scan consume and incremental clustering of
    collect/packed.py.  The rows, and so the output, are the same."""
    from svim_tpu_torch import native

    original = native.BamScanSession.next_rows
    buffers = {}

    def chunked(self, min_rows):
        buffer = buffers.get(id(self))
        if buffer is None:
            buffers[id(self)] = buffer = list(original(self, min_rows))
        row_start, remaining, max_ops, body, done = buffer
        take = min(chunk, remaining)
        buffer[0] += take
        buffer[1] -= take
        if buffer[1] == 0:
            buffers.pop(id(self))   # claim a fresh range next call
        return (row_start, take, max_ops, body, done and buffer[1] == 0)

    native.BamScanSession.next_rows = chunked
    try:
        yield
    finally:
        native.BamScanSession.next_rows = original


_ALIGNER_STUB = """#!{python}
import os, sys
with open(os.environ["SVIM_STUB_LOG"], "a") as log:
    log.write("{name} " + " ".join(sys.argv[1:]) + "\\n")
if "--help" in sys.argv:
    sys.exit(0)
if "-q" not in sys.argv and not sys.stdin.isatty():
    # reads piped in (gunzip -c ... | ngmlr): consume them as the aligner
    # would, or the upstream stage dies on EPIPE under pipefail
    sys.stdin.read()
with open(os.environ["SVIM_STUB_SAM"]) as sam:
    sys.stdout.write(sam.read())
"""

_SAMTOOLS_STUB = """#!{python}
import os, sys
sys.path.insert(0, {root!r})
with open(os.environ["SVIM_STUB_LOG"], "a") as log:
    log.write("samtools " + " ".join(sys.argv[1:]) + "\\n")
if "--help" in sys.argv:
    sys.exit(0)
mode = sys.argv[1]
if mode == "view":
    sys.stdout.write(sys.stdin.read())       # SAM text passes through
elif mode == "sort":
    out_path = sys.argv[sys.argv.index("-o") + 1]
    from svim_tpu_torch.io.sam import AlignmentHeader, parse_sam_line
    from svim_tpu_torch.io import bam as bamio
    header_lines, records = [], []
    header = None
    for line in sys.stdin:
        if line.startswith("@"):
            header_lines.append(line.rstrip("\\n"))
            continue
        if header is None:
            header = AlignmentHeader.from_text("\\n".join(header_lines))
        if line.strip():
            records.append(parse_sam_line(line, header))
    records.sort(key=lambda r: (r.reference_id, r.reference_start))
    # stamp the coordinate sort order the pipeline dispatches on
    text = "\\n".join(l for l in header_lines if not l.startswith("@HD"))
    header = AlignmentHeader.from_text("@HD\\tVN:1.6\\tSO:coordinate\\n" + text)
    bamio.write_bam(out_path, header, records)
elif mode == "index":
    with open(sys.argv[2] + ".bai", "wb") as handle:
        handle.write(b"BAI\\x01")
"""

_GUNZIP_STUB = """#!{python}
import sys
if "--help" in sys.argv:
    sys.exit(0)
import gzip
with gzip.open(sys.argv[-1], "rt") as handle:
    sys.stdout.write(handle.read())
"""


@contextlib.contextmanager
def stub_aligners(directory, sam_path):
    """While active, PATH starts with `directory`/bin holding stub ngmlr,
    minimap2, samtools and gunzip executables: the aligners write the SAM
    text at `sam_path` to their standard output, `samtools sort` turns what
    it reads into a coordinate-sorted BGZF BAM, `samtools index` leaves a
    .bai marker.  Yields the path of the log that every stub call appends
    its argv to (one line a call, the --help probes included)."""
    bin_dir = os.path.join(directory, "bin")
    os.makedirs(bin_dir, exist_ok=True)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for name, template in (("ngmlr", _ALIGNER_STUB),
                           ("minimap2", _ALIGNER_STUB),
                           ("samtools", _SAMTOOLS_STUB),
                           ("gunzip", _GUNZIP_STUB)):
        path = os.path.join(bin_dir, name)
        with open(path, "w") as handle:
            handle.write(template.format(python=sys.executable, name=name,
                                         root=root))
        os.chmod(path, os.stat(path).st_mode | stat.S_IXUSR | stat.S_IXGRP
                 | stat.S_IXOTH)
    log_path = os.path.join(directory, "stub_calls.log")
    with open(log_path, "w"):
        pass
    changed = {"PATH": bin_dir + os.pathsep + os.environ.get("PATH", ""),
               "SVIM_STUB_SAM": sam_path, "SVIM_STUB_LOG": log_path}
    saved = {name: os.environ.get(name) for name in changed}
    os.environ.update(changed)
    try:
        yield log_path
    finally:
        for name, value in saved.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value
