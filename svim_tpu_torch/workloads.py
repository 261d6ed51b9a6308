"""Seeded input workloads that drive the port end to end.

- `golden_workload`: the simulated two-contig sample whose variants.vcf is
  pinned in tests/golden/variants.golden.vcf (the SimConfig of
  tests/test_golden_vcf.py), written by the host simulator (sim.py).
- `bench_workload`: bench.py's synthetic long-read sample (ONT-like reads
  of 3,000 CIGAR ops, DEL and INS loci at 24x coverage, split reads on 1 in
  12 background reads) at a given read count; the same bytes as
  `bench.make_workload` with SVIM_BENCH_READS set to that count.
- `tiefree_workload`: the same kind of sample with loci whose reads never
  share a position or a size, so that the device clustering labels most of
  its partitions (on bench every partition has an exact distance tie and is
  resolved on the host).

All three write a coordinate-sorted BGZF BAM and a FASTA genome and return
(bam_path, genome_path).  The two accuracy harnesses of
scripts/eval_accuracy.py, which hold all six SV classes and a truth set:

- `stress_workload`: its `--big` stress simulation (sim.py; 54 Mb over
  five contigs, 15% of each contig under repeat arrays, 12% per-base read
  noise, cut&paste DUP:INT);
- `independent_workload`: its `--independent` donor-genome projection
  (sim2.py; reads from both strands and both haplotypes).

Both return (genome_path, bam_path, truth) as the simulators do and write
the truth set as truth.json beside the BAM (`load_truth` reads it back).
Three rewrites of a BAM serve the port's other input paths:

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
import json
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


# the SimConfig of scripts/eval_accuracy.py --big, but for its seed
STRESS_SIM = dict(genome_length=18_000_000, second_contig_length=4_000_000,
                  extra_contigs=(14_000_000, 10_000_000, 8_000_000),
                  coverage=8, n_del=50, n_ins=50, n_inv=35, n_tan=35,
                  n_dup_int=15, n_dup_int_cutpaste=10, n_bnd=20,
                  n_background=2500, error_rate=0.12, repeat_fraction=0.15)
TRUTH_FILE = "truth.json"


def _save_truth(directory, generator, truth):
    with open(os.path.join(directory, TRUTH_FILE), "w") as handle:
        json.dump({"generator": generator,
                   "records": [variant._asdict() for variant in truth]},
                  handle)


def load_truth(directory):
    """The truth set that stress_workload or independent_workload wrote
    into `directory`, as the simulator's records."""
    from svim_tpu_torch.sim import TruthVariant
    from svim_tpu_torch.sim2 import Truth

    with open(os.path.join(directory, TRUTH_FILE)) as handle:
        saved = json.load(handle)
    record = {"sim": TruthVariant, "sim2": Truth}[saved["generator"]]
    return [record(**fields) for fields in saved["records"]]


def stress_workload(directory, seed=1, **changes):
    """scripts/eval_accuracy.py --big at `seed`: sim.simulate with
    STRESS_SIM, written into `directory` with its truth set.  `changes`
    replace fields of the configuration (the CPU tests' smaller sizes).
    Returns (genome_path, bam_path, truth)."""
    from svim_tpu_torch.sim import SimConfig, simulate

    config = SimConfig(seed=seed, **dict(STRESS_SIM, **changes))
    genome, bam, truth = simulate(directory, config)
    _save_truth(directory, "sim", truth)
    return genome, bam, truth


def independent_workload(directory, seed=1, **changes):
    """scripts/eval_accuracy.py --independent at `seed`:
    sim2.simulate_independent with Sim2Config(seed=seed), written into
    `directory` with its truth set.  `changes` replace fields of the
    configuration (the CPU tests' smaller sizes).  Returns (genome_path,
    bam_path, truth)."""
    from svim_tpu_torch.sim2 import Sim2Config, simulate_independent

    genome, bam, truth = simulate_independent(
        directory, Sim2Config(seed=seed, **changes))
    _save_truth(directory, "sim2", truth)
    return genome, bam, truth


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

    return _write_workload(directory, "bench.bam", header, records,
                           genome_span)


def _write_workload(directory, bam_name, header, records, genome_span):
    """The records as a coordinate-sorted BGZF BAM and a random genome FASTA
    whose chr1 covers `genome_span`.  Returns (bam_path, genome_path)."""
    records.sort(key=lambda record: record.reference_start)
    bam_path = os.path.join(directory, bam_name)
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


# tiefree_workload: reads a locus, and the few loci wide enough for the
# 128-slot bucket of the device clustering
TIEFREE_COVERAGE = (8, 16)
TIEFREE_WIDE_LOCI = 3
TIEFREE_WIDE_COVERAGE = (40, 100)
TIEFREE_POSITION_JITTER = {"D": 120, "I": 20}   # bp each way, by SV op
TIEFREE_SIZE_JITTER = 0.08   # of the locus's size, each way
# the first wide locus of each type has TIEFREE_SEPARATED_COVERAGE reads; the
# DEL one is the separated locus: its jitter, and the margins its merge
# sequence must keep (four times the device clustering's float32
# guard of 3e-4 between a step's best and second-best pair; every merge
# height clear of the default --cluster_max_distance)
TIEFREE_SEPARATED_COVERAGE = 40
TIEFREE_SEPARATED_JITTER = (300, 0.15)
TIEFREE_SEPARATED_GAP = 1.2e-3
TIEFREE_SEPARATED_CUT = (0.5, 0.02)


def _merge_margins(starts, spans, normalizer=900.0):
    """Exact float64 average linkage over the span-position distances of
    deletion signatures (|dcenter| / normalizer + |dspan| / max span), by
    global argmin: (the smallest relative gap between a step's best pair
    and its runner-up, the merge heights)."""
    centers = (2 * starts + spans) // 2
    d = (np.abs(centers[:, None] - centers[None, :]) / normalizer
         + np.abs(spans[:, None] - spans[None, :])
         / np.maximum(np.maximum(spans[:, None], spans[None, :]), 1))
    n = len(starts)
    np.fill_diagonal(d, np.inf)
    sizes = np.ones(n)
    heights = []
    min_gap = np.inf
    with np.errstate(invalid="ignore"):
        for _ in range(n - 1):
            lo, hi = sorted(divmod(int(np.argmin(d)), n))
            best = d[lo, hi]
            rest = d.copy()
            rest[lo, hi] = rest[hi, lo] = np.inf
            second = rest.min()
            if np.isfinite(second):
                min_gap = min(min_gap, (second - best) / max(best, 1.0))
            row = (sizes[lo] * d[lo] + sizes[hi] * d[hi]) \
                / (sizes[lo] + sizes[hi])
            d[lo, :] = row
            d[:, lo] = row
            d[hi, :] = np.inf
            d[:, hi] = np.inf
            d[lo, lo] = np.inf
            sizes[lo] += sizes[hi]
            heights.append(best)
    return min_gap, heights


def _separated_offsets(rng, size):
    """Position and size offsets of TIEFREE_SEPARATED_COVERAGE deletion
    reads, redrawn until no two pairs are at one distance, every step of
    their exact average linkage has a clear winner and every height is
    clear of the cut: a partition of the 128-slot bucket whose device
    labeling the float32 guard accepts (a random draw of that many reads
    hardly ever is: its pair distances lie too close)."""
    coverage = TIEFREE_SEPARATED_COVERAGE
    shift, fraction = TIEFREE_SEPARATED_JITTER
    reach = int(size * fraction)
    cut, margin = TIEFREE_SEPARATED_CUT
    while True:
        shifts = rng.sample(range(-shift, shift + 1), coverage)
        resizes = rng.sample(range(-reach, reach + 1), coverage)
        min_gap, heights = _merge_margins(
            np.asarray(shifts, dtype=np.int64),
            size + np.asarray(resizes, dtype=np.int64))
        if min_gap >= TIEFREE_SEPARATED_GAP and heights[-1] < cut - margin \
                and all(abs(height - cut) > margin for height in heights):
            return shifts, resizes


def tiefree_workload(directory, reads=8192, wide_loci=TIEFREE_WIDE_LOCI):
    """The bench workload's kind of sample (ONT-like reads, DEL and INS
    loci, one of each per 85 reads, background reads with 1 in 12 split to
    chr2), built so that the device labels most of its partitions: bench's
    loci (24 reads within 3 bp of one size and 10 bp of one position)
    always hold two pairs at the same float64 distance, which the CLUSTER
    stage resolves on the host before any device work.

    Here a locus has 8 to 16 reads whose positions (within
    TIEFREE_POSITION_JITTER bp) and sizes (within TIEFREE_SIZE_JITTER of
    the locus's size) are drawn without repeats, so no two reads share a
    (start, span), exact distance ties are rare, and the gaps between
    merge heights mostly clear the float32 guard; the jitter is small
    enough that a locus stays one partition and one cluster under the
    default --partition_max_distance and --cluster_max_distance.  The first
    `wide_loci` loci of each type have 40 to 100 reads and fill the
    128-slot bucket; so many reads lie too close for the float32 guard, so
    the first deletion locus is drawn until its merges are separated
    (_separated_offsets) and is the bucket's accepted labeling.

    `wide_loci` is a knob for the CPU tests only; the workload proper is
    the default.  A wide insertion locus is thousands of haplotype pairs,
    too many for the plain wavefront loop on the CPU, so the tests' small
    samples pass 0 or 1 (and with 0 the 128-slot bucket stays empty).
    Writes tiefree.bam and genome.fa into `directory` and returns their
    paths."""
    n_loci = max(8, reads // 85)
    genome_span = max(12_000_000, reads * 6_000)
    rng = random.Random(4321)
    header = AlignmentHeader.from_text(
        "@HD\tVN:1.6\tSO:coordinate\n"
        "@SQ\tSN:chr1\tLN:200000000\n@SQ\tSN:chr2\tLN:150000000\n")
    records = []

    def add_read(start, cigar, seq, tags=""):
        line = "read{0}\t0\tchr1\t{1}\t60\t{2}\t*\t0\t0\t{3}\t*{4}".format(
            len(records), start + 1, cigar, seq, tags)
        records.append(parse_sam_line(line, header))

    def locus(index, op, low, high):
        """(position, size, per-read position and size offsets)."""
        position = rng.randint(100_000, genome_span)
        wide = index < wide_loci
        # a wide locus needs as many distinct sizes as it has reads
        size = rng.randint(3 * high // 4 if wide else low, high)
        coverage = rng.randint(*(TIEFREE_WIDE_COVERAGE if wide
                                 else TIEFREE_COVERAGE))
        if index == 0 and wide:
            # the fewest reads that fill the 128-slot bucket: the fewest
            # pairs, so the best chance that no two are at one distance
            coverage = TIEFREE_SEPARATED_COVERAGE
        shift = max(TIEFREE_POSITION_JITTER[op], coverage // 2)
        reach = max(int(size * TIEFREE_SIZE_JITTER), coverage)
        return (position, size,
                rng.sample(range(-shift, shift + 1), coverage),
                rng.sample(range(-reach, reach + 1), coverage))

    for index in range(n_loci):
        position, size, shifts, resizes = locus(index, "D", 300, 2000)
        if index == 0 and wide_loci:
            shifts, resizes = _separated_offsets(rng, size)
        for shift, resize in zip(shifts, resizes):
            cigar, seq_len, _, _, ref_before = _noisy_cigar(
                rng, sv=("D", size + resize))
            add_read(position - ref_before + shift, cigar, "A" * seq_len)

    for index in range(n_loci):
        position, size, shifts, resizes = locus(index, "I", 400, 1200)
        reach = max(abs(resize) for resize in resizes)
        motif = "".join(rng.choice("ACGT") for _ in range(size + reach))
        for shift, resize in zip(shifts, resizes):
            noisy = list(motif[:size + resize])
            for _ in range(rng.randint(0, 4)):
                noisy[rng.randrange(len(noisy))] = rng.choice("ACGT")
            insert = "".join(noisy)
            cigar, seq_len, _, sv_pos, ref_before = _noisy_cigar(
                rng, sv=("I", len(insert)))
            seq = ("A" * sv_pos + insert
                   + "A" * (seq_len - sv_pos - len(insert)))
            add_read(position - ref_before + shift, cigar, seq)

    for i in range(max(0, reads - len(records))):
        cigar, seq_len, _, _, _ = _noisy_cigar(rng)
        tags = ""
        if i % 12 == 0:
            tags = "\tSA:Z:chr2,{0},+,{1}S{2}M,60,0;".format(
                rng.randint(1, 100000000), seq_len - 500, 500)
        add_read(rng.randint(0, genome_span), cigar, "A" * seq_len, tags)

    return _write_workload(directory, "tiefree.bam", header, records,
                           genome_span)


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
