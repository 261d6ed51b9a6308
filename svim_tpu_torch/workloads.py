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
At the scale a user runs:

- `sample_workload`: a chromosome of a 30x ONT-like sample (~114,000 reads
  of _noisy_cigar's distribution on a contig the length of GRCh38 chr20,
  560 DEL and INS loci whose reads do not share breakpoints, split
  partners on a second contig), built as arrays and written as BAM record
  bytes; a 1.1 GB BAM that the CLI streams, with truth.json;
- `sample_classes_workload`: the same with 60 loci of each split-read
  class (INV, DUP:TANDEM, DUP:INT with multi-copy sources, BND) beside the
  DEL and INS loci, their reads' breakpoints drawn so that no split-read
  partition has an exact tie: all six classes labelled on the device.
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
import functools
import json
import os
import random
import stat
import struct
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


# sample_workload: a chromosome of a 30x ONT-like sample, at the widths of
# _noisy_cigar's reads
SAMPLE = dict(contig_length=64_444_167,    # GRCh38 chr20, the SV host
              partner_length=46_709_983,   # GRCh38 chr21: split partners
              depth=30,
              loci=None,             # per type; None: a locus a 115 kb
              ins_sizes=(50, 3000),  # bp, log-uniform
              split_loci=None)       # loci a split-read class; None: none
SAMPLE_DEL_SIZES = (50, 5000)   # bp, log-uniform
SAMPLE_COVERAGE = (12, 30)      # reads a locus
SAMPLE_LOCUS_GAP = 5000         # bp from a locus's end to the next
SAMPLE_SPLIT_EVERY = 12         # background reads per SA-tagged one
SAMPLE_CONTIGS = ("chr20", "chr21")
SAMPLE_LOCUS_SPAN = 115_000   # bp of contig per SV locus, of either type
SAMPLE_MARGIN = 50_000        # bp kept free of loci at either end of the host
# _noisy_cigar's read: NOISE_PAIRS (match, indel) pairs and a closing 20M
NOISE_PAIRS = READ_LENGTH_OPS // 2
SAMPLE_OPS = READ_LENGTH_OPS + 1
SAMPLE_MEAN_SPAN = NOISE_PAIRS * 9 + NOISE_PAIRS // 2 * 9 // 2 + 20   # bp
SAMPLE_SPLIT_SPAN = 500       # bp of a split partner's alignment
SAMPLE_CHUNK = 2048           # reads built and written at a time
SAMPLE_BGZF_LEVEL = 1
SAMPLE_FILE = "sample.json"
_BASE_CODES = np.array([1, 2, 4, 8], dtype=np.uint8)   # BAM's A, C, G, T
_CIGAR_I, _CIGAR_D, _CIGAR_S = 1, 2, 4
# the split-read loci (`split_loci`), placed between the DEL and INS loci
SAMPLE_SPLIT_CLASSES = ("INV", "DUP:TANDEM", "DUP:INT", "BND")
SAMPLE_SPLIT_SIZES = {"INV": (300, 10_000), "DUP:TANDEM": (100, 5_000),
                      "DUP:INT": (200, 5_000)}   # bp, log-uniform
# reads of a wide locus, which takes the 128-slot bucket: INV, DUP:TANDEM
# and DUP:INT; BND, whose n reads need n(n-1)/2 distinct integer breakpoint
# distances (_ruler_offsets), so that their spread grows as n^2
SAMPLE_WIDE_COVERAGE = {"span": (40, 100), "ruler": (40, 60)}
SAMPLE_SIZE_PER_READ = {False: 8, True: 25}   # bp of SV at least, by wide
# a class's wide loci, and the DUP:INT sources copied to several
# destinations (this many each): one of each per 20 split-read loci, 1 to 3
SAMPLE_DUP_COPIES = (3, 4, 5)
SAMPLE_END_JITTER = 120       # bp each way of an INV or DUP:TANDEM end, most
SAMPLE_TAIL = (400, 900)      # bp a supplementary runs past its breakpoint
# bp between a DUP:INT source and its destinations at least: past
# --max_sv_size (100 kb), so that the read's segments pair as two
# translocations (collect/inter.py) rather than a deletion or a tandem
SAMPLE_SOURCE_DISTANCE = 150_000
# read kinds of the split-read loci: the primary's breakpoint is its
# reference end (a soft clip after it), or its start (INV_RIGHT: a reverse
# primary, the clip before it)
_INV_LEFT, _INV_RIGHT, _DUP_TAN, _DUP_INT, _BND = range(5)


def _distinct_offsets(rng, reach, count):
    """`count` distinct integers in [-reach, reach]."""
    return rng.choice(2 * reach + 1, size=count, replace=False) - reach


def _sample_loci(rng, config):
    """(ops, positions, sizes, per-locus (shifts, resizes, motif)): DEL and
    INS loci placed uniformly over the host contig, SAMPLE_LOCUS_GAP
    apart."""
    length = config["contig_length"]
    per_type = config["loci"]
    if per_type is None:
        per_type = round(length / (2 * SAMPLE_LOCUS_SPAN))
    ops = rng.permutation(np.repeat(
        np.array([_CIGAR_D, _CIGAR_I], dtype=np.int64), per_type))
    low = np.where(ops == _CIGAR_D, SAMPLE_DEL_SIZES[0],
                   config["ins_sizes"][0])
    high = np.where(ops == _CIGAR_D, SAMPLE_DEL_SIZES[1],
                    config["ins_sizes"][1])
    sizes = np.rint(np.exp(rng.uniform(np.log(low), np.log(high)))).astype(
        np.int64)
    spacing = SAMPLE_LOCUS_GAP + np.where(ops == _CIGAR_D, sizes, 0)
    free = length - 2 * SAMPLE_MARGIN - int(spacing.sum())
    if free < 0:
        raise ValueError("{0} loci do not fit a {1} bp contig".format(
            len(ops), length))
    positions = (SAMPLE_MARGIN + np.sort(rng.integers(0, free + 1, len(ops)))
                 + np.concatenate([[0], np.cumsum(spacing)[:-1]]))
    low_cover, high_cover = SAMPLE_COVERAGE
    offsets = []
    for op, size in zip(ops.tolist(), sizes.tolist()):
        coverage = int(rng.integers(low_cover, high_cover + 1))
        shift = max(TIEFREE_POSITION_JITTER["D" if op == _CIGAR_D else "I"],
                    coverage // 2)
        reach = max(int(size * TIEFREE_SIZE_JITTER), coverage)
        shifts = _distinct_offsets(rng, shift, coverage)
        resizes = _distinct_offsets(rng, reach, coverage)
        motif = (rng.integers(0, 4, size + reach, dtype=np.uint8)
                 if op == _CIGAR_I else None)
        offsets.append((shifts, resizes, motif))
    return ops, positions, sizes, offsets


def _prime_factors(value):
    factors = []
    divisor = 2
    while divisor * divisor <= value:
        if value % divisor == 0:
            factors.append(divisor)
            while value % divisor == 0:
                value //= divisor
        divisor += 1
    return factors + ([value] if value > 1 else [])


@functools.lru_cache(maxsize=None)
def _golomb_marks(n):
    """n increasing integers from 0 whose pairwise differences are all
    distinct, no two consecutive ones closer than 2: the shortest such
    window of n marks over the rotations of Bose's modular Golomb ruler for
    the least prime p above n (the p exponents k < p^2 - 1 at which
    theta^k - theta lies in GF(p), theta a primitive element of GF(p^2) =
    GF(p)[x] / (x^2 - r)); ~n^2 long (931 at n = 30)."""
    p = n + 1
    while _prime_factors(p) != [p]:
        p += 1
    r = next(r for r in range(2, p) if pow(r, (p - 1) // 2, p) == p - 1)

    def times(x, y):
        return ((x[0] * y[0] + r * x[1] * y[1]) % p,
                (x[0] * y[1] + x[1] * y[0]) % p)

    def power(x, exponent):
        result = (1, 0)
        while exponent:
            if exponent & 1:
                result = times(result, x)
            x = times(x, x)
            exponent >>= 1
        return result

    order = p * p - 1
    factors = _prime_factors(order)
    theta = next((a, b) for b in range(1, p) for a in range(p)
                 if all(power((a, b), order // q) != (1, 0)
                        for q in factors))
    marks = []
    value = (1, 0)
    for exponent in range(order):
        if value[1] == theta[1]:
            marks.append(exponent)
        value = times(value, theta)
    windows = (sorted((mark - origin) % order for mark in marks)[:n]
               for origin in marks)
    return tuple(min((window for window in windows
                      if min(np.diff(window)) >= 2),
                     key=lambda window: window[-1]))


def _ruler_offsets(rng, n):
    """Two offset columns of n reads, each strictly increasing, whose sums
    are Golomb marks (_golomb_marks, mirrored at random): no two pairs of
    reads share |d first| + |d second|, so a BND partition, whose distance
    is that sum over 3,000, has no exact tie.  Each gap between marks is
    split at random between the columns; both are centred on 0."""
    marks = np.asarray(_golomb_marks(n), dtype=np.int64)
    if rng.integers(0, 2):
        marks = marks[-1] - marks[::-1]
    gaps = np.diff(marks)
    first = rng.integers(1, gaps)
    columns = [np.concatenate([[0], np.cumsum(part)])
               for part in (first, gaps - first)]
    return [column - int(round(column.mean())) for column in columns]


def _span_offsets(rng, n, size, reach, columns=2):
    """Start and end offsets (and with columns=3 destination offsets), each
    in [-reach, reach] and none repeated in its column, of n reads whose SV
    spans [start, size + end): drawn read by read, a draw refused when it
    repeats an offset or when one of its distances to the reads before it
    equals another distance of the partition, which then has no exact tie.
    The distances are cluster/accel.py's in float64 at the default
    --position_distance_normalizer: |d center| / 900 (+ |d destination| /
    900 for DUP:INT) + |d span| / max span."""
    drawn = np.empty((0, columns), dtype=np.int64)
    seen = set()
    while len(drawn) < n:
        draw = rng.integers(-reach, reach + 1, columns)
        if (drawn == draw).any():
            continue
        start, end = int(draw[0]), size + int(draw[1])
        starts, ends = drawn[:, 0], size + drawn[:, 1]
        spans = ends - starts
        distances = np.abs((starts + ends) // 2 - (start + end) // 2) / 900
        if columns == 3:
            distances = distances + np.abs(drawn[:, 2] - draw[2]) / 900
        distances = distances + (np.abs(spans - (end - start))
                                 / np.maximum(spans, end - start))
        new = set(distances.tolist())
        if len(new) < len(distances) or new & seen:
            continue
        seen |= new
        drawn = np.vstack([drawn, draw])
    return drawn.T


def _cut(intervals, low, high):
    """Half-open `intervals` less [low, high)."""
    return [piece for a, b in intervals
            for piece in ((a, min(b, low)), (max(a, high), b))
            if piece[0] < piece[1]]


def _place(rng, free, width, avoid=()):
    """A left edge x, uniform over the places where [x, x + width] lies in
    one of the half-open `free` intervals and outside every [low, high) of
    `avoid`; the free intervals lose [x - SAMPLE_LOCUS_GAP, x + width +
    SAMPLE_LOCUS_GAP)."""
    pieces = free
    for low, high in avoid:
        pieces = _cut(pieces, low, high)
    room = [(a, b - width - a) for a, b in pieces if b - a > width]
    if not room:
        raise ValueError("the split-read loci do not fit the host contig")
    pick = int(rng.integers(0, sum(size for _, size in room)))
    for a, size in room:
        if pick < size:
            x = a + pick
            break
        pick -= size
    free[:] = _cut(free, x - SAMPLE_LOCUS_GAP, x + width + SAMPLE_LOCUS_GAP)
    return x


def _split_plan(rng, config, ops, positions, sizes):
    """The split-read loci of sample_workload: `split_loci` a class of
    SAMPLE_SPLIT_CLASSES, 1 to 3 of each wide (SAMPLE_WIDE_COVERAGE reads),
    placed uniformly in the room the DEL and INS loci leave,
    SAMPLE_LOCUS_GAP from every other locus and SAMPLE_MARGIN from the
    host's ends.  The first DUP:INT loci are copies of 1 to 3 sources, the
    sources copied to SAMPLE_DUP_COPIES destinations.  Every DUP:INT destination lies SAMPLE_SOURCE_DISTANCE or
    more before its source: a read's two breakends then both normalise to
    the destination (pos1 < pos2), where their opposite directions wall the
    BND partition (host linkage, as every DUP:INT of sim.py); a source
    before its destination would put them into two unwalled partitions at
    the source.  BND partners lie on SAMPLE_CONTIGS[1].

    A read's breakpoints are offsets drawn without repeats: INV, DUP:TANDEM
    and DUP:INT (with its destination) by _span_offsets, BND (host,
    partner) by _ruler_offsets; so no partition of these classes has an
    exact float64 tie.  Returns (reads, truth, loci): reads a dict of
    per-read columns (kind, bp: the primary's breakpoint, seg_pos and
    seg_len: the first supplementary segment, tail: a DUP:INT read's right
    flank, at: the noise pair whose M the primary ends or starts on), truth
    the loci as sim.TruthVariant records, loci the count a class."""
    from svim_tpu_torch.sim import TruthVariant

    per_class = config["split_loci"]
    wide = max(1, min(3, per_class // 20))
    copies = SAMPLE_DUP_COPIES[:wide]
    if per_class < sum(copies) + wide:
        raise ValueError("{0} DUP:INT loci cannot hold {1} copies and {2} "
                         "wide loci".format(per_class, sum(copies), wide))
    host, partner = SAMPLE_CONTIGS
    length, partner_length = config["contig_length"], config["partner_length"]
    free = []
    low = SAMPLE_MARGIN
    ends = positions + np.where(ops == _CIGAR_D, sizes, 0)
    for start, end in zip(positions.tolist(), ends.tolist()):
        free.append((low, start - SAMPLE_LOCUS_GAP))
        low = end + SAMPLE_LOCUS_GAP
    free = [(a, b) for a, b in free + [(low, length - SAMPLE_MARGIN)]
            if a < b]

    def coverage(is_wide, route="span"):
        low_cover, high_cover = (SAMPLE_WIDE_COVERAGE[route] if is_wide
                                 else SAMPLE_COVERAGE)
        return int(rng.integers(low_cover, high_cover + 1))

    def size_of(svtype, n, is_wide):
        low_size, high_size = SAMPLE_SPLIT_SIZES[svtype]
        low_size = max(low_size, n * SAMPLE_SIZE_PER_READ[is_wide])
        return int(np.rint(np.exp(rng.uniform(np.log(low_size),
                                              np.log(high_size)))))

    def span_locus(svtype, is_wide, columns=2, size=None):
        n = coverage(is_wide)
        if size is None:
            size = size_of(svtype, n, is_wide)
        reach = max(n, min(SAMPLE_END_JITTER, size // 25))
        return size, _span_offsets(rng, n, size, reach, columns)

    loci = [(svtype, kinds) + span_locus(svtype, index < wide)
            for svtype, kinds in (("INV", (_INV_LEFT, _INV_RIGHT)),
                                  ("DUP:TANDEM", (_DUP_TAN,)))
            for index in range(per_class)]
    # a source's size, and each destination's (start, end, destination)
    # offsets of its reads
    sources = []
    for index, count in enumerate(copies + (1,) * (per_class - sum(copies))):
        is_wide = count == 1 and index - len(copies) < wide
        size, drawn = span_locus("DUP:INT", is_wide, 3)
        drawn = [drawn] + [span_locus("DUP:INT", False, 3, size)[1]
                           for _ in range(count - 1)]
        sources.append((size, drawn))
    bnds = [_ruler_offsets(rng, coverage(index < wide, "ruler"))
            for index in range(per_class)]

    columns = []   # (kind, bp, seg_pos, seg_len) of each read
    truth = []
    for size, drawn in sources:
        low_offset = min(int(offsets[0].min()) for offsets in drawn)
        width = size + max(int(offsets[1].max()) for offsets in drawn) \
            - low_offset
        # room before the source for its destinations
        room = SAMPLE_SOURCE_DISTANCE + len(drawn) * 2 * SAMPLE_LOCUS_SPAN
        source = _place(rng, free, width, avoid=[
            (0, SAMPLE_MARGIN + room)]) - low_offset
        for starts, ends, dest_offsets in drawn:
            dest_low = int(dest_offsets.min()) - 1
            destination = _place(rng, free, int(dest_offsets.max())
                                 - dest_low, avoid=[
                (source + low_offset - SAMPLE_SOURCE_DISTANCE,
                 length)]) - dest_low
            truth += [TruthVariant("DUP:INT", host, source, size,
                                   dest_contig=host, dest_pos=destination),
                      TruthVariant("BND", host, destination - 1, 0),
                      TruthVariant("BND", host, destination, 0),
                      TruthVariant("BND", host, source, 0),
                      TruthVariant("BND", host, source + size - 1, 0)]
            columns += [(_DUP_INT, destination + dest, source + start,
                         size + end - start)
                        for start, end, dest in zip(starts.tolist(),
                                                    ends.tolist(),
                                                    dest_offsets.tolist())]
    for svtype, kinds, size, (starts, ends) in loci:
        low_offset = int(starts.min())
        position = _place(rng, free, size + int(ends.max()) - low_offset) \
            - low_offset
        truth.append(TruthVariant(svtype, host, position, size))
        for read, (start, end) in enumerate(zip(starts.tolist(),
                                                ends.tolist())):
            kind = kinds[read % len(kinds)]
            bp = position + (start if kind == _INV_LEFT else size + end)
            columns.append((kind, bp, position + start, size + end - start))
    for host_offsets, partner_offsets in bnds:
        low_offset = int(host_offsets.min()) - 1
        position = _place(rng, free, int(host_offsets.max())
                          - low_offset) - low_offset
        mate = int(rng.integers(SAMPLE_MARGIN - int(partner_offsets.min()),
                                partner_length - SAMPLE_MARGIN
                                - int(partner_offsets.max())))
        truth += [TruthVariant("BND", host, position - 1, 0,
                               dest_contig=partner, dest_pos=mate),
                  TruthVariant("BND", partner, mate, 0)]
        columns += [(_BND, position + offset, mate + mate_offset, 0)
                    for offset, mate_offset in zip(host_offsets.tolist(),
                                                   partner_offsets.tolist())]

    kind, bp, seg_pos, seg_len = (np.asarray(column, dtype=np.int64)
                                  for column in zip(*columns))
    # the supplementary's run past its breakpoint: a DUP:TANDEM copy's
    # second flank, a DUP:INT read's right flank, a BND partner segment
    tails = rng.integers(SAMPLE_TAIL[0], SAMPLE_TAIL[1] + 1, len(kind))
    seg_len = np.where(kind == _DUP_TAN, seg_len + tails,
                       np.where(kind == _BND, tails, seg_len))
    at = rng.integers(NOISE_PAIRS // 4, 3 * NOISE_PAIRS // 4 + 1, len(kind))
    return (dict(kind=kind, bp=bp, seg_pos=seg_pos, seg_len=seg_len,
                 tail=np.where(kind == _DUP_INT, tails, 0), at=at), truth,
            {svtype: per_class for svtype in SAMPLE_SPLIT_CLASSES})


def _split_records(reads, ref_spans, query_spans):
    """Per split read, given its primary's reference and query bases: (the
    primary's start, its SEQ length, the soft clip, and the SA:Z tag as BAM
    tag bytes)."""
    host, partner = SAMPLE_CONTIGS
    kind, bp, seg_pos, seg_len, tail = (reads[name] for name in (
        "kind", "bp", "seg_pos", "seg_len", "tail"))
    clip = seg_len + tail
    starts = np.where(kind == _INV_RIGHT, bp, bp - ref_spans)
    tags = []
    for read_kind, position, first, run, right, query in zip(
            kind.tolist(), bp.tolist(), seg_pos.tolist(), seg_len.tolist(),
            tail.tolist(), query_spans.tolist()):
        if read_kind == _INV_LEFT:
            text = "{0},{1},-,{2}M{3}S,60,0;".format(host, first + 1, run,
                                                     query)
        elif read_kind == _DUP_INT:
            text = ("{0},{1},+,{2}S{3}M{4}S,60,0;"
                    "{0},{5},+,{6}S{4}M,60,0;").format(
                        host, first + 1, query, run, right, position + 1,
                        query + run)
        else:
            text = "{0},{1},+,{2}S{3}M,60,0;".format(
                partner if read_kind == _BND else host, first + 1, query, run)
        tags.append(b"SAZ" + text.encode() + b"\x00")
    return starts, query_spans + clip, clip, tags


def _check_split_segments(reads, lengths):
    """check_inside for the supplementary segments of the split reads: the
    first (on the partner for BND) and a DUP:INT read's right flank."""
    host, partner = SAMPLE_CONTIGS
    kind = reads["kind"]
    bnd = kind == _BND
    for contig, rows in ((host, ~bnd), (partner, bnd)):
        check_inside(reads["seg_pos"][rows], reads["seg_len"][rows],
                     lengths[contig], contig)
    flank = kind == _DUP_INT
    check_inside(reads["bp"][flank], reads["tail"][flank], lengths[host],
                 host)


def _noise_rows(rng, count):
    """_noisy_cigar's draws for `count` reads, a byte an (M, indel) pair:
    M length (3-15) in the high nibble, 1 for an insertion in bit 3, the
    indel's length less one (0-7) in the low bits."""
    rows = np.empty((count, NOISE_PAIRS), dtype=np.uint8)
    for low in range(0, count, 8192):
        high = min(count, low + 8192)
        shape = (high - low, NOISE_PAIRS)
        rows[low:high] = ((rng.integers(3, 16, shape, dtype=np.uint8) << 4)
                          | (rng.integers(0, 2, shape, dtype=np.uint8) << 3)
                          | rng.integers(0, 8, shape, dtype=np.uint8))
    return rows


def _noise_fields(rows):
    """(M lengths, 1 for an insertion, indel lengths) of noise rows."""
    return rows >> 4, (rows >> 3) & 1, (rows & 7) + 1


def _noise_sums(rows, sv_at, block=8192):
    """Per read: its noise's (M, inserted, deleted) bases; and per
    supporting read (the first len(sv_at)), the indel at its sv_at (length,
    1 for an insertion) and the reference and sequence bases before its SV
    op.  Summed a block of rows at a time."""
    sums = np.empty((3, len(rows)), dtype=np.int64)
    heads = np.empty((4, len(sv_at)), dtype=np.int64)
    for low in range(0, len(rows), block):
        m, is_ins, indel = _noise_fields(rows[low:low + block])
        inserted = indel * is_ins
        sums[:, low:low + block] = [m.sum(axis=1, dtype=np.int64),
                                    inserted.sum(axis=1, dtype=np.int64),
                                    (indel - inserted).sum(axis=1,
                                                           dtype=np.int64)]
        at = sv_at[low:low + block]
        if not len(at):
            continue
        count = len(at)
        m, is_ins, indel, inserted = (m[:count], is_ins[:count],
                                      indel[:count], inserted[:count])
        column = np.arange(NOISE_PAIRS)[None, :]
        before = column < at[:, None]
        rows_at = np.arange(count)
        head_m = (m * (column <= at[:, None])).sum(axis=1, dtype=np.int64)
        heads[:, low:low + count] = [
            indel[rows_at, at], is_ins[rows_at, at],
            head_m + ((indel - inserted) * before).sum(axis=1,
                                                       dtype=np.int64),
            head_m + (inserted * before).sum(axis=1, dtype=np.int64)]
    return sums, heads


def check_inside(starts, spans, length, contig):
    """Refuses a read that starts before 0 or ends past its contig's LN."""
    starts = np.asarray(starts)
    ends = starts + np.asarray(spans)
    outside = np.flatnonzero((starts < 0) | (ends > length))
    if len(outside):
        raise ValueError("{0} reads lie outside {1} (LN {2}): the first "
                         "covers [{3}, {4})".format(
                             len(outside), contig, length,
                             int(starts[outside[0]]), int(ends[outside[0]])))


class _BgzfWriter:
    """Writes an inflated BAM stream as BGZF members of 0xFF00 bytes,
    deflated by a pool of threads (zlib lets go of the GIL), and keeps the
    stream's sha256 and size."""

    def __init__(self, path):
        from concurrent.futures import ThreadPoolExecutor
        import hashlib

        self.handle = open(path, "wb")
        self.pool = ThreadPoolExecutor(max_workers=os.cpu_count() or 1)
        self.pending = []
        self.carry = b""
        self.digest = hashlib.sha256()
        self.inflated = 0

    def _member(self, data):
        compressor = zlib.compressobj(SAMPLE_BGZF_LEVEL, zlib.DEFLATED, -15)
        payload = compressor.compress(data) + compressor.flush()
        return (struct.pack("<BBBBIBBHBBHH", 0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
                            ord("B"), ord("C"), 2, len(payload) + 25)
                + payload + struct.pack("<II", zlib.crc32(data), len(data)))

    def _drain(self, keep):
        while len(self.pending) > keep:
            self.handle.write(self.pending.pop(0).result())

    def write(self, data):
        self.digest.update(data)
        self.inflated += len(data)
        data = self.carry + data
        full = len(data) - len(data) % 0xFF00
        for start in range(0, full, 0xFF00):
            self.pending.append(self.pool.submit(
                self._member, data[start:start + 0xFF00]))
        self.carry = data[full:]
        self._drain(4 * (os.cpu_count() or 1))

    def close(self):
        if self.carry:
            self.pending.append(self.pool.submit(self._member, self.carry))
        self._drain(0)
        self.pool.shutdown()
        self.handle.write(bamio.BGZF_EOF)
        self.handle.close()


def _bam_header(contigs):
    text = _header_text(AlignmentHeader({}, [name for name, _ in contigs],
                                        [size for _, size in contigs], ""),
                        "coordinate").encode()
    parts = [b"BAM\x01", struct.pack("<i", len(text)), text,
             struct.pack("<i", len(contigs))]
    for name, size in contigs:
        name_bytes = name.encode() + b"\x00"
        parts += [struct.pack("<i", len(name_bytes)), name_bytes,
                  struct.pack("<i", size)]
    return b"".join(parts)


def _write_genome(path, contigs, seed):
    """Random bases, 60 a line, for each (name, length)."""
    rng = np.random.default_rng([seed, 2])
    letters = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(path, "wb") as handle:
        for name, length in contigs:
            handle.write(">{0}\n".format(name).encode())
            for low in range(0, length, 60 << 20):
                high = min(length, low + (60 << 20))
                bases = letters[rng.integers(0, 4, high - low,
                                             dtype=np.uint8)]
                full = len(bases) - len(bases) % 60
                lines = np.empty((full // 60, 61), dtype=np.uint8)
                lines[:, :60] = bases[:full].reshape(-1, 60)
                lines[:, 60] = ord("\n")
                handle.write(lines.tobytes())
                if full < len(bases):
                    handle.write(bases[full:].tobytes() + b"\n")


def sample_workload(directory, seed=1, **changes):
    """A chromosome of a 30x ONT-like sample, at the scale a user runs:
    SAMPLE_CONTIGS[0] the length of GRCh38 chr20 holds the reads and the
    SV loci, SAMPLE_CONTIGS[1] the length of chr21 the partners of split
    reads.  Reads have _noisy_cigar's distribution (3,001 CIGAR ops,
    ~16.9 kb of reference and of sequence), random bases and no QUAL; the
    host is covered `depth` times over.  One locus of each type per
    2 * SAMPLE_LOCUS_SPAN bp: DEL sizes log-uniform over SAMPLE_DEL_SIZES,
    INS over `ins_sizes`, placed uniformly with SAMPLE_LOCUS_GAP bp between
    one locus's end and the next; each has SAMPLE_COVERAGE reads whose
    position and size offsets are drawn without repeats as in
    tiefree_workload, so that the device labels partitions as it would on
    a real sample; an INS read carries its locus's motif with
    tiefree_workload's per-read base noise.  One background read in
    SAMPLE_SPLIT_EVERY carries an SA:Z partner on the second contig.  With
    `split_loci`, loci of INV, DUP:TANDEM, DUP:INT and BND too
    (_split_plan), drawn from a stream of their own: a supporting read's
    primary is the first pairs of a _noisy_cigar read ending (or, reversed,
    starting) in a soft clip at its breakpoint, and its SA:Z tag places the
    other segments in sim.py's shapes.  Every segment of every read lies
    inside its contig's LN (check_inside).

    Built as arrays, the BAM's record bytes written directly (no SAM text)
    and deflated by threads.  `changes` replace fields of SAMPLE (the CPU
    tests' smaller samples).  Writes sample.bam, genome.fa, truth.json (the
    loci, for load_truth and sim.evaluate_vcf) and sample.json
    (reads, loci, BAM and inflated bytes, the inflated stream's sha256,
    seconds).  Returns (bam_path, genome_path)."""
    import time

    from svim_tpu_torch.sim import TruthVariant

    unknown = set(changes) - set(SAMPLE)
    if unknown:
        raise TypeError("unknown sample fields: {0}".format(sorted(unknown)))
    config = dict(SAMPLE, **changes)
    started = time.perf_counter()
    rng = np.random.default_rng(seed)
    host, partner = SAMPLE_CONTIGS
    length, partner_length = config["contig_length"], config["partner_length"]
    ops, positions, sizes, offsets = _sample_loci(rng, config)
    coverages = np.array([len(shifts) for shifts, _, _ in offsets],
                         dtype=np.int64)
    n_sv = int(coverages.sum())
    # the split-read loci draw from a stream of their own, so that without
    # them every draw is as it was
    plan, split_truth, split_loci = (
        _split_plan(np.random.default_rng([seed, 3]), config, ops,
                    positions, sizes)
        if config["split_loci"] else (None, [], {}))
    n_support = n_sv + (len(plan["kind"]) if plan else 0)
    total = round(length * config["depth"] / SAMPLE_MEAN_SPAN)
    n_reads = n_support + max(0, total - n_support)
    rows = _noise_rows(rng, n_reads)

    # the supporting reads come first, locus by locus, the split reads after
    # them; the SV op takes the place of the noise indel at sv_at, as in
    # _noisy_cigar; a split read's primary ends (or, reversed, starts) on
    # the M of its noise pair `at`, the soft clip beyond it
    locus_of = np.repeat(np.arange(len(ops)), coverages)
    sv_op = ops[locus_of]
    sv_len = sizes[locus_of] + np.concatenate(
        [resizes for _, resizes, _ in offsets]).astype(np.int64)
    sv_at = rng.integers(NOISE_PAIRS // 4, 3 * NOISE_PAIRS // 4 + 1, n_sv)
    (match, inserted, deleted), (at_len, at_ins, ref_before, sv_seq_pos) = \
        _noise_sums(rows, np.concatenate([sv_at, plan["at"]]) if plan
                    else sv_at)
    inserted[:n_sv] += np.where(sv_op == _CIGAR_I, sv_len, 0) \
        - at_len[:n_sv] * at_ins[:n_sv]
    deleted[:n_sv] += np.where(sv_op == _CIGAR_D, sv_len, 0) \
        - at_len[:n_sv] * (1 - at_ins[:n_sv])
    spans = match + deleted + 20
    seq_lens = match + inserted + 20

    starts = np.empty(n_reads, dtype=np.int64)
    starts[:n_sv] = positions[locus_of] - ref_before[:n_sv] + np.concatenate(
        [shifts for shifts, _, _ in offsets])
    tags = {}
    if plan:
        spans[n_sv:n_support] = ref_before[n_sv:]
        (starts[n_sv:n_support], seq_lens[n_sv:n_support], clips,
         split_tags) = _split_records(plan, ref_before[n_sv:],
                                      sv_seq_pos[n_sv:])
        _check_split_segments(plan, {host: length, partner: partner_length})
        tags.update(zip(range(n_sv, n_support), split_tags))
    starts[n_support:] = np.floor(rng.random(n_reads - n_support) * (
        length - spans[n_support:] + 1)).astype(np.int64)
    check_inside(starts, spans, length, host)
    background = np.arange(n_reads - n_support)
    split = n_support + background[background % SAMPLE_SPLIT_EVERY == 0]
    partners = rng.integers(1, partner_length - SAMPLE_SPLIT_SPAN + 2,
                            len(split))
    check_inside(partners - 1, np.full(len(split), SAMPLE_SPLIT_SPAN),
                 partner_length, partner)
    # BAM's SA tag: its name, type Z, the text, NUL
    tags.update((int(read), b"SAZ" + "{0},{1},+,{2}S{3}M,60,0;".format(
        partner, int(position), int(seq_lens[read]) - SAMPLE_SPLIT_SPAN,
        SAMPLE_SPLIT_SPAN).encode() + b"\x00")
        for read, position in zip(split, partners))
    inserts = {}
    for locus in np.flatnonzero(ops == _CIGAR_I).tolist():
        _, resizes, motif = offsets[locus]
        for read, resize in zip(np.flatnonzero(locus_of == locus).tolist(),
                                resizes.tolist()):
            insert = motif[:sizes[locus] + resize].copy()
            noise = int(rng.integers(0, 5))
            insert[rng.integers(0, len(insert), noise)] = rng.integers(
                0, 4, noise, dtype=np.uint8)
            inserts[read] = insert

    os.makedirs(directory, exist_ok=True)
    bam_path = os.path.join(directory, "sample.bam")
    writer = _BgzfWriter(bam_path)
    writer.write(_bam_header([(host, length), (partner, partner_length)]))
    order = np.argsort(starts, kind="stable")
    for low in range(0, n_reads, SAMPLE_CHUNK):
        reads = order[low:low + SAMPLE_CHUNK]
        chunk_m, chunk_ins, chunk_indel = (
            field.astype(np.uint32) for field in _noise_fields(rows[reads]))
        words = np.empty((len(reads), SAMPLE_OPS), dtype=np.uint32)
        words[:, 0:READ_LENGTH_OPS:2] = chunk_m << 4
        words[:, 1:READ_LENGTH_OPS:2] = (chunk_indel << 4) | (
            _CIGAR_D - chunk_ins)
        words[:, READ_LENGTH_OPS] = 20 << 4
        sv = np.flatnonzero(reads < n_sv)
        words[sv, 2 * sv_at[reads[sv]] + 1] = (sv_len[reads[sv]] << 4) \
            | sv_op[reads[sv]]
        # random bases, each read's run padded to an even count (the pad
        # is BAM's 0 nibble), each INS read's insert at its SV op
        lengths = seq_lens[reads]
        padded = lengths + lengths % 2
        read_starts = np.concatenate([[0], np.cumsum(padded)[:-1]])
        codes = _BASE_CODES[rng.integers(0, 4, int(padded.sum()),
                                         dtype=np.uint8)]
        codes[(read_starts + lengths)[lengths % 2 == 1]] = 0
        for index in sv.tolist():
            insert = inserts.get(int(reads[index]))
            if insert is not None:
                at = read_starts[index] + sv_seq_pos[reads[index]]
                codes[at:at + len(insert)] = _BASE_CODES[insert]
        packed = (codes[0::2] << 4) | codes[1::2]   # BAM's two a byte
        packed_at = read_starts // 2
        parts = []
        for index, read in enumerate(reads.tolist()):
            name = "read{0}".format(low + index).encode() + b"\x00"
            l_seq = int(lengths[index])
            tag = tags.get(read, b"")
            seq = packed[packed_at[index]:packed_at[index] + (l_seq + 1) // 2]
            cigar = words[index]
            flag = 0
            if n_sv <= read < n_support:
                split_read = read - n_sv
                clip = np.uint32((int(clips[split_read]) << 4) | _CIGAR_S)
                aligned = words[index, :2 * int(plan["at"][split_read]) + 1]
                if plan["kind"][split_read] == _INV_RIGHT:
                    cigar = np.concatenate([[clip], aligned])
                    flag = 16
                else:
                    cigar = np.concatenate([aligned, [clip]])
            size = 32 + len(name) + 4 * len(cigar) + len(seq) + l_seq \
                + len(tag)
            parts += [struct.pack("<iiiBBHHHiiii", size, 0,
                                  int(starts[read]), len(name), 60, 0,
                                  len(cigar), flag, l_seq, -1, -1, 0),
                      name, cigar.tobytes(), seq.tobytes(),
                      b"\xff" * l_seq, tag]
        writer.write(b"".join(parts))
    writer.close()

    genome_path = os.path.join(directory, "genome.fa")
    _write_genome(genome_path, [(host, length), (partner, partner_length)],
                  seed)
    truth = [TruthVariant("DEL" if op == _CIGAR_D else "INS", host,
                          int(position), int(size))
             for op, position, size in zip(ops.tolist(), positions.tolist(),
                                           sizes.tolist())]
    _save_truth(directory, "sim", truth + split_truth)
    with open(os.path.join(directory, SAMPLE_FILE), "w") as handle:
        json.dump({"reads": n_reads, "supporting_reads": n_support,
                   "split_reads": len(split),
                   "loci": dict({"DEL": int((ops == _CIGAR_D).sum()),
                                 "INS": int((ops == _CIGAR_I).sum())},
                                **split_loci),
                   "bam_bytes": os.path.getsize(bam_path),
                   "inflated_bytes": writer.inflated,
                   "inflated_sha256": writer.digest.hexdigest(),
                   "seconds": time.perf_counter() - started}, handle)
    return bam_path, genome_path


# sample-classes-chr20: the sample with loci of all six classes
SAMPLE_SPLIT_LOCI = 60   # loci a split-read class


def sample_classes_workload(directory, seed=1, **changes):
    """sample_workload with SAMPLE_SPLIT_LOCI loci of each split-read class
    (INV, DUP:TANDEM, DUP:INT, BND) beside its DEL and INS loci: a
    chromosome of a 30x sample that carries all six SV classes, whose
    split-read partitions have no exact tie.  `changes` replace fields of
    SAMPLE.  Returns (bam_path, genome_path)."""
    return sample_workload(directory, seed,
                           **dict({"split_loci": SAMPLE_SPLIT_LOCI},
                                  **changes))


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
