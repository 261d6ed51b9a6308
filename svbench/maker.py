"""The benchmark's input maker: a chromosome of a 30x long-read sample as a
coordinate-sorted BGZF BAM, its FASTA genome, truth.json and sample.json.

A frozen copy of the sample maker of the measured program
(`sample_workload` and the helpers it calls), with the program's BAM and SAM
helpers rewritten here, so that a change to the program cannot move the
benchmark's inputs.  One general entry, `make(directory, seed, **knobs)`,
takes a traffic mix's knobs (the fields of SAMPLE).  The same seed gives the
same inflated BAM stream, byte for byte; its BGZF members are deflated by a
pool of threads (zlib's output a member does not depend on the thread).
Imports numpy and the standard library only.
"""

from __future__ import annotations

import functools
import json
import os
import struct
import time
import zlib
from typing import NamedTuple

import numpy as np

READ_LENGTH_OPS = 3000   # CIGAR ops per read
TIEFREE_POSITION_JITTER = {"D": 120, "I": 20}   # bp each way, by SV op
TIEFREE_SIZE_JITTER = 0.08   # of the locus's size, each way
TRUTH_FILE = "truth.json"
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


class TruthVariant(NamedTuple):
    svtype: str      # DEL | INS | INV | DUP:TANDEM | DUP:INT | BND
    contig: str
    start: int       # 0-based
    length: int
    dest_contig: str = None
    dest_pos: int = -1
    cutpaste: bool = False   # DUP:INT whose origin is deleted (cut&paste)


def _save_truth(directory, generator, truth):
    with open(os.path.join(directory, TRUTH_FILE), "w") as handle:
        json.dump({"generator": generator,
                   "records": [variant._asdict() for variant in truth]},
                  handle)


def _header_text(references, lengths, sort_order):
    return "".join(["@HD\tVN:1.6\tSO:{0}\n".format(sort_order)] + [
        "@SQ\tSN:{0}\tLN:{1}\n".format(name, length)
        for name, length in zip(references, lengths)])


# sample_workload: a chromosome of a 30x ONT-like sample, at the widths of
# _noisy_cigar's reads
SAMPLE = dict(contig_length=64_444_167,    # GRCh38 chr20, the SV host
              partner_length=46_709_983,   # GRCh38 chr21: split partners
              depth=30,
              loci=None,             # per type; None: a locus a 115 kb
              ins_sizes=(50, 3000),  # bp, log-uniform
              split_loci=None,       # loci a split-read class; None: none
              pileup=None,           # depth of the collapsed repeat; None: none
              long_ins=None)         # ultra-long insertion loci; None: none
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


def _planned_loci(rng, plan_rng, config):
    """_sample_loci's loci drawn from `plan_rng` (their ops, sizes,
    coverages, offsets and motifs), put in an order and at places drawn
    from `rng`, SAMPLE_LOCUS_GAP apart as _sample_loci places them."""
    ops, _, sizes, offsets = _sample_loci(plan_rng, config)
    order = rng.permutation(len(ops))
    ops, sizes = ops[order], sizes[order]
    offsets = [offsets[index] for index in order.tolist()]
    spacing = SAMPLE_LOCUS_GAP + np.where(ops == _CIGAR_D, sizes, 0)
    free = config["contig_length"] - 2 * SAMPLE_MARGIN - int(spacing.sum())
    positions = (SAMPLE_MARGIN + np.sort(rng.integers(0, free + 1, len(ops)))
                 + np.concatenate([[0], np.cumsum(spacing)[:-1]]))
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


def _free_room(length, ops, positions, sizes):
    """The half-open intervals of the host that lie SAMPLE_LOCUS_GAP from
    every DEL and INS locus and SAMPLE_MARGIN from either end."""
    free = []
    low = SAMPLE_MARGIN
    ends = positions + np.where(ops == _CIGAR_D, sizes, 0)
    for start, end in zip(positions.tolist(), ends.tolist()):
        free.append((low, start - SAMPLE_LOCUS_GAP))
        low = end + SAMPLE_LOCUS_GAP
    return [(a, b) for a, b in free + [(low, length - SAMPLE_MARGIN)]
            if a < b]


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

    per_class = config["split_loci"]
    wide = max(1, min(3, per_class // 20))
    copies = SAMPLE_DUP_COPIES[:wide]
    if per_class < sum(copies) + wide:
        raise ValueError("{0} DUP:INT loci cannot hold {1} copies and {2} "
                         "wide loci".format(per_class, sum(copies), wide))
    host, partner = SAMPLE_CONTIGS
    length, partner_length = config["contig_length"], config["partner_length"]
    free = _free_room(length, ops, positions, sizes)

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


# the long tail of a real sample (sample_workload's `pileup` and
# `long_ins`): reads of diverged copies of a repeat that collapse onto one
# reference copy, and ultra-long reads across long insertions
PILEUP_SPAN = 100_000        # bp of the host the collapsed repeat covers
PILEUP_PAIRS = 600           # noise pairs of a pileup read (~7 kb)
PILEUP_READ_SPAN = PILEUP_PAIRS * 45 // 4 + 20   # bp, without its events
PILEUP_COPIES = 8            # diverged copies of the repeat
PILEUP_SITE_GAP = 1_500      # bp between the sites where the copies differ
PILEUP_DEL_AT = 500          # bp past a site's insertions, its deletions
PILEUP_SHIFT = 60            # bp each way a copy's event lies off its site
PILEUP_EVENT_SIZES = (40, 300)   # bp, log-uniform
PILEUP_PRESENT = 0.9         # chance that a copy differs at a site, a type
# long insertion loci: sizes log-uniform over the first range for the first
# half of the loci (rounded up), over the second for the others
LONG_INS_SIZES = ((16_700, 30_000), (5_000, 15_000))
LONG_INS_COVERAGE = (12, 20)   # reads a locus
LONG_INS_READ_LENGTH = (40_000, 80_000)   # bp of a read's sequence
LONG_INS_FLANK = 5_000         # bp of sequence at least on either side
LONG_INS_SIZE_JITTER = 0.02    # of the locus's size, each way
LONG_INS_NOISE = 0.01          # substitutions a base of a read's copy
_PAIR_QUERY = 45 / 4   # mean sequence bases of a noise pair (9 + 4.5 / 2)


def _extra_read(rng, rows, events=()):
    """A read of noise `rows` in which each event (pair, op, length, insert
    codes or None) takes the place of that pair's indel, closed by 20M:
    (CIGAR words, base codes 0-3)."""
    m, is_ins, indel = (field.astype(np.int64)
                        for field in _noise_fields(rows))
    op = _CIGAR_D - is_ins
    length = indel.copy()
    inserts = {}
    for pair, event_op, event_length, insert in events:
        op[pair] = event_op
        length[pair] = event_length
        if insert is not None:
            inserts[pair] = insert
    words = np.empty(2 * len(rows) + 1, dtype=np.uint32)
    words[0:-1:2] = m << 4
    words[1:-1:2] = (length << 4) | op
    words[-1] = 20 << 4
    inserted = np.where(op == _CIGAR_I, length, 0)
    query = m + inserted
    codes = rng.integers(0, 4, int(query.sum()) + 20, dtype=np.uint8)
    if inserts:
        # sequence bases up to the end of each pair's M
        before = np.cumsum(query) - inserted
        for pair, insert in inserts.items():
            codes[before[pair]:before[pair] + len(insert)] = insert
    return words, codes


def _log_uniform(rng, low, high, count=None):
    return np.rint(np.exp(rng.uniform(np.log(low), np.log(high),
                                      count))).astype(np.int64)


def _noisy_copy(rng, motif, substitutions):
    """`motif` with `substitutions` random bases written over it."""
    copy = motif.copy()
    copy[rng.integers(0, len(copy), substitutions)] = rng.integers(
        0, 4, substitutions, dtype=np.uint8)
    return copy


def _pileup_reads(rng, start, depth):
    """The collapsed repeat over [start, start + PILEUP_SPAN): PILEUP_COPIES
    copies, each differing from the reference by an insertion near every
    site (PILEUP_SITE_GAP apart) and a deletion PILEUP_DEL_AT past it, each
    with chance PILEUP_PRESENT, PILEUP_SHIFT off the site and of a size of
    its own; `depth` times over the region, reads of PILEUP_PAIRS noise
    pairs from a copy drawn at random, each carrying the copy's events it
    spans (at the first noise pair at or past the event's position; an
    insertion with the sample's 0-4 substitutions a read).  Returns
    (starts, [(words, codes)], events per read)."""
    sites = np.arange(start + PILEUP_SITE_GAP // 2,
                      start + PILEUP_SPAN - PILEUP_SITE_GAP, PILEUP_SITE_GAP)
    copies = []
    for _ in range(PILEUP_COPIES):
        events = []
        for op, offset in ((_CIGAR_I, 0), (_CIGAR_D, PILEUP_DEL_AT)):
            present = rng.random(len(sites)) < PILEUP_PRESENT
            positions = sites + offset + rng.integers(
                -PILEUP_SHIFT, PILEUP_SHIFT + 1, len(sites))
            sizes = _log_uniform(rng, *PILEUP_EVENT_SIZES, len(sites))
            for position, size in zip(positions[present].tolist(),
                                      sizes[present].tolist()):
                events.append((position, op, size, rng.integers(
                    0, 4, size, dtype=np.uint8) if op == _CIGAR_I else None))
        copies.append(sorted(events, key=lambda event: event[0]))
    count = round(depth * PILEUP_SPAN / PILEUP_READ_SPAN)
    # a read's span stays under 2 * PILEUP_READ_SPAN: the region holds it
    starts = np.sort(rng.integers(start, start + PILEUP_SPAN
                                  - 2 * PILEUP_READ_SPAN, count))
    copy_of = rng.integers(0, PILEUP_COPIES, count)
    rows = _noise_rows(rng, count, PILEUP_PAIRS)
    records = []
    carried = np.empty(count, dtype=np.int64)
    for read, (read_start, copy) in enumerate(zip(starts.tolist(),
                                                  copy_of.tolist())):
        m, is_ins, indel = (field.astype(np.int64)
                            for field in _noise_fields(rows[read]))
        deleted = indel * (1 - is_ins)
        # the reference position of each pair's indel, after its M
        at = read_start + np.cumsum(m + deleted) - deleted
        events = []
        for position, op, size, motif in copies[copy]:
            if position < read_start:
                continue
            pair = int(np.searchsorted(at, position))
            if pair >= PILEUP_PAIRS - 1:
                break
            if pair < 1 or (events and pair <= events[-1][0] + 1):
                continue
            at[pair + 1:] += (size if op == _CIGAR_D else 0) - deleted[pair]
            events.append((pair, op, size, None if motif is None else
                           _noisy_copy(rng, motif, int(rng.integers(0, 5)))))
        records.append(_extra_read(rng, rows[read], events))
        carried[read] = len(events)
    return starts, records, carried


def _long_ins_reads(rng, count, free, length):
    """`count` loci of one long insertion each, placed in `free` (at least
    LONG_INS_READ_LENGTH[1] + SAMPLE_MARGIN from the host's ends), with
    LONG_INS_COVERAGE reads of LONG_INS_READ_LENGTH bases that span it with
    LONG_INS_FLANK or more on either side; position and size offsets drawn
    without repeats as in tiefree_workload, each read's copy of the insert
    with LONG_INS_NOISE substitutions a base.  Returns (starts, [(words,
    codes)], [(position, size, reads)])."""
    reach = LONG_INS_READ_LENGTH[1] + SAMPLE_MARGIN
    starts, records, loci = [], [], []
    for index in range(count):
        size = int(_log_uniform(rng, *LONG_INS_SIZES[
            0 if index < (count + 1) // 2 else 1]))
        reads = int(rng.integers(LONG_INS_COVERAGE[0],
                                 LONG_INS_COVERAGE[1] + 1))
        shifts = _distinct_offsets(rng, max(TIEFREE_POSITION_JITTER["I"],
                                            reads // 2), reads)
        resizes = _distinct_offsets(rng, max(int(size * LONG_INS_SIZE_JITTER),
                                             reads), reads)
        motif = rng.integers(0, 4, size + int(resizes.max()), dtype=np.uint8)
        position = _place(rng, free, int(shifts.max() - shifts.min()),
                          avoid=[(0, reach), (length - reach, length)]) \
            - int(shifts.min())
        loci.append((position, size, reads))
        for shift, resize in zip(shifts.tolist(), resizes.tolist()):
            insert = motif[:size + resize]
            insert = _noisy_copy(rng, insert, int(rng.binomial(
                len(insert), LONG_INS_NOISE)))
            total = int(rng.integers(max(LONG_INS_READ_LENGTH[0],
                                         len(insert) + 2 * LONG_INS_FLANK),
                                     LONG_INS_READ_LENGTH[1] + 1))
            left = int(rng.integers(LONG_INS_FLANK, total - len(insert)
                                    - LONG_INS_FLANK + 1))
            parts = []
            for bases in (left, total - len(insert) - left):
                rows = _noise_rows(rng, 1, int(bases / _PAIR_QUERY * 1.25)
                                   + 32)[0]
                m, is_ins, indel = _noise_fields(rows)
                query = np.cumsum(m.astype(np.int64) + indel * is_ins)
                parts.append(rows[:int(np.searchsorted(query, bases)) + 1])
            m, is_ins, indel = (field.astype(np.int64)
                                for field in _noise_fields(parts[0]))
            # the insertion takes the place of the left run's last indel
            ref_before = int(m.sum() + (indel * (1 - is_ins))[:-1].sum())
            starts.append(position + shift - ref_before)
            records.append(_extra_read(
                rng, np.concatenate(parts),
                [(len(parts[0]) - 1, _CIGAR_I, len(insert), insert)]))
    return np.asarray(starts, dtype=np.int64), records, loci


def _longtail_reads(rng, config, ops, positions, sizes, split):
    """The reads of `pileup` (_pileup_reads) and `long_ins`
    (_long_ins_reads), placed in the room the DEL, INS and split-read loci
    leave (SAMPLE_LOCUS_GAP from each), each read inside the host
    (check_inside).  Returns (starts, [(words, codes)], truth: the long
    insertions as sim.TruthVariant records, a summary for sample.json)."""

    host = SAMPLE_CONTIGS[0]
    length = config["contig_length"]
    free = _free_room(length, ops, positions, sizes)
    if split is not None:
        for point in np.concatenate([split["bp"], split["seg_pos"]]).tolist():
            free = _cut(free, point - SAMPLE_LOCUS_GAP,
                        point + SAMPLE_LOCUS_GAP)
    starts, records, summary, truth = [], [], {}, []
    if config["pileup"]:
        begin = _place(rng, free, PILEUP_SPAN)
        pileup_starts, pileup_records, carried = _pileup_reads(
            rng, begin, config["pileup"])
        starts.append(pileup_starts)
        records += pileup_records
        summary["pileup"] = {"start": begin, "span": PILEUP_SPAN,
                             "reads": len(pileup_records),
                             "events_per_read": [int(carried.min()),
                                                 float(carried.mean()),
                                                 int(carried.max())]}
    if config["long_ins"]:
        ins_starts, ins_records, loci = _long_ins_reads(
            rng, config["long_ins"], free, length)
        starts.append(ins_starts)
        records += ins_records
        summary["long_ins"] = loci
        truth += [TruthVariant("INS", host, position, size)
                  for position, size, _reads in loci]
    starts = np.concatenate(starts)
    check_inside(starts, [_ref_span(words) for words, _codes in records],
                 length, host)
    return starts, records, truth, summary


def _ref_span(words):
    """Reference bases of BAM CIGAR words of M, I and D ops."""
    op = words & 0xF
    return int(((words >> 4) * ((op == 0) | (op == _CIGAR_D))).sum())


def _record(name, start, words, codes, flag=0, tag=b""):
    """One BAM record (mapq 60, no QUAL) of base codes 0-3."""
    bases = _BASE_CODES[codes]
    if len(bases) % 2:
        bases = np.append(bases, np.uint8(0))
    seq = (bases[0::2] << 4) | bases[1::2]
    size = 32 + len(name) + 4 * len(words) + len(seq) + len(codes) + len(tag)
    return b"".join([struct.pack("<iiiBBHHHiiii", size, 0, int(start),
                                 len(name), 60, 0, len(words), flag,
                                 len(codes), -1, -1, 0),
                     name, words.astype(np.uint32).tobytes(), seq.tobytes(),
                     b"\xff" * len(codes), tag])


def _noise_rows(rng, count, pairs=NOISE_PAIRS):
    """_noisy_cigar's draws for `count` reads of `pairs` pairs, a byte an
    (M, indel) pair: M length (3-15) in the high nibble, 1 for an insertion
    in bit 3, the indel's length less one (0-7) in the low bits."""
    rows = np.empty((count, pairs), dtype=np.uint8)
    for low in range(0, count, 8192):
        high = min(count, low + 8192)
        shape = (high - low, pairs)
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

    def __init__(self, path, digest=True):
        from concurrent.futures import ThreadPoolExecutor
        import hashlib

        self.handle = open(path, "wb")
        self.pool = ThreadPoolExecutor(max_workers=os.cpu_count() or 1)
        self.pending = []
        self.carry = b""
        self.digest = hashlib.sha256() if digest else None
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
        if self.digest is not None:
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
        self.handle.write(BGZF_EOF)
        self.handle.close()


def _bam_header(contigs):
    text = _header_text([name for name, _ in contigs],
                        [size for _, size in contigs], "coordinate").encode()
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


def make(directory, seed=1, digest=True, plan_seed=None, **changes):
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
    other segments in sim.py's shapes.  With `pileup`, a collapsed repeat
    of PILEUP_SPAN bp at that extra depth (_pileup_reads), and with
    `long_ins`, that many loci of ultra-long reads across a long insertion
    (_long_ins_reads), both from a third stream, their reads merged into
    the coordinate order.  Every segment of every read lies inside its
    contig's LN (check_inside).

    Built as arrays, the BAM's record bytes written directly (no SAM text)
    and deflated by threads.  `changes` replace fields of SAMPLE (the CPU
    tests' smaller samples); `digest=False` leaves out the inflated
    stream's sha256, which costs a pass over it.  With `plan_seed`, the
    loci (_planned_loci), the split-read loci and the long tail are drawn
    from that seed and only the reads from `seed`, so that every seed
    holds the same set of loci, sizes and coverages, in another order and
    at other places; at seed == plan_seed the bytes are as without it.
    Writes sample.bam, genome.fa, truth.json (the loci, for load_truth and
    sim.evaluate_vcf) and sample.json
    (reads, loci, BAM and inflated bytes, the inflated stream's sha256,
    seconds).  Returns (bam_path, genome_path)."""

    unknown = set(changes) - set(SAMPLE)
    if unknown:
        raise TypeError("unknown sample fields: {0}".format(sorted(unknown)))
    config = dict(SAMPLE, **changes)
    started = time.perf_counter()
    rng = np.random.default_rng(seed)
    host, partner = SAMPLE_CONTIGS
    length, partner_length = config["contig_length"], config["partner_length"]
    ops, positions, sizes, offsets = (
        _sample_loci(rng, config) if plan_seed in (None, seed)
        else _planned_loci(rng, np.random.default_rng(plan_seed), config))
    loci_seed = seed if plan_seed is None else plan_seed
    coverages = np.array([len(shifts) for shifts, _, _ in offsets],
                         dtype=np.int64)
    n_sv = int(coverages.sum())
    # the split-read loci draw from a stream of their own, so that without
    # them every draw is as it was
    plan, split_truth, split_loci = (
        _split_plan(np.random.default_rng([loci_seed, 3]), config, ops,
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

    # the long tail draws from a stream of its own, as the split-read loci
    extra_starts, extras, extra_truth, extra_summary = (
        _longtail_reads(np.random.default_rng([loci_seed, 4]), config, ops,
                        positions, sizes, plan)
        if config["pileup"] or config["long_ins"]
        else (np.empty(0, dtype=np.int64), [], [], {}))

    os.makedirs(directory, exist_ok=True)
    bam_path = os.path.join(directory, "sample.bam")
    writer = _BgzfWriter(bam_path, digest)
    writer.write(_bam_header([(host, length), (partner, partner_length)]))
    order = np.argsort(np.concatenate([starts, extra_starts]), kind="stable")
    for low in range(0, len(order), SAMPLE_CHUNK):
        chunk = order[low:low + SAMPLE_CHUNK]
        reads = chunk[chunk < n_reads]
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
        index = -1   # the read's place in `reads`
        for place, read in enumerate(chunk.tolist()):
            name = "read{0}".format(low + place).encode() + b"\x00"
            if read >= n_reads:
                parts.append(_record(name, extra_starts[read - n_reads],
                                     *extras[read - n_reads]))
                continue
            index += 1
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
    _save_truth(directory, "sim", truth + split_truth + extra_truth)
    with open(os.path.join(directory, SAMPLE_FILE), "w") as handle:
        json.dump(dict({"reads": len(order), "supporting_reads": n_support,
                        "split_reads": len(split),
                        "loci": dict({"DEL": int((ops == _CIGAR_D).sum()),
                                      "INS": int((ops == _CIGAR_I).sum())},
                                     **split_loci)}, **extra_summary,
                       bam_bytes=os.path.getsize(bam_path),
                       inflated_bytes=writer.inflated,
                       inflated_sha256=(writer.digest.hexdigest()
                                        if writer.digest is not None else None),
                       seconds=time.perf_counter() - started), handle)
    return bam_path, genome_path
