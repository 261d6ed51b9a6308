"""SV simulation: synthetic genomes, reads and truth sets for evaluation.

Generates coordinate-consistent alignments for all six SV classes (the
alignments a long-read aligner would produce for a donor genome carrying the
variants), plus background coverage.  Used by scripts/eval_accuracy.py and
the accuracy tests; BASELINE config 2 ("simulated genome, all six SV
classes") is this module's target shape.
"""

from __future__ import annotations

import random
from typing import List, NamedTuple

from svim_tpu_torch.io import bam as bamio
from svim_tpu_torch.io.sam import AlignmentHeader, parse_sam_line


class TruthVariant(NamedTuple):
    svtype: str      # DEL | INS | INV | DUP:TANDEM | DUP:INT | BND
    contig: str
    start: int       # 0-based
    length: int
    dest_contig: str = None
    dest_pos: int = -1
    cutpaste: bool = False   # DUP:INT whose origin is deleted (cut&paste)


class SimConfig(NamedTuple):
    genome_length: int = 5_000_000
    second_contig_length: int = 1_000_000
    coverage: int = 12
    n_del: int = 10
    n_ins: int = 10
    n_inv: int = 8
    n_tan: int = 8
    n_dup_int: int = 6
    n_bnd: int = 6
    n_background: int = 200
    seed: int = 1
    # stress knobs (any non-default value switches simulate() into "stress
    # mode": numpy genome generation, multi-contig SV placement, read noise;
    # defaults keep the rng draw sequence — and thus existing fixtures —
    # byte-identical)
    extra_contigs: tuple = ()       # extra SV-host contig lengths (chr3..)
    error_rate: float = 0.0         # per-base read error probability
    repeat_fraction: float = 0.0    # fraction of each contig under repeats
    n_dup_int_cutpaste: int = 0     # DUP:INT loci whose origin is deleted


def _random_genome(rng, length):
    return "".join(rng.choice("ACGT") for _ in range(length))


def _stress_contig(np_rng, length, repeat_fraction):
    """Large contig via numpy: uniform background plus repeat overlay —
    tandem micro/minisatellite arrays and one dispersed repeat family
    reused genome-wide (the ambiguity long-read SV callers trip on)."""
    import numpy as np

    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    arr = bases[np_rng.integers(0, 4, size=length)].copy()
    if repeat_fraction > 0 and length > 100_000:
        target = int(length * repeat_fraction)
        family = bases[np_rng.integers(
            0, 4, size=int(np_rng.integers(300, 2000)))]
        placed = 0
        while placed < target:
            if np_rng.random() < 0.5:
                motif = bases[np_rng.integers(
                    0, 4, size=int(np_rng.integers(20, 200)))]
                block = np.tile(motif, int(np_rng.integers(10, 60)))
            else:
                block = family
            pos = int(np_rng.integers(0, length - len(block)))
            arr[pos:pos + len(block)] = block
            placed += len(block)
    return arr.tobytes().decode("ascii")


def _parse_cigar(cigar):
    ops = []
    num = 0
    for ch in cigar:
        if ch.isdigit():
            num = num * 10 + ord(ch) - 48
        else:
            ops.append((num, ch))
            num = 0
    return ops


def _noisy_read(rng, cigar, seq, error_rate):
    """Inject sequencing errors into the M runs of one read.

    Sequence-bearing reads get mismatches (60%), small insertions (20%) and
    small deletions (20%).  '*' reads (split-read evidence whose SA tag pins
    the mate geometry) instead get paired kD+kI blocks — the clustered-error
    pattern aligners emit — which consume equal reference and query, so the
    CIGAR-implied read length stays consistent with the SA tag; their S/M
    boundaries additionally jitter by a few bases (breakpoint ambiguity),
    shifting POS when the leading clip grows.  Indels cap at 8 bp — far
    below any realistic min_sv_size — so noise stresses clustering and
    consensus, not signature extraction thresholds.

    Returns (cigar, seq, pos_shift)."""
    has_seq = seq != "*"
    out_ops = []     # [length, op] with adjacent same-op merge
    out_seq = []

    def emit(length, op, text=""):
        if length <= 0:
            return
        if out_ops and out_ops[-1][1] == op:
            out_ops[-1][0] += length
        else:
            out_ops.append([length, op])
        if has_seq and op in "MIS":
            out_seq.append(text)

    qpos = 0
    for length, op in _parse_cigar(cigar):
        consumes_query = op in "MIS"
        if op != "M" or length < 20:
            emit(length, op,
                 seq[qpos:qpos + length] if has_seq and consumes_query else "")
            if consumes_query:
                qpos += length
            continue
        run = list(seq[qpos:qpos + length]) if has_seq else None
        qpos += length
        cursor = 0
        while cursor < length:
            gap = 1 + int(rng.expovariate(error_rate))
            take = min(gap, length - cursor)
            emit(take, "M",
                 "".join(run[cursor:cursor + take]) if has_seq else "")
            cursor += take
            if cursor >= length:
                break
            kind = rng.random()
            if kind < 0.6:  # mismatch ('*' reads: invisible in CIGAR)
                if has_seq:
                    base = run[cursor]
                    run[cursor] = rng.choice(
                        [b for b in "ACGT" if b != base])
                    emit(1, "M", run[cursor])
                else:
                    emit(1, "M")
                cursor += 1
            elif kind < 0.8:  # insertion
                ins_len = min(1 + int(rng.expovariate(0.7)), 8)
                if has_seq:
                    emit(ins_len, "I", "".join(
                        rng.choice("ACGT") for _ in range(ins_len)))
                # '*' reads: no-op (a bare I would desync the read length
                # implied by this CIGAR from the one implied by the SA tag)
            else:  # deletion — never terminal within the run
                del_len = min(1 + int(rng.expovariate(0.7)), 8,
                              length - cursor - 1)
                if del_len > 0:
                    emit(del_len, "D")
                    if has_seq:
                        cursor += del_len
                    else:
                        # paired kD+kI: equal reference and query consumed,
                        # net geometry identical
                        emit(del_len, "I")
                        cursor += del_len

    pos_shift = 0
    if not has_seq and len(out_ops) >= 2:
        # breakpoint ambiguity: shave a few aligned bases into the clips
        if out_ops[0][1] == "S" and out_ops[1][1] == "M" and out_ops[1][0] > 20:
            j = rng.randint(0, 6)
            out_ops[0][0] += j
            out_ops[1][0] -= j
            pos_shift = j
        if out_ops[-1][1] == "S" and out_ops[-2][1] == "M" and out_ops[-2][0] > 20:
            j = rng.randint(0, 6)
            out_ops[-1][0] += j
            out_ops[-2][0] -= j
    cigar_out = "".join("{0}{1}".format(n, op) for n, op in out_ops)
    return cigar_out, ("".join(out_seq) if has_seq else "*"), pos_shift


def simulate(out_dir: str, config: SimConfig = SimConfig()):
    """Write genome.fa and reads.bam under out_dir; return the truth list."""
    import os

    stress = bool(config.extra_contigs or config.error_rate > 0
                  or config.repeat_fraction > 0
                  or config.n_dup_int_cutpaste > 0)
    rng = random.Random(config.seed)
    if stress:
        import numpy as np
        np_rng = np.random.default_rng(config.seed)
        contig_seqs = {"chr1": _stress_contig(np_rng, config.genome_length,
                                              config.repeat_fraction),
                       "chr2": _stress_contig(np_rng,
                                              config.second_contig_length,
                                              config.repeat_fraction)}
        for index, extra_length in enumerate(config.extra_contigs):
            contig_seqs["chr{0}".format(index + 3)] = _stress_contig(
                np_rng, extra_length, config.repeat_fraction)
    else:
        contig_seqs = {"chr1": _random_genome(rng, config.genome_length),
                       "chr2": _random_genome(rng,
                                              config.second_contig_length)}
    # SV-host contigs (chr2 stays the translocation source)
    hosts = ["chr1"] + ["chr{0}".format(i + 3)
                        for i in range(len(config.extra_contigs))]
    chr2 = contig_seqs["chr2"]
    genome_path = os.path.join(out_dir, "genome.fa")
    with open(genome_path, "w") as handle:
        for name, seq in contig_seqs.items():
            handle.write(">{0}\n".format(name))
            for i in range(0, len(seq), 80):
                handle.write(seq[i:i + 80] + "\n")

    header = AlignmentHeader.from_text(
        "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
            "@SQ\tSN:{0}\tLN:{1}\n".format(name, len(seq))
            for name, seq in contig_seqs.items()))
    lines: List[str] = []
    read_counter = [0]
    truth: List[TruthVariant] = []

    def line(flag, contig, pos0, cigar, seq="*", sa=None):
        read_counter[0] += 1
        if config.error_rate > 0:
            cigar, seq, pos_shift = _noisy_read(rng, cigar, seq,
                                                config.error_rate)
            pos0 += pos_shift
        tags = "\tSA:Z:{0}".format(sa) if sa else ""
        lines.append("sim{0}\t{1}\t{2}\t{3}\t60\t{4}\t*\t0\t0\t{5}\t*{6}".format(
            read_counter[0], flag, contig, pos0 + 1, cigar, seq, tags))

    def locus(margin=20000):
        # one rng draw in the single-host case (fixture compatibility)
        if len(hosts) == 1:
            return "chr1", rng.randint(margin,
                                       config.genome_length - margin)
        name = hosts[rng.randrange(len(hosts))]
        return name, rng.randint(margin, len(contig_seqs[name]) - margin)

    # --- deletions (CIGAR D runs, sequence-accurate reads) ----------------------
    for _ in range(config.n_del):
        host, position = locus()
        ref = contig_seqs[host]
        size = rng.randint(50, 900)
        truth.append(TruthVariant("DEL", host, position, size))
        for _ in range(config.coverage):
            left = rng.randint(600, 1800)
            right = rng.randint(600, 1800)
            start = position - left
            seq = ref[start:position] + ref[position + size:position + size + right]
            line(0, host, start, "{0}M{1}D{2}M".format(left, size, right), seq)

    # --- insertions (CIGAR I runs with a shared motif) --------------------------
    for _ in range(config.n_ins):
        host, position = locus()
        ref = contig_seqs[host]
        size = rng.randint(50, 600)
        motif = _random_genome(rng, size)
        truth.append(TruthVariant("INS", host, position, size))
        for _ in range(config.coverage):
            left = rng.randint(600, 1800)
            right = rng.randint(600, 1800)
            start = position - left
            seq = ref[start:position] + motif + ref[position:position + right]
            line(0, host, start, "{0}M{1}I{2}M".format(left, size, right), seq)

    # --- inversions (split reads, both flank directions) ------------------------
    for _ in range(config.n_inv):
        host, position = locus()
        size = rng.randint(200, 2000)
        truth.append(TruthVariant("INV", host, position, size))
        for flank in range(config.coverage):
            span = rng.randint(500, 1200)
            if flank % 2 == 0:  # left flank: fwd primary then rev supplementary
                line(0, host, position - span, "{0}M{1}S".format(span, size),
                     sa="{0},{1},-,{2}M{3}S,60,0;".format(host, position + 1,
                                                          size, span))
            else:  # right flank: rev primary then fwd supplementary
                line(16, host, position, "{0}S{1}M".format(span, size),
                     sa="{0},{1},+,{2}S{3}M,60,0;".format(
                         host, position + size + 1, size, span))

    # --- tandem duplications (reference-overlap split reads) --------------------
    for _ in range(config.n_tan):
        host, position = locus()
        size = rng.randint(150, 1200)
        truth.append(TruthVariant("DUP:TANDEM", host, position, size))
        for _ in range(config.coverage):
            span = rng.randint(400, 900)
            # primary covers [position - span, position + size), supplementary
            # restarts at position (one extra copy)
            line(0, host, position - span,
                 "{0}M{1}S".format(span + size, size + span),
                 sa="{0},{1},+,{2}S{3}M,60,0;".format(
                     host, position + 1, span + size, size + span))
        # give every read the same read-level duplication evidence

    # --- interspersed duplications (paired translocations) ----------------------
    def dup_int_locus(cutpaste):
        source = rng.randint(20000, config.second_contig_length - 20000)
        size = rng.randint(100, 800)
        host, dest = locus()
        truth.append(TruthVariant("DUP:INT", "chr2", source, size,
                                  dest_contig=host, dest_pos=dest,
                                  cutpaste=cutpaste))
        # the flanking breakend clusters also surface as BND records (the
        # reference emits BND candidates for every translocation cluster,
        # SVIM_COMBINE.py:372-383), forward and mirrored
        truth.append(TruthVariant("BND", host, dest - 1, 0))
        truth.append(TruthVariant("BND", host, dest, 0))
        truth.append(TruthVariant("BND", "chr2", source, 0))
        truth.append(TruthVariant("BND", "chr2", source + size - 1, 0))
        for _ in range(config.coverage):
            span = rng.randint(400, 900)
            line(0, host, dest - span, "{0}M{1}S".format(span, size + span),
                 sa=("chr2,{0},+,{1}S{2}M{3}S,60,0;"
                     "{4},{5},+,{6}S{7}M,60,0;").format(
                         source + 1, span, size, span,
                         host, dest + 1, span + size, span))
        if cutpaste:
            # the origin is deleted in the donor: deletion-spanning reads
            # over [source, source + size) flag the candidate CUTPASTE
            # (reference: SVIM_merging.py:12-29)
            truth.append(TruthVariant("DEL", "chr2", source, size))
            for _ in range(config.coverage):
                left = rng.randint(600, 1800)
                right = rng.randint(600, 1800)
                start = source - left
                seq = (chr2[start:source]
                       + chr2[source + size:source + size + right])
                line(0, "chr2", start,
                     "{0}M{1}D{2}M".format(left, size, right), seq)

    for _ in range(config.n_dup_int):
        dup_int_locus(cutpaste=False)
    for _ in range(config.n_dup_int_cutpaste):
        dup_int_locus(cutpaste=True)

    # --- breakends (cross-contig split reads) -----------------------------------
    for _ in range(config.n_bnd):
        host, position = locus()
        dest = rng.randint(20000, config.second_contig_length - 20000)
        truth.append(TruthVariant("BND", host, position - 1, 0,
                                  dest_contig="chr2", dest_pos=dest))
        truth.append(TruthVariant("BND", "chr2", dest, 0))  # mirrored record
        for _ in range(config.coverage):
            span = rng.randint(400, 900)
            line(0, host, position - span, "{0}M{1}S".format(span, span),
                 sa="chr2,{0},+,{1}S{2}M,60,0;".format(dest + 1, span, span))

    # --- background coverage (clean reads; also genotyping reference support) ---
    for _ in range(config.n_background):
        if len(hosts) == 1:
            host = "chr1"
        else:
            host = hosts[rng.randrange(len(hosts))]
        ref = contig_seqs[host]
        start = rng.randint(0, len(ref) - 4000)
        length = rng.randint(2000, 4000)
        line(0, host, start, "{0}M".format(length), ref[start:start + length])

    lines.sort(key=lambda entry: (entry.split("\t")[2], int(entry.split("\t")[3])))
    records = [parse_sam_line(entry, header) for entry in lines]
    bam_path = os.path.join(out_dir, "reads.bam")
    bamio.write_bam(bam_path, header, records)
    return genome_path, bam_path, truth


def evaluate_vcf(vcf_path: str, truth: List[TruthVariant],
                 position_tolerance: int = 150, size_tolerance: float = 0.3):
    """Match VCF records against the truth set.

    Returns {svtype: (true_positives, false_positives, false_negatives)} plus
    an "ALL" entry; BND reverse records count as one with their mate."""
    calls = []
    with open(vcf_path) as handle:
        for entry in handle:
            if entry.startswith("#"):
                continue
            fields = entry.rstrip("\n").split("\t")
            info_fields = fields[7].split(";")
            info = dict(kv.split("=", 1) for kv in info_fields if "=" in kv)
            flags = set(kv for kv in info_fields if "=" not in kv)
            svtype = info.get("SVTYPE")
            pos = int(fields[1]) - 1
            if svtype in ("DEL", "INS"):
                length = abs(int(info.get("SVLEN", 0)))
            elif svtype == "INV":
                length = int(info.get("END", pos)) - pos
            elif svtype in ("DUP:TANDEM", "DUP:INT"):
                length = int(info.get("END", pos)) - pos
            else:
                length = 0
            calls.append((svtype, fields[0], pos, length,
                          "CUTPASTE" in flags))

    matched_truth = set()
    matched_calls = set()
    for call_index, (svtype, contig, pos, length, call_cutpaste) in enumerate(calls):
        for truth_index, variant in enumerate(truth):
            if truth_index in matched_truth:
                continue
            if variant.svtype != svtype or variant.contig != contig:
                continue
            if variant.cutpaste and not call_cutpaste:
                continue  # cut&paste truth needs the CUTPASTE-flagged call
            if abs(variant.start - pos) > position_tolerance:
                continue
            if variant.length and length:
                ratio = abs(variant.length - length) / variant.length
                if ratio > size_tolerance:
                    continue
            matched_truth.add(truth_index)
            matched_calls.add(call_index)
            break

    results = {}
    svtypes = sorted(set(v.svtype for v in truth))
    for svtype in svtypes + ["ALL"]:
        relevant_truth = [i for i, v in enumerate(truth)
                          if svtype == "ALL" or v.svtype == svtype]
        relevant_calls = [i for i, c in enumerate(calls)
                          if (svtype == "ALL" or c[0] == svtype)
                          and c[0] in (svtypes if svtype == "ALL" else [svtype])]
        tp = sum(1 for i in relevant_truth if i in matched_truth)
        fn = len(relevant_truth) - tp
        fp = sum(1 for i in relevant_calls if i not in matched_calls)
        results[svtype] = (tp, fp, fn)
    return results


def truth_collisions(truth: List[TruthVariant], margin: int = 1000):
    """Pairs of truth placements close enough that the reference's merge
    semantics may legitimately absorb one call into the other.

    sim.py places loci independently (no site reservation, unlike sim2), so
    by birthday statistics a dense truth set collides occasionally: e.g. an
    INS within ~partition distance of a DUP:INT destination is merged into
    the DUP_INT candidate and its INS call removed by the INS-removal sweep
    (SVIM_COMBINE.py:404-457, SVIM_merging.py:93-158) — a correct call, a
    'missed' truth row.  The accuracy harness bounds observed false
    negatives by this count so the stress number stays interpretable
    (round-4 344/345 root cause).

    Returns a list of (truth_index_a, truth_index_b) pairs, each counted
    once, for non-BND truths whose affected intervals (DUP:INT uses its
    DESTINATION locus) lie within `margin` bp on the same contig."""
    intervals = []
    for index, variant in enumerate(truth):
        if variant.svtype == "BND":
            continue
        if variant.svtype == "DUP:INT":
            intervals.append((index, variant.dest_contig, variant.dest_pos,
                              variant.dest_pos + variant.length))
        else:
            intervals.append((index, variant.contig, variant.start,
                              variant.start + variant.length))
    collisions = []
    for a in range(len(intervals)):
        index_a, contig_a, lo_a, hi_a = intervals[a]
        for b in range(a + 1, len(intervals)):
            index_b, contig_b, lo_b, hi_b = intervals[b]
            if contig_a != contig_b:
                continue
            gap = max(lo_a, lo_b) - min(hi_a, hi_b)
            if gap <= margin:
                collisions.append((index_a, index_b))
    return collisions


def f1(tp, fp, fn):
    if tp == 0:
        return 0.0
    precision = tp / (tp + fp)
    recall = tp / (tp + fn)
    return 2 * precision * recall / (precision + recall)
