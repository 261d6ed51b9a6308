"""Independent donor-genome read simulator (the second accuracy harness).

Counterpart of svim_tpu/sim2.py, copied.  F1=1.0 against sim.py is
self-referential: the generator fabricates reads locus by locus with
exactly the CIGAR/SA shapes the detector looks for.  This module uses a fundamentally different model,
written from the SAM/VCF specs without sharing sim.py's helpers:

  1. build a reference genome;
  2. APPLY the structural variants to produce a DONOR haplotype, kept as a
     segment list (reference spans with strand, or novel sequence);
  3. sample reads uniformly from the donor (lognormal-ish lengths, both
     sequencing strands, diploid mixing with the unmodified reference
     haplotype);
  4. PROJECT each read back through the segment map into SAM alignments —
     contained D/I ops where a real aligner would keep one alignment,
     split alignments with SA tags where the walk jumps, flips strand, or
     re-walks reference (tandem copies).

Reads therefore span multiple SVs, cover breakpoints partially, appear on
both strands, and carry per-base noise — none of which sim.py's per-locus
fabrication produces.  Two confusion cases are explicit:
short tandem duplications represented as insertions by half the reads
(the DUP_TAN-vs-INS ambiguity the COMBINE sweep must resolve), and
cut&paste interspersed duplications whose source deletion must flag
CUTPASTE.

Truth is written as a BED file next to the outputs and evaluated against
variants.vcf straight from the VCF spec (scripts/eval_accuracy.py
--independent reports both harnesses).
"""

from __future__ import annotations

import math
import os
import random
from typing import List, NamedTuple, Optional, Tuple

_COMPLEMENT = str.maketrans("ACGTN", "TGCAN")


def _revcomp(seq: str) -> str:
    return seq.translate(_COMPLEMENT)[::-1]


class Truth(NamedTuple):
    svtype: str
    contig: str
    start: int      # 0-based reference breakpoint
    length: int
    cutpaste: bool = False


class Sim2Config(NamedTuple):
    seed: int = 1
    contig_lengths: Tuple[int, ...] = (1_600_000, 700_000)
    coverage: int = 14          # total; ~half of it carries the SVs (diploid)
    donor_fraction: float = 0.5
    read_mean: int = 12_000
    read_sigma: float = 0.35    # lognormal sigma of read length
    read_min: int = 3_000
    substitution_rate: float = 0.02
    indel_rate: float = 0.004   # small 1-4 bp sequencing indels
    n_del: int = 6
    n_ins: int = 6
    n_inv: int = 4
    n_tan: int = 4
    n_tan_short: int = 3        # DUP_TAN-vs-INS ambiguity cases
    n_dup_int: int = 3
    n_dup_int_cutpaste: int = 2
    n_bnd: int = 3
    # nested / adjacent SV stress (0 = off; round-5 addition — the prior
    # reserved-site design only ever placed isolated events)
    n_ins_in_inv: int = 0       # novel insertion INSIDE an inverted span
    n_del_in_tan: int = 0       # deletion inside the SECOND tandem copy
    n_replace: int = 0          # adjacent DEL+INS at one breakpoint
    n_close_del_pair: int = 0   # two DELs within one partition gap
    # a single alignment keeps reference gaps up to this size as D ops
    contain_gap: int = 3_000


class _Segment(NamedTuple):
    """One donor segment: a reference span or novel sequence.

    emit_as_insert marks reference spans a real aligner would express as an
    I op rather than a split (short duplication copies) — the sequence
    content still matches the reference elsewhere."""
    contig: Optional[str]       # None = novel sequence
    start: int
    end: int
    reverse: bool
    novel: str = ""
    emit_as_insert: bool = False


class _Donor:
    """A donor haplotype as an ordered segment list with a length index."""

    def __init__(self, segments: List[_Segment], genome):
        self.segments = segments
        self.genome = genome
        self.lengths = [self._segment_length(s) for s in segments]
        self.offsets = [0]
        for length in self.lengths:
            self.offsets.append(self.offsets[-1] + length)
        self.total = self.offsets[-1]

    def _segment_length(self, segment: _Segment) -> int:
        if segment.contig is None:
            return len(segment.novel)
        return segment.end - segment.start

    def segment_text(self, segment: _Segment) -> str:
        if segment.contig is None:
            return segment.novel
        text = self.genome[segment.contig][segment.start:segment.end]
        return _revcomp(text) if segment.reverse else text

    def window(self, lo: int, hi: int):
        """Segments (clipped) covering donor interval [lo, hi)."""
        import bisect
        out = []
        index = bisect.bisect_right(self.offsets, lo) - 1
        while index < len(self.segments) and self.offsets[index] < hi:
            segment = self.segments[index]
            seg_lo = max(lo, self.offsets[index]) - self.offsets[index]
            seg_hi = min(hi, self.offsets[index + 1]) - self.offsets[index]
            if seg_hi > seg_lo:
                out.append(self._clip(segment, seg_lo, seg_hi))
            index += 1
        return out

    def _clip(self, segment: _Segment, lo: int, hi: int) -> _Segment:
        if segment.contig is None:
            return segment._replace(novel=segment.novel[lo:hi])
        if segment.reverse:
            # donor-order position 0 corresponds to reference end
            return segment._replace(start=segment.end - hi,
                                    end=segment.end - lo)
        return segment._replace(start=segment.start + lo,
                                end=segment.start + hi)


class _Run:
    """One alignment-to-be: reference-colinear ops over a read span."""

    __slots__ = ("contig", "ref_start", "reverse", "ops", "read_start",
                 "read_end")

    def __init__(self, contig, ref_start, reverse, read_start):
        self.contig = contig
        self.ref_start = ref_start
        self.reverse = reverse
        self.ops = []           # (op char in read order, length)
        self.read_start = read_start
        self.read_end = read_start

    def add(self, op: str, length: int):
        if length <= 0:
            return
        if self.ops and self.ops[-1][0] == op:
            self.ops[-1] = (op, self.ops[-1][1] + length)
        else:
            self.ops.append((op, length))
        if op in ("M", "I"):
            self.read_end += length

    @property
    def ref_span(self) -> int:
        return sum(length for op, length in self.ops if op in ("M", "D"))


def _project(donor: _Donor, lo: int, hi: int, contain_gap: int,
             insert_rep: bool):
    """Alignment runs for donor interval [lo, hi) (donor-forward
    orientation).  insert_rep: whether THIS read expresses emit_as_insert
    segments as I ops (True) or as ordinary reference walks that split into
    duplication-shaped alignments (False) — the per-read representation coin
    behind the DUP_TAN-vs-INS confusion cases.

    Returns (runs, read_text).  Run ops and read coordinates are in
    donor-forward order; _run_records converts to SAM frames."""
    segments = donor.window(lo, hi)
    text_parts = [donor.segment_text(s) for s in segments]
    read_text = "".join(text_parts)

    runs: List[_Run] = []
    run: Optional[_Run] = None
    pending_insert = 0          # read bases awaiting attachment as an I op
    read_pos = 0
    for segment, text in zip(segments, text_parts):
        if segment.contig is None or (segment.emit_as_insert and insert_rep):
            pending_insert += len(text)
            read_pos += len(text)
            continue
        seg_len = segment.end - segment.start
        gap = None
        if run is not None and run.contig == segment.contig \
                and run.reverse == segment.reverse:
            if not segment.reverse:
                gap = segment.start - (run.ref_start + run.ref_span)
            else:
                # reverse runs walk reference right-to-left in donor order
                gap = run.ref_start - segment.end
        if gap is not None and 0 <= gap <= contain_gap:
            if pending_insert:
                run.add("I", pending_insert)
            if gap:
                run.add("D", gap)
            if segment.reverse:
                run.ref_start = segment.start
            run.add("M", seg_len)
        else:
            # split: any pending novel bases fall into the soft-clipped
            # inter-segment territory (none occurs at the SV junctions this
            # generator builds)
            run = _Run(segment.contig, segment.start, segment.reverse,
                       read_pos)
            run.add("M", seg_len)
            runs.append(run)
        pending_insert = 0
        read_pos += seg_len
    return [r for r in runs if r.ref_span > 0], read_text


def _apply_noise(rng, runs, read_text, substitution_rate, indel_rate):
    """Sequencing noise: substitutions mutate the read text in place;
    small indels splice extra I/D ops into the runs' M blocks."""
    text = list(read_text)
    n = len(text)
    for _ in range(int(n * substitution_rate)):
        position = rng.randrange(n)
        text[position] = rng.choice("ACGT")
    # indels: inject into a random M op of a random run.  Insertions add
    # bases to the read (splice into text); deletions drop bases.
    out_runs = runs
    events = int(n * indel_rate)
    for _ in range(events):
        run = rng.choice(out_runs)
        m_indices = [i for i, (op, _) in enumerate(run.ops) if op == "M"
                     and run.ops[i][1] > 10]
        if not m_indices:
            continue
        at = rng.choice(m_indices)
        op_len = run.ops[at][1]
        split = rng.randint(5, op_len - 5)
        size = rng.randint(1, 4)
        # read offset of the split point within this run
        read_offset = run.read_start + sum(
            length for op, length in run.ops[:at] if op in ("M", "I")) + split
        if rng.random() < 0.5:
            # insertion: novel bases appear in the read
            run.ops[at:at + 1] = [("M", split), ("I", size),
                                  ("M", op_len - split)]
            insert = [rng.choice("ACGT") for _ in range(size)]
            text[read_offset:read_offset] = insert
            _shift_reads(out_runs, run, read_offset, size)
            run.read_end += size
        else:
            if op_len - split <= size + 5:
                continue
            run.ops[at:at + 1] = [("M", split), ("D", size),
                                  ("M", op_len - split - size)]
            del text[read_offset:read_offset + size]
            _shift_reads(out_runs, run, read_offset, -size)
            run.read_end -= size
    return out_runs, "".join(text)


def _shift_reads(runs, changed, read_offset, delta):
    """Shift read coordinates of runs after an indel in `changed`."""
    for run in runs:
        if run is changed:
            continue
        if run.read_start >= read_offset:
            run.read_start += delta
            run.read_end += delta


def _cigar_string(ops) -> str:
    return "".join("{0}{1}".format(length, op) for op, length in ops)


def _run_records(runs, read_text, read_reverse, name):
    """SAM record tuples for one read: (flag, contig, pos0, cigar, seq, sa).

    Frames: run ops/coords are donor-forward.  A record's CIGAR depends only
    on the SEGMENT strand (reverse runs mirror ops and clips into
    reference-forward order); the SEQUENCING strand only flips the FLAG
    orientation and which orientation of the read the SEQ column stores.
    Primary = longest aligned run; every record carries the SA tag listing
    the others."""
    length = len(read_text)
    rendered = []
    for run in runs:
        if run.reverse:
            ops = run.ops[::-1]
            lead = length - run.read_end
            tail = run.read_start
        else:
            ops = run.ops
            lead = run.read_start
            tail = length - run.read_end
        cigar = "".join(((str(lead) + "S") if lead else "",
                         _cigar_string(ops),
                         (str(tail) + "S") if tail else ""))
        rendered.append({
            "contig": run.contig, "pos": run.ref_start,
            "reverse": run.reverse != read_reverse,
            "seq_reverse": run.reverse,  # SEQ = revcomp^seq_reverse(donor)
            "cigar": cigar,
            "aligned": run.read_end - run.read_start,
        })
    primary_index = max(range(len(rendered)),
                        key=lambda i: rendered[i]["aligned"])
    records = []
    for index, info in enumerate(rendered):
        primary = index == primary_index
        flag = (0x10 if info["reverse"] else 0) | (0 if primary else 0x800)
        others = [rendered[j] for j in range(len(rendered)) if j != index]
        sa = ";".join("{0},{1},{2},{3},60,0".format(
            other["contig"], other["pos"] + 1,
            "-" if other["reverse"] else "+", other["cigar"])
            for other in others)
        sa = sa + ";" if sa else None
        seq = "*"
        if primary:
            seq = _revcomp(read_text) if info["seq_reverse"] else read_text
        records.append((flag, info["contig"], info["pos"], info["cigar"],
                        seq, sa, name))
    return records


def build_donor(genome, config: Sim2Config, rng):
    """Apply SVs to the reference; returns ({contig: [segments]}, truth)."""
    contigs = sorted(genome)
    truth: List[Truth] = []
    # reserve non-overlapping edit sites per contig
    edits = {name: [] for name in contigs}   # (pos, kind, params)
    used = {name: [] for name in contigs}

    def reserve(contig, span, margin=None):
        if margin is None:
            margin = min(30_000, len(genome[contig]) // 8)
        for _ in range(200):
            position = rng.randint(margin, len(genome[contig]) - margin - span)
            if all(abs(position - p) > span + other + 8_000
                   for p, other in used[contig]):
                used[contig].append((position, span))
                return position
        raise RuntimeError("could not place SV")

    def pick_host():
        # SVs land on every contig
        return contigs[rng.randrange(len(contigs))]

    for _ in range(config.n_del):
        contig = pick_host()
        size = rng.randint(50, 1_500)
        position = reserve(contig, size)
        edits[contig].append((position, "DEL", size))
        truth.append(Truth("DEL", contig, position, size))
    for _ in range(config.n_ins):
        contig = pick_host()
        size = rng.randint(50, 900)
        position = reserve(contig, size)
        novel = "".join(rng.choice("ACGT") for _ in range(size))
        edits[contig].append((position, "INS", novel))
        truth.append(Truth("INS", contig, position, size))
    for _ in range(config.n_inv):
        contig = pick_host()
        size = rng.randint(200, 4_000)
        position = reserve(contig, size)
        edits[contig].append((position, "INV", size))
        truth.append(Truth("INV", contig, position, size))
    for _ in range(config.n_tan):
        contig = pick_host()
        size = rng.randint(150, 1_200)
        position = reserve(contig, size)
        edits[contig].append((position, "TAN", (size, 1, False)))
        truth.append(Truth("DUP:TANDEM", contig, position, size))
    for _ in range(config.n_tan_short):
        # short copies: half the reads will show an I op instead of a split
        contig = pick_host()
        size = rng.randint(60, 140)
        position = reserve(contig, size)
        edits[contig].append((position, "TAN", (size, 1, True)))
        truth.append(Truth("DUP:TANDEM", contig, position, size))
    for index in range(config.n_dup_int + config.n_dup_int_cutpaste):
        cutpaste = index >= config.n_dup_int
        # source on one contig, insertion point on another (clean BND pair)
        source_contig = contigs[index % len(contigs)]
        dest_contig = contigs[(index + 1) % len(contigs)]
        size = rng.randint(120, 900)
        source = reserve(source_contig, size)
        dest = reserve(dest_contig, 1)
        edits[dest_contig].append((dest, "COPY_IN",
                                   (source_contig, source, size)))
        if cutpaste:
            # the donor really deletes the origin span: a DEL call there is
            # a true variant, and its cluster flags the candidate CUTPASTE
            edits[source_contig].append((source, "DEL", size))
            truth.append(Truth("DEL", source_contig, source, size))
        truth.append(Truth("DUP:INT", source_contig, source, size, cutpaste))
        # the copy junctions also surface as breakend records (the reference
        # emits BND candidates for every translocation cluster,
        # SVIM_COMBINE.py:372-383)
        truth.append(Truth("BND", dest_contig, dest - 1, 0))
        truth.append(Truth("BND", dest_contig, dest, 0))
        truth.append(Truth("BND", source_contig, source, 0))
        truth.append(Truth("BND", source_contig, source + size - 1, 0))
    # --- nested / adjacent stress cases (all share one reserved outer
    # span, so the reservation guarantee still isolates the COMPOSITE from
    # other truth sites while the composite's parts deliberately interact) —
    for _ in range(config.n_ins_in_inv):
        # inversion whose INVERTED sequence carries a novel insertion: the
        # reverse alignment run keeps an internal I op, so the caller must
        # report both the INV (split orientation flips, SVIM_inter.py:152-204)
        # and the INS (cigar scan, SVIM_intra.py:33) at the same locus
        contig = pick_host()
        size = rng.randint(800, 3_000)
        position = reserve(contig, size)
        k = rng.randint(150, size - 150)      # reference offset of the INS
        ins_len = rng.randint(60, 300)
        novel = "".join(rng.choice("ACGT") for _ in range(ins_len))
        edits[contig].append((position, "INV_INS", (size, k, novel)))
        truth.append(Truth("INV", contig, position, size))
        truth.append(Truth("INS", contig, position + k, ins_len))
    for _ in range(config.n_del_in_tan):
        # tandem duplication whose second copy lost an internal span: the
        # duplication split evidence and a DEL cigar signature (from the
        # second copy's alignment) coexist inside one reference window
        contig = pick_host()
        size = rng.randint(600, 1_500)
        position = reserve(contig, size)
        d_off = rng.randint(80, size - 300)
        d_len = rng.randint(60, min(size - d_off - 100, 400))
        edits[contig].append((position, "TAN_DEL", (size, d_off, d_len)))
        truth.append(Truth("DUP:TANDEM", contig, position, size))
        truth.append(Truth("DEL", contig, position + d_off, d_len))
    for _ in range(config.n_replace):
        # replacement: a deletion and an insertion at the SAME breakpoint
        # (adjacent I and D ops in one alignment)
        contig = pick_host()
        d_size = rng.randint(60, 600)
        i_size = rng.randint(60, 600)
        position = reserve(contig, d_size)
        novel = "".join(rng.choice("ACGT") for _ in range(i_size))
        edits[contig].append((position, "REPLACE", (d_size, novel)))
        truth.append(Truth("DEL", contig, position, d_size))
        truth.append(Truth("INS", contig, position, i_size))
    for _ in range(config.n_close_del_pair):
        # two deletions inside ONE partition gap (< partition_max_distance):
        # form_partitions groups them and the linkage cut must still
        # separate the two clusters (gap >= 550 keeps the span-position
        # distance above the 0.5 fcluster cut, SVIM_clustering.py:47-63)
        contig = pick_host()
        d1 = rng.randint(60, 400)
        gap = rng.randint(550, 900)
        d2 = rng.randint(60, 400)
        position = reserve(contig, d1 + gap + d2)
        edits[contig].append((position, "DEL", d1))
        edits[contig].append((position + d1 + gap, "DEL", d2))
        truth.append(Truth("DEL", contig, position, d1))
        truth.append(Truth("DEL", contig, position + d1 + gap, d2))
    for _ in range(config.n_bnd):
        # reciprocal-less simple junction: splice a distant span in.
        # The destination must be INTER-chromosomal: a same-contig
        # reversed splice within max_sv_size is legitimately classified
        # as an INVERSION by the reference (SVIM_inter.py:152-204), which
        # would make the BND truth rows unmatchable.
        dest_contig = pick_host()
        source_contig = contigs[-1]
        if dest_contig == source_contig and len(contigs) > 1:
            dest_contig = contigs[contigs.index(dest_contig) - 1]
        size = rng.randint(5_000, 12_000)
        source = reserve(source_contig, size)
        dest = reserve(dest_contig, 1)
        edits[dest_contig].append((dest, "SPLICE",
                                   (source_contig, source, size)))
        truth.append(Truth("BND", dest_contig, dest - 1, 0))
        truth.append(Truth("BND", dest_contig, dest, 0))
        truth.append(Truth("BND", source_contig, source, 0))
        truth.append(Truth("BND", source_contig, source + size - 1, 0))

    donors = {}
    for contig in contigs:
        cursor = 0
        segments: List[_Segment] = []
        for position, kind, params in sorted(edits[contig]):
            if position > cursor:
                segments.append(_Segment(contig, cursor, position, False))
            if kind == "DEL":
                cursor = position + params
            elif kind == "INS":
                segments.append(_Segment(None, 0, 0, False, novel=params))
                cursor = position
            elif kind == "INV":
                segments.append(_Segment(contig, position, position + params,
                                         True))
                cursor = position + params
            elif kind == "TAN":
                size, extra_copies, as_insert = params
                segments.append(_Segment(contig, position, position + size,
                                         False))
                for _ in range(extra_copies):
                    segments.append(_Segment(contig, position,
                                             position + size, False,
                                             emit_as_insert=as_insert))
                cursor = position + size
            elif kind == "INV_INS":
                size, k, novel = params
                # donor carries revcomp(ref[p:p+size]) with `novel` spliced
                # at donor offset size-k (= reference offset k); the three
                # segments merge into ONE reverse alignment run with an
                # internal I op (_project's reverse-gap merge)
                segments.append(_Segment(contig, position + k,
                                         position + size, True))
                segments.append(_Segment(None, 0, 0, False, novel=novel))
                segments.append(_Segment(contig, position, position + k,
                                         True))
                cursor = position + size
            elif kind == "TAN_DEL":
                size, d_off, d_len = params
                segments.append(_Segment(contig, position, position + size,
                                         False))
                # second copy, minus [d_off, d_off+d_len): the two pieces
                # merge into one forward run with an internal D op
                segments.append(_Segment(contig, position, position + d_off,
                                         False))
                segments.append(_Segment(contig, position + d_off + d_len,
                                         position + size, False))
                cursor = position + size
            elif kind == "REPLACE":
                d_size, novel = params
                segments.append(_Segment(None, 0, 0, False, novel=novel))
                cursor = position + d_size
            elif kind == "COPY_IN":
                other, source, size = params
                segments.append(_Segment(other, source, source + size, False))
                cursor = position
            elif kind == "SPLICE":
                # REVERSED span: the (fwd,rev)/(rev,fwd) junction pair does
                # not satisfy the reference's INS_DUP pairing
                # (SVIM_inter.py:292-301 emits nothing for the inverted
                # case), so these stay pure breakends
                other, source, size = params
                segments.append(_Segment(other, source, source + size, True))
                cursor = position
        if cursor < len(genome[contig]):
            segments.append(_Segment(contig, cursor, len(genome[contig]),
                                     False))
        donors[contig] = segments
    return donors, truth


def simulate_independent(out_dir: str, config: Sim2Config = Sim2Config()):
    """Write genome.fa, reads.bam, truth.bed under out_dir; return
    (genome_path, bam_path, truth list)."""
    from svim_tpu_torch.io import bam as bamio
    from svim_tpu_torch.io.sam import AlignmentHeader, parse_sam_line

    rng = random.Random(config.seed)
    genome = {}
    for index, length in enumerate(config.contig_lengths):
        name = "ctg{0}".format(index + 1)
        genome[name] = "".join(rng.choice("ACGT") for _ in range(length))
    genome_path = os.path.join(out_dir, "genome.fa")
    with open(genome_path, "w") as handle:
        for name in sorted(genome):
            handle.write(">{0}\n".format(name))
            seq = genome[name]
            for i in range(0, len(seq), 80):
                handle.write(seq[i:i + 80] + "\n")

    donor_segments, truth = build_donor(genome, config, rng)
    donors = {name: _Donor(segments, genome)
              for name, segments in donor_segments.items()}
    reference_donors = {name: _Donor([_Segment(name, 0, len(genome[name]),
                                               False)], genome)
                        for name in genome}

    header_text = "@HD\tVN:1.6\tSO:coordinate\n" + "".join(
        "@SQ\tSN:{0}\tLN:{1}\n".format(name, len(genome[name]))
        for name in sorted(genome))
    header = AlignmentHeader.from_text(header_text)

    sam_records = []
    read_id = [0]

    def sample_reads(donor_map, coverage_fraction):
        for contig in sorted(donor_map):
            donor = donor_map[contig]
            target_bases = int(donor.total * config.coverage
                               * coverage_fraction)
            emitted = 0
            while emitted < target_bases:
                length = int(rng.lognormvariate(math.log(config.read_mean),
                                                config.read_sigma))
                length = max(config.read_min, min(length, donor.total))
                lo = rng.randint(0, donor.total - length)
                runs, text = _project(donor, lo, lo + length,
                                      config.contain_gap,
                                      insert_rep=rng.random() < 0.5)
                emitted += length
                if not runs:
                    continue
                runs, text = _apply_noise(rng, runs, text,
                                          config.substitution_rate,
                                          config.indel_rate)
                read_reverse = rng.random() < 0.5
                read_id[0] += 1
                name = "ind{0}".format(read_id[0])
                for (flag, rec_contig, pos, cigar, seq, sa,
                     rec_name) in _run_records(runs, text, read_reverse,
                                               name):
                    tags = "\tSA:Z:{0}".format(sa) if sa else ""
                    sam_records.append(
                        "{0}\t{1}\t{2}\t{3}\t60\t{4}\t*\t0\t0\t{5}\t*{6}"
                        .format(rec_name, flag, rec_contig, pos + 1, cigar,
                                seq, tags))

    sample_reads(donors, config.donor_fraction)
    sample_reads(reference_donors, 1.0 - config.donor_fraction)

    records = [parse_sam_line(line, header) for line in sam_records]
    records.sort(key=lambda record: (record.reference_id,
                                     record.reference_start))
    bam_path = os.path.join(out_dir, "reads.bam")
    bamio.write_bam(bam_path, header, records)

    truth_path = os.path.join(out_dir, "truth.bed")
    with open(truth_path, "w") as handle:
        for variant in truth:
            handle.write("{0}\t{1}\t{2}\t{3}\t{4}\n".format(
                variant.contig, variant.start, variant.start + variant.length,
                variant.svtype, "CUTPASTE" if variant.cutpaste else "."))
    return genome_path, bam_path, truth
