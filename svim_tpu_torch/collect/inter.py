"""Inter-alignment (split-read) signature extraction.

Behavioral contract: svim/SVIM_inter.py:24-302 — read segments sorted along
the read, adjacent pairs classified into INS / DEL / INV / tandem-duplication
/ BND evidence by contig, orientation and deviation; per-read tandem-dup
run-length merging with copy counting; and a second pass that pairs opposing
translocations into interspersed-duplication evidence.

The pair classification here is organized as three handlers (same contig &
orientation, same contig & inverted, cross-contig), each emitting into a
shared per-read emitter; the decision thresholds and emitted coordinates are
exactly the reference's.
"""

from __future__ import annotations

import logging
from statistics import mean
from typing import List, NamedTuple

from svim_tpu_torch.signatures import (
    SignatureDeletion,
    SignatureDuplicationTandem,
    SignatureInsertion,
    SignatureInsertionFrom,
    SignatureInversion,
    SignatureTranslocation,
)


def is_similar(chr1, start1, end1, chr2, start2, end2, span_position_treshold=0.3):
    """Span-position similarity with the hardcoded 900 bp normalizer
    (reference: SVIM_inter.py:11-21)."""
    span1 = end1 - start1
    span2 = end2 - start2
    center1 = (start1 + end1) // 2
    center2 = (start2 + end2) // 2
    position_distance = abs(center1 - center2) / 900
    span_distance = abs(span1 - span2) / max(span1, span2)
    return chr1 == chr2 and position_distance + span_distance < span_position_treshold


class Segment(NamedTuple):
    """One alignment of a read in read-oriented query coordinates."""

    q_start: int
    q_end: int
    ref_id: int
    ref_start: int
    ref_end: int
    is_reverse: bool


def segments_from_alignments(alignments) -> List[Segment]:
    """Strand-correct query coordinates and sort segments along the read
    (reference: SVIM_inter.py:27-49)."""
    segments = []
    for alignment in alignments:
        if alignment.is_reverse:
            inferred_read_length = alignment.infer_read_length()
            if inferred_read_length is None:
                logging.warning(
                    "Skipping alignment because read length could not be inferred "
                    "from CIGAR. Query name: {0}, CIGAR: {1}".format(
                        alignment.query_name, alignment.cigarstring))
                continue
            q_start = inferred_read_length - alignment.query_alignment_end
            q_end = inferred_read_length - alignment.query_alignment_start
        else:
            q_start = alignment.query_alignment_start
            q_end = alignment.query_alignment_end
        segments.append(Segment(q_start, q_end, alignment.reference_id,
                                alignment.reference_start, alignment.reference_end,
                                alignment.is_reverse))
    segments.sort(key=lambda seg: (seg.q_start, seg.q_end))
    return segments


class _Emitter:
    """Collects the three output streams of the per-read analysis."""

    def __init__(self, read_name, options):
        self.read_name = read_name
        self.options = options
        self.signatures = []
        self.all_bnds = []       # BND twins of other classes (--all_bnds)
        self.tandem_runs = []    # (chr, start, end, fully_covered, is_forward)
        self.translocations = []  # (dir1, dir2, chr1, pos1, chr2, pos2)

    def bnd(self, chr1, pos1, dir1, chr2, pos2, dir2):
        self.signatures.append(SignatureTranslocation(
            chr1, pos1, dir1, chr2, pos2, dir2, "suppl", self.read_name))
        self.translocations.append((dir1, dir2, chr1, pos1, chr2, pos2))

    def bnd_twin(self, chr1, pos1, dir1, chr2, pos2, dir2):
        if self.options.all_bnds:
            self.all_bnds.append(SignatureTranslocation(
                chr1, pos1, dir1, chr2, pos2, dir2, "suppl", self.read_name))


def _classify_colinear(cur: Segment, nxt: Segment, ref_chr, primary, emit: _Emitter):
    """Same contig, same orientation (reference: SVIM_inter.py:68-150)."""
    opts = emit.options
    distance_on_read = nxt.q_start - cur.q_end
    if cur.is_reverse:
        distance_on_reference = cur.ref_start - nxt.ref_end
    else:
        distance_on_reference = nxt.ref_start - cur.ref_end
    if distance_on_read < -opts.segment_overlap_tolerance:
        return
    if distance_on_reference >= -opts.segment_overlap_tolerance:
        deviation = distance_on_read - distance_on_reference
        if deviation >= opts.min_sv_size:
            # INS candidate: needs no gap on the reference
            if distance_on_reference <= opts.segment_gap_tolerance:
                if not cur.is_reverse:
                    try:
                        insertion_seq = primary.query_sequence[cur.q_end:cur.q_end + deviation]
                    except TypeError:
                        insertion_seq = ""
                    anchor = cur.ref_end
                else:
                    try:
                        read_length = primary.infer_read_length()
                        insertion_seq = primary.query_sequence[
                            read_length - nxt.q_start:read_length - nxt.q_start + deviation]
                    except TypeError:
                        insertion_seq = ""
                    anchor = cur.ref_start
                emit.signatures.append(SignatureInsertion(
                    ref_chr, anchor, anchor + deviation, "suppl", emit.read_name, insertion_seq))
        elif -opts.max_sv_size <= deviation <= -opts.min_sv_size:
            # DEL candidate: needs no gap on the read
            if distance_on_read <= opts.segment_gap_tolerance:
                anchor = cur.ref_end if not cur.is_reverse else nxt.ref_end
                emit.signatures.append(SignatureDeletion(
                    ref_chr, anchor, anchor - deviation, "suppl", emit.read_name))
                emit.bnd_twin(ref_chr, anchor - 1, "fwd", ref_chr, anchor - deviation, "fwd")
        elif deviation < -opts.max_sv_size:
            # very large DEL or translocation
            if distance_on_read <= opts.segment_gap_tolerance:
                if not cur.is_reverse:
                    emit.bnd(ref_chr, cur.ref_end - 1, "fwd", ref_chr, nxt.ref_start, "fwd")
                else:
                    emit.bnd(ref_chr, cur.ref_start, "rev", ref_chr, nxt.ref_end - 1, "rev")
    else:
        # overlap on the reference -> tandem duplication evidence
        if distance_on_reference <= -opts.min_sv_size:
            if not cur.is_reverse:
                if nxt.ref_end > cur.ref_start:
                    emit.tandem_runs.append((ref_chr, nxt.ref_start, cur.ref_end, True, True))
                    emit.bnd_twin(ref_chr, cur.ref_end - 1, "fwd", ref_chr, nxt.ref_start, "fwd")
                elif distance_on_reference >= -opts.max_sv_size:
                    emit.tandem_runs.append((ref_chr, nxt.ref_start, cur.ref_end, False, True))
                    emit.bnd_twin(ref_chr, cur.ref_end - 1, "fwd", ref_chr, nxt.ref_start, "fwd")
                else:
                    emit.bnd(ref_chr, cur.ref_end - 1, "fwd", ref_chr, nxt.ref_start, "fwd")
            else:
                if nxt.ref_start < cur.ref_end:
                    emit.tandem_runs.append((ref_chr, cur.ref_start, nxt.ref_end, True, False))
                    emit.bnd_twin(ref_chr, cur.ref_start, "rev", ref_chr, nxt.ref_end - 1, "rev")
                elif distance_on_reference >= -opts.max_sv_size:
                    emit.tandem_runs.append((ref_chr, cur.ref_start, nxt.ref_end, False, False))
                    emit.bnd_twin(ref_chr, cur.ref_start, "rev", ref_chr, nxt.ref_end - 1, "rev")
                else:
                    emit.bnd(ref_chr, cur.ref_start, "rev", ref_chr, nxt.ref_end - 1, "rev")


def _classify_inverted(cur: Segment, nxt: Segment, ref_chr, emit: _Emitter):
    """Same contig, opposite orientations: the four inversion direction cases
    (reference: SVIM_inter.py:152-204)."""
    opts = emit.options
    distance_on_read = nxt.q_start - cur.q_end
    if not (-opts.segment_overlap_tolerance <= distance_on_read <= opts.segment_gap_tolerance):
        return
    if not cur.is_reverse and nxt.is_reverse:
        if nxt.ref_start - cur.ref_end >= -opts.segment_overlap_tolerance:  # Case 1
            span = nxt.ref_end - cur.ref_end
            if opts.min_sv_size <= span <= opts.max_sv_size:
                emit.signatures.append(SignatureInversion(
                    ref_chr, cur.ref_end, nxt.ref_end, "suppl", emit.read_name, "left_fwd"))
                emit.bnd_twin(ref_chr, cur.ref_end - 1, "fwd", ref_chr, nxt.ref_end - 1, "rev")
            elif span > opts.max_sv_size:
                emit.bnd(ref_chr, cur.ref_end - 1, "fwd", ref_chr, nxt.ref_end - 1, "rev")
        elif cur.ref_start - nxt.ref_end >= -opts.segment_overlap_tolerance:  # Case 3
            span = cur.ref_end - nxt.ref_end
            if opts.min_sv_size <= span <= opts.max_sv_size:
                emit.signatures.append(SignatureInversion(
                    ref_chr, nxt.ref_end, cur.ref_end, "suppl", emit.read_name, "left_rev"))
                emit.bnd_twin(ref_chr, cur.ref_end - 1, "fwd", ref_chr, nxt.ref_end - 1, "rev")
            elif span > opts.max_sv_size:
                emit.bnd(ref_chr, cur.ref_end - 1, "fwd", ref_chr, nxt.ref_end - 1, "rev")
    elif cur.is_reverse and not nxt.is_reverse:
        if nxt.ref_start - cur.ref_end >= -opts.segment_overlap_tolerance:  # Case 2
            span = nxt.ref_start - cur.ref_start
            if opts.min_sv_size <= span <= opts.max_sv_size:
                emit.signatures.append(SignatureInversion(
                    ref_chr, cur.ref_start, nxt.ref_start, "suppl", emit.read_name, "right_fwd"))
                emit.bnd_twin(ref_chr, cur.ref_start, "rev", ref_chr, nxt.ref_start, "fwd")
            elif span > opts.max_sv_size:
                emit.bnd(ref_chr, cur.ref_start, "rev", ref_chr, nxt.ref_start, "fwd")
        elif cur.ref_start - nxt.ref_end >= -opts.segment_overlap_tolerance:  # Case 4
            span = cur.ref_start - nxt.ref_start
            if opts.min_sv_size <= span <= opts.max_sv_size:
                emit.signatures.append(SignatureInversion(
                    ref_chr, nxt.ref_start, cur.ref_start, "suppl", emit.read_name, "right_rev"))
                emit.bnd_twin(ref_chr, cur.ref_start, "rev", ref_chr, nxt.ref_start, "fwd")
            elif span > opts.max_sv_size:
                emit.bnd(ref_chr, cur.ref_start, "rev", ref_chr, nxt.ref_start, "fwd")


def _classify_cross_contig(cur: Segment, nxt: Segment, chr_cur, chr_nxt, emit: _Emitter):
    """Different contigs -> breakends (reference: SVIM_inter.py:206-240)."""
    opts = emit.options
    distance_on_read = nxt.q_start - cur.q_end
    if not (-opts.segment_overlap_tolerance <= distance_on_read <= opts.segment_gap_tolerance):
        return
    if cur.is_reverse == nxt.is_reverse:
        if not cur.is_reverse:
            emit.bnd(chr_cur, cur.ref_end - 1, "fwd", chr_nxt, nxt.ref_start, "fwd")
        else:
            emit.bnd(chr_cur, cur.ref_start, "rev", chr_nxt, nxt.ref_end - 1, "rev")
    else:
        if not cur.is_reverse:
            emit.bnd(chr_cur, cur.ref_end - 1, "fwd", chr_nxt, nxt.ref_end - 1, "rev")
        else:
            emit.bnd(chr_cur, cur.ref_start, "rev", chr_nxt, nxt.ref_start, "fwd")


def _merge_tandem_runs(emit: _Emitter):
    """Run-length merge of per-read tandem duplication evidence with copy
    counting (reference: SVIM_inter.py:242-272)."""
    current_chromosome = None
    current_starts = []
    current_ends = []
    current_copy_number = 0
    current_fully_covered = []
    current_direction = None

    def flush():
        fully_covered = bool(sum(current_fully_covered))
        emit.signatures.append(SignatureDuplicationTandem(
            current_chromosome, int(mean(current_starts)), int(mean(current_ends)),
            current_copy_number, fully_covered, "suppl", emit.read_name))

    for chrom, start, end, covered, direction in emit.tandem_runs:
        if current_chromosome is None:
            current_chromosome = chrom
            current_starts = [start]
            current_ends = [end]
            current_copy_number = 1
            current_fully_covered = [covered]
            current_direction = direction
        elif (is_similar(current_chromosome, mean(current_starts), mean(current_ends),
                         chrom, start, end)
              and current_direction == direction):
            current_starts.append(start)
            current_ends.append(end)
            current_copy_number += 1
            current_fully_covered.append(covered)
        else:
            flush()
            current_chromosome = chrom
            current_starts = [start]
            current_ends = [end]
            current_copy_number = 1
            current_fully_covered = [covered]
            # Bug-for-bug parity: the reference does NOT reset
            # current_direction when a run flushes (SVIM_inter.py:262-269 only
            # resets chromosome/starts/ends/copies/covered), so every
            # subsequent run keeps comparing against the FIRST tandem's
            # direction.  Mixed-direction evidence in one read must merge the
            # same stale way here.
    if current_chromosome is not None:
        flush()


def _pair_translocations(emit: _Emitter):
    """Pair opposing translocations of one read into interspersed-duplication
    evidence (reference: SVIM_inter.py:274-301)."""
    opts = emit.options
    translocations = emit.translocations
    for this_index, (this_dir1, this_dir2, this_chr1, this_pos1,
                     this_chr2, this_pos2) in enumerate(translocations):
        for (before_dir1, before_dir2, before_chr1, before_pos1,
             before_chr2, before_pos2) in translocations[:this_index]:
            if before_dir1 != this_dir2 or before_dir2 != this_dir1:
                continue
            if not is_similar(before_chr1, before_pos1, before_pos1 + 1,
                              this_chr2, this_pos2, this_pos2 + 1,
                              span_position_treshold=0.1):
                continue
            if before_chr2 != this_chr1:
                continue
            if before_dir2 == before_dir1:
                if before_dir1 == "fwd":
                    if opts.min_sv_size <= this_pos1 - before_pos2 + 1 <= opts.max_sv_size:
                        emit.signatures.append(SignatureInsertionFrom(
                            before_chr2, before_pos2, this_pos1 + 1, before_chr1,
                            int(mean([before_pos1 + 1, this_pos2])), "suppl", emit.read_name))
                elif before_dir1 == "rev":
                    if opts.min_sv_size <= before_pos2 - this_pos1 <= opts.max_sv_size:
                        emit.signatures.append(SignatureInsertionFrom(
                            before_chr2, this_pos1, before_pos2 + 1, before_chr1,
                            int(mean([before_pos1, this_pos2 + 1])), "suppl", emit.read_name))
            # opposite flank directions would be an inverted interspersed
            # duplication; the reference leaves that case unhandled


def analyze_read_segments(primary, supplementaries, bam, options):
    """Analyze all segments of one read (reference: SVIM_inter.py:24-302).

    Returns (sv_signatures, translocation_signatures_all_bnds)."""
    emit = _Emitter(primary.query_name, options)
    segments = segments_from_alignments([primary] + supplementaries)

    for cur, nxt in zip(segments, segments[1:]):
        if cur.ref_id == nxt.ref_id:
            ref_chr = bam.getrname(cur.ref_id)
            if cur.is_reverse == nxt.is_reverse:
                _classify_colinear(cur, nxt, ref_chr, primary, emit)
            else:
                _classify_inverted(cur, nxt, ref_chr, emit)
        else:
            _classify_cross_contig(cur, nxt, bam.getrname(cur.ref_id),
                                   bam.getrname(nxt.ref_id), emit)

    _merge_tandem_runs(emit)
    _pair_translocations(emit)
    return emit.signatures, emit.all_bnds
