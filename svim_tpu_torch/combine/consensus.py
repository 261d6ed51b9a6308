"""Insertion consensus generation (SPOA replacement).

Behavioral contract: svim/SVIM_COMBINE.py:188-329 — build reference-padded
haplotypes for an insertion cluster, compute their consensus, re-align the
consensus against the reference window, locate the gap run in the reference
MSA row, and accept a unique match with size ratio < allowed_size_deviation.
Status codes: 0 success, 1 skipped (too long), 2 failed, 3 no match,
4 multiple matches.

The consensus itself is a star MSA over a two-piece-affine global aligner
(SPOA's algorithm=1 scoring: m=2, n=-4, g=-4, e=-2, q=-24, c=-1).  The
aligner is the native C++ kernel (svim_tpu_torch/native); the pure-Python
Gotoh DP takes only an input the native call refuses.  On a CUDA device the
pool's alignments (the polish rounds' members against the center, the
realignment, the star MSA's) run on the card instead, as batched launches
of csrc/gotoh.cu (ops/gotoh_kernel.py) with the host aligner's results; the
seed, the row walk and the votes stay on the host.
"""

from __future__ import annotations

import logging
import re
from collections import Counter

from svim_tpu_torch.utils import timing

# SPOA algorithm=1 parameters (SVIM_COMBINE.py:208)
MATCH = 2
MISMATCH = -4
GAP_OPEN1 = -4
GAP_EXT1 = -2
GAP_OPEN2 = -24
GAP_EXT2 = -1

# guards against pathological DP sizes (SPOA raises MemoryError there;
# reference catches it and reports status 2).  The native aligner holds one
# byte of traceback per cell, so it affords far larger problems (a full
# 10 kb x 10 kb haplotype pair is ~110 MB) than the Python fallback.
MAX_DP_CELLS_NATIVE = 256_000_000
MAX_DP_CELLS_PY = 16_000_000
# DPs at or below this many cells run the full matrix; larger ones run a
# banded corridor (band 64, doubled whenever the traceback grazes a corridor
# boundary — the acceptance rule of the round-4 banded graph alignment).
# Native (svimnative.cpp kGotohFullDpCells) and this Python oracle apply the
# identical policy so the star-polish differential stays byte-equal.
# Round-5: 4M -> 16k, banding typical cluster-sized DPs (measured 3-24x
# at mid-length 436-4000 with byte-identical alignments).
FULL_DP_CELLS_AUTO = 16_384

NEG_INF = float("-inf")


def align_global(a: str, b: str, full_dp_cells: int = FULL_DP_CELLS_AUTO):
    """Global alignment of a vs b with two-piece affine gaps.

    Returns (row_a, row_b): equal-length strings with '-' for gaps.  Large
    problems (> full_dp_cells) run banded-with-doubling; an accepted banded
    alignment never grazed its corridor boundary."""
    if len(a) == 0:
        return "-" * len(b), b
    if len(b) == 0:
        return a, "-" * len(a)
    from svim_tpu_torch.native import aligner

    try:
        return aligner.align_global(a, b, full_dp_cells=full_dp_cells)
    except RuntimeError as error:
        # the native aligner's refusal of an input (a non-zero status);
        # a library that fails to build or load raises through
        if error.args != (aligner.REFUSED,):
            raise
    return _align_global_py_auto(a, b, full_dp_cells)


def _on_card(device) -> bool:
    return device is not None and device.type == "cuda"


def _card_alignments(center: str, others, device):
    """gotoh_align_auto of `center` against each of `others` on the card,
    in one batch in a workspace (a CUDA stream and buffers) that no other
    thread uses meanwhile, so that the clusters' launches do not queue
    behind each other on one stream; the pairs and DP cells go to the
    job's counts `consensus.card_alignments` and `consensus.gotoh_cells`."""
    from svim_tpu_torch.ops import gotoh_kernel

    encoded = center.encode()
    with gotoh_kernel.WORKSPACES.borrow(device) as workspace:
        aligned = gotoh_kernel.gotoh_align_batch(
            [(encoded, other.encode()) for other in others], device,
            workspace)
    timing.count("consensus.card_alignments", aligned.aligned)
    timing.count("consensus.gotoh_cells", aligned.cells)
    return aligned


def _align_all(center: str, others, device=None):
    """[align_global(center, other) for other in others]: on the card on a
    CUDA device, else the host aligner; the pairs with two non-empty sides
    count as `consensus.card_alignments` or `consensus.host_alignments`."""
    if _on_card(device):
        aligned = _card_alignments(center, others, device)
        return [aligned.rows(k, center, other)
                for k, other in enumerate(others)]
    if center:
        timing.count("consensus.host_alignments",
                     sum(1 for other in others if other))
    return [align_global(center, other) for other in others]


def _align_global_py_auto(a: str, b: str,
                          full_dp_cells: int = FULL_DP_CELLS_AUTO):
    """Python twin of the native gotoh_align_auto banding policy."""
    la, lb = len(a), len(b)
    full_cells = (la + 1) * (lb + 1)
    if full_cells <= full_dp_cells:
        if full_cells > MAX_DP_CELLS_PY:
            raise MemoryError(
                "alignment DP too large: {0}x{1}".format(la, lb))
        return _align_global_py(a, b)
    spread = abs(lb - la)
    band = 64
    while spread + 2 * band < lb:
        cells = (la + 1) * (spread + 2 * band + 1)
        if cells > MAX_DP_CELLS_PY:
            raise MemoryError(
                "alignment DP too large: {0}x{1}".format(la, lb))
        result = _align_global_banded_py(a, b, band)
        if result is not None:
            return result
        band *= 2
    if full_cells > MAX_DP_CELLS_PY:
        raise MemoryError("alignment DP too large: {0}x{1}".format(la, lb))
    return _align_global_py(a, b)


def _align_global_py(a: str, b: str):
    """Pure-Python Gotoh with two gap pieces (M plus two vertical and two
    horizontal gap states) and a packed per-cell traceback.

    Traceback byte layout: bits 0-1 best state (0 M, 1 V, 2 H); bit 2 V won
    with piece 2; bit 3/4 V piece 1/2 extended; bit 5 H won with piece 2;
    bit 6/7 H piece 1/2 extended."""
    la, lb = len(a), len(b)
    width = lb + 1
    traceback = [bytearray(width) for _ in range(la + 1)]

    # row 0: only horizontal gaps are reachable
    best_prev = [0.0] * width
    h1 = NEG_INF
    h2 = NEG_INF
    row_tb = traceback[0]
    for j in range(1, width):
        open1 = best_prev[j - 1] + GAP_OPEN1
        ext1 = h1 + GAP_EXT1
        h1 = max(open1, ext1)
        open2 = best_prev[j - 1] + GAP_OPEN2
        ext2 = h2 + GAP_EXT2
        h2 = max(open2, ext2)
        flags = 2
        if h2 > h1:
            flags |= 0x20
        if ext1 >= open1:
            flags |= 0x40
        if ext2 >= open2:
            flags |= 0x80
        row_tb[j] = flags
        best_prev[j] = max(h1, h2)

    v1_prev = [NEG_INF] * width
    v2_prev = [NEG_INF] * width
    for i in range(1, la + 1):
        ca = a[i - 1]
        row_tb = traceback[i]
        best_cur = [NEG_INF] * width
        v1 = [NEG_INF] * width
        v2 = [NEG_INF] * width
        # column 0: only vertical gaps
        open1 = best_prev[0] + GAP_OPEN1
        ext1 = v1_prev[0] + GAP_EXT1
        v1[0] = max(open1, ext1)
        open2 = best_prev[0] + GAP_OPEN2
        ext2 = v2_prev[0] + GAP_EXT2
        v2[0] = max(open2, ext2)
        flags = 1
        if v2[0] > v1[0]:
            flags |= 0x04
        if ext1 >= open1:
            flags |= 0x08
        if ext2 >= open2:
            flags |= 0x10
        row_tb[0] = flags
        best_cur[0] = max(v1[0], v2[0])
        h1 = NEG_INF
        h2 = NEG_INF
        for j in range(1, width):
            flags = 0
            # vertical gaps: open from previous row's best or extend
            open1 = best_prev[j] + GAP_OPEN1
            ext1 = v1_prev[j] + GAP_EXT1
            v1[j] = max(open1, ext1)
            if ext1 >= open1:
                flags |= 0x08
            open2 = best_prev[j] + GAP_OPEN2
            ext2 = v2_prev[j] + GAP_EXT2
            v2[j] = max(open2, ext2)
            if ext2 >= open2:
                flags |= 0x10
            vbest = v1[j]
            if v2[j] > vbest:
                vbest = v2[j]
                flags |= 0x04
            # horizontal gaps: open from this row's best or extend
            open1 = best_cur[j - 1] + GAP_OPEN1
            ext1 = h1 + GAP_EXT1
            h1 = max(open1, ext1)
            if ext1 >= open1:
                flags |= 0x40
            open2 = best_cur[j - 1] + GAP_OPEN2
            ext2 = h2 + GAP_EXT2
            h2 = max(open2, ext2)
            if ext2 >= open2:
                flags |= 0x80
            hbest = h1
            if h2 > hbest:
                hbest = h2
                flags |= 0x20
            score = best_prev[j - 1] + (MATCH if ca == b[j - 1] else MISMATCH)
            # tie preference: gaps win ties so runs consolidate
            if vbest >= score and vbest >= hbest:
                best = vbest
                flags |= 1
            elif hbest >= score:
                best = hbest
                flags |= 2
            else:
                best = score
            best_cur[j] = best
            row_tb[j] = flags
        best_prev = best_cur
        v1_prev = v1
        v2_prev = v2

    # walk the traceback honoring gap-state persistence
    row_a = []
    row_b = []
    i, j = la, lb
    state = traceback[i][j] & 3
    piece = None  # gap piece of the current run; None until first gap cell
    while i > 0 or j > 0:
        flags = traceback[i][j]
        if state == 0:
            row_a.append(a[i - 1])
            row_b.append(b[j - 1])
            i -= 1
            j -= 1
            state = traceback[i][j] & 3
            piece = None
        elif state == 1:
            if piece is None:
                piece = 2 if (flags & 0x04) else 1
            extended = bool(flags & (0x10 if piece == 2 else 0x08))
            row_a.append(a[i - 1])
            row_b.append("-")
            i -= 1
            if not extended:
                state = traceback[i][j] & 3
                piece = None
        else:
            if piece is None:
                piece = 2 if (flags & 0x20) else 1
            extended = bool(flags & (0x80 if piece == 2 else 0x40))
            row_a.append("-")
            row_b.append(b[j - 1])
            j -= 1
            if not extended:
                state = traceback[i][j] & 3
                piece = None
    return "".join(reversed(row_a)), "".join(reversed(row_b))


def _align_global_banded_py(a: str, b: str, band: int):
    """Banded twin of _align_global_py (corridor between the start and end
    diagonals plus `band` each side; out-of-corridor reads are -inf).

    Returns (row_a, row_b), or None when the traceback grazed a corridor
    boundary (caller doubles the band).  Mirrors the native
    gotoh_align_banded cell-for-cell."""
    la, lb = len(a), len(b)
    delta = lb - la
    lo_off = min(0, delta) - band
    hi_off = max(0, delta) + band
    lo = [max(0, i + lo_off) for i in range(la + 1)]
    hi = [min(lb, i + hi_off) for i in range(la + 1)]
    traceback = [bytearray(hi[i] - lo[i] + 1) for i in range(la + 1)]

    width = lb + 1
    best_prev = [NEG_INF] * width
    best_prev[0] = 0.0
    row_tb = traceback[0]
    h1 = NEG_INF
    h2 = NEG_INF
    for j in range(1, hi[0] + 1):
        open1 = best_prev[j - 1] + GAP_OPEN1
        ext1 = h1 + GAP_EXT1
        h1 = max(open1, ext1)
        open2 = best_prev[j - 1] + GAP_OPEN2
        ext2 = h2 + GAP_EXT2
        h2 = max(open2, ext2)
        flags = 2
        if h2 > h1:
            flags |= 0x20
        if ext1 >= open1:
            flags |= 0x40
        if ext2 >= open2:
            flags |= 0x80
        row_tb[j] = flags
        best_prev[j] = max(h1, h2)

    v1_prev = [NEG_INF] * width
    v2_prev = [NEG_INF] * width
    for i in range(1, la + 1):
        ca = a[i - 1]
        jlo = lo[i]
        jhi = hi[i]
        row_tb = traceback[i]
        best_cur = [NEG_INF] * width
        v1 = [NEG_INF] * width
        v2 = [NEG_INF] * width
        left_best = NEG_INF
        h1 = NEG_INF
        h2 = NEG_INF
        jstart = jlo
        if jlo == 0:
            open1 = best_prev[0] + GAP_OPEN1
            ext1 = v1_prev[0] + GAP_EXT1
            v1[0] = max(open1, ext1)
            open2 = best_prev[0] + GAP_OPEN2
            ext2 = v2_prev[0] + GAP_EXT2
            v2[0] = max(open2, ext2)
            flags = 1
            if v2[0] > v1[0]:
                flags |= 0x04
            if ext1 >= open1:
                flags |= 0x08
            if ext2 >= open2:
                flags |= 0x10
            row_tb[0] = flags
            best_cur[0] = max(v1[0], v2[0])
            left_best = best_cur[0]
            jstart = 1
        for j in range(jstart, jhi + 1):
            flags = 0
            open1 = best_prev[j] + GAP_OPEN1
            ext1 = v1_prev[j] + GAP_EXT1
            v1[j] = max(open1, ext1)
            if ext1 >= open1:
                flags |= 0x08
            open2 = best_prev[j] + GAP_OPEN2
            ext2 = v2_prev[j] + GAP_EXT2
            v2[j] = max(open2, ext2)
            if ext2 >= open2:
                flags |= 0x10
            vbest = v1[j]
            if v2[j] > vbest:
                vbest = v2[j]
                flags |= 0x04
            open1 = left_best + GAP_OPEN1
            ext1 = h1 + GAP_EXT1
            h1 = max(open1, ext1)
            if ext1 >= open1:
                flags |= 0x40
            open2 = left_best + GAP_OPEN2
            ext2 = h2 + GAP_EXT2
            h2 = max(open2, ext2)
            if ext2 >= open2:
                flags |= 0x80
            hbest = h1
            if h2 > hbest:
                hbest = h2
                flags |= 0x20
            score = best_prev[j - 1] + (MATCH if ca == b[j - 1] else MISMATCH)
            if vbest >= score and vbest >= hbest:
                best = vbest
                flags |= 1
            elif hbest >= score:
                best = hbest
                flags |= 2
            else:
                best = score
            best_cur[j] = best
            left_best = best
            row_tb[j - jlo] = flags
        best_prev = best_cur
        v1_prev = v1
        v2_prev = v2

    if best_prev[lb] == NEG_INF:
        return None  # corridor disconnected the problem

    row_a = []
    row_b = []
    i, j = la, lb
    state = traceback[i][j - lo[i]] & 3
    piece = None
    while i > 0 or j > 0:
        if (lo[i] > 0 and j <= lo[i]) or (hi[i] < lb and j >= hi[i]):
            return None  # path grazed the corridor: widen and retry
        flags = traceback[i][j - lo[i]]
        if state == 0:
            row_a.append(a[i - 1])
            row_b.append(b[j - 1])
            i -= 1
            j -= 1
            state = traceback[i][j - lo[i]] & 3
            piece = None
        elif state == 1:
            if piece is None:
                piece = 2 if (flags & 0x04) else 1
            extended = bool(flags & (0x10 if piece == 2 else 0x08))
            row_a.append(a[i - 1])
            row_b.append("-")
            i -= 1
            if not extended:
                state = traceback[i][j - lo[i]] & 3
                piece = None
        else:
            if piece is None:
                piece = 2 if (flags & 0x20) else 1
            extended = bool(flags & (0x80 if piece == 2 else 0x40))
            row_a.append("-")
            row_b.append(b[j - 1])
            j -= 1
            if not extended:
                state = traceback[i][j - lo[i]] & 3
                piece = None
    return "".join(reversed(row_a)), "".join(reversed(row_b))


def _common_affixes(sequences):
    """(prefix_len, suffix_len) of the bytes shared by EVERY sequence,
    non-overlapping in the shortest one."""
    limit = min(len(sequence) for sequence in sequences)
    first = sequences[0]
    prefix = 0
    while prefix < limit and all(sequence[prefix] == first[prefix]
                                 for sequence in sequences):
        prefix += 1
    suffix = 0
    while suffix < limit - prefix and all(
            sequence[len(sequence) - 1 - suffix] == first[len(first) - 1 - suffix]
            for sequence in sequences):
        suffix += 1
    return prefix, suffix


def poa_consensus(sequences, refine_rounds=2, device=None):
    """Consensus of several similar sequences.

    Seed: true partial-order alignment over the native graph aligner
    (svim_tpu_torch/native/poa.cpp — SPOA's role), falling back to a star MSA when
    the DP exceeds its budget (a library that fails to build raises).  The seed
    is then polished by `refine_rounds` vote rounds: every sequence re-aligns
    to the consensus and columns are re-voted, which cleans residual
    heaviest-path artifacts (measured: residual error 0-0.5% at 5-15% read
    noise, better than either method alone).

    Bytes shared by EVERY sequence at the ends (insertion haplotypes carry
    long identical reference pads) are trimmed before the DP and reattached
    after — they align trivially and vote unanimously, so the consensus is
    unchanged while every alignment shrinks by the shared flank length.
    On a CUDA `device` the polish rounds' alignments run on the card."""
    if len(sequences) > 1:
        prefix, suffix = _common_affixes(sequences)
        if prefix or suffix:
            middles = [sequence[prefix:len(sequence) - suffix]
                       for sequence in sequences]
            head = sequences[0][:prefix]
            tail = sequences[0][len(sequences[0]) - suffix:] if suffix else ""
            if all(not middle for middle in middles):
                return head + tail
            if all(middle for middle in middles):
                core = poa_consensus(middles, refine_rounds, device)
                return head + core + tail
            # a sequence reduced to nothing while others did not: fall
            # through to the untrimmed path (rare; empty rows would distort
            # alignment votes)
    consensus = None
    if len(sequences) > 1:
        from svim_tpu_torch.native import poa_consensus_native

        # None: the banded DP exceeds its budget (the star MSA takes it)
        with timing.span("poa", part=True):
            consensus = poa_consensus_native(sequences)
    if consensus is None:
        consensus = _star_consensus(sequences, device=device)
    with timing.span("polish", part=True):
        for _ in range(refine_rounds):
            if not consensus:
                break
            refined = _polish_round(sequences, consensus, device)
            if refined == consensus:
                break
            consensus = refined
    return consensus


def _polish_round(sequences, center, device=None):
    """One vote-polish round: native C++ (alignments + column voting in one
    call), the Python oracle where it returns None — byte-identical results
    (tests/test_consensus.py pins the differential).  On a CUDA `device` the
    alignments run on the card as one batch and the same C++ votes on them
    (`star_vote_native`).

    Pairs over the align_global DP budget keep the pre-existing contract
    (MemoryError -> consensus status 2) instead of running an unbounded
    native DP."""
    largest = max((len(sequence) for sequence in sequences), default=0)
    if (len(center) + 1) * (largest + 1) > MAX_DP_CELLS_NATIVE:
        raise MemoryError("alignment DP too large: {0}x{1}".format(
            len(center), largest))
    if _on_card(device) and sequences and center:
        from svim_tpu_torch.native import star_vote_native

        aligned = _card_alignments(center, sequences, device)
        return star_vote_native(sequences, center, aligned.ops,
                                aligned.starts, aligned.lengths)
    from svim_tpu_torch.native import star_polish_native

    refined = star_polish_native(sequences, center)
    if refined is not None:
        if center:
            timing.count("consensus.host_alignments",
                         sum(1 for sequence in sequences if sequence))
        return refined
    # the oracle aligns (and counts) the pairs itself
    return _star_consensus(sequences, center=center, device=device)


def _star_consensus(sequences, center=None, device=None):
    if len(sequences) == 1 and center is None:
        return sequences[0]
    if center is None:
        # center: the sequence of median length (stable choice)
        order = sorted(range(len(sequences)), key=lambda k: (len(sequences[k]), k))
        center = sequences[order[len(order) // 2]]
        others = [sequences[k] for k in range(len(sequences))
                  if k != order[len(order) // 2]]
        center_votes = True       # the center is a real member and votes
    else:
        others = list(sequences)
        center_votes = False      # synthetic anchor (previous consensus)

    # per center-position insertion blocks and aligned characters
    center_len = len(center)
    insert_blocks = [[] for _ in range(center_len + 1)]  # list of inserted strings before pos
    if center_votes:
        column_chars = [[center[i]] for i in range(center_len)]
    else:
        column_chars = [[] for _ in range(center_len)]

    for row_center, row_seq in _align_all(center, others, device):
        pos = 0  # center position
        pending_insert = []
        inserts = {}
        aligned = [None] * center_len
        for ch_center, ch_seq in zip(row_center, row_seq):
            if ch_center == "-":
                pending_insert.append(ch_seq)
            else:
                if pending_insert:
                    inserts[pos] = "".join(pending_insert)
                    pending_insert = []
                aligned[pos] = ch_seq
                pos += 1
        if pending_insert:
            inserts[pos] = "".join(pending_insert)
        for at, block in inserts.items():
            insert_blocks[at].append(block)
        for idx in range(center_len):
            column_chars[idx].append(aligned[idx] if aligned[idx] is not None else "-")

    total = len(others) + (1 if center_votes else 0)
    consensus = []

    def vote(chars, n_rows):
        counts = Counter(chars)
        counts["-"] += n_rows - len(chars)
        base, count = max(counts.items(), key=lambda kv: (kv[1], kv[0] != "-"))
        if base != "-" and count * 2 >= n_rows:
            return base
        return None

    for pos in range(center_len + 1):
        blocks = insert_blocks[pos]
        if blocks:
            width = max(len(block) for block in blocks)
            for col in range(width):
                chars = [block[col] for block in blocks if col < len(block)]
                base = vote(chars, total)
                if base:
                    consensus.append(base)
        if pos < center_len:
            base = vote(column_chars[pos], total)
            if base:
                consensus.append(base)
    return "".join(consensus)


def prepare_consensus_inputs(ins_cluster, reference, window_padding=100):
    """Reference fetches for one insertion cluster (serial: FastaFile handles
    are not thread-safe).  Returns (haplotypes, ref_sequence, window_start,
    expected_size, cluster_size)."""
    member_pos = [member.start for member in ins_cluster.members]
    window_start = min(member_pos) - window_padding
    window_end = max(member_pos) + window_padding
    haplotypes = []
    for member in ins_cluster.members:
        haplotype = reference.fetch(ins_cluster.contig, max(0, window_start),
                                    max(0, member.start)).upper()
        haplotype += member.sequence.upper()
        haplotype += reference.fetch(ins_cluster.contig, max(0, member.start),
                                     max(0, window_end)).upper()
        haplotypes.append(haplotype)
    ref_sequence = reference.fetch(ins_cluster.contig, max(0, window_start),
                                   max(0, window_end)).upper()
    return (haplotypes, ref_sequence, window_start,
            ins_cluster.end - ins_cluster.start, ins_cluster.size)


def consensus_from_inputs(inputs, maximum_haplotype_length=10000,
                          allowed_size_deviation=2.0, device=None):
    """Pure-compute half of the consensus: POA + realignment + acceptance.
    Thread-safe (native calls on local buffers, card launches on the
    thread's own stream), so clusters can run on a thread pool.  Its three
    parts are the running job's spans `poa` (the graph aligner's seed),
    `polish` and `realign`, parts of the cluster's own span.  On a CUDA
    `device` the polish rounds and the realignment align on the card."""
    haplotypes, ref_sequence, window_start, expected_size, cluster_size = inputs
    largest_haplotype_length = max(len(h) for h in haplotypes)
    if largest_haplotype_length > maximum_haplotype_length:
        logging.info("Skipping consensus computation for insertion with haplotypes "
                     "exceeding maximum length ({0} > {1})".format(
                         largest_haplotype_length, maximum_haplotype_length))
        return (1, ())

    try:
        consensus_reads = poa_consensus(haplotypes, device=device)
    except MemoryError:
        logging.warning("Error: consensus computation ran out of memory for a cluster "
                        "of insertion signatures (size = {0}, maximum haplotype "
                        "length = {1}).".format(cluster_size, largest_haplotype_length))
        return (2, ())

    try:
        with timing.span("realign", part=True):
            (consensus_row, ref_row), = _align_all(
                consensus_reads, [ref_sequence], device)
    except MemoryError:
        logging.warning("Error: consensus realignment ran out of memory for a cluster "
                        "of insertion signatures (size = {0}, maximum haplotype "
                        "length = {1}).".format(cluster_size, largest_haplotype_length))
        return (2, ())
    matches = []
    for match in re.finditer(r"-+", ref_row):
        match_size = match.end() - match.start()
        size_ratio = max(match_size, expected_size) / min(match_size, expected_size)
        matches.append((match.start(), match_size, size_ratio))
    good_matches = [m for m in matches if m[2] < allowed_size_deviation]
    if len(good_matches) == 0:
        logging.info("Consensus failure (no suitable insertion found in realignment "
                     "step). Expected size: {0}; Match sizes: {1}".format(
                         expected_size, "/".join(str(m[1]) for m in matches)))
        return (3, ())
    if len(good_matches) == 1:
        realigned_insertion_start = max(0, window_start) + good_matches[0][0]
        realigned_insertion_size = good_matches[0][1]
        insertion_consensus = consensus_row[good_matches[0][0]:good_matches[0][0] + good_matches[0][1]]
        logging.debug("Consensus success. Expected size: {0}; Consensus size: {1}".format(
            expected_size, realigned_insertion_size))
        return (0, (realigned_insertion_start, realigned_insertion_size, insertion_consensus))
    logging.info("Consensus failure (multiple suitable insertions found in realignment "
                 "step). Expected size: {0}; Match sizes: {1}".format(
                     expected_size, "/".join(str(m[1]) for m in matches)))
    return (4, ())


def generate_insertion_consensus(ins_cluster, reference, window_padding=100,
                                 maximum_haplotype_length=10000,
                                 allowed_size_deviation=2.0):
    """Consensus + realignment acceptance for one insertion cluster
    (reference: SVIM_COMBINE.py:188-254)."""
    inputs = prepare_consensus_inputs(ins_cluster, reference, window_padding)
    return consensus_from_inputs(inputs, maximum_haplotype_length,
                                 allowed_size_deviation)
