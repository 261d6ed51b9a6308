"""COMBINE's consensus alignments on the card (svim_tpu_torch/ops/
gotoh_kernel.py, csrc/gotoh.cu) against the host aligner they replace there
(svim_tpu_torch/native: `gotoh_align_auto` through `aligner.align_global`,
`gotoh_align_banded` for one rung) and its Python oracle
(`combine.consensus._align_global_py_auto`), row for row: the plain
version of a rung on the CPU, its band ladder, the votes on alignments made
elsewhere (`star_vote_native`) against `star_polish_native`, the pool's
card route (the plain version standing in for the kernel) against the host
route, the counts and the fetch span of a job, the reader of
`card_align_share`, and on a card (skipped without one) the kernel against
the plain version and the host aligner.  Everything is bytes: the
tolerance is equality."""

import ctypes
import random

import numpy as np
import pytest
import torch

from svbench import run
from svim_tpu_torch import native
from svim_tpu_torch.combine import consensus
from svim_tpu_torch.native import aligner
from svim_tpu_torch.ops import gotoh_kernel
from svim_tpu_torch.utils import timing

CPU = torch.device("cpu")
# one intra-op thread: the suite runs several pytest workers, and the plain
# version is many small ops that oversubscribed threads stall
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _text(rng, length, alphabet="ACGT"):
    return "".join(rng.choice(alphabet) for _ in range(length))


def _noisy(rng, text, rate):
    """`text` with substitutions, deletions and insertions at `rate`."""
    out = []
    for char in text:
        roll = rng.random()
        if roll < rate / 3:
            continue
        if roll < 2 * rate / 3:
            out.append(rng.choice("ACGT"))
        elif roll < rate:
            out.append(char + rng.choice("ACGT"))
        else:
            out.append(char)
    return "".join(out)


def _drift(rng, length, edits):
    """(a, b) of two halves of `length` each, b with `edits` single-base
    insertions in its first half and as many deletions in its second."""
    first, second = _text(rng, length), _text(rng, length)
    inserted, deleted = list(first), list(second)
    for _ in range(edits):
        inserted.insert(rng.randrange(len(inserted)), rng.choice("ACGT"))
        del deleted[rng.randrange(len(deleted))]
    return first + second, "".join(inserted) + "".join(deleted)


def _host(a, b):
    """align_global's rows of a pair, the empty sides included."""
    if not a:
        return "-" * len(b), b
    if not b:
        return a, "-" * len(a)
    return aligner.align_global(a, b)


def _pairs(name):
    """The named differential cases: (a, b) string pairs."""
    rng = random.Random(name)
    base = _text(rng, 400)
    if name == "homopolymers":
        return [("A" * 150, "A" * 190),
                ("A" * 60 + "C" * 80, "A" * 90 + "C" * 40),
                ("T" * 200, "T" * 120 + "G" + "T" * 70)]
    if name == "tandem_repeats":
        return [("ACACACAC" * 30, "ACACAC" * 45),
                ("GATTA" * 50, "GATTA" * 38 + "GATA" * 12),
                ("CAG" * 90, "CAG" * 70 + "CTG" * 10)]
    if name == "equal_gap_pieces":
        # a gap where one piece's and the other's scores tie or cross
        # (open1 + e1 k = open2 + e2 k at k = 20) and long gaps that the
        # second piece wins
        return [(base[:150] + base[170:300], base[:300]),
                (base[:150] + base[171:300], base[:300]),
                (base[:150] + base[169:300], base[:300]),
                (base[:100] + base[300:], base),
                (base, base[:120] + _text(rng, 60) + base[120:])]
    if name == "empty_sides":
        return [("", "ACGT"), ("ACG", ""), ("", ""), ("A", "C"),
                ("ACGT", "A")]
    if name == "full_threshold":
        # (la + 1)(lb + 1) at FULL_DP_CELLS (127 x 127, the full matrix)
        # and just past it (129 x 129, band 64), noisy and exact
        near = _noisy(rng, base[:129], 0.1).ljust(129, "A")
        return [(base[:127], near[:127]), (base[:129], near[:129]),
                (base[:127], base[:127]), (base[:129], base[:129])]
    if name == "graze_to_full":
        # the path drifts off the diagonal and back (single-base insertions
        # in one half, deletions in the other): the first pair grazes band
        # 64 and 128, band 256 exceeds it, so the full matrix decides; the
        # second grazes band 64 only
        drift = random.Random(1)
        return [_drift(drift, 220, 130), _drift(drift, 250, 100)]
    if name == "noisy":
        pairs = []
        for length in (30, 90, 140, 260, 380):
            core = _text(rng, length)
            pairs.append((_noisy(rng, core, 0.05), _noisy(rng, core, 0.15)))
            pairs.append((_noisy(rng, core, 0.2),
                          _noisy(rng, core, 0.05) + "A" * rng.randrange(80)))
        return pairs
    raise KeyError(name)


CASES = ["homopolymers", "tandem_repeats", "equal_gap_pieces", "empty_sides",
         "full_threshold", "graze_to_full", "noisy"]


@pytest.mark.parametrize("name", CASES)
def test_the_plain_version_equals_the_host_aligner(name):
    """Every pair of a case in one batch: the plain version's ladder gives
    align_global's rows and the Python oracle's."""
    pairs = _pairs(name)
    aligned = gotoh_kernel.gotoh_align_batch(
        [(a.encode(), b.encode()) for a, b in pairs], CPU)
    assert aligned.aligned == sum(1 for a, b in pairs if a and b)
    for k, (a, b) in enumerate(pairs):
        want = _host(a, b)
        assert aligned.rows(k, a, b) == want
        if a and b:
            assert consensus._align_global_py_auto(a, b) == want


def test_the_ladder_climbs_as_the_host_does(monkeypatch):
    """The shifted pair runs band 64, 128, then the full matrix: the cells
    counted are those three rungs' corridors, and each rung ran once."""
    (a, b), _ = _pairs("graze_to_full")
    assert gotoh_kernel.first_band(len(a), len(b)) == 64
    assert gotoh_kernel.next_band(len(a), len(b), 64) == 128
    assert gotoh_kernel.next_band(len(a), len(b), 128) == -1
    rungs = []
    plain = gotoh_kernel.gotoh_align_batch_torch

    def counted(seqs, plan):
        rungs.append([int(band) for band in plan[:, 4]])
        return plain(seqs, plan)

    monkeypatch.setattr(gotoh_kernel, "gotoh_align_batch_torch", counted)
    aligned = gotoh_kernel.gotoh_align_batch([(a.encode(), b.encode())], CPU)
    assert rungs == [[64], [128], [-1]]
    assert aligned.cells == sum(gotoh_kernel.band_cells(len(a), len(b), band)
                                for band in (64, 128, -1))
    assert aligned.rows(0, a, b) == _host(a, b)


@pytest.mark.parametrize("la,lb", [(1, 1), (5, 300), (300, 5), (127, 127),
                                   (129, 129), (440, 440), (900, 700),
                                   (700, 900)])
def test_the_cells_counted_are_the_corridors(la, lb):
    rows = np.arange(la + 1)
    for band in (-1, 1, 64, 128, 1024):
        lo_off, hi_off = gotoh_kernel.corridor(la, lb, band)
        want = int((np.minimum(lb, rows + hi_off)
                    - np.maximum(0, rows + lo_off) + 1).sum())
        assert gotoh_kernel.band_cells(la, lb, band) == want


def _host_banded(a, b, band):
    """One rung of the host aligner (gotoh_align_banded): (rows, touched)."""
    lib = native.get_library()
    function = lib.gotoh_align_banded
    function.restype = ctypes.c_int
    function.argtypes = (
        [ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64]
        + [ctypes.c_float] * 6 + [ctypes.c_int64, ctypes.c_char_p,
                                  ctypes.c_char_p,
                                  ctypes.POINTER(ctypes.c_int64),
                                  ctypes.POINTER(ctypes.c_int)])
    out_a = ctypes.create_string_buffer(len(a) + len(b) + 1)
    out_b = ctypes.create_string_buffer(len(a) + len(b) + 1)
    length, touched = ctypes.c_int64(0), ctypes.c_int(0)
    assert function(a.encode(), len(a), b.encode(), len(b),
                    *gotoh_kernel.SCORES, band, out_a, out_b,
                    ctypes.byref(length), ctypes.byref(touched)) == 0
    n = length.value
    return (out_a.raw[:n].decode(), out_b.raw[:n].decode()), touched.value


@pytest.mark.parametrize("band", [1, 4, 16, 64])
def test_a_rung_equals_the_host_banded_aligner(band):
    """Narrow rungs forced on the noisy and shifted pairs: the same pairs
    touch the corridor, and the others get the host's rows."""
    pairs = _pairs("noisy") + _pairs("graze_to_full") + _pairs("homopolymers")
    blob, plan, offset = b"", [], 0
    for a, b in pairs:
        blob += (a + b).encode()
        plan.append((offset, len(a), offset + len(a), len(b), band))
        offset += len(a) + len(b)
    seqs = torch.from_numpy(np.frombuffer(blob, dtype=np.uint8).copy())
    ops, result = gotoh_kernel.gotoh_align_batch_torch(seqs, np.array(plan))
    ends = np.cumsum([len(a) + len(b) for a, b in pairs])
    grazed = 0
    for k, (a, b) in enumerate(pairs):
        rows, touched = _host_banded(a, b, band)
        assert int(result[k, 1]) == touched
        grazed += touched
        if not touched:
            aligned = gotoh_kernel.Alignments(
                ops.numpy(), np.array([ends[k] - int(result[k, 0])]),
                np.array([int(result[k, 0])]), 0, 1)
            assert aligned.rows(0, a, b) == rows
    assert 0 < grazed < len(pairs) or band == 64


NEG = np.float32(gotoh_kernel.NEG_INF)
STAGE_GROUPS = 64   # csrc/gotoh.cu's kStageGroups


def _strip_groups(la, lo_off, hi_off):
    """csrc/gotoh.cu's strip_groups: four-step groups of one strip of the
    traceback, the rows of 32 columns' corridors plus 31 of skew."""
    return (min(la + 1, hi_off - lo_off + 1 + 31) + 31 + 3) // 4


def _model_kernel(a, b, band):
    """A numpy model of csrc/gotoh.cu for one pair at one rung, step for
    step: strips of 32 columns, lane t one step behind lane t-1 (a shift of
    the lane vector is the kernel's shuffle up), lane 0's left column and
    a's characters staged 32 rows a chunk, a chunk ahead, from two boundary
    columns that alternate between strips; the traceback as (strip, group
    of four steps, lane) words; then the walk through a window of
    STAGE_GROUPS groups of one strip.  Returns (op region of la + lb
    bytes, length, touched, windows staged)."""
    match, mismatch, open1, ext1, open2, ext2 = (
        np.float32(x) for x in gotoh_kernel.SCORES)
    la, lb = len(a), len(b)
    text_a = np.frombuffer(a.encode(), dtype=np.uint8)
    text_b = np.frombuffer(b.encode(), dtype=np.uint8)
    lo_off, hi_off = gotoh_kernel.corridor(la, lb, band)
    groups = _strip_groups(la, lo_off, hi_off)
    strips = (lb + 32) // 32
    trace = np.zeros((strips, groups, 32), dtype=np.uint32)
    boundary = np.full((2, la + 1, 3), NEG, dtype=np.float32)
    lane = np.arange(32)

    def up(vector):   # the kernel's __shfl_up_sync: lane t gets t - 1
        return np.concatenate([vector[:1], vector[:-1]])

    end_best = NEG
    for n in range(strips):
        j0 = 32 * n
        j = j0 + lane
        rbase = max(0, j0 - hi_off)
        last_j = min(lb, j0 + 31)
        steps = min(la, last_j - lo_off) - rbase + (last_j - j0) + 1
        column = j <= lb
        row_lo = np.maximum(0, j - hi_off)
        row_hi = np.minimum(la, j - lo_off)
        cb = np.where(column & (j >= 1), text_b[np.clip(j - 1, 0, lb - 1)], 0)
        left_lo, left_hi = max(0, j0 - 1 - hi_off), min(la, j0 - 1 - lo_off)
        read_left, write_left = boundary[(n + 1) & 1], boundary[n & 1]

        def stage(first):
            rows = first + lane
            valid = (j0 >= 1) & (rows >= left_lo) & (rows <= left_hi)
            values = np.where(valid[:, None],
                              read_left[np.clip(rows, 0, la)], NEG)
            chars = np.where((rows >= 1) & (rows <= la),
                             text_a[np.clip(rows - 1, 0, la - 1)], 0)
            return values, chars

        up_best = np.full(32, NEG)
        up_v1, up_v2 = up_best.copy(), up_best.copy()
        out_best, out_h1, out_h2 = (up_best.copy() for _ in range(3))
        out_a = np.zeros(32, dtype=np.int64)
        diag = np.full(32, NEG)
        if j0 >= 1 and left_lo <= rbase - 1 <= left_hi:
            diag[0] = read_left[rbase - 1, 0]
        packed = np.zeros(32, dtype=np.uint32)
        chunk, chunk_a = stage(rbase)
        upcoming, upcoming_a = stage(rbase + 32)
        for step in range(steps):
            i = rbase + step - lane
            k = step & 31
            if k == 0 and step > 0:
                chunk, chunk_a = upcoming, upcoming_a
                upcoming, upcoming_a = stage(rbase + step + 32)
            in_best, in_h1, in_h2, ca = (up(out_best), up(out_h1),
                                         up(out_h2), up(out_a))
            in_best[0], in_h1[0], in_h2[0] = chunk[k]
            ca[0] = chunk_a[k]
            from_diag, diag, out_a = diag, in_best.copy(), ca
            live = column & (i >= row_lo) & (i <= row_hi)

            v_open1, v_ext1 = up_best + open1, up_v1 + ext1
            v_open2, v_ext2 = up_best + open2, up_v2 + ext2
            v1, v2 = np.maximum(v_open1, v_ext1), np.maximum(v_open2, v_ext2)
            vbest = np.where(v2 > v1, v2, v1)
            v_bits = ((v2 > v1) << 2 | (v_ext1 >= v_open1) << 3
                      | (v_ext2 >= v_open2) << 4)
            h_open1, h_ext1 = in_best + open1, in_h1 + ext1
            h_open2, h_ext2 = in_best + open2, in_h2 + ext2
            h1, h2 = np.maximum(h_open1, h_ext1), np.maximum(h_open2, h_ext2)
            hbest = np.maximum(h1, h2)
            h_bits = ((h2 > h1) << 5 | (h_ext1 >= h_open1) << 6
                      | (h_ext2 >= h_open2) << 7)
            score = from_diag + np.where(ca == cb, match, mismatch)
            take_v = (vbest >= score) & (vbest >= hbest)
            take_h = ~take_v & (hbest >= score)
            best = np.where(take_v, vbest, np.where(take_h, hbest, score))
            flags = take_v | take_h << 1 | v_bits | h_bits
            top, side = i == 0, (j == 0) & (i != 0)
            origin = top & (j == 0)
            flags = np.where(top, 2 | h_bits, np.where(side, 1 | v_bits,
                                                       flags))
            best = np.where(top, hbest, np.where(side, vbest, best))
            v1, v2 = np.where(top, NEG, v1), np.where(top, NEG, v2)
            h1 = np.where(side | origin, NEG, h1)
            h2 = np.where(side | origin, NEG, h2)
            best = np.where(origin, np.float32(0), best)
            flags = np.where(origin, 0, flags)

            up_best = np.where(live, best, up_best)
            up_v1, up_v2 = np.where(live, v1, up_v1), np.where(live, v2, up_v2)
            out_best, out_h1, out_h2 = (np.where(live, value, NEG)
                                        for value in (best, h1, h2))
            if live[31]:
                write_left[i[31]] = (best[31], h1[31], h2[31])
            packed |= (np.where(live, flags, 0).astype(np.uint32)
                       << np.uint32(8 * (step & 3)))
            if step & 3 == 3 or step == steps - 1:
                trace[n, step >> 2] = packed
                packed = np.zeros(32, dtype=np.uint32)
        if n == strips - 1:
            end_best = up_best[lb & 31]

    ops = np.zeros(la + lb, dtype=np.uint8)
    if end_best <= NEG / 2:
        return ops, 0, 1, 0
    window = None   # (strip, first group, last group)
    windows = 0
    i, j, state, piece, length = la, lb, -1, 0, 0
    while i > 0 or j > 0:
        n, t = j >> 5, j & 31
        lo_i, hi_i = max(0, i + lo_off), min(lb, i + hi_off)
        if (lo_i > 0 and j <= lo_i) or (hi_i < lb and j >= hi_i) \
                or not lo_i <= j <= hi_i:
            return ops, 0, 1, windows
        step = i - max(0, 32 * n - hi_off) + t
        group = step >> 2
        if window is None or window[0] != n or not \
                window[1] <= group <= window[2]:
            window = (n, max(0, group - STAGE_GROUPS + 1), group)
            windows += 1
        flags = int(trace[n, group, t] >> np.uint32(8 * (step & 3))) & 0xff
        if state < 0:
            state, piece = flags & 3, 0
        ops[la + lb - 1 - length] = state
        length += 1
        if state == 0:
            i, j, state = i - 1, j - 1, -1
        elif state == 1:
            piece = piece or (2 if flags & 0x04 else 1)
            i -= 1
            if not flags & (0x10 if piece == 2 else 0x08):
                state = -1
        else:
            piece = piece or (2 if flags & 0x20 else 1)
            j -= 1
            if not flags & (0x80 if piece == 2 else 0x40):
                state = -1
    return ops, length, 0, windows


@pytest.mark.parametrize("band", [-1, 4, 64])
def test_the_kernels_model_equals_the_plain_version(band):
    """The kernel's layout (strips, skew, staged chunks, the two boundary
    columns, the traceback's words, the walk's windows) gives the plain
    version's rung, pair for pair, on pairs of one strip and of many,
    grazing and not."""
    rng = random.Random(7)
    inserted = _text(rng, 320)
    pairs = (_pairs("noisy")[4:] + _pairs("graze_to_full")
             + _pairs("tandem_repeats")[:1] + _pairs("empty_sides")[3:]
             + [(inserted[:10] + _text(rng, 300) + inserted[10:20],
                 inserted[:20])])
    blob, plan, offset = b"", [], 0
    for a, b in pairs:
        blob += (a + b).encode()
        plan.append((offset, len(a), offset + len(a), len(b), band))
        offset += len(a) + len(b)
    seqs = torch.from_numpy(np.frombuffer(blob, dtype=np.uint8).copy())
    ops, result = gotoh_kernel.gotoh_align_batch_torch(seqs, np.array(plan))
    ops, result = ops.numpy(), result.numpy()
    end = 0
    restaged = 0
    for k, (a, b) in enumerate(pairs):
        end += len(a) + len(b)
        model_ops, length, touched, windows = _model_kernel(a, b, band)
        assert (length, touched) == tuple(result[k])
        assert np.array_equal(model_ops[len(model_ops) - length:],
                              ops[end - length:end])
        restaged += windows > (len(b) + 32) // 32
    assert restaged > 0   # a walk longer than its window


def test_the_budget_raises_as_the_host_does(monkeypatch):
    """Under a small budget the same pairs raise MemoryError on both: a
    full matrix over it, and a ladder whose next rung is over it."""
    pairs = _pairs("noisy") + _pairs("graze_to_full")
    budget = 60_000
    monkeypatch.setattr(aligner, "MAX_CELLS", budget)
    monkeypatch.setattr(gotoh_kernel, "MAX_CELLS", budget)
    raised = 0
    for a, b in pairs:
        try:
            want = aligner.align_global(a, b)
        except MemoryError:
            raised += 1
            with pytest.raises(MemoryError):
                gotoh_kernel.gotoh_align_batch([(a.encode(), b.encode())],
                                               CPU)
            continue
        got = gotoh_kernel.gotoh_align_batch([(a.encode(), b.encode())], CPU)
        assert got.rows(0, a, b) == want
    assert 0 < raised < len(pairs)


def _cluster(seed, size, members, rate=0.08):
    """Members of an insertion cluster as a polish round gets them: noisy
    copies of one sequence, one of them empty now and then."""
    rng = random.Random(seed)
    core = _text(rng, size)
    sequences = [_noisy(rng, core, rate) for _ in range(members)]
    if seed % 3 == 0:
        sequences[1] = ""
    return sequences, _noisy(rng, core, 0.02)


@pytest.mark.parametrize("seed,size,members", [
    (1, 40, 5), (2, 120, 12), (3, 200, 8), (4, 330, 6)])
def test_the_votes_on_plain_alignments_equal_star_polish(seed, size,
                                                         members):
    sequences, center = _cluster(seed, size, members)
    aligned = gotoh_kernel.gotoh_align_batch(
        [(center.encode(), s.encode()) for s in sequences], CPU)
    refined = native.star_vote_native(sequences, center, aligned.ops,
                                      aligned.starts, aligned.lengths)
    assert refined == native.star_polish_native(sequences, center)
    assert native.star_vote_native([], center, aligned.ops, aligned.starts,
                                   aligned.lengths) is None


def test_an_op_string_that_does_not_spell_its_pair_raises():
    sequences, center = _cluster(2, 60, 3)
    aligned = gotoh_kernel.gotoh_align_batch(
        [(center.encode(), s.encode()) for s in sequences], CPU)
    ops = aligned.ops.copy()
    ops[aligned.starts[0]] = 3
    with pytest.raises(RuntimeError, match="star_vote failed"):
        native.star_vote_native(sequences, center, ops, aligned.starts,
                                aligned.lengths)


@pytest.fixture
def plain_card(monkeypatch):
    """The pool's card route with the plain version on the CPU standing in
    for the kernel (the route's own stream needs a card)."""
    def card_alignments(center, others, device):
        aligned = gotoh_kernel.gotoh_align_batch(
            [(center.encode(), other.encode()) for other in others], CPU)
        timing.count("consensus.card_alignments", aligned.aligned)
        timing.count("consensus.gotoh_cells", aligned.cells)
        return aligned

    monkeypatch.setattr(consensus, "_card_alignments", card_alignments)


def _inputs(seed, size, members):
    """consensus_from_inputs's input for one cluster: haplotypes of noisy
    inserted copies between reference flanks, the reference window."""
    rng = random.Random(seed)
    flank = _text(rng, 200)
    insert = _text(rng, size)
    haplotypes = [flank[:100] + _noisy(rng, insert, 0.06) + flank[100:]
                  for _ in range(members)]
    return (haplotypes, flank, 1000, size, members)


CLUSTERS = [(11, 60, 4), (12, 140, 9), (13, 260, 6)]


@pytest.mark.parametrize("seed,size,members", CLUSTERS)
def test_the_card_route_gives_the_host_routes_outcome(plain_card, seed,
                                                      size, members):
    inputs = _inputs(seed, size, members)
    host_timer, card_timer = timing.StageTimer(), timing.StageTimer()
    with host_timer.job(), host_timer.stage("combine"):
        want = consensus.consensus_from_inputs(inputs)
    with card_timer.job(), card_timer.stage("combine"):
        got = consensus.consensus_from_inputs(inputs,
                                              device=torch.device("cuda"))
    assert got == want and want[0] == 0
    host, card = host_timer.counts, card_timer.counts
    assert host["consensus.host_alignments"] > 0
    assert "consensus.card_alignments" not in host
    assert card["consensus.card_alignments"] == \
        host["consensus.host_alignments"]
    assert card["consensus.gotoh_cells"] > 0
    assert "consensus.host_alignments" not in card


def test_the_cpu_route_calls_the_host_aligner_as_before(monkeypatch):
    """Without a card the pool's rounds go to star_polish_native and the
    realignment to align_global, with the same arguments as before."""
    calls = []
    polish, align = native.star_polish_native, consensus.align_global

    def spy_polish(sequences, center):
        calls.append(("star_polish_native", len(sequences), center))
        return polish(sequences, center)

    def spy_align(a, b, *args):
        calls.append(("align_global", a, b))
        return align(a, b, *args)

    monkeypatch.setattr(native, "star_polish_native", spy_polish)
    monkeypatch.setattr(consensus, "align_global", spy_align)
    inputs = _inputs(12, 140, 9)
    outcome = consensus.consensus_from_inputs(inputs, device=CPU)
    assert outcome[0] == 0
    assert [call[0] for call in calls[:-1]] == ["star_polish_native"] * (
        len(calls) - 1)
    assert calls[-1][0] == "align_global" and calls[-1][2] == inputs[1]


def test_concurrent_callers_borrow_their_own_workspaces(monkeypatch):
    """Each caller aligning at the same time gets a workspace of its own
    (its own stream); a workspace given back is lent again, so the
    process keeps as many as ever aligned at once."""
    import threading

    made = []

    class Made:
        def __init__(self, device):
            self.device = device
            made.append(self)

    monkeypatch.setattr(gotoh_kernel, "Workspace", Made)
    pool = gotoh_kernel.WorkspacePool()
    device = torch.device("cuda")
    barrier = threading.Barrier(4, timeout=10)
    held = []

    def borrow():
        with pool.borrow(device) as workspace:
            held.append(workspace)
            barrier.wait()

    threads = [threading.Thread(target=borrow) for _ in range(4)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=10)
        assert not thread.is_alive()
    assert len(made) == 4 and len({id(w) for w in held}) == 4
    with pool.borrow(device) as again:
        assert again in made
    with pool.borrow(torch.device("cuda", 1)) as other:
        assert other not in made[:4] and other.device.index == 1
    assert len(made) == 5


def test_concurrent_batches_align_in_workspaces_of_their_own(monkeypatch):
    """Card batches that align at the same time each borrow a workspace
    of their own (its own stream and buffers) through the pool's
    `_card_alignments`; the rows are the host route's."""
    import threading

    made = []

    class Made:
        def __init__(self, device):
            self.device = device
            made.append(self)

    barrier = threading.Barrier(4, timeout=10)
    seen = []

    def rung(blob, plan, workspace, scores=gotoh_kernel.SCORES):
        seen.append(workspace)
        if len(seen) <= 4:
            barrier.wait()   # the four batches' first rungs at once
        ops, result = gotoh_kernel.gotoh_align_batch_torch(
            torch.from_numpy(blob), plan, scores)
        return ops.numpy(), result.numpy()

    monkeypatch.setattr(gotoh_kernel, "Workspace", Made)
    monkeypatch.setattr(gotoh_kernel, "WORKSPACES",
                        gotoh_kernel.WorkspacePool())
    monkeypatch.setattr(gotoh_kernel, "gotoh_align_batch_cuda", rung)
    clusters = [_cluster(seed, 90, 5) for seed in (21, 22, 23, 24)]
    rows = [None] * len(clusters)

    def align(index):
        sequences, center = clusters[index]
        aligned = consensus._card_alignments(center, sequences,
                                             torch.device("cuda"))
        rows[index] = [aligned.rows(k, center, other)
                       for k, other in enumerate(sequences)]

    threads = [threading.Thread(target=align, args=(index,))
               for index in range(len(clusters))]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=20)
        assert not thread.is_alive()
    assert len(made) == 4 and len({id(w) for w in seen[:4]}) == 4
    assert all(workspace.device.type == "cuda" for workspace in made)
    for (sequences, center), got in zip(clusters, rows):
        assert got == [_host(center, other) for other in sequences]


def test_a_host_round_counts_each_pair_once(monkeypatch):
    """Where star_polish_native gives no answer the Python oracle aligns
    the round's pairs, and only it counts them."""
    sequences, center = _cluster(5, 80, 6)
    timer = timing.StageTimer()
    with timer.job(), timer.stage("combine"):
        want = consensus._polish_round(sequences, center)
    monkeypatch.setattr(native, "star_polish_native", lambda *args: None)
    oracle = timing.StageTimer()
    with oracle.job(), oracle.stage("combine"):
        got = consensus._polish_round(sequences, center)
    pairs = sum(1 for sequence in sequences if sequence)
    assert got == want
    assert timer.counts["consensus.host_alignments"] == pairs
    assert oracle.counts["consensus.host_alignments"] == pairs


def test_the_pools_waits_are_a_span_of_their_own():
    """Each rung is the span `gotoh_fetch` (on a card, the pool thread's
    wait for it), so `device_wait_s` (every `<stage>.fetch`) leaves the
    pool's waits out."""
    (a, b), _ = _pairs("graze_to_full")
    timer = timing.StageTimer()
    with timer.job(), timer.stage("combine"):
        gotoh_kernel.gotoh_align_batch([(a.encode(), b.encode())], CPU)
    assert timer.spans["combine.gotoh_fetch"] > 0
    assert "combine.fetch" not in timer.spans
    reader = run.metric_reader("device_wait_s")
    assert reader.read({"stages": [timer.record()]}) is None


def _job(card=None, host=None):
    job = {"combine": 5.0, "spans": {}, "counts": {}}
    if card is not None:
        job["counts"]["consensus.card_alignments"] = card
    if host is not None:
        job["counts"]["consensus.host_alignments"] = host
    return job


def test_the_reader_gives_the_cards_share_of_the_alignments():
    reader = run.metric_reader("card_align_share")
    assert reader.UNIT == "%"
    jobs = [_job(card=99, host=1), _job(card=50), _job(host=10)]
    assert reader.read({"stages": jobs}) == pytest.approx((99 + 100 + 0) / 3)


@pytest.mark.parametrize("jobs", [[], [_job()], [_job(card=0, host=0)],
                                  [_job(card=5), _job()]])
def test_the_reader_gives_nothing_where_a_job_aligned_nothing(jobs):
    assert run.metric_reader("card_align_share").read({"stages": jobs}) \
        is None


# --- on a card ---------------------------------------------------------------


def _cluster_batches(rng):
    """Cluster-shaped batches: a center against 12-30 members of 50 bp to
    10 kb, and a consensus against its reference window."""
    batches = []
    for size in (50, 400, 1500, 3000, 10000):
        core = _text(rng, size)
        center = _noisy(rng, core, 0.02)
        batches.append([(center, _noisy(rng, core, 0.1))
                        for _ in range(rng.randint(12, 30))])
    flank = _text(rng, 200)
    batches.append([(flank[:100] + _text(rng, 900) + flank[100:], flank)])
    return batches


@pytest.mark.cuda
def test_the_kernel_equals_the_host_aligner_on_cluster_batches(cuda_device):
    rng = random.Random(24)
    before = gotoh_kernel.LAUNCHES
    launches = 0
    for batch in _cluster_batches(rng):
        aligned = gotoh_kernel.gotoh_align_batch(
            [(a.encode(), b.encode()) for a, b in batch], cuda_device)
        launches += 1
        for k, (a, b) in enumerate(batch):
            assert aligned.rows(k, a, b) == _host(a, b)
    assert gotoh_kernel.LAUNCHES >= before + launches


@pytest.mark.cuda
@pytest.mark.parametrize("band", [-1, 4, 64])
def test_a_kernel_rung_equals_the_plain_version(cuda_device, band):
    pairs = (_pairs("noisy") + _pairs("graze_to_full")
             + _pairs("tandem_repeats"))
    blob, plan, offset = b"", [], 0
    for a, b in pairs:
        blob += (a + b).encode()
        plan.append((offset, len(a), offset + len(a), len(b), band))
        offset += len(a) + len(b)
    blob = np.frombuffer(blob, dtype=np.uint8).copy()
    plan = np.array(plan)
    ops, result = gotoh_kernel.gotoh_align_batch_cuda(
        blob, plan, gotoh_kernel.Workspace(cuda_device))
    want_ops, want = gotoh_kernel.gotoh_align_batch_torch(
        torch.from_numpy(blob), plan)
    assert np.array_equal(result, want.numpy())
    ends = np.cumsum(plan[:, 1] + plan[:, 3])
    for end, length in zip(ends, result[:, 0]):
        assert np.array_equal(ops[end - length:end],
                              want_ops.numpy()[end - length:end])


@pytest.mark.cuda
@pytest.mark.parametrize("seed,size,members", CLUSTERS + [(14, 1200, 14)])
def test_the_card_route_equals_the_host_route(cuda_device, seed, size,
                                              members):
    inputs = _inputs(seed, size, members)
    host_timer, card_timer = timing.StageTimer(), timing.StageTimer()
    with host_timer.job(), host_timer.stage("combine"):
        want = consensus.consensus_from_inputs(inputs)
        sequences, center = _cluster(seed, size, members)
        want_round = consensus._polish_round(sequences, center)
    before = gotoh_kernel.LAUNCHES
    with card_timer.job(), card_timer.stage("combine"):
        got = consensus.consensus_from_inputs(inputs, device=cuda_device)
        got_round = consensus._polish_round(sequences, center, cuda_device)
    assert got == want and got_round == want_round
    assert gotoh_kernel.LAUNCHES > before
    card = card_timer.counts
    assert card["consensus.card_alignments"] == \
        host_timer.counts["consensus.host_alignments"]
    assert card["consensus.gotoh_cells"] > 0
    assert card_timer.spans["combine.gotoh_fetch"] > 0
