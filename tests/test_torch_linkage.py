"""Parity of the port's agglomeration kernels (svim_tpu_torch.ops.
linkage_kernel) with the JAX package's on the same seeded inputs.

Merge sequences and the dedup / wall flags must be equal.  Heights and
min_gap agree to rtol 1e-6: XLA on the CPU and PyTorch may contract
(s_lo*d_lo + s_hi*d_hi) / (s_lo+s_hi) differently by an ulp.  The flat
labels rebuilt by labels_from_merges must be equal.

The resident INS matrices: the plain version equals JAX bit for bit on
every cell off the diagonal on chip_smoke.py's seeded cases
(ins_matrix_cases: P = 32 and 128, padding pairs only, spans 0 and past
2^24, starts whose differences wrap, norms around 1 and an edit-distance
normaliser of 0.3, which shows XLA's one division by max_span * ed_norm,
position norms outside the kernel's fast division), a numpy model of
csrc/ins_matrices.cu (a CTA a partition: the share of the order checked,
the pairs from the warp search's lower bound to the first column of
another partition, the cells mirrored, the pairs in any order among the
threads, bands past P = 128) equals JAX the same way, columns out of
partition order are refused on both routes (ValueError; the model traps
where the kernel does), the port builds its columns in that order,
and the dispatcher never falls back."""

import os
import random
import sys

import numpy as np
import pytest
import torch

from svim_tpu.cluster import device_cluster as jax_cluster
from svim_tpu.ops import linkage_kernel as jax_linkage
from svim_tpu_torch.cluster import device_cluster as torch_cluster
from svim_tpu_torch.ops import _build
from svim_tpu_torch.ops import linkage_kernel as torch_linkage

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_collect_kernel import SMOKE, _OnCard  # noqa: E402

# one intra-op thread: the suite runs several pytest workers, and the
# plain versions are many small ops that oversubscribed threads stall
torch.set_num_threads(1)

RTOL = 1e-6
THRESHOLD = np.float32(0.3)
NORM = np.float32(900.0)


def _t(array):
    return torch.from_numpy(np.ascontiguousarray(array))


def _coordinate_batch(seed, pad, kinds, walls):
    rng = np.random.default_rng(seed)
    batch = len(kinds)
    starts = np.zeros((batch, pad), dtype=np.int32)
    ends = np.zeros((batch, pad), dtype=np.int32)
    dest = np.zeros((batch, pad), dtype=np.int32)
    reads = np.full((batch, pad), -1, dtype=np.int32)
    valid = np.zeros((batch, pad), dtype=bool)
    for row in range(batch):
        n = int(rng.integers(3, pad + 1))
        base = int(rng.integers(10_000, 1_000_000))
        starts[row, :n] = base + rng.integers(-400, 400, size=n)
        ends[row, :n] = starts[row, :n] + rng.integers(50, 3000, size=n)
        dest[row, :n] = base + 50_000 + rng.integers(-600, 600, size=n)
        # a few repeated read ids: same-read dedup and walls
        reads[row, :n] = rng.integers(0, max(2, n - 2), size=n)
        valid[row, :n] = True
    return (starts, ends, dest, reads, valid, np.asarray(walls, dtype=bool),
            np.asarray(kinds, dtype=np.int32))


def _assert_merges_equal(got, want, batch_rows):
    got_lo, got_hi, got_heights, got_gap = (x.numpy() for x in got[:4])
    want_lo, want_hi, want_heights, want_gap = (np.asarray(x)
                                                for x in want[:4])
    np.testing.assert_array_equal(got_lo, want_lo)
    np.testing.assert_array_equal(got_hi, want_hi)
    np.testing.assert_allclose(got_heights, want_heights, rtol=RTOL)
    np.testing.assert_allclose(got_gap, want_gap, rtol=RTOL)
    # some rows really merged
    assert (got_lo[:batch_rows] >= 0).any()


@pytest.mark.parametrize("pad", [32, 128])
@pytest.mark.parametrize("wall", [True, False])
def test_span_position_agglomerate_equals_jax(pad, wall):
    kinds = [0, 1, 2, 0, 1, 2]
    arrays = _coordinate_batch(pad + wall, pad, kinds, [wall] * len(kinds))
    starts, ends, dest, reads, valid, walls, kind = arrays
    want = jax_linkage.span_position_agglomerate_batched(
        starts, ends, reads, valid, NORM, THRESHOLD, walls, dest=dest,
        kind=kind)
    got = torch_linkage.span_position_agglomerate_batched(
        _t(starts), _t(ends), _t(reads), _t(valid), float(NORM),
        float(THRESHOLD), _t(walls), dest=_t(dest), kind=_t(kind))
    _assert_merges_equal(got, want, len(kinds))
    for got_flag, want_flag in zip(got[4:], want[4:]):
        np.testing.assert_array_equal(got_flag.numpy(), np.asarray(want_flag))
    if wall:
        assert got[4].numpy().any()   # same-read dedup dropped something


def test_span_position_agglomerate_mixed_walls_and_kinds():
    arrays = _coordinate_batch(7, 32, [0, 2, 1, 0, 2, 1, 0, 0],
                               [True, False, True, False, True, False, True,
                                False])
    starts, ends, dest, reads, valid, walls, kind = arrays
    want = jax_linkage.span_position_agglomerate_batched(
        starts, ends, reads, valid, NORM, THRESHOLD, walls, dest=dest,
        kind=kind)
    got = torch_linkage.span_position_agglomerate_batched(
        _t(starts), _t(ends), _t(reads), _t(valid), float(NORM),
        float(THRESHOLD), _t(walls), dest=_t(dest), kind=_t(kind))
    _assert_merges_equal(got, want, 8)
    for got_flag, want_flag in zip(got[4:], want[4:]):
        np.testing.assert_array_equal(got_flag.numpy(), np.asarray(want_flag))


def _matrix_batch(seed, pad, sizes):
    rng = np.random.default_rng(seed)
    matrices = np.full((len(sizes), pad, pad), 3.0e38, dtype=np.float32)
    valid = np.zeros((len(sizes), pad), dtype=bool)
    for row, n in enumerate(sizes):
        condensed = rng.random(n * (n - 1) // 2) * 1.4
        matrix = np.zeros((n, n))
        matrix[np.triu_indices(n, k=1)] = condensed
        matrix += matrix.T
        matrices[row, :n, :n] = matrix
        valid[row, :n] = True
    return matrices, valid


@pytest.mark.parametrize("pad,sizes", [(32, [2, 5, 9, 17, 24, 32, 3, 4]),
                                       (128, [3, 40, 100, 128])])
def test_agglomerate_batched_equals_jax_and_labels_agree(pad, sizes):
    matrices, valid = _matrix_batch(pad, pad, sizes)
    want = jax_linkage.agglomerate_batched(matrices, valid)
    got = torch_linkage.agglomerate_batched(_t(matrices), _t(valid))
    _assert_merges_equal(got, want, len(sizes))
    got_np = [x.numpy() for x in got]
    want_np = [np.asarray(x) for x in want]
    for row, n in enumerate(sizes):
        got_labels = torch_cluster.labels_from_merges(
            got_np[0][row], got_np[1][row], got_np[2][row], n,
            float(THRESHOLD))
        want_labels = jax_cluster.labels_from_merges(
            want_np[0][row], want_np[1][row], want_np[2][row], n,
            float(THRESHOLD))
        if want_labels is None:
            assert got_labels is None
        else:
            np.testing.assert_array_equal(got_labels, want_labels)


def test_ins_matrices_from_pairs_equals_jax():
    rng = np.random.default_rng(11)
    batch, pad = 4, 32
    starts = np.zeros((batch, pad), dtype=np.int32)
    spans = np.zeros((batch, pad), dtype=np.int32)
    valid = np.zeros((batch, pad), dtype=bool)
    pairs = []
    for row in range(batch):
        n = int(rng.integers(3, pad + 1))
        starts[row, :n] = 50_000 + rng.integers(-900, 900, size=n)
        spans[row, :n] = rng.integers(40, 600, size=n)
        valid[row, :n] = True
        for i in range(n):
            for j in range(i + 1, n):
                if rng.random() < 0.5:
                    pairs.append((row, i, j, int(rng.integers(0, 300))))
    pair_pad = 1
    while pair_pad < len(pairs):
        pair_pad *= 2
    columns = np.zeros((4, pair_pad), dtype=np.int32)
    columns[:, :len(pairs)] = np.asarray(pairs, dtype=np.int32).T
    part, first, second, ed = columns
    want = np.asarray(jax_linkage.ins_matrices_from_pairs(
        starts, spans, part, first, second, ed, np.float32(900.0),
        np.float32(0.3)))
    got = torch_linkage.ins_matrices_from_pairs(
        _t(starts), _t(spans), _t(part), _t(first), _t(second), _t(ed),
        900.0, 0.3).numpy()
    off_diagonal = (valid[:, :, None] & valid[:, None, :]
                    & ~np.eye(pad, dtype=bool)[None])
    np.testing.assert_allclose(got[off_diagonal], want[off_diagonal],
                               rtol=RTOL)
    # and the agglomeration over them agrees too
    got_merges = torch_linkage.agglomerate_batched(_t(got), _t(valid))
    want_merges = jax_linkage.agglomerate_batched(want, valid)
    _assert_merges_equal(got_merges, want_merges, batch)


# the seed of chip_smoke.py's phase 6
INS_CASES = list(SMOKE.ins_matrix_cases(np.random.default_rng(20261027)))


def _ins_tensors(args):
    return [_t(value) if isinstance(value, np.ndarray) else float(value)
            for value in args]


def _contract_cells(valid):
    pad = valid.shape[1]
    return (valid[:, :, None] & valid[:, None, :]
            & ~np.eye(pad, dtype=bool)[None])


def _assert_bit_equal_off_diagonal(got, want, valid, label):
    off = ~np.eye(got.shape[1], dtype=bool)[None].repeat(got.shape[0], 0)
    for cells in (_contract_cells(valid), off):
        np.testing.assert_array_equal(got[cells].view(np.int32),
                                      want[cells].view(np.int32),
                                      err_msg=label)


@pytest.mark.parametrize("case", range(len(INS_CASES)),
                         ids=[label for label, _, _ in INS_CASES])
def test_ins_matrices_plain_equals_jax_bit_for_bit(case):
    """Bit-equal on every cell off the diagonal, and the agglomeration that
    follows gives JAX's merges."""
    label, args, valid = INS_CASES[case]
    want = np.asarray(jax_linkage.ins_matrices_from_pairs(*args))
    got = torch_linkage.ins_matrices_from_pairs(*_ins_tensors(args)).numpy()
    _assert_bit_equal_off_diagonal(got, want, valid, label)
    got_merges = torch_linkage.agglomerate_batched(_t(got), _t(valid))
    want_merges = jax_linkage.agglomerate_batched(want, valid)
    _assert_merges_equal(got_merges, want_merges, len(valid))


def test_ins_cases_reach_their_edges():
    by_label = {label: (args, valid) for label, args, valid in INS_CASES}
    assert {args[0].shape[1] for args, _ in by_label.values()} == {
        32, 37, 128, 200}
    assert _kernel_band_rows(200) < 200
    args, _ = by_label["no real pair"]
    assert not (args[3] - args[4]).any()
    args, _ = by_label["spans 0 and past 2^24"]
    assert (args[1] == 0).any() and (args[1] > 2**24).any()
    args, _ = by_label["starts whose differences wrap"]
    delta = args[0][:, :, None].astype(np.int64) - args[0][:, None, :]
    assert (delta == -2**31).any() and (np.abs(delta) >= 2**31).any()
    assert any(args[7] != 1.0 for args, _ in by_label.values())


class _Trap(Exception):
    """What the kernel's __trap() is to the numpy model of it."""


PADDING_KEY = 2**32 - 1


def _pair_keys(part, first, second):
    """The kernel's order key a pair column: the partition as uint32,
    PADDING_KEY for padding (i == j)."""
    return np.where(np.asarray(first) == np.asarray(second), PADDING_KEY,
                    np.asarray(part).astype(np.int64) % 2**32)


def _warp_lower_bound(keys, target, chunks=256):
    """csrc/ins_matrices.cu::warp_lower_bound: a round cuts [lo, hi] into
    256 chunks (8 a lane), the last key of each is tested, and the count of
    chunks below the target picks the next chunk."""
    lo, hi = 0, len(keys)
    while lo < hi:
        step = -(-(hi - lo) // chunks)
        ends = np.minimum(lo + (np.arange(chunks) + 1) * step, hi) - 1
        below = int(((lo + np.arange(chunks) * step < hi)
                     & (keys[ends] < target)).sum())
        following = lo + below * step
        if following >= hi:
            lo = hi
        else:
            lo, hi = following, min(following + step, hi) - 1
    return lo


def _kernel_band_rows(pad):
    """The rows of a partition's matrix a CTA holds at once: all of them up
    to P = 128, bands of 65536 / (4 P) rows above."""
    return pad if pad <= 128 else 65536 // (4 * pad)


def _model_ins_matrices(args, order, band_rows=None):
    """numpy model of csrc/ins_matrices.cu, one CTA a partition: the CTA's
    1/B share of the columns checked (each inside the matrices, no key
    below the one before it: the kernel traps otherwise); the
    CTA's pairs, the columns from lower_bound(b) (the warp search) up to
    the first of another key; band by band (`band_rows` rows, the kernel's
    by default) the cells, in the whole matrix each unordered cell once and
    mirrored, then the CTA's pairs in `order` among its threads
    ("forward", "reverse" or "shuffled": threads run in no order), trapping
    on one outside the matrix, overwriting the cells of their (i, j) and
    (j, i) that fall in the band; the band stored."""
    starts, spans, part, first, second, ed, pos_norm, ed_norm = args
    pos_norm, ed_norm = np.float32(pos_norm), np.float32(ed_norm)
    one = np.float32(1.0)
    batch, pad = starts.shape
    band_rows = band_rows or _kernel_band_rows(pad)
    whole = band_rows == pad
    pairs = len(part)
    keys = _pair_keys(part, first, second)
    share = -(-pairs // batch)

    def position(a, b):
        delta = (a.astype(np.int64) - b + 2**31) % 2**32 - 2**31
        magnitude = np.where(delta == -2**31, delta, np.abs(delta))
        return magnitude.astype(np.float32) / pos_norm

    def inside(q):
        return (0 <= part[q] < batch and 0 <= first[q] < pad
                and 0 <= second[q] < pad)

    out = np.empty((batch, pad, pad), dtype=np.float32)
    floats = spans.astype(np.float32)
    shuffle = np.random.default_rng(5)
    for b in range(batch):
        for q in range(share * b, min(share * (b + 1), pairs)):
            if not inside(q) or (q + 1 < pairs and keys[q + 1] < keys[q]):
                raise _Trap("column {0} in the share of {1}".format(q, b))
        own = []
        for q in range(_warp_lower_bound(keys, b), pairs):
            if keys[q] != b:
                break
            own.append(q)
        own = np.asarray(own, dtype=np.int64)
        if order == "reverse":
            own = own[::-1]
        elif order == "shuffled":
            own = shuffle.permutation(own)
        for row0 in range(0, pad, band_rows):
            rows = range(row0, min(row0 + band_rows, pad))
            band = np.empty((len(rows), pad), dtype=np.float32)
            for i in rows:
                columns = slice(i, pad) if whole else slice(0, pad)
                larger = np.maximum(np.maximum(floats[b, i],
                                               floats[b, columns]), one)
                span_d = np.abs(floats[b, i] - floats[b, columns]) / larger
                values = position(starts[b, i], starts[b, columns]) + span_d
                band[i - row0, columns] = values
                if whole:
                    band[i:, i] = values
            for q in own:
                i, j = int(first[q]), int(second[q])
                if not inside(q):
                    raise _Trap("column {0} of partition {1}".format(q, b))
                larger = np.maximum(np.maximum(floats[b, i], floats[b, j]),
                                    one)
                term = (position(starts[b, i], starts[b, j])
                        + np.float32(ed[q]) / np.float32(larger * ed_norm))
                if i in rows:
                    band[i - row0, j] = term
                if j in rows:
                    band[j - row0, i] = term
            out[b, row0:row0 + len(rows)] = band
    return out


@pytest.mark.parametrize("order,band_rows", [("forward", None),
                                             ("reverse", None),
                                             ("shuffled", None),
                                             ("shuffled", 1),
                                             ("forward", 3)])
def test_the_ins_matrix_kernel_model_equals_jax(order, band_rows):
    """The kernel's one pass equals JAX bit for bit off the diagonal
    whatever order the CTA's threads take its pairs in, in the kernel's
    bands and in narrower ones, also past P = 128."""
    for label, args, valid in INS_CASES:
        # narrower bands at P <= 37, and at P = 200 the 3-row ones
        if args[0].shape[1] > 37 and band_rows not in (None, 3):
            continue
        if args[0].shape[1] == 128 and band_rows is not None:
            continue
        want = np.asarray(jax_linkage.ins_matrices_from_pairs(*args))
        _assert_bit_equal_off_diagonal(
            _model_ins_matrices(args, order, band_rows), want, valid, label)


def test_the_kernel_bands_past_p_128():
    """The whole matrix up to P = 128 (64.5 KiB with its padded rows);
    bands of 65536 / (4 P) rows above, at least 4 rows at the kernel's
    largest P."""
    assert _kernel_band_rows(32) == 32 and _kernel_band_rows(128) == 128
    assert _kernel_band_rows(129) == 127 and _kernel_band_rows(300) == 54
    assert _kernel_band_rows(4096) == 4


def test_the_warp_search_is_a_lower_bound_and_monotone():
    """On keys that do not decrease the warp search is the lower bound, at
    the kernel's fan-out and at a warp's 32; on any keys its result stays
    in range and does not decrease with the target."""
    rng = np.random.default_rng(11)
    for length in (0, 1, 5, 31, 32, 33, 1000, 1025, 40_000):
        keys = np.sort(rng.integers(0, 50, size=length))
        keys[length - length // 5:] = PADDING_KEY
        for chunks in (32, 256):
            for target in (0, 1, 7, 49, 50, PADDING_KEY):
                assert _warp_lower_bound(keys, target, chunks) \
                    == np.searchsorted(keys, target, side="left"), (
                        length, target, chunks)
            shuffled = rng.permutation(keys)
            found = [_warp_lower_bound(shuffled, target, chunks)
                     for target in range(52)]
            assert found == sorted(found) and found[0] == 0, length


# the faults of chip_smoke.ins_column_faults: phase 2c sends INS_TRAPS of
# them through the kernel on the card
COLUMN_FAULTS = ["partitions swapped", "real pair after the padding",
                 "padding among the real pairs", "last partition first",
                 "a pair outside the matrices"]


@pytest.mark.parametrize("kind", COLUMN_FAULTS)
def test_ins_columns_out_of_partition_order_raise(kind):
    """Pair columns with one fault are refused: the plain version raises
    ValueError, and the kernel's model traps (as csrc/ins_matrices.cu does)
    on the same columns; the columns as built pass both.  The columns are
    chip_smoke's at the bench's shape, as phase 2c builds them."""
    assert set(SMOKE.INS_TRAPS) <= set(COLUMN_FAULTS)
    built = SMOKE._ins_inputs(np.random.default_rng(20261028),
                              *SMOKE.INS_BENCH_SHAPE)
    torch_linkage.ins_matrices_from_pairs(*_ins_tensors(built))
    _model_ins_matrices(built, "forward")
    args = SMOKE.ins_column_faults(
        [value.copy() if isinstance(value, np.ndarray) else value
         for value in built], kind)
    assert (args[3] != args[4]).any()
    message = "outside" if kind == "a pair outside the matrices" \
        else "partition order"
    with pytest.raises(ValueError, match=message):
        torch_linkage.ins_matrices_from_pairs(*_ins_tensors(args))
    with pytest.raises(_Trap):
        _model_ins_matrices(args, "forward")


@pytest.mark.parametrize("column,place", [(2, -1), (2, "B"), (3, -1),
                                          (3, "P"), (4, -1), (4, "P")],
                         ids=["part -1", "part B", "i -1", "i P", "j -1",
                              "j P"])
def test_the_kernel_model_traps_on_pairs_outside_the_matrices(column, place):
    """Where the plain version raises for a pair outside the matrices, the
    kernel's model traps, for real pairs and padding alike."""
    label, args, valid = INS_CASES[0]
    for q in (0, len(args[2]) - 1):
        bad = [value.copy() if isinstance(value, np.ndarray) else value
               for value in args]
        batch, pad = bad[0].shape
        bad[column][q] = {"B": batch, "P": pad}.get(place, place)
        with pytest.raises(_Trap):
            _model_ins_matrices(bad, "forward")


def test_ins_padding_is_accepted_only_at_the_tail():
    """Padding (i == j) at the tail of the columns, columns of padding
    only, of real pairs only, and no columns at all are in partition
    order; one padding pair before a real one is not."""
    starts = np.arange(64, dtype=np.int32).reshape(2, 32) * 1000
    spans = np.full((2, 32), 100, dtype=np.int32)

    def call(part, first, second):
        columns = [np.asarray(column, dtype=np.int32)
                   for column in (part, first, second,
                                  np.arange(len(part)))]
        return torch_linkage.ins_matrices_from_pairs(
            _t(starts), _t(spans), *(_t(column) for column in columns),
            900.0, 1.0)

    call([0, 0, 1, 0, 0], [0, 2, 5, 0, 0], [1, 3, 6, 0, 0])
    call([0, 0, 0], [0, 0, 0], [0, 0, 0])
    call([0, 1, 1], [1, 0, 2], [0, 2, 4])   # i > j is a real pair too
    call([], [], [])
    with pytest.raises(ValueError, match="partition order"):
        call([0, 0, 1], [0, 0, 5], [1, 0, 6])


def test_the_ports_pair_columns_are_in_partition_order(monkeypatch):
    """Every pair column the port builds meets the precondition: the
    resident dispatch's (recorded on partitions with near pairs in two pad
    buckets), chip_smoke's _ins_inputs, ins_matrix_cases and
    _synthetic_linkage."""
    from svim_tpu_torch.config import parse_arguments
    from svim_tpu_torch.signatures import SignatureInsertion
    from test_ins_resident import _Reference

    seen = []

    def recording(starts, spans, part, first, second, ed, pos_norm,
                  ed_norm):
        torch_linkage.check_pair_order(part, first, second, starts.shape[0])
        seen.append((starts.shape, int((first != second).sum())))
        return torch_linkage.ins_matrices_from_pairs_plain(
            starts, spans, part, first, second, ed, pos_norm, ed_norm)

    monkeypatch.setattr(torch_cluster, "ins_matrices_from_pairs", recording)
    rng = random.Random(5)
    options = parse_arguments(arguments=["alignment", "/tmp", "/tmp/x.bam",
                                         "/tmp/g.fa", "--edit_backend",
                                         "wavefront"])
    samples = []
    for index, members in enumerate((6, 9, 4, 40, 7)):
        motif = "".join(rng.choice("ACGT") for _ in range(60))
        base = 50_000 + index * 20_000
        samples.append([SignatureInsertion(
            "chr1", base + rng.randint(-8, 8),
            base + rng.randint(-8, 8) + 60, "cigar",
            "r{0}_{1}".format(index, k), motif) for k in range(members)])
    batcher = torch_cluster.DeviceBatcher(options, torch.device("cpu"))
    torch_cluster.dispatch_ins_resident(samples, _Reference(), options,
                                        batcher)
    assert {shape[1] for shape, _ in seen} == {32, 128}
    assert all(real > 0 for _, real in seen)

    smoke_columns = [SMOKE._ins_inputs(np.random.default_rng(seed), *shape)
                     for seed, shape in enumerate(
                         [(128, 32, 32768), (16, 128, 4000), (4, 32, 10)])]
    smoke_columns += [args for _, args, _ in INS_CASES]
    smoke_columns += [args for name, args, _ in SMOKE._synthetic_linkage(
        np.random.default_rng(20261017), torch.device("cpu"))
        if name == "ins_matrices_from_pairs"]
    for args in smoke_columns:
        part, first, second = (torch.as_tensor(np.asarray(column))
                               for column in args[2:5])
        torch_linkage.check_pair_order(part, first, second, len(args[0]))


def test_ins_dispatch_never_falls_back(monkeypatch):
    """CPU tensors take ins_matrices_from_pairs_plain without a build; a
    tensor on a card goes to the kernel, and a failing build reaches the
    caller; a tensor on any other device raises."""
    def broken(name):
        raise RuntimeError("nvcc failed for {0}.cu".format(name))

    monkeypatch.setattr(_build, "load", broken)
    monkeypatch.setattr(torch_linkage, "_ins_library", None)
    label, args, valid = INS_CASES[0]
    tensors = _ins_tensors(args)
    got = torch_linkage.ins_matrices_from_pairs(*tensors).numpy()
    want = np.asarray(jax_linkage.ins_matrices_from_pairs(*args))
    _assert_bit_equal_off_diagonal(got, want, valid, label)

    def no_plain(*args, **kwargs):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(torch_linkage, "ins_matrices_from_pairs_plain",
                        no_plain)
    launches = torch_linkage.INS_LAUNCHES
    on_card = [_OnCard(value) if isinstance(value, torch.Tensor) else value
               for value in tensors]
    with pytest.raises(RuntimeError, match="nvcc failed for ins_matrices.cu"):
        torch_linkage.ins_matrices_from_pairs(*on_card)
    assert torch_linkage.INS_LAUNCHES == launches
    meta = [value.to("meta") if isinstance(value, torch.Tensor) else value
            for value in tensors]
    with pytest.raises(ValueError, match="no INS matrix kernel"):
        torch_linkage.ins_matrices_from_pairs(*meta)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        torch_linkage.ins_matrices_from_pairs_cuda(*tensors)




@pytest.mark.parametrize("column,place", [(2, -1), (2, "B"), (3, -1),
                                          (3, "P"), (4, -1), (4, "P")],
                         ids=["part -1", "part B", "i -1", "i P", "j -1",
                              "j P"])
def test_ins_pairs_outside_the_matrices_raise(column, place):
    """A pair outside the (B, P) matrices is an error, never a wrapped or
    skipped write: the plain version raises (the kernel traps)."""
    label, args, valid = INS_CASES[0]
    tensors = _ins_tensors(args)
    batch, pad = tensors[0].shape
    bad = tensors[column].clone()
    bad[0] = {"B": batch, "P": pad}.get(place, place)
    tensors[column] = bad
    with pytest.raises(ValueError, match="outside"):
        torch_linkage.ins_matrices_from_pairs(*tensors)


def test_resident_no_near_pairs_equals_jax():
    """Twin of test_ins_resident.py::test_resident_no_near_pairs: members
    all beyond the position gate, so the matrices come from the padding
    pair alone; the port's resident route clusters as svim_tpu's does."""
    from svim_tpu.config import parse_arguments as jax_parse_arguments
    from svim_tpu.signatures import SignatureInsertion as JaxInsertion
    from svim_tpu_torch.config import parse_arguments
    from svim_tpu_torch.signatures import SignatureInsertion
    from test_ins_resident import _Reference

    reference = _Reference()
    rng = random.Random(3)
    motifs = ["".join(rng.choice("ACGT") for _ in range(70))
              for _ in range(4)]
    arguments = ["alignment", "/tmp", "/tmp/x.bam", "/tmp/g.fa",
                 "--edit_backend", "wavefront"]
    results = []
    for cluster, parse, insertion in (
            (jax_cluster, jax_parse_arguments, JaxInsertion),
            (torch_cluster, parse_arguments, SignatureInsertion)):
        options = parse(arguments=arguments)
        elements = [insertion("chr1", 40_000 + k * 5_000,
                              40_000 + k * 5_000 + 70, "cigar",
                              "r{0}".format(k), motif)
                    for k, motif in enumerate(motifs)]
        batcher = (cluster.DeviceBatcher(options) if cluster is jax_cluster
                   else cluster.DeviceBatcher(options, torch.device("cpu")))
        pending = cluster.dispatch_ins_resident([elements], reference,
                                                options, batcher)
        assert pending.resident and not pending.resident[0][2].size
        result = cluster.consume_partitions_device(pending)
        results.append([[(e.read, e.start, e.end) for e in members]
                        for members in result[0].clusters])
    assert results[0] == results[1]
    assert sum(len(members) for members in results[1]) == 4
