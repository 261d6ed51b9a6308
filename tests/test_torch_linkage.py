"""Parity of the port's agglomeration kernels (svim_tpu_torch.ops.
linkage_kernel) with the JAX package's on the same seeded inputs.

Merge sequences and the dedup / wall flags must be equal.  Heights and
min_gap agree to rtol 1e-6: XLA on the CPU and PyTorch may contract
(s_lo*d_lo + s_hi*d_hi) / (s_lo+s_hi) differently by an ulp.  The flat
labels rebuilt by labels_from_merges must be equal."""

import numpy as np
import pytest
import torch

from svim_tpu.cluster import device_cluster as jax_cluster
from svim_tpu.ops import linkage_kernel as jax_linkage
from svim_tpu_torch.cluster import device_cluster as torch_cluster
from svim_tpu_torch.ops import linkage_kernel as torch_linkage

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
