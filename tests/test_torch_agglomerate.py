"""The agglomeration kernel (svim_tpu_torch/csrc/agglomerate.cu) on the CPU.

A CUDA kernel cannot run here, so this file keeps a numpy model of the
kernel's algorithm as the `.cu` writes it (`_model_*` below: a partition's
own step count with the early exit, the thread-strided scan and the two
reduction stages of the block argmin with the lowest flat index winning, the
runner-up over every cell but the merged pair's two, the one fused
multiply-add, the fused entry's staging, votes and masks) and holds it
bitwise to svim_tpu's agglomerate_batched and
span_position_agglomerate_batched and to the port's plain versions, on
seeded numpy inputs: both pad buckets, the three distance kinds, the wall on
and off, ragged valid counts, padding partitions, exact ties.

Also here: the dispatch (CPU tensors take the plain version and never touch
the build; a tensor on a card takes the kernel, and a loader that fails
raises: nothing falls back to the plain version).
"""

import numpy as np
import pytest
import torch

from svim_tpu.ops import linkage_kernel as jax_linkage
from svim_tpu_torch.ops import _build
from svim_tpu_torch.ops import linkage_kernel as torch_linkage

torch.set_num_threads(1)

F32 = np.float32
BIG = F32(3.0e38)
CUTOFF = F32(1.0e30)
TIE_EPS = F32(3.0e-4)
WALL = F32(99999.0)
BND_RECIPROCAL = F32(1.0) / F32(3000.0)
NORM = 900.0
THRESHOLD = 0.3


def _threads_for(p):
    """threads_for() of the .cu."""
    return 256 if p <= 64 else 512


def _model_block_argmin(flat, threads):
    """block_argmin(): every thread scans its cells tid, tid + T, ... and
    keeps its first minimum; a warp's 32 threads, then the warps, reduce
    (value, flat index) pairs by value and then by index."""
    cells = len(flat)
    rounds = -(-cells // threads)
    padded = np.full(rounds * threads, np.inf, dtype=F32)
    padded[:cells] = flat
    table = padded.reshape(rounds, threads)
    rows = np.argmin(table, axis=0)            # first minimum of a thread
    value = table[rows, np.arange(threads)]
    index = rows * threads + np.arange(threads)
    idle = np.arange(threads) >= cells         # such a thread offers cell 0
    value[idle] = flat[0]
    index[idle] = 0

    def reduce(value, index):
        order = np.lexsort((index, value))     # by value, then by index
        return value[order[0]], index[order[0]]

    warp = [reduce(value[w:w + 32], index[w:w + 32])
            for w in range(0, threads, 32)]
    return reduce(np.array([v for v, _ in warp], dtype=F32),
                  np.array([i for _, i in warp]))


def _fma(a, b, c):
    """fma(a, b, c) in float32: the product of two float32 is exact in
    float64."""
    return F32(np.float64(a) * np.float64(b) + np.float64(c))


def _model_agglomerate(d, steps):
    """agglomerate() of the .cu over one (P, P) float32 matrix."""
    p = d.shape[0]
    d = d.copy()
    threads = _threads_for(p)
    merges_lo = np.full(p - 1, -1, dtype=np.int32)
    merges_hi = np.full(p - 1, -1, dtype=np.int32)
    heights = np.full(p - 1, BIG, dtype=F32)
    sizes = ((d < CUTOFF).any(axis=1) | (d < CUTOFF).any(axis=0)).astype(F32)
    min_gap = BIG
    with np.errstate(over="ignore", invalid="ignore"):
        for step in range(steps):
            _found, flat = _model_block_argmin(d.reshape(-1), threads)
            i, j = divmod(int(flat), p)
            lo, hi = min(i, j), max(i, j)
            best = d[lo, hi]
            if not best < CUTOFF:
                break
            masked = d.copy()
            masked[lo, hi] = BIG
            masked[hi, lo] = BIG
            second = masked.min()
            gap = F32(second - best) / max(best, F32(1.0))
            if second < CUTOFF:
                min_gap = min(min_gap, gap)
            size_lo, size_hi = sizes[lo], sizes[hi]
            size_sum = F32(size_lo + size_hi)
            merged = np.full(p, BIG, dtype=F32)
            for k in range(p):
                d_lo, d_hi = d[lo, k], d[hi, k]
                keep_big = (d_lo >= CUTOFF or d_hi >= CUTOFF
                            or k == lo or k == hi)
                if not keep_big:
                    merged[k] = _fma(size_lo, d_lo,
                                     F32(size_hi * d_hi)) / size_sum
            d[lo, :] = merged
            d[:, lo] = merged
            d[hi, :] = BIG
            d[:, hi] = BIG
            sizes[lo] = size_sum
            sizes[hi] = 0.0
            merges_lo[step], merges_hi[step], heights[step] = lo, hi, best
    return merges_lo, merges_hi, heights, F32(min_gap)


def _model_matrix(distances, valid):
    """agglomerate_matrix_kernel over a batch."""
    batch, p, _ = distances.shape
    outputs = []
    for b in range(batch):
        slots = int(valid[b].sum())
        if slots < 2:
            outputs.append((np.full(p - 1, -1, np.int32),
                            np.full(p - 1, -1, np.int32),
                            np.full(p - 1, BIG, F32), BIG))
            continue
        pair = valid[b][:, None] & valid[b][None, :] & ~np.eye(p, dtype=bool)
        d = np.where(pair, distances[b].astype(F32), BIG)
        outputs.append(_model_agglomerate(d, slots - 1))
    return tuple(np.stack([out[k] for out in outputs]) for k in range(4))


def _wrap_abs_delta(values):
    """float32(|a - b|) in wrapping int32, INT32_MIN staying itself."""
    with np.errstate(over="ignore"):
        return np.abs(values[:, None] - values[None, :]).astype(F32)


def _model_fused(starts, ends, dest, reads, valid, wall, kind, norm,
                 threshold):
    """agglomerate_fused_kernel over a batch."""
    batch, p = starts.shape
    norm, threshold = F32(norm), F32(threshold)
    outputs = []
    for b in range(batch):
        slots = int(valid[b].sum())
        if slots < 2:
            outputs.append((np.full(p - 1, -1, np.int32),
                            np.full(p - 1, -1, np.int32),
                            np.full(p - 1, BIG, F32), BIG,
                            np.zeros(p, bool), False, False))
            continue
        with np.errstate(over="ignore"):
            center = (starts[b] + ends[b]) >> 1
            span = ends[b] - starts[b]
        delta_dest = _wrap_abs_delta(dest[b])
        if kind[b] == 2:
            distance = (_wrap_abs_delta(starts[b]) + delta_dest) \
                * BND_RECIPROCAL
        else:
            max_span = np.maximum(np.maximum(span[:, None], span[None, :]),
                                  1).astype(F32)
            distance = (_wrap_abs_delta(center) / norm
                        + _wrap_abs_delta(span) / max_span)
            if kind[b] == 1:
                distance = distance + delta_dest / norm
        distance = distance.astype(F32)
        off_diagonal = ~np.eye(p, dtype=bool)
        same_read = ((reads[b][:, None] == reads[b][None, :])
                     & valid[b][:, None] & valid[b][None, :] & off_diagonal)
        dropped = np.zeros(p, dtype=bool)
        ambiguous = False
        if wall[b]:
            earlier = np.arange(p)[:, None] < np.arange(p)[None, :]
            dropped = (same_read & earlier & (distance <= threshold)).any(
                axis=0)
            near_cut = (np.abs(distance - threshold)
                        < TIE_EPS * np.maximum(distance, F32(1.0)))
            ambiguous = bool((same_read & near_cut).any())
        alive = valid[b] & ~dropped
        pair_alive = alive[:, None] & alive[None, :] & off_diagonal
        surviving = (pair_alive & bool(wall[b])
                     & (reads[b][:, None] == reads[b][None, :]))
        d = np.where(surviving, WALL, np.where(pair_alive, distance, BIG))
        outputs.append(_model_agglomerate(d.astype(F32), slots - 1)
                       + (dropped, bool(surviving.any()), ambiguous))
    return tuple(np.stack([np.asarray(out[k]) for out in outputs])
                 for k in range(7))


def _t(array):
    return torch.from_numpy(np.ascontiguousarray(array))


def _bits(array):
    array = np.ascontiguousarray(np.asarray(array))
    return array.view(np.int32) if array.dtype == np.float32 else array


def _assert_bitwise(got, want, what):
    assert len(got) == len(want)
    for index, (a, b) in enumerate(zip(got, want)):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, (what, index)
        np.testing.assert_array_equal(_bits(a), _bits(b),
                                      err_msg="{0}, output {1}".format(
                                          what, index))


def _coordinates(seed, pad, counts, kinds, walls, wide=False):
    """Seeded fused-route inputs: `counts` valid slots a partition (0 = a
    padding partition), a few repeated read ids, zero spans and negative
    starts; `wide` draws from all of int32 so that sums and differences
    wrap."""
    rng = np.random.default_rng(seed)
    batch = len(counts)
    starts = np.zeros((batch, pad), dtype=np.int32)
    ends = np.zeros((batch, pad), dtype=np.int32)
    dest = np.zeros((batch, pad), dtype=np.int32)
    reads = np.full((batch, pad), -1, dtype=np.int32)
    valid = np.zeros((batch, pad), dtype=bool)
    for row, n in enumerate(counts):
        if wide:
            starts[row, :n] = rng.integers(-2**31, 2**31 - 1, size=n)
            ends[row, :n] = rng.integers(-2**31, 2**31 - 1, size=n)
            dest[row, :n] = rng.integers(-2**31, 2**31 - 1, size=n)
        else:
            base = int(rng.integers(-300, 1_000_000))
            starts[row, :n] = base + rng.integers(-400, 400, size=n)
            ends[row, :n] = starts[row, :n] + rng.integers(0, 3000, size=n)
            ends[row, :n:5] = starts[row, :n:5]
            dest[row, :n] = base + 50_000 + rng.integers(-600, 600, size=n)
        reads[row, :n] = rng.integers(0, max(2, n - 2), size=n)
        valid[row, :n] = True
    return (starts, ends, dest, reads, valid, np.asarray(walls, dtype=bool),
            np.asarray(kinds, dtype=np.int32))


def _fused_three_ways(arrays):
    starts, ends, dest, reads, valid, walls, kinds = arrays
    model = _model_fused(starts, ends, dest, reads, valid, walls, kinds,
                         NORM, THRESHOLD)
    jax_out = jax_linkage.span_position_agglomerate_batched(
        starts, ends, reads, valid, F32(NORM), F32(THRESHOLD), walls,
        dest=dest, kind=kinds)
    plain = torch_linkage.span_position_agglomerate_batched_plain(
        _t(starts), _t(ends), _t(reads), _t(valid), NORM, THRESHOLD,
        _t(walls), _t(dest), _t(kinds))
    return model, jax_out, plain


FUSED_COUNTS = {32: [3, 32, 9, 0, 17, 1, 2, 24],
                128: [3, 128, 40, 0, 100, 64, 1, 33]}


@pytest.mark.parametrize("pad", [32, 128])
@pytest.mark.parametrize("kind", [0, 1, 2])
@pytest.mark.parametrize("wall", [True, False])
def test_fused_model_is_bitwise_jax_and_plain(pad, kind, wall):
    counts = FUSED_COUNTS[pad]
    arrays = _coordinates(1000 * pad + 10 * kind + wall, pad, counts,
                          [kind] * len(counts), [wall] * len(counts))
    model, jax_out, plain = _fused_three_ways(arrays)
    _assert_bitwise(model, jax_out, "model against svim_tpu")
    _assert_bitwise(plain, jax_out, "plain against svim_tpu")
    assert (model[0] >= 0).any()
    if wall:
        assert model[4].any()     # the dedup dropped a slot


def test_fused_model_mixed_kinds_walls_and_wrapping_coordinates():
    counts = [5, 32, 0, 11, 3, 20, 2, 7]
    for wide in (False, True):
        arrays = _coordinates(77 + wide, 32, counts,
                              [0, 1, 2, 2, 1, 0, 0, 1],
                              [True, False, True, True, False, True, False,
                               True], wide=wide)
        model, jax_out, plain = _fused_three_ways(arrays)
        _assert_bitwise(model, jax_out, "model against svim_tpu")
        _assert_bitwise(plain, jax_out, "plain against svim_tpu")


def _matrices(seed, pad, counts, ties=False):
    """Seeded symmetric matrices; with `ties` the distances are multiples of
    1/8 drawn from a few values, so that most steps have several minima."""
    rng = np.random.default_rng(seed)
    matrices = np.full((len(counts), pad, pad), 3.0e38, dtype=np.float32)
    valid = np.zeros((len(counts), pad), dtype=bool)
    for row, n in enumerate(counts):
        if ties:
            values = rng.integers(1, 6, size=(n, n)).astype(np.float32) / 8
        else:
            values = (rng.random((n, n)) * 1.4).astype(np.float32)
        upper = np.triu(values, 1)
        matrices[row, :n, :n] = upper + upper.T
        valid[row, :n] = True
    return matrices, valid


@pytest.mark.parametrize("pad,counts", [
    (32, [2, 5, 9, 17, 24, 32, 3, 0]), (128, [3, 40, 100, 128, 0, 1, 64, 33])])
@pytest.mark.parametrize("ties", [False, True])
def test_matrix_model_is_bitwise_jax_and_plain(pad, counts, ties):
    matrices, valid = _matrices(pad + ties, pad, counts, ties)
    model = _model_matrix(matrices, valid)
    jax_out = jax_linkage.agglomerate_batched(matrices, valid)
    plain = torch_linkage.agglomerate_batched_plain(_t(matrices), _t(valid))
    _assert_bitwise(model, jax_out, "model against svim_tpu")
    _assert_bitwise(plain, jax_out, "plain against svim_tpu")
    if ties:
        # an exact tie: gap 0 on a partition that merged
        assert (model[3][np.asarray(counts) > 2] == 0).any()


def test_lowest_flat_index_wins_an_exact_tie():
    """Four equal minima, the first of them at flat index 1 * P + 2: the
    model's two reduction stages must return that cell whichever thread and
    warp holds it, as jnp.argmin of the flattened matrix does."""
    for pad in (32, 128):
        matrix = np.full((1, pad, pad), 3.0e38, dtype=np.float32)
        count = pad - 1
        matrix[0, :count, :count] = 2.0
        for i, j in ((1, 2), (2, 9), (pad - 3, pad - 2), (5, 6)):
            matrix[0, i, j] = matrix[0, j, i] = 0.25
        valid = np.zeros((1, pad), dtype=bool)
        valid[0, :count] = True
        model = _model_matrix(matrix, valid)
        jax_out = jax_linkage.agglomerate_batched(matrix, valid)
        _assert_bitwise(model, jax_out, "model against svim_tpu")
        assert (model[0][0, 0], model[1][0, 0]) == (1, 2)
        assert model[3][0] == 0
        flat = matrix[0].reshape(-1)
        assert _model_block_argmin(flat, _threads_for(pad))[1] == pad + 2
        assert int(np.argmin(flat)) == pad + 2


def test_a_partition_runs_its_own_step_count():
    """A partition of 3 beside one of 128: the small one's rows past its
    two merges hold the padding a batch-wide step count leaves there."""
    matrices, valid = _matrices(5, 128, [3, 128, 0, 1])
    model = _model_matrix(matrices, valid)
    jax_out = jax_linkage.agglomerate_batched(matrices, valid)
    _assert_bitwise(model, jax_out, "model against svim_tpu")
    assert (model[0][0, :2] >= 0).all() and (model[0][0, 2:] == -1).all()
    assert (model[2][0, 2:] == BIG).all()
    assert (model[0][2] == -1).all() and model[3][2] == BIG
    assert (model[0][1] >= 0).all()


def test_public_ops_take_the_plain_version_on_the_cpu(monkeypatch):
    """CPU tensors never reach the build."""
    def no_build(name):
        raise AssertionError("a CPU call tried to build " + name)

    monkeypatch.setattr(_build, "load", no_build)
    monkeypatch.setattr(torch_linkage, "_library", None)
    launches = torch_linkage.LAUNCHES
    matrices, valid = _matrices(3, 32, [4, 7])
    got = torch_linkage.agglomerate_batched(_t(matrices), _t(valid))
    _assert_bitwise(got, torch_linkage.agglomerate_batched_plain(
        _t(matrices), _t(valid)), "dispatcher against plain")
    starts, ends, dest, reads, valid, walls, kinds = _coordinates(
        4, 32, [6, 9], [0, 2], [True, False])
    got = torch_linkage.span_position_agglomerate_batched(
        _t(starts), _t(ends), _t(reads), _t(valid), NORM, THRESHOLD,
        _t(walls), dest=_t(dest), kind=_t(kinds))
    _assert_bitwise(got, torch_linkage.span_position_agglomerate_batched_plain(
        _t(starts), _t(ends), _t(reads), _t(valid), NORM, THRESHOLD,
        _t(walls), _t(dest), _t(kinds)), "dispatcher against plain")
    assert torch_linkage.LAUNCHES == launches


class _OnCard:
    """What the wrappers read of a tensor before they launch, for a tensor
    that claims to lie on a card (there is none here)."""

    def __init__(self, tensor):
        self.device = torch.device("cuda", 0)
        self.dtype = tensor.dtype
        self.shape = tensor.shape

    def dim(self):
        return len(self.shape)

    def is_contiguous(self):
        return True

    def to(self, dtype):
        cast = _OnCard(self)
        cast.dtype = dtype
        return cast


def test_a_failed_build_raises_and_nothing_falls_back(monkeypatch):
    """On a CUDA tensor the public ops go to the kernel; when its loader
    fails the error reaches the caller, and the plain version is not
    called."""
    def broken(name):
        raise RuntimeError("nvcc failed for {0}.cu".format(name))

    def no_plain(*args, **kwargs):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(_build, "load", broken)
    monkeypatch.setattr(torch_linkage, "_library", None)
    monkeypatch.setattr(torch_linkage, "agglomerate_batched_plain", no_plain)
    monkeypatch.setattr(torch_linkage,
                        "span_position_agglomerate_batched_plain", no_plain)
    monkeypatch.setattr(torch_linkage, "_agglomerate", no_plain)
    launches = torch_linkage.LAUNCHES
    matrices, valid = _matrices(3, 32, [4, 7])
    with pytest.raises(RuntimeError, match="nvcc failed for agglomerate.cu"):
        torch_linkage.agglomerate_batched(_OnCard(_t(matrices)),
                                          _OnCard(_t(valid)))
    arrays = _coordinates(4, 32, [6, 9], [0, 2], [True, False])
    starts, ends, dest, reads, valid, walls, kinds = (
        _OnCard(_t(array)) for array in arrays)
    with pytest.raises(RuntimeError, match="nvcc failed for agglomerate.cu"):
        torch_linkage.span_position_agglomerate_batched(
            starts, ends, reads, valid, NORM, THRESHOLD, walls, dest=dest,
            kind=kinds)
    assert torch_linkage.LAUNCHES == launches


def test_without_nvcc_the_real_loader_raises(monkeypatch, tmp_path):
    """The loader itself, where the CUDA toolkit is missing: an error that
    names nvcc, no library, no launch counted."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "_build"))
    monkeypatch.setattr(_build, "_libraries", {})
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no_cuda"))
    monkeypatch.setattr(torch_linkage, "_library", None)
    matrices, valid = _matrices(3, 32, [4, 7])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        torch_linkage.agglomerate_batched(_OnCard(_t(matrices)),
                                          _OnCard(_t(valid)))


def test_float64_distances_are_rounded_to_float32_on_either_device(
        monkeypatch):
    """The dispatcher rounds the matrix before it chooses a route, so the
    plain version and the kernel are handed the same float32 values."""
    matrices, valid = _matrices(3, 32, [4, 7])
    wide = matrices.astype(np.float64)
    wide[(wide > 0.01) & (wide < 2)] += 1e-9
    assert (wide.astype(np.float32) == matrices).all()
    got = torch_linkage.agglomerate_batched(_t(wide), _t(valid))
    _assert_bitwise(got, torch_linkage.agglomerate_batched_plain(
        _t(matrices), _t(valid)), "float64 against float32 on the CPU")
    seen = []
    monkeypatch.setattr(torch_linkage, "agglomerate_batched_cuda",
                        lambda distances, valid: seen.append(distances.dtype))
    torch_linkage.agglomerate_batched(_OnCard(_t(wide)), _OnCard(_t(valid)))
    assert seen == [torch.float32]


def test_cuda_wrappers_refuse_what_the_kernel_does_not_take():
    matrices, valid = _matrices(3, 32, [4, 7])
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        torch_linkage.agglomerate_batched_cuda(_t(matrices), _t(valid))
    arrays = _coordinates(4, 32, [6, 9], [0, 2], [True, False])
    starts, ends, dest, reads, valid, walls, kinds = (_t(a) for a in arrays)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        torch_linkage.span_position_agglomerate_batched_cuda(
            starts, ends, reads, valid, NORM, THRESHOLD, walls, dest, kinds)
    with pytest.raises(ValueError, match="must be a .* torch.int32"):
        torch_linkage.span_position_agglomerate_batched_cuda(
            _OnCard(starts.long()), _OnCard(ends), _OnCard(reads),
            _OnCard(valid), NORM, THRESHOLD, _OnCard(walls), _OnCard(dest),
            _OnCard(kinds))
    with pytest.raises(ValueError, match=r"must be \(B, P, P\)"):
        torch_linkage.agglomerate_batched_cuda(_OnCard(valid), _OnCard(valid))
