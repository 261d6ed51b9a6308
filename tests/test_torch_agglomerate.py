"""The agglomeration kernel (svim_tpu_torch/csrc/agglomerate.cu) on the CPU.

A CUDA kernel cannot run here, so this file keeps a numpy model of the
kernel's algorithm as the `.cu` writes it (`_model_*` below) and holds it
bitwise to svim_tpu's agglomerate_batched and
span_position_agglomerate_batched and to the port's plain versions, on
seeded numpy inputs: both pad buckets, the three distance kinds, the wall on
and off, ragged valid counts, padding partitions, exact ties, matrices that
are not symmetric.  The model of the step loop keeps what the kernel keeps:
a minimum a row (value, first column), the global argmin as the least of
the row minima by value and then by flat index, the runner-up from the
other rows' minima and rows lo and hi, the one fused multiply-add, and the
rules by which a row's minimum follows the update (row hi dead, row lo
reduced from its new cells in the next step's exchange, a row whose minimum
sat in column lo or hi rescanned, any other row comparing its new cell
(r, lo) with its minimum); a partition's own step count with the early
exit; the fused entry's staging, votes and masks.

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


def _lexmin(values, indices):
    """The (value, index) pair that the kernel's reductions return: the
    least value, and on equal values the least index.  The order is total,
    so the shape of the shuffle tree and of the exchange between warps does
    not change the result."""
    values = np.asarray(values, dtype=F32)
    indices = np.asarray(indices)
    first = np.lexsort((indices, values))[0]
    return values[first], int(indices[first])


def _rescan(row):
    """A row's minimum as the kernel's rescan finds it: (value, first
    column)."""
    return _lexmin(row, np.arange(len(row)))


def _fma(a, b, c):
    """fma(a, b, c) in float32: the product of two float32 is exact in
    float64."""
    return F32(np.float64(a) * np.float64(b) + np.float64(c))


def _model_agglomerate(d, steps, trace=None):
    """agglomerate() of the .cu over one (P, P) float32 matrix.  With
    `trace` (a list) the state after every step's exchange is appended:
    the matrix, the row minima (values, columns) and the counts so far of
    rescanned rows and of rows whose minimum moved to column lo on an equal
    value."""
    p = d.shape[0]
    d = d.copy()
    merges_lo = np.full(p - 1, -1, dtype=np.int32)
    merges_hi = np.full(p - 1, -1, dtype=np.int32)
    heights = np.full(p - 1, BIG, dtype=F32)
    sizes = ((d < CUTOFF).any(axis=1) | (d < CUTOFF).any(axis=0)).astype(F32)
    min_gap = BIG
    minima = [_rescan(d[r]) for r in range(p)]
    value = np.array([v for v, _ in minima], dtype=F32)
    column = np.array([c for _, c in minima])
    counts = {"rescans": 0, "tie_takeovers": 0}
    last_lo, merged, pending = -1, None, None
    slots = np.arange(p)
    with np.errstate(over="ignore", invalid="ignore"):
        for step in range(steps + 1):
            # the exchange: every row's minimum but last step's row lo, whose
            # new cells stand in for it; row lo's own minimum from those
            # cells; last step's runner-up
            others = slots != last_lo
            candidates = value[others]
            flats = slots[others] * p + column[others]
            if last_lo >= 0:
                candidates = np.concatenate([candidates, merged])
                flats = np.concatenate([flats, last_lo * p + slots])
                value[last_lo], column[last_lo] = _lexmin(merged, slots)
            _found, flat = _lexmin(candidates, flats)
            if trace is not None:
                trace.append(dict(counts, d=d.copy(), value=value.copy(),
                                  column=column.copy()))
            if pending is not None:
                best, second = pending
                gap = F32(second - best) / max(best, F32(1.0))
                if second < CUTOFF:
                    min_gap = min(min_gap, gap)
            if step == steps:
                break
            i, j = divmod(int(flat), p)
            lo, hi = min(i, j), max(i, j)
            best = d[lo, hi]
            if not best < CUTOFF:
                break
            # rows lo and hi: each slot k's runner-up candidate and merged
            # cell
            size_lo, size_hi = sizes[lo], sizes[hi]
            size_sum = F32(size_lo + size_hi)
            second = BIG
            merged = np.full(p, BIG, dtype=F32)
            for k in range(p):
                d_lo, d_hi = d[lo, k], d[hi, k]
                if k not in (lo, hi):
                    second = min(second, value[k])
                if k != hi:
                    second = min(second, d_lo)
                if k != lo:
                    second = min(second, d_hi)
                keep_big = (d_lo >= CUTOFF or d_hi >= CUTOFF
                            or k == lo or k == hi)
                if not keep_big:
                    merged[k] = _fma(size_lo, d_lo,
                                     F32(size_hi * d_hi)) / size_sum
            pending = (best, second)
            # the writes, then each row's minimum follows them
            d[lo, :] = merged
            d[:, lo] = merged
            d[hi, :] = BIG
            d[:, hi] = BIG
            for k in range(p):
                if k == hi:
                    value[k], column[k] = BIG, 0
                elif k == lo:
                    continue
                elif column[k] in (lo, hi):
                    value[k], column[k] = _rescan(d[k])
                    counts["rescans"] += 1
                elif merged[k] < value[k] or (merged[k] == value[k]
                                              and lo < column[k]):
                    counts["tie_takeovers"] += int(merged[k] == value[k])
                    value[k], column[k] = merged[k], lo
            sizes[lo] = size_sum
            sizes[hi] = 0.0
            merges_lo[step], merges_hi[step], heights[step] = lo, hi, best
            last_lo = lo
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
    least row minimum by value and then by flat index must be that cell,
    whichever warp holds its row, as jnp.argmin of the flattened matrix
    returns."""
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
        minima = [_rescan(row) for row in matrix[0]]
        assert _lexmin([v for v, _ in minima],
                       [r * pad + c for r, (_, c) in enumerate(minima)])[1] \
            == pad + 2
        assert int(np.argmin(matrix[0].reshape(-1))) == pad + 2


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


def _asymmetric_matrices(seed, pad, counts, ties=False):
    """Seeded matrices whose (r, c) and (c, r) differ: the matrix entry
    takes any (B, P, P) matrix, and jnp.argmin runs over all of it."""
    rng = np.random.default_rng(seed)
    matrices = np.full((len(counts), pad, pad), 3.0e38, dtype=np.float32)
    valid = np.zeros((len(counts), pad), dtype=bool)
    for row, n in enumerate(counts):
        if ties:
            values = rng.integers(1, 6, size=(n, n)).astype(np.float32) / 8
        else:
            values = (rng.random((n, n)) * 1.4).astype(np.float32)
        matrices[row, :n, :n] = values
        valid[row, :n] = True
    return matrices, valid


def _traced(matrix, count):
    """The model's trace over one partition of the matrix entry."""
    pad = matrix.shape[0]
    valid = np.arange(pad) < count
    pair = valid[:, None] & valid[None, :] & ~np.eye(pad, dtype=bool)
    trace = []
    _model_agglomerate(np.where(pair, matrix, BIG).astype(F32), count - 1,
                       trace)
    return trace


@pytest.mark.parametrize("pad,counts", [
    (32, [2, 5, 32, 17, 0, 31]), (128, [3, 128, 40, 1, 100])])
@pytest.mark.parametrize("ties", [False, True])
def test_non_symmetric_matrices_through_the_matrix_entry(pad, counts, ties):
    """Rows keep the input's asymmetry where the update does not reach:
    the row minima must follow each full row, not the upper triangle."""
    matrices, valid = _asymmetric_matrices(7 * pad + ties, pad, counts, ties)
    assert not np.array_equal(matrices, matrices.transpose(0, 2, 1))
    model = _model_matrix(matrices, valid)
    jax_out = jax_linkage.agglomerate_batched(matrices, valid)
    plain = torch_linkage.agglomerate_batched_plain(_t(matrices), _t(valid))
    _assert_bitwise(model, jax_out, "model against svim_tpu")
    _assert_bitwise(plain, jax_out, "plain against svim_tpu")
    assert (model[0][np.asarray(counts) >= 2] >= 0).any()


@pytest.mark.parametrize("pad,counts", [(32, [32, 24, 32, 17]),
                                        (128, [128, 60])])
def test_a_new_cell_in_column_lo_takes_a_tied_row_minimum(pad, counts):
    """Few-valued matrices (multiples of 1/8): a merged cell (r, lo) can
    equal row r's minimum at a higher column and must then take it over, or
    the argmin drifts from jnp.argmin's first minimum.  Only a matrix that
    is not symmetric gets there: in a symmetric one the merged cell averages
    (r, lo) and (r, hi), both at least the row's minimum, so it equals the
    minimum only where both do, and then the first minimum already lies at
    or before column lo."""
    matrices, valid = _asymmetric_matrices(40 + pad, pad, counts, ties=True)
    takeovers = [_traced(matrix, count)[-1]["tie_takeovers"]
                 for matrix, count in zip(matrices, counts)]
    assert sum(takeovers) > 0
    model = _model_matrix(matrices, valid)
    _assert_bitwise(model, jax_linkage.agglomerate_batched(matrices, valid),
                    "model against svim_tpu")
    symmetric, valid = _matrices(40 + pad, pad, counts, ties=True)
    assert all(_traced(matrix, count)[-1]["tie_takeovers"] == 0
               for matrix, count in zip(symmetric, counts))


@pytest.mark.parametrize("make,ties", [(_matrices, False), (_matrices, True),
                                       (_asymmetric_matrices, False),
                                       (_asymmetric_matrices, True)])
def test_row_minima_equal_a_full_rescan_after_every_step(make, ties):
    """The invariant the kernel rests on: after every step each row's kept
    (value, column) is the first minimum of the whole row, dead rows and
    padding slots included."""
    pad = 32
    counts = [32, 9, 2]
    matrices, _valid = make(5 + ties, pad, counts, ties)
    rescans = 0
    for matrix, count in zip(matrices, counts):
        trace = _traced(matrix, count)
        assert len(trace) >= count - 1
        for state in trace:
            for r in range(pad):
                assert (state["value"][r], state["column"][r]) \
                    == _rescan(state["d"][r])
        rescans += trace[-1]["rescans"]
    assert rescans > 0


def test_the_runner_up_ties_in_row_lo_or_hi_give_gap_zero():
    """(lo, hi) ties with a cell of row lo, then of row hi: the runner-up
    reads those rows without the pair's own cells, so the gap is exactly
    0."""
    pad = 32
    for other in ((0, 2), (1, 2)):
        matrix = np.full((1, pad, pad), 3.0e38, dtype=np.float32)
        matrix[0, :4, :4] = 2.0
        for i, j in ((0, 1), other):
            matrix[0, i, j] = matrix[0, j, i] = 0.5
        valid = np.arange(pad)[None, :] < 4
        model = _model_matrix(matrix, valid)
        _assert_bitwise(model, jax_linkage.agglomerate_batched(matrix, valid),
                        "model against svim_tpu")
        assert (model[0][0, 0], model[1][0, 0]) == (0, 1)
        assert model[3][0] == 0
