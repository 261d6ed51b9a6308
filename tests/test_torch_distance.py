"""Parity of the port's span-position distance matrices (svim_tpu_torch.ops.
distance_kernel) with the JAX package's: the plain PyTorch version against
the jnp `span_position_matrix` (bit for bit, both wall settings, negative,
wrapping and padded coordinates), against the Pallas tile kernel in
interpret mode (rtol=atol=1e-5, the JAX package's own tolerance between its
two versions) and against the float64 host oracle (rtol=1e-6, as in
tests/test_parallel.py); a numpy model of the CUDA kernel's tiling
(partitions walked by a persistent grid, row groups, four columns a thread,
16-byte and scalar stores, the per-slot float32 maximum) against both, bit
for bit, with every cell written exactly once; and the CUDA kernel against
the plain version on a card (bit for bit; skipped without one)."""

import numpy as np
import pytest
import torch

from svim_tpu.ops import distance_kernel as jax_distance
from svim_tpu_torch.ops import distance_kernel as torch_distance

# one intra-op thread: the suite runs several pytest workers
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _inputs(seed, batch, pad, low=-5_000, high=2_000_000, max_span=5_000):
    """Seeded (B, P) partitions: negative starts, repeated read ids, a
    ragged number of valid slots per partition, garbage in padded slots,
    and zero and negative spans."""
    rng = np.random.default_rng(seed)
    starts = rng.integers(low, high, size=(batch, pad)).astype(np.int32)
    ends = (starts + rng.integers(-50, max_span, size=(batch, pad))).astype(
        np.int32)
    ends[:, ::7] = starts[:, ::7]          # zero spans
    reads = rng.integers(0, max(2, pad // 3), size=(batch, pad)).astype(
        np.int32)
    counts = rng.integers(0, pad + 1, size=batch)
    valid = np.arange(pad)[None, :] < counts[:, None]
    return starts, ends, reads, valid


def _port(starts, ends, reads, valid, norm, wall, device=torch.device("cpu")):
    tensors = [torch.from_numpy(x).to(device)
               for x in (starts, ends, reads, valid)]
    return torch_distance.span_position_matrix_torch(*tensors, norm,
                                                     wall_same_read=wall)


@pytest.mark.parametrize("pad", [32, 128])
@pytest.mark.parametrize("wall", [True, False])
def test_plain_version_equals_jnp_bit_for_bit(pad, wall):
    starts, ends, reads, valid = _inputs(pad + wall, 6, pad)
    for norm in (900.0, 1.0, 333.3):
        want = np.asarray(jax_distance.span_position_matrix(
            starts, ends, reads, valid, np.float32(norm),
            wall_same_read=wall))
        got = _port(starts, ends, reads, valid, norm, wall).numpy()
        assert got.dtype == np.float32 and got.shape == (6, pad, pad)
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        assert (got < torch_distance.BIG).any() and (got == 99999.0).any()


def test_plain_version_equals_jnp_where_int32_wraps():
    """Coordinates near the int32 limits: start+end and the differences
    wrap in both versions alike."""
    starts, ends, reads, valid = _inputs(9, 4, 32, low=-2**31, high=2**31 - 1,
                                         max_span=2**30)
    want = np.asarray(jax_distance.span_position_matrix(
        starts, ends, reads, valid, np.float32(900.0)))
    got = _port(starts, ends, reads, valid, 900.0, True).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_plain_version_matches_pallas_interpret():
    """The case of tests/test_parallel.py: read ids % 60, a padded tail."""
    rng = np.random.default_rng(11)
    starts = rng.integers(1000, 2000, size=(3, 128)).astype(np.int32)
    ends = starts + rng.integers(50, 500, size=(3, 128)).astype(np.int32)
    reads = np.tile(np.arange(128, dtype=np.int32) % 60, (3, 1))
    valid = np.ones((3, 128), bool)
    valid[0, 100:] = False
    pallas = np.asarray(jax_distance.span_position_matrix_pallas(
        starts, ends, reads, valid, np.float32(900.0), interpret=True))
    got = _port(starts, ends, reads, valid, 900.0, True).numpy()
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-5)


def test_plain_version_matches_host_oracle():
    from svim_tpu.cluster.accel import distance_matrix
    from svim_tpu.config import parse_arguments
    from svim_tpu.signatures import SignatureDeletion

    rng = np.random.default_rng(3)
    n = 24
    starts = rng.integers(1000, 2000, size=n)
    ends = starts + rng.integers(50, 500, size=n)
    sigs = [SignatureDeletion("chr1", int(s), int(e), "cigar", "r{0}".format(i))
            for i, (s, e) in enumerate(zip(starts, ends))]
    options = parse_arguments(arguments=["alignment", ".", "x.bam", "g.fa"])
    host = distance_matrix(sigs, "DEL", None, options)

    pad = 128
    starts_pad = np.zeros((1, pad), dtype=np.int32)
    ends_pad = np.zeros((1, pad), dtype=np.int32)
    valid = np.zeros((1, pad), dtype=bool)
    starts_pad[0, :n] = starts
    ends_pad[0, :n] = ends
    valid[0, :n] = True
    reads = np.arange(pad, dtype=np.int32)[None]
    got = _port(starts_pad, ends_pad, reads, valid,
                options.position_distance_normalizer, True).numpy()
    np.testing.assert_allclose(got[0, :n, :n], host, rtol=1e-6)


def test_dispatcher_routes_cpu_tensors_to_plain_version():
    arrays = [torch.from_numpy(x) for x in _inputs(5, 3, 32)]
    before = torch_distance.LAUNCHES
    got = torch_distance.span_position_matrix(*arrays, 900.0)
    want = torch_distance.span_position_matrix_torch(*arrays, 900.0)
    assert torch.equal(got, want)
    assert torch_distance.LAUNCHES == before
    with pytest.raises(ValueError):
        torch_distance.span_position_matrix_cuda(*arrays, 900.0)


THREADS = 256     # kThreads of csrc/span_distance.cu
STAGED_SLOTS = 5120   # the largest P whose two staging buffers fit


def _tiling_plan(batch, p, resident, variant=None):
    """The layout make_plan() of csrc/span_distance.cu picks for (B, P) on
    a card that holds `resident` CTAs at once: 16-byte stores when P is a
    multiple of 4 (unless scalar stores are forced); as a row group the
    smallest power of two of threads, at most the CTA, whose four columns
    each cover a row; and as many row bands of whole sweeps a partition as
    give every resident CTA a work item (one with that many partitions)."""
    quads = -(-p // 4)
    group_log2 = 0
    while (1 << group_log2) < min(quads, THREADS):
        group_log2 += 1
    rows_per_sweep = THREADS >> group_log2
    sweeps = -(-p // rows_per_sweep)
    wanted = min(sweeps, -(-resident // batch))
    sweeps_per_band = -(-sweeps // wanted)
    bands = -(-sweeps // sweeps_per_band)
    return {"vector": variant != "scalar" and p % 4 == 0,
            "group_log2": group_log2, "staged": p <= STAGED_SLOTS,
            "bands": bands, "rows_per_band": sweeps_per_band * rows_per_sweep,
            "grid": min(batch * bands, resident)}


def _tiling_model(starts, ends, reads, valid, norm, wall, plan):
    """What csrc/span_distance.cu stores, thread by thread, for the layout
    `plan`: returns the (B, P, P) float32 result and how often each cell
    was stored."""
    batch, p = starts.shape
    group_log2 = plan["group_log2"]
    thread = np.arange(THREADS)
    column_lane = thread & ((1 << group_log2) - 1)
    row_lane = thread >> group_log2
    rows_per_sweep = THREADS >> group_log2
    out = np.full((batch, p, p), np.nan, dtype=np.float32)
    stores = np.zeros((batch, p, p), dtype=np.int32)
    norm = np.float32(norm)
    items = batch * plan["bands"]
    for cta in range(plan["grid"]):
        for item in range(cta, items, plan["grid"]):
            b, band = divmod(item, plan["bands"])
            row_begin = band * plan["rows_per_band"]
            row_end = min(p, row_begin + plan["rows_per_band"])
            # a slot's quantities: staged once an item, or derived from
            # global memory at each use when P is too large to stage
            span = ends[b] - starts[b]                     # int32, wraps
            center = (starts[b] + ends[b]) >> 1
            span_floor1 = np.maximum(span, 1).astype(np.float32)
            for chunk in range(0, p, 4 << group_log2):
                k = np.arange(4)[None, :]
                if plan["vector"]:
                    column = chunk + 4 * column_lane[:, None] + k
                else:
                    column = chunk + column_lane[:, None] + (k << group_log2)
                busy = column[:, 0] < p
                staged = np.minimum(column, p - 1)
                for sweep in range(row_begin, row_end, rows_per_sweep):
                    r = sweep + row_lane
                    live = busy & (r < row_end)
                    row = np.minimum(r, p - 1)[:, None]
                    delta_center = np.abs(center[row] - center[staged])
                    delta_span = np.abs(span[row] - span[staged])
                    max_span = np.maximum(span_floor1[row],
                                          span_floor1[staged])
                    value = (delta_center.astype(np.float32) / norm
                             + delta_span.astype(np.float32) / max_span)
                    big = ~valid[b][staged]
                    if wall:
                        big = big | ((reads[b][row] == reads[b][staged])
                                     & (row != column))
                    value = np.where(big | ~valid[b][row],
                                     np.float32(torch_distance.BIG), value)
                    stored = live[:, None] & (column < p)
                    if plan["vector"]:      # one 16-byte store a thread
                        assert (stored == live[:, None]).all()
                        assert (column[live, 0] % 4 == 0).all()
                    rows = np.broadcast_to(row, column.shape)[stored]
                    out[b, rows, column[stored]] = value[stored]
                    np.add.at(stores[b], (rows, column[stored]), 1)
    return out, stores


@pytest.mark.parametrize("pad", [30, 32, 64, 128, 256])
@pytest.mark.parametrize("variant,resident", [
    (None, 1056), (None, 3), ("scalar", 7), ("scalar", 1)])
def test_tiling_model_equals_plain_version_and_jnp(pad, variant, resident):
    batch = 4
    starts, ends, reads, valid = _inputs(pad + resident, batch, pad,
                                         low=-2**31, high=2**31 - 1,
                                         max_span=2**30)
    plan = _tiling_plan(batch, pad, resident, variant)
    assert plan["vector"] == (variant is None and pad % 4 == 0)
    assert plan["staged"]
    assert plan["grid"] == min(resident, batch * plan["bands"])
    assert plan["bands"] * plan["rows_per_band"] >= pad
    for wall in (True, False):
        got, stores = _tiling_model(starts, ends, reads, valid, 900.0, wall,
                                    plan)
        assert (stores == 1).all()
        want = _port(starts, ends, reads, valid, 900.0, wall).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        jnp_want = np.asarray(jax_distance.span_position_matrix(
            starts, ends, reads, valid, np.float32(900.0),
            wall_same_read=wall))
        np.testing.assert_array_equal(got.view(np.uint32),
                                      jnp_want.view(np.uint32))


@pytest.mark.parametrize("pad", [1300, 1301])
def test_tiling_model_of_rows_wider_than_a_cta(pad):
    """Over 1,024 columns a row takes several chunks of the whole CTA, as
    every partition too large to stage does (P > 5,120; the layout is the
    same, only where a slot's quantities come from differs)."""
    starts, ends, reads, valid = _inputs(pad, 1, pad)
    plan = _tiling_plan(1, pad, 7)
    assert plan["group_log2"] == 8 and plan["vector"] == (pad % 4 == 0)
    assert plan["bands"] == 7 and plan["rows_per_band"] == 186
    assert not _tiling_plan(1, 6000, 528)["staged"]
    assert _tiling_plan(1, 6000, 528)["group_log2"] == 8
    got, stores = _tiling_model(starts, ends, reads, valid, 900.0, True, plan)
    assert (stores == 1).all()
    want = _port(starts, ends, reads, valid, 900.0, True).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_tiling_plan_row_bands_and_wrapper_refusals():
    # few partitions: the rows are cut into bands so that every resident
    # CTA has an item; many partitions: one item a partition
    few = _tiling_plan(8, 128, 528)
    assert (few["bands"], few["rows_per_band"], few["grid"]) == (16, 8, 128)
    many = _tiling_plan(8192, 128, 528)
    assert (many["bands"], many["rows_per_band"], many["grid"]) \
        == (1, 128, 528)
    assert many["vector"] and many["group_log2"] == 5
    # 25 of a row group's 32 threads hold columns at P = 100
    assert _tiling_plan(9, 100, 528)["group_log2"] == 5
    assert _tiling_plan(2, 5000, 528)["group_log2"] == 8
    # one partition too large to stage: a band of 12 rows a CTA
    assert _tiling_plan(1, 6000, 528)["bands"] == 500
    arrays = [torch.from_numpy(x) for x in _inputs(5, 4, 30)]
    with pytest.raises(ValueError, match="multiple of 4"):
        torch_distance.span_position_matrix_cuda(*arrays, 900.0,
                                                 variant="vector")
    with pytest.raises(ValueError, match="variant"):
        torch_distance.span_position_matrix_cuda(*arrays, 900.0,
                                                 variant="tma")


@pytest.mark.cuda
@pytest.mark.parametrize("batch,pad", [(8, 32), (1024, 128), (5, 200)])
@pytest.mark.parametrize("wall", [True, False])
def test_cuda_kernel_equals_plain_version(cuda_device, batch, pad, wall):
    arrays = [torch.from_numpy(x).to(cuda_device)
              for x in _inputs(batch + pad, batch, pad, low=-2**31,
                               high=2**31 - 1, max_span=2**30)]
    before = torch_distance.LAUNCHES
    got = torch_distance.span_position_matrix(*arrays, 900.0,
                                              wall_same_read=wall)
    assert torch_distance.LAUNCHES == before + 1
    want = torch_distance.span_position_matrix_torch(*arrays, 900.0,
                                                     wall_same_read=wall)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu().view(torch.int32),
                       want.cpu().view(torch.int32))


# norms on both sides of the range [2^-40, 2^40] in which the kernel divides
# by its own written-out sequence (outside it calls __fdiv_rn), the edges
# and their neighbours, and negative ones
NORMS = [900.0, 1e-13, 1e13, 1.0, 3.0, -900.0, 2.0**-40, 2.0**40,
         -2.0**-40, -2.0**40,
         float(np.nextafter(np.float32(2.0**-40), np.float32(0))),
         float(np.nextafter(np.float32(2.0**-40), np.float32(1))),
         float(np.nextafter(np.float32(2.0**40), np.float32(1))),
         float(np.nextafter(np.float32(2.0**40), np.float32(np.inf)))]


@pytest.mark.cuda
@pytest.mark.parametrize("batch,pad,variant", [
    (1, 30, None), (133, 30, None), (133, 64, None), (3, 256, None),
    (64, 128, "scalar"), (64, 64, "vector"), (1057, 30, None),
    (2113, 64, None), (1, 6000, None), (2, 5121, None), (300, 256, None)])
@pytest.mark.parametrize("norm", NORMS)
def test_cuda_kernel_forced_paths_equal_plain_version(cuda_device, batch, pad,
                                                      variant, norm):
    starts, ends, reads, valid = _inputs(batch + pad, batch, pad, low=-2**31,
                                         high=2**31 - 1, max_span=2**30)
    # a ragged number of valid slots, then every slot valid (an invalid row
    # is stored without being computed)
    for slots in (valid, np.ones_like(valid)):
        arrays = [torch.from_numpy(x).to(cuda_device)
                  for x in (starts, ends, reads, slots)]
        got = torch_distance.span_position_matrix_cuda(*arrays, norm,
                                                       variant=variant)
        want = torch_distance.span_position_matrix_torch(*arrays, norm)
        torch.cuda.synchronize()
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
