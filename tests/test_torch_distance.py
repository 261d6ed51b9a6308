"""Parity of the port's span-position distance matrices (svim_tpu_torch.ops.
distance_kernel) with the JAX package's: the plain PyTorch version against
the jnp `span_position_matrix` (bit for bit, both wall settings, negative,
wrapping and padded coordinates), against the Pallas tile kernel in
interpret mode (rtol=atol=1e-5, the JAX package's own tolerance between its
two versions) and against the float64 host oracle (rtol=1e-6, as in
tests/test_parallel.py); and the CUDA kernel against the plain version on
a card (bit for bit; skipped without one)."""

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
