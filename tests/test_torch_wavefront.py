"""Parity of the port's wavefront edit distance (svim_tpu_torch.ops.
wavefront_kernel) with the JAX package's: the plain PyTorch version against
the jnp scan (all entries equal) and the Pallas kernel in interpret mode
(equal where resolved), the host drivers against the JAX drivers, and the
CUDA kernel against the plain version on a card (skipped without one)."""

import random

import numpy as np
import pytest
import torch

from svim_tpu.cluster.edit_distance import edit_distance_dp
from svim_tpu.ops import wavefront_kernel as jax_wavefront
from svim_tpu_torch.ops import wavefront_kernel as torch_wavefront

CPU = torch.device("cpu")
# one intra-op thread: the suite runs several pytest workers, and the
# plain versions are many small ops that oversubscribed threads stall
torch.set_num_threads(1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _mutate(rng, text, edits):
    out = list(text)
    for _ in range(edits):
        if not out:
            break
        op = rng.choice("sid")
        position = rng.randrange(len(out))
        if op == "s":
            out[position] = rng.choice("ACGT")
        elif op == "i":
            out.insert(position, rng.choice("ACGT"))
        else:
            del out[position]
    return "".join(out)


def _random_pairs(seed, count, max_len, max_edits, empties=True):
    rng = random.Random(seed)
    pairs = []
    for _ in range(count):
        a = "".join(rng.choice("ACGT") for _ in range(rng.randint(0, max_len)))
        if rng.random() < 0.6:
            b = _mutate(rng, a, rng.randint(0, max_edits))
        else:
            b = "".join(rng.choice("ACGT")
                        for _ in range(rng.randint(0, max_len)))
        pairs.append((a, b))
    if empties:
        pairs += [("", ""), ("", "ACGT"), ("AC", ""), ("A" * 50, "A" * 50),
                  ("A", "C"), ("A", "")]
    return pairs


def _codes(pairs, length):
    a_codes = jax_wavefront._encode([a for a, _ in pairs], length)
    b_codes = jax_wavefront._encode([b for _, b in pairs], length)
    a_lens = np.asarray([len(a) for a, _ in pairs], dtype=np.int32)
    b_lens = np.asarray([len(b) for _, b in pairs], dtype=np.int32)
    return a_codes, a_lens, b_codes, b_lens


@pytest.mark.parametrize("band,length", [(1, 64), (4, 128), (16, 128),
                                         (64, 128)])
def test_plain_version_equals_jnp_on_every_entry(band, length):
    """Every output, "retry" values above the band included, is equal."""
    pairs = _random_pairs(band, 40, length, 10)
    a_codes, a_lens, b_codes, b_lens = _codes(pairs, length)
    want = np.asarray(jax_wavefront.banded_distance(a_codes, a_lens, b_codes,
                                                    b_lens, band))
    got = torch_wavefront.banded_distance_torch(
        torch.from_numpy(a_codes), torch.from_numpy(a_lens),
        torch.from_numpy(b_codes), torch.from_numpy(b_lens), band).numpy()
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    resolved = got <= band
    assert resolved.any() and not resolved.all()


def test_plain_version_matches_pallas_interpret_where_resolved():
    """The Pallas kernel (interpret mode) widens the front to 128 lanes, so
    it agrees with the plain version wherever the plain version resolves;
    both agree with the DP oracle there."""
    rng = random.Random(17)
    pairs = []
    for _ in range(16):
        base = "".join(rng.choice("ACGT") for _ in range(rng.randint(4, 450)))
        pairs.append((base, _mutate(rng, base, rng.randint(0, 50))))
    length, band = 512, 64
    a_codes, a_lens, b_codes, b_lens = _codes(pairs, length)
    pallas = np.asarray(jax_wavefront.banded_distance_pallas(
        a_codes.astype(np.int32), a_lens, b_codes.astype(np.int32), b_lens,
        band, tile_b=8, interpret=True))
    got = torch_wavefront.banded_distance_torch(
        torch.from_numpy(a_codes), torch.from_numpy(a_lens),
        torch.from_numpy(b_codes), torch.from_numpy(b_lens), band).numpy()
    resolved = np.flatnonzero(got <= band)
    assert len(resolved) >= 8
    for index in resolved.tolist():
        a, b = pairs[index]
        assert got[index] == pallas[index] == edit_distance_dp(a, b)


@pytest.mark.parametrize("initial_band", [2, 64])
def test_batched_driver_equals_jax_driver(initial_band):
    """Band doubling from a tiny band, empties, and distant pairs."""
    pairs = _random_pairs(13, 30, 120, 8)
    pairs.append(("A" * 64, "C" * 64))
    want = jax_wavefront.batched_edit_distance(pairs, initial_band=initial_band,
                                               use_pallas=False)
    got = torch_wavefront.batched_edit_distance(pairs, CPU,
                                                initial_band=initial_band)
    assert got == want
    assert got == [edit_distance_dp(a, b) for a, b in pairs]


def test_batched_driver_with_band_hints_equals_jax_driver():
    """Proven hints bucket the leftovers of a narrow first pass."""
    pairs = _random_pairs(29, 24, 300, 40, empties=False)
    hints = [len(a) + len(b) for a, b in pairs]
    want = jax_wavefront.batched_edit_distance(
        pairs, initial_band=2, band_hints=hints, use_pallas=False)
    got = torch_wavefront.batched_edit_distance(pairs, CPU, initial_band=2,
                                                band_hints=hints)
    assert got == want == [edit_distance_dp(a, b) for a, b in pairs]


def test_resident_driver_equals_jax_driver():
    pairs = _random_pairs(31, 24, 200, 20)
    hints = [max(len(a), len(b)) for a, b in pairs]
    want = np.asarray(jax_wavefront.batched_edit_distance_resident(
        pairs, hints, use_pallas=False))
    got = torch_wavefront.batched_edit_distance_resident(pairs, hints, CPU)
    assert got.device == CPU and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_dispatcher_routes_cpu_tensors_to_plain_version():
    pairs = _random_pairs(5, 8, 60, 4, empties=False)
    arrays = [torch.from_numpy(x) for x in _codes(pairs, 64)]
    before = torch_wavefront.LAUNCHES
    got = torch_wavefront.banded_distance(arrays[0], arrays[1], arrays[2],
                                          arrays[3], 8)
    want = torch_wavefront.banded_distance_torch(arrays[0], arrays[1],
                                                 arrays[2], arrays[3], 8)
    assert torch.equal(got, want)
    assert torch_wavefront.LAUNCHES == before
    with pytest.raises(ValueError):
        torch_wavefront.banded_distance_cuda(arrays[0], arrays[1], arrays[2],
                                             arrays[3], 8)


@pytest.mark.cuda
@pytest.mark.parametrize("batch,length,band", [(8, 512, 64), (64, 1024, 256),
                                               (8, 2048, 1024)])
def test_cuda_kernel_equals_plain_version(cuda_device, batch, length, band):
    pairs = _random_pairs(batch + band, batch, length, 50, empties=False)
    arrays = [torch.from_numpy(x).to(cuda_device)
              for x in _codes(pairs, length)]
    before = torch_wavefront.LAUNCHES
    got = torch_wavefront.banded_distance(*arrays, band)
    assert torch_wavefront.LAUNCHES == before + 1
    want = torch_wavefront.banded_distance_torch(*arrays, band)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), want.cpu())


@pytest.mark.cuda
def test_cuda_kernel_global_scratch_fronts(cuda_device):
    """A band whose fronts exceed the shared-memory limit."""
    pairs = _random_pairs(3, 4, 600, 30, empties=False)
    arrays = [torch.from_numpy(x).to(cuda_device) for x in _codes(pairs, 1024)]
    band = 16384
    assert not torch_wavefront.uses_shared_fronts(band)
    got = torch_wavefront.banded_distance_cuda(*arrays, band)
    want = torch_wavefront.banded_distance_torch(*arrays, band)
    assert torch.equal(got.cpu(), want.cpu())
