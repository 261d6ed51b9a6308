"""Parity of the port's wavefront edit distance (svim_tpu_torch.ops.
wavefront_kernel) with the JAX package's: the plain PyTorch version against
the jnp scan (all entries equal) and the Pallas kernel in interpret mode
(equal where resolved), the host drivers against the JAX drivers, the
properties the CUDA kernel's design leans on (narrow bands first, fronts of
one parity over live cells only, boundaries out of the recurrence) shown on
the plain version (the strip layout's model: test_torch_wavefront_ladder.py), the vectorised string encoding against the per-string
one, and the CUDA kernel against the plain version on a card (skipped
without one).  Every comparison is exact (int32)."""

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
    got = torch_wavefront.batched_edit_distance_resident(
        torch_wavefront.HaplotypePairs.from_strings(pairs), hints, CPU)
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


def _plain(pairs, length, band):
    arrays = [torch.from_numpy(x) for x in _codes(pairs, length)]
    return torch_wavefront.banded_distance_torch(*arrays, band).numpy()


_RAGGED = [("", ""), ("A", ""), ("", "C"), ("A", "A"), ("A", "C"),
           ("A", "ACGTACGT"), ("ACGTACGTAC", "G"), ("AC", "CA"),
           ("ACGT" * 8, "ACGT" * 8), ("ACGT" * 8, "A" + "ACGT" * 7),
           ("A" * 30, "C" * 33)]


def test_value_within_its_band_equals_every_wider_band():
    """The in-kernel widening argument: a value <= the band it was computed
    in is the exact distance, so any wider band (W > L included) returns
    the same, in the plain version and in the jnp one."""
    pairs = _random_pairs(41, 40, 60, 12) + _RAGGED
    length = 64
    exact = np.asarray([edit_distance_dp(a, b) for a, b in pairs])
    bands = (0, 1, 2, 3, 7, 15, 31, 63, 64, 100)
    values = {band: _plain(pairs, length, band) for band in bands}
    codes = _codes(pairs, length)
    for band in (1, 7, 63):
        np.testing.assert_array_equal(
            values[band],
            np.asarray(jax_wavefront.banded_distance(*codes, band)))
    seen_resolved = seen_open = 0
    for index, band in enumerate(bands):
        resolved = values[band] <= band
        np.testing.assert_array_equal(values[band][resolved], exact[resolved])
        # unresolved entries never undercut the distance
        assert (values[band][~resolved] >= exact[~resolved]).all()
        for wider in bands[index + 1:]:
            np.testing.assert_array_equal(values[wider][resolved],
                                          values[band][resolved])
        seen_resolved += int(resolved.sum())
        seen_open += int((~resolved).sum())
    assert seen_resolved > 100 and seen_open > 100
    # a band of at least max(m, n) holds every cell: W > L changes nothing
    np.testing.assert_array_equal(values[64], exact)
    np.testing.assert_array_equal(values[100], exact)


def _one_parity_fronts(a, b, band):
    """The front layout of csrc/wavefront.cu in numpy: slot q of front d is
    the diagonal e = 2q - Q + (d & 1), cells of the other parity do not
    exist, cells outside 0 <= i <= m, 0 <= j <= n, |e| <= w are INF, and the
    boundaries D(0, d) = D(d, 0) = d come out of the recurrence."""
    inf = torch_wavefront.INF
    m, n = len(a), len(b)
    if m + n == 0:
        return 0
    if abs(m - n) > band:
        return inf
    if m + n == 1:
        return 1
    w = min(band, max(m, n))
    offset = (min(w, n) + 1) & ~1
    half = offset >> 1
    slots = ((min(w, m) + offset) >> 1) + 1
    q = np.arange(slots)
    fronts = [np.full(slots, inf, dtype=np.int64),
              np.full(slots, inf, dtype=np.int64)]
    fronts[0][half] = 0
    for d in range(1, m + n + 1):
        parity = d & 1
        base = offset - parity
        reach = min(w, d)
        q_lo = max((base - reach + 1) >> 1, (base + d - 2 * n + 1) >> 1)
        q_hi = min((base + reach) >> 1, (base + 2 * m - d) >> 1)
        previous = np.concatenate([[inf], fronts[1 - parity], [inf]])
        # odd fronts take slots q, q+1 of the even front; even fronts q-1, q
        neighbours = np.minimum(previous[q + parity], previous[q + 1 + parity])
        i = (d >> 1) + q - half + parity
        j = (d >> 1) - q + half
        differ = np.asarray([
            0 if 1 <= x <= m and 1 <= y <= n and a[x - 1] == b[y - 1] else 1
            for x, y in zip(i.tolist(), j.tolist())])
        value = np.minimum(neighbours + 1, fronts[parity] + differ)
        fronts[parity] = np.where((q >= q_lo) & (q <= q_hi), value, inf)
    final = (m - n + offset - ((m + n) & 1)) >> 1
    return int(fronts[(m + n) & 1][final])


@pytest.mark.parametrize("band", [0, 1, 2, 5, 16, 33, 64, 200])
def test_one_parity_live_cell_fronts_equal_plain_version(band):
    """Odd-parity slots never reach the answer and the clipped live range
    loses nothing: fronts of one parity over live cells return the plain
    version's value on every entry, above the band too; ragged lengths
    incl. m or n = 1, m + n <= 1 and W > L."""
    pairs = _random_pairs(band + 7, 30, 60, 10) + _RAGGED
    want = _plain(pairs, 64, band)
    got = np.asarray([_one_parity_fronts(a, b, band) for a, b in pairs])
    np.testing.assert_array_equal(got, want)
    if 0 < band < 64:
        assert (want <= band).any() and (want > band).any()


def _encode_per_string(strings, length):
    """The encoding the vectorised _encode replaced."""
    out = np.zeros((len(strings), length), dtype=np.uint8)
    for row, text in enumerate(strings):
        raw = np.frombuffer(text.encode(), dtype=np.uint8)
        out[row, :len(raw)] = raw
    return out


def test_vectorised_encoding_equals_per_string_encoding():
    rng = random.Random(53)
    strings = ["".join(rng.choice("ACGTNacgtn*-") for _ in range(
        rng.choice((0, 1, 2, 17, 63, 64)))) for _ in range(200)]
    for batch in (strings, strings[:1], [""], ["", ""], []):
        got = torch_wavefront._encode(batch, 64)
        assert got.dtype == np.uint8 and got.shape == (len(batch), 64)
        np.testing.assert_array_equal(got, _encode_per_string(batch, 64))
        np.testing.assert_array_equal(got, jax_wavefront._encode(batch, 64))
    # characters outside ASCII go up as their UTF-8 bytes, as before
    mixed = ["ACGT", "N\u00e9T", ""]
    np.testing.assert_array_equal(torch_wavefront._encode(mixed, 8),
                                  _encode_per_string(mixed, 8))
    out = np.full((3, 8), 7, dtype=np.uint8)
    assert torch_wavefront._encode(mixed, 8, out=out) is out
    np.testing.assert_array_equal(out, _encode_per_string(mixed, 8))
    for too_long in (["A" * 65], ["\u00e9" * 33]):
        with pytest.raises(ValueError):
            torch_wavefront._encode(too_long, 64)


def test_chunk_goes_up_as_one_buffer_with_the_same_bytes():
    pairs = _random_pairs(59, 21, 60, 6)
    a_codes, a_lens, b_codes, b_lens = torch_wavefront._pack_chunk(pairs, 64,
                                                                   CPU)
    want = _codes(pairs, 64)
    for got, expected in zip((a_codes, a_lens, b_codes, b_lens), want):
        assert got.is_contiguous() and got.device == CPU
        np.testing.assert_array_equal(got.numpy(), expected)
    assert a_codes.dtype == torch.uint8 and a_lens.dtype == torch.int32
    # one storage behind all four
    assert len({t.untyped_storage().data_ptr()
                for t in (a_codes, a_lens, b_codes, b_lens)}) == 1


def test_kernel_variant_follows_the_shape(monkeypatch):
    """Which code path a launch takes is decided in Python from the shape
    and the shared-memory limit (227 KB on the H100; the strip kernel's
    static shared memory, 7,244 bytes, beside its staged strings)."""
    monkeypatch.setattr(torch_wavefront, "_kernel_library", lambda: None)
    monkeypatch.setattr(torch_wavefront, "_max_shared_bytes", 232448)
    monkeypatch.setattr(torch_wavefront, "_strip_static_bytes", 7244)
    variant = torch_wavefront.kernel_variant
    assert [variant(512, 64), variant(512, 256), variant(1024, 1024),
            variant(1024, 16384), variant(16384, 64)] == ["warp"] * 5
    assert variant(2048, 2048) == "strip"
    assert variant(16384, 16384) == "strip"
    assert variant(32768, 32768) == "strip"
    assert variant(112000, 112000) == "strip"
    assert variant(120000, 4096) == "strip_unstaged"
    assert variant(120000, 64) == "strip_unstaged"
    assert torch_wavefront._warps_per_cta(8192, 1024) == 4
    assert torch_wavefront._warps_per_cta(8, 1024) == 1
    assert torch_wavefront._warps_per_cta(8192, 40000) == 2
    assert torch_wavefront._warps_per_cta(8192, 200000, staged=False) == 4
    assert [torch_wavefront._strip_warps(length) for length in (
        300, 1024, 2048, 4096, 16384, 32768, 120000)] == [1, 1, 2, 4, 8, 8, 8]
    # the ladder stages its strings where four warps' fit an SM
    assert torch_wavefront._ladder_stages(16384)
    assert torch_wavefront._ladder_stages(29056)
    assert not torch_wavefront._ladder_stages(32768)


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
@pytest.mark.parametrize("variant", ["strip", "strip_unstaged"])
def test_cuda_kernel_global_scratch_fronts(cuda_device, variant):
    """The strip layout (the warp ladder, then strips of rows a CTA a pair,
    with and without staged strings; its top rows between strips in shared
    rings and a device-memory row), forced at a small shape, and the widest
    band's layout."""
    pairs = _random_pairs(3, 5, 600, 30, empties=False)
    arrays = [torch.from_numpy(x).to(cuda_device) for x in _codes(pairs, 1024)]
    want = torch_wavefront.banded_distance_torch(*arrays, 300)
    got = torch_wavefront.banded_distance_cuda(*arrays, 300, variant=variant)
    assert torch.equal(got.cpu(), want.cpu())
    if variant == "strip":
        assert torch_wavefront.kernel_variant(32768, 32768) == "strip"
