"""Twins of tests/test_ins_indexed_ed.py and tests/test_distance_accel.py
for the port's cluster/accel.py, which differs from svim_tpu's: its
forced-backend route assembles the haplotypes with ins_haplotype_pairs,
it takes the device, and it has no route for a missing native library
(a failed build raises).  svim_tpu's original forces the string route by
patching _native_indexed_ed to None; here `edit_backend` forces it ("python":
the Myers recurrence, exact; "wavefront" on the CPU device: the plain
wavefront version, on short inserts).  On the same seeded partitions:

- the native indexed route gives the string route's cache, bit for bit;
- precompute_ins_edit_distances gives svim_tpu's cache on either route;
- the vectorized matrix fill equals the scalar lookups;
- the vectorized distance matrices equal the port's scalar oracle
  (cluster/reference_path.py::_pairwise_condensed) and svim_tpu's, bit for
  bit (float64), for every signature type.
"""

import random

import numpy as np
import pytest
import torch

from svim_tpu.cluster import accel as jax_accel
from svim_tpu.cluster.cluster import _pairwise_condensed as jax_condensed
from svim_tpu import signatures as jax_signatures
from svim_tpu_torch import signatures as torch_signatures
from svim_tpu_torch.cluster import accel
from svim_tpu_torch.cluster.reference_path import _pairwise_condensed
from tests.test_ins_indexed_ed import FakeRef, FakeSig, _make_partitions

CPU = torch.device("cpu")


class Opts:
    position_distance_normalizer = 900
    cluster_max_distance = 0.5
    edit_distance_normalizer = 1.0

    def __init__(self, edit_backend="auto"):
        self.edit_backend = edit_backend


def _same_cache(got, want, samples):
    assert set(got.pairs) == set(want.pairs)
    assert all(got.pairs[key] == want.pairs[key] for key in want.pairs)
    for sample in samples:
        arrays_a = got.partition_arrays(sample)
        arrays_b = want.partition_arrays(sample)
        assert (arrays_a is None) == (arrays_b is None)
        if arrays_a is not None:
            for left, right in zip(arrays_a, arrays_b):
                assert np.array_equal(left, right)


def _jax_string_cache(samples, reference, monkeypatch):
    with monkeypatch.context() as patch:
        patch.setattr(jax_accel, "_native_indexed_ed", lambda: None)
        return jax_accel.precompute_ins_edit_distances(samples, reference,
                                                       Opts())


def test_indexed_matches_string_route():
    rng = random.Random(11)
    reference, samples = _make_partitions(rng)
    indexed = accel.precompute_ins_edit_distances(samples, reference, Opts(),
                                                  CPU)
    strings = accel.precompute_ins_edit_distances(samples, reference,
                                                  Opts("python"), CPU)
    _same_cache(indexed, strings, samples)


@pytest.mark.parametrize("backend", ["auto", "python"])
def test_precompute_equals_svim_tpu(backend, monkeypatch):
    """The port's cache equals svim_tpu's on the same partitions: its
    indexed route against svim_tpu's, its string route against svim_tpu's
    string route."""
    rng = random.Random(11)
    reference, samples = _make_partitions(rng)
    got = accel.precompute_ins_edit_distances(samples, reference,
                                              Opts(backend), CPU)
    want = (jax_accel.precompute_ins_edit_distances(samples, reference,
                                                    Opts())
            if backend == "auto"
            else _jax_string_cache(samples, reference, monkeypatch))
    _same_cache(got, want, samples)


def test_wavefront_route_equals_the_indexed_route():
    """The forced wavefront route (the plain version on the CPU) on a few
    short-insert partitions gives the native indexed route's cache."""
    rng = random.Random(5)
    genome = "".join(rng.choice("ACGT") for _ in range(20000))
    reference = FakeRef(genome)
    samples = []
    for locus in (50, 4000, 9000):
        motif = "".join(rng.choice("ACGT") for _ in range(rng.randint(20, 80)))
        part = []
        for k in range(rng.randint(2, 6)):
            noisy = list(motif)
            for _ in range(rng.randint(0, 4)):
                noisy[rng.randrange(len(noisy))] = rng.choice("ACGT")
            part.append(FakeSig("chr1", max(0, locus + rng.randint(-300, 300)),
                                "".join(noisy), "r{0}".format(k)))
        samples.append(part)
    wavefront = accel.precompute_ins_edit_distances(
        samples, reference, Opts("wavefront"), CPU)
    indexed = accel.precompute_ins_edit_distances(samples, reference, Opts(),
                                                  CPU)
    _same_cache(wavefront, indexed, samples)


def test_vectorized_matrix_fill_bitwise():
    rng = random.Random(23)
    reference, samples = _make_partitions(rng)
    options = Opts()
    cache = accel.precompute_ins_edit_distances(samples, reference, options,
                                                CPU)
    checked = 0
    for sample in samples:
        if len(sample) < 3:
            continue
        pairs_i, pairs_j, values = cache.partition_arrays(sample)
        scalar = {}
        for i, j, value in zip(pairs_i.tolist(), pairs_j.tolist(),
                               values.tolist()):
            scalar[(id(sample[i]), id(sample[j]))] = value
            scalar[(id(sample[j]), id(sample[i]))] = value
        vectorized = accel.distance_matrix(sample, "INS", reference, options,
                                           ed_cache=cache)
        assert np.array_equal(vectorized, accel.distance_matrix(
            sample, "INS", reference, options, ed_cache=scalar))
        assert np.array_equal(vectorized, jax_accel.distance_matrix(
            sample, "INS", reference, options, ed_cache=scalar))
        checked += 1
    assert checked


def _elements(module, sv_type, rng):
    """tests/test_distance_accel.py's 14 elements of a type, as `module`'s
    signature classes."""
    elements = []
    for i in range(14):
        start = rng.randint(1000, 2500)
        span = rng.randint(40, 400)
        read = "read{0}".format(i % 10)
        if sv_type == "DEL":
            elements.append(module.SignatureDeletion(
                "chr1", start, start + span, "cigar", read))
        elif sv_type == "DUP_TAN":
            elements.append(module.SignatureDuplicationTandem(
                "chr1", start, start + span, rng.randint(1, 3), True, "suppl",
                read))
        elif sv_type == "INS":
            seq = "".join(rng.choice("ACGT") for _ in range(span))
            elements.append(module.SignatureInsertion(
                "chr1", start, start + span, "cigar", read, seq))
        elif sv_type == "DUP_INT":
            elements.append(module.SignatureInsertionFrom(
                "chr1", start, start + span, "chr1", rng.randint(3000, 3500),
                "suppl", read))
        else:
            elements.append(module.SignatureTranslocation(
                "chr1", start, rng.choice(["fwd", "rev"]), "chr2",
                rng.randint(100, 700), rng.choice(["fwd", "rev"]), "suppl",
                read))
    return elements


@pytest.mark.parametrize("sv_type", ["DEL", "DUP_TAN", "INS", "DUP_INT",
                                     "BND"])
def test_accel_matches_scalar(default_options, sv_type):
    genome_rng = random.Random(hash(sv_type) & 0xFFFF)
    reference = FakeRef("".join(genome_rng.choice("ACGT")
                                for _ in range(6000)))
    seed = genome_rng.getstate()
    port_rng, jax_rng = random.Random(), random.Random()
    port_rng.setstate(seed)
    jax_rng.setstate(seed)
    elements = _elements(torch_signatures, sv_type, port_rng)
    jax_elements = _elements(jax_signatures, sv_type, jax_rng)

    matrix = accel.distance_matrix(elements, sv_type, reference,
                                   default_options)
    fast = accel.condensed_with_wall(matrix, accel.read_index_array(elements),
                                     wall_same_read=True)
    scalar = np.asarray(_pairwise_condensed(elements, sv_type, reference,
                                            default_options),
                        dtype=np.float64)
    np.testing.assert_array_equal(scalar, fast)
    np.testing.assert_array_equal(
        np.asarray(jax_condensed(jax_elements, sv_type, reference,
                                 default_options), dtype=np.float64), fast)
