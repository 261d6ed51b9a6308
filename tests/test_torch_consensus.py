"""Twins of tests/test_consensus.py and tests/test_consensus_noise.py for
the port's insertion consensus (svim_tpu_torch/combine/consensus.py, whose
native catches are narrower than svim_tpu's: a failed build raises).  The
same seeded inputs as the originals, the same demands, and on each input
the port's result equal to svim_tpu's (exact): the skip of haplotypes over
10 kb, recovery from identical and from mostly clean members, the global
alignment's single gap run, the POA of identical inputs, the banded
graph POA of an 8 kb insertion (slow, as the original), the native star
polish against the Python one, the banded Gotoh aligner against the full
DP (native and Python), and recovery from ONT-like noise."""

import random
import re

import pytest

from svim_tpu.combine import consensus as jax_consensus
from svim_tpu.signatures import SignatureClusterUniLocal as JaxCluster
from svim_tpu.signatures import SignatureInsertion as JaxInsertion
from svim_tpu_torch import native
from svim_tpu_torch.cluster.edit_distance import edit_distance
from svim_tpu_torch.combine.consensus import (
    _align_global_py,
    _align_global_py_auto,
    _star_consensus,
    align_global,
    generate_insertion_consensus,
    poa_consensus,
)
from svim_tpu_torch.signatures import (
    SignatureClusterUniLocal,
    SignatureInsertion,
)
from tests.test_consensus import _MockReference, _mutate
from tests.test_consensus_noise import _noisy


def _clusters(specs, start=None, end=None):
    """The same insertion cluster in the port's classes and svim_tpu's:
    specs are (contig, start, end, read, sequence)."""
    made = []
    for cluster_class, insertion_class in ((SignatureClusterUniLocal,
                                            SignatureInsertion),
                                           (JaxCluster, JaxInsertion)):
        members = [insertion_class(contig, low, high, "cigar", read, seq)
                   for contig, low, high, read, seq in specs]
        made.append(cluster_class(
            members[0].contig, members[0].start if start is None else start,
            members[0].end if end is None else end, 10, len(members),
            members, "INS", 0.0, 0.0))
    return made


def _consensus_of(specs, reference, **bounds):
    port, jax = _clusters(specs, **bounds)
    result = generate_insertion_consensus(port, reference)
    assert result == jax_consensus.generate_insertion_consensus(jax,
                                                                reference)
    return result


def test_skip_too_long_haplotypes():
    reference = _MockReference("A" * 100 + "C" * 100)
    specs = [("chr1", 100, 100 + 20000, "read{0}".format(i), "T" * 20000)
             for i in range(5)]
    assert _consensus_of(specs, reference) == (1, ())


def test_exact_recovery_from_identical_signatures():
    rng = random.Random(5)
    reference = _MockReference("".join(rng.choice("ACGT")
                                       for _ in range(400)))
    insertion = "".join(rng.choice("ACGT") for _ in range(60))
    specs = [("chr1", 200, 260, "read{0}".format(i), insertion)
             for i in range(10)]
    assert _consensus_of(specs, reference) == (0, (200, 60, insertion))


def test_consensus_robust_to_minority_errors():
    rng = random.Random(6)
    reference = _MockReference("".join(rng.choice("ACGT")
                                       for _ in range(400)))
    insertion = "".join(rng.choice("ACGT") for _ in range(50))
    noisy1 = insertion[:20] + ("A" if insertion[20] != "A" else "C") \
        + insertion[21:]
    noisy2 = insertion[:35] + insertion[36:]
    specs = [("chr1", 200, 250, "r{0}".format(i), seq) for i, seq in
             enumerate([insertion] * 8 + [noisy1, noisy2])]
    status, result = _consensus_of(specs, reference)
    assert status == 0
    assert result[2] == insertion


def test_align_global_places_single_gap_run():
    rng = random.Random(7)
    left = "".join(rng.choice("ACGT") for _ in range(120))
    right = "".join(rng.choice("ACGT") for _ in range(120))
    insert = "".join(rng.choice("ACGT") for _ in range(40))
    row_a, row_b = align_global(left + insert + right, left + right)
    assert (row_a, row_b) == jax_consensus.align_global(left + insert + right,
                                                        left + right)
    assert row_a.replace("-", "") == left + insert + right
    assert row_b.replace("-", "") == left + right
    assert [m.end() - m.start() for m in re.finditer(r"-+", row_b)] == [40]


def test_poa_consensus_identical_inputs():
    seq = "ACGTACGTACGTTTTGGGACGT"
    assert poa_consensus([seq] * 7) == seq
    assert poa_consensus([seq]) == seq


@pytest.mark.slow
def test_long_insertion_cluster_banded_poa():
    """An 8 kb insertion with 20 noisy members through the banded graph
    POA (status 0), as svim_tpu's."""
    rng = random.Random(11)
    reference = _MockReference("".join(rng.choice("ACGT")
                                       for _ in range(2000)))
    motif = "".join(rng.choice("ACGT") for _ in range(8000))
    specs = []
    for i in range(20):
        noisy = list(motif)
        for _ in range(100):
            op = rng.random()
            pos = rng.randrange(len(noisy))
            if op < 0.5:
                noisy[pos] = rng.choice("ACGT")
            elif op < 0.75:
                noisy.insert(pos, rng.choice("ACGT"))
            else:
                del noisy[pos]
        specs.append(("chr1", 1000, 1000 + len(noisy), "read{0}".format(i),
                      "".join(noisy)))
    status, (start, size, consensus) = _consensus_of(specs, reference,
                                                     start=1000, end=9000)
    assert status == 0
    assert start == 1000
    assert abs(size - 8000) < 40
    assert native.aligner.edit_distance(consensus, motif) < 40


def test_native_star_polish_matches_python_oracle():
    """The port's C++ star_polish round equals its Python _star_consensus
    and svim_tpu's, vote ties and empty rows included."""
    rng = random.Random(91)
    for trial in range(60):
        base = "".join(rng.choice("ACGT") for _ in range(rng.randint(2, 300)))
        sequences = []
        for _ in range(rng.randint(1, 15)):
            chars = list(base)
            for _ in range(rng.randint(0, 8)):
                op = rng.choice("sid")
                pos = rng.randrange(max(1, len(chars)))
                if op == "s" and chars:
                    chars[pos] = rng.choice("ACGT")
                elif op == "i":
                    chars.insert(pos, rng.choice("ACGT"))
                elif chars:
                    del chars[pos]
            sequences.append("".join(chars))
        if rng.random() < 0.2:
            sequences.append("")
        center = base if rng.random() < 0.5 else sequences[0] or base
        result = native.star_polish_native(sequences, center)
        assert result == _star_consensus(sequences, center=center), trial
        assert result == jax_consensus._star_consensus(sequences,
                                                       center=center)


def test_banded_gotoh_matches_full_dp():
    """The banded aligner (forced with full_dp_cells=0), native and Python,
    reproduces the port's full DP, which equals svim_tpu's native result."""
    from svim_tpu import native as jax_native

    rng = random.Random(417)
    for trial in range(30):
        base = "".join(rng.choice("ACGT")
                       for _ in range(rng.randint(80, 900)))
        other = _mutate(rng, base, rng.randint(0, 20))
        full = _align_global_py(base, other)
        assert _align_global_py_auto(base, other, full_dp_cells=0) == full
        assert native.aligner.align_global(base, other,
                                           full_dp_cells=0) == full
        assert jax_native.aligner.align_global(base, other,
                                               full_dp_cells=0) == full


def test_banded_gotoh_band_doubling_on_distant_pair():
    rng = random.Random(31)
    left = "".join(rng.choice("ACGT") for _ in range(400))
    mid = "".join(rng.choice("ACGT") for _ in range(300))
    right = "".join(rng.choice("ACGT") for _ in range(400))
    a = left + mid + right
    b = left + mid[::-1] + right
    full = _align_global_py(a, b)
    assert _align_global_py_auto(a, b, full_dp_cells=0) == full
    assert native.aligner.align_global(a, b, full_dp_cells=0) == full
    assert jax_consensus._align_global_py(a, b) == full


def test_banded_gotoh_length_skew_pair():
    rng = random.Random(77)
    window = "".join(rng.choice("ACGT") for _ in range(240))
    insertion = "".join(rng.choice("ACGT") for _ in range(1500))
    a = window[:120] + insertion + window[120:]
    full = _align_global_py(a, window)
    assert _align_global_py_auto(a, window, full_dp_cells=0) == full
    assert native.aligner.align_global(a, window, full_dp_cells=0) == full
    assert jax_consensus._align_global_py(a, window) == full


def test_consensus_recovers_under_noise():
    """tests/test_consensus_noise.py's case: within 1% of the truth, and
    the port's consensus equal to svim_tpu's."""
    rng = random.Random(3)
    for error_rate, n_reads, length, tolerance in (
            (0.05, 10, 300, 0.01),
            (0.10, 10, 300, 0.01),
            (0.15, 20, 500, 0.01)):
        truth = "".join(rng.choice("ACGT") for _ in range(length))
        reads = [_noisy(rng, truth, error_rate) for _ in range(n_reads)]
        consensus = poa_consensus(reads)
        assert consensus == jax_consensus.poa_consensus(reads)
        residual = edit_distance(consensus, truth)
        assert residual <= tolerance * length, (error_rate, n_reads, residual)
