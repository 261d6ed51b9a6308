"""Twin of tests/test_poa_oracle.py for the port: the port's native graph
POA (svim_tpu_torch/native/poa.cpp, its own g++ build, through
svim_tpu_torch.native.poa_consensus_native) against the independent SPOA
oracle (tests/oracles/spoa_oracle.py, which imports neither package) on
the same seeded clusters, with the same demands: exact equality on every
instance the oracle saw no equal-score choice in, divergence only on tied
instances, the tie-class breakdown pinned as for svim_tpu's POA.  Every
cluster's consensus must also equal svim_tpu's native POA on it (exact)."""

import random

import pytest

from svim_tpu.native import poa_consensus_native as jax_poa
from svim_tpu_torch.native import poa_consensus_native
from tests.oracles.spoa_oracle import spoa_consensus_oracle
from tests.test_poa_oracle import (
    PINNED_TIE_BREAKDOWN,
    _noisy_cluster,
    _tie_class_instances,
)


def _consensus(cluster):
    """The port's consensus, held to svim_tpu's on the same cluster."""
    native = poa_consensus_native(cluster)
    assert native is not None
    assert native == jax_poa(cluster)
    return native


def _differential(clusters):
    """Run the port and the oracle over the clusters; return (exact
    matches on tie-free instances, tie-free count, divergent tied
    instances, failures)."""
    tie_free_equal = tie_free_total = tied_divergent = 0
    failures = []
    for cluster in clusters:
        oracle = spoa_consensus_oracle(cluster)
        native = _consensus(cluster)
        if not oracle.ties:
            tie_free_total += 1
            if native == oracle.consensus:
                tie_free_equal += 1
            else:
                failures.append((cluster, oracle.consensus, native))
        elif native != oracle.consensus:
            tied_divergent += 1
    return tie_free_equal, tie_free_total, tied_divergent, failures


def test_single_and_identical_sequences_are_fixed_points():
    rng = random.Random(11)
    for _ in range(10):
        motif = "".join(rng.choice("ACGT") for _ in range(rng.randint(3, 60)))
        result = spoa_consensus_oracle([motif] * rng.randint(2, 6))
        assert result.consensus == motif
        assert _consensus([motif] * 3) == motif


def test_oracle_recovers_majority_base():
    cluster = ["ACGTACGTAC", "ACGTACGTAC", "ACGTACGTAC", "ACGAACGTAC"]
    assert spoa_consensus_oracle(cluster).consensus == "ACGTACGTAC"
    assert _consensus(cluster) == "ACGTACGTAC"


def test_differential_substitution_noise():
    rng = random.Random(1524)
    clusters = [_noisy_cluster(rng, rng.randint(8, 60), rng.randint(3, 6),
                               substitutions=rng.randint(0, 3))
                for _ in range(60)]
    equal, tie_free, _tied_divergent, failures = _differential(clusters)
    assert tie_free >= 10
    assert equal == tie_free, failures[:2]


def test_differential_indel_noise():
    rng = random.Random(77)
    clusters = [_noisy_cluster(rng, rng.randint(10, 50), rng.randint(3, 5),
                               substitutions=rng.randint(0, 2),
                               indels=rng.randint(0, 2))
                for _ in range(40)]
    equal, tie_free, _tied_divergent, failures = _differential(clusters)
    assert tie_free >= 5
    assert equal == tie_free, failures[:2]


def test_adversarial_homopolymers_and_near_ties():
    """As the original: tie-breaking territory, where the port must stay
    within the length envelope and diverge from the oracle only on
    instances the oracle flagged as tied."""
    rng = random.Random(5)
    clusters = []
    for _ in range(12):
        run = rng.randint(6, 20)
        flank = "".join(rng.choice("ACGT") for _ in range(6))
        clusters.append([flank + "A" * (run + rng.randint(-1, 1))
                         + flank[::-1] for _ in range(4)])
    for _ in range(12):
        length = rng.randint(10, 30)
        members = []
        for member in range(4):
            seq = ["A"] * length
            for pos in range(0, length, 2):
                seq[pos] = "C" if member % 2 else "G"
            members.append("".join(seq))
        clusters.append(members)
    for cluster in clusters:
        oracle = spoa_consensus_oracle(cluster)
        native = _consensus(cluster)
        shortest = min(len(s) for s in cluster)
        longest = max(len(s) for s in cluster)
        assert shortest <= len(native) <= longest + 2
        if native != oracle.consensus:
            assert oracle.ties, cluster


@pytest.mark.slow
def test_differential_fuzz_broad():
    rng = random.Random(20260820)
    clusters = [_noisy_cluster(rng, rng.randint(4, 200), rng.randint(2, 8),
                               substitutions=rng.randint(0, 4),
                               indels=rng.randint(0, 3))
                for _ in range(250)]
    equal, tie_free, tied_divergent, failures = _differential(clusters)
    assert tie_free >= 25
    assert equal == tie_free, failures[:2]
    assert tied_divergent <= 250 - tie_free


def test_tie_class_breakdown_pinned():
    """svim_tpu's pinned per-class breakdown holds for the port too."""
    breakdown = {}
    for family, clusters in _tie_class_instances().items():
        tied = divergent = 0
        for cluster in clusters:
            oracle = spoa_consensus_oracle(cluster)
            native = _consensus(cluster)
            tied += bool(oracle.ties)
            if native != oracle.consensus:
                divergent += 1
                assert oracle.ties, (family, cluster)
                assert set(native) <= set("".join(cluster))
        breakdown[family] = (len(clusters), tied, divergent)
    assert breakdown == PINNED_TIE_BREAKDOWN, breakdown
