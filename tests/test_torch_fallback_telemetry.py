"""The port's device-clustering telemetry: the cases of
tests/test_fallback_telemetry.py through the port's cluster_sv_signatures
on the CPU, each held to the JAX test's bounds on the port's TELEMETRY and
to svim_tpu's counts on the same signatures (each built with each
package's classes from one seed).  The TPU switch of the resident INS
route (`test_auto_backend_resident_predicate`) is not ported."""

import random

import pytest
import torch

import svim_tpu.signatures as jax_signatures
import svim_tpu_torch.signatures as port_signatures
from svim_tpu.cluster import cluster_sv_signatures as jax_cluster
from svim_tpu.cluster.device_cluster import TELEMETRY as JAX_TELEMETRY
from svim_tpu.config import parse_arguments as jax_parse_arguments
from svim_tpu_torch.cluster.cluster import (
    cluster_sv_signatures as port_cluster,
)
from svim_tpu_torch.cluster.device_cluster import TELEMETRY
from svim_tpu_torch.config import parse_arguments as port_parse_arguments

# one intra-op thread: the suite runs several pytest workers
torch.set_num_threads(1)


def _tie_free_deletions(signatures):
    """Tie-free DEL partitions: distinct sizes."""
    rng = random.Random(7)
    out = []
    for locus in range(6):
        base = 10_000 + locus * 30_000
        for member in range(8):
            start = base + rng.randint(-40, 40)
            size = 300 + rng.randint(-25, 25) + member
            out.append(signatures.SignatureDeletion(
                "chr1", start, start + size, "cigar",
                "read_l{0}_m{1}".format(locus, member)))
    return out


def _tied_insertions(signatures):
    """INS partitions of identical members: exactly tied distances."""
    return [signatures.SignatureInsertion(
        "chr1", 50_000 + locus * 40_000, 50_000 + locus * 40_000 + 200,
        "cigar", "read_t{0}_{1}".format(locus, member), "A" * 200)
        for locus in range(3) for member in range(4)]


def _noisy_motifs(rng, signatures, loci, spacing, members, size_range,
                  prefix, base_offset, jitter):
    out = []
    for locus in range(loci):
        base = base_offset + locus * spacing
        size = rng.randint(*size_range)
        motif = "".join(rng.choice("ACGT") for _ in range(size))
        for member in range(members):
            noisy = list(motif)
            for _ in range(rng.randint(1, 5)):
                noisy[rng.randrange(len(noisy))] = rng.choice("ACGT")
            out.append(signatures.SignatureInsertion(
                "chr1", base + rng.randint(-jitter, jitter), base + size,
                "cigar", "read_{0}{1}_{2}".format(prefix, locus, member),
                "".join(noisy)))
    return out


def _bench_shaped(signatures):
    """Jittered DEL pileups and noisy INS motifs, as the bench workload."""
    rng = random.Random(1234)
    out = []
    for locus in range(24):
        base = 10_000 + locus * 12_000
        size = rng.randint(60, 800)
        for member in range(12):
            jitter = rng.randint(-10, 10)
            out.append(signatures.SignatureDeletion(
                "chr1", base + jitter,
                base + jitter + size + rng.randint(-3, 3), "cigar",
                "read_d{0}_{1}".format(locus, member)))
    return out + _noisy_motifs(rng, signatures, 24, 12_000, 12, (60, 400),
                               "i", 11_000, 10)


def _resident_motifs(signatures):
    """Noisy INS motif clusters of distinct reads (the resident route)."""
    return _noisy_motifs(random.Random(99), signatures, 20, 15_000, 10,
                         (60, 400), "r", 20_000, 10)


def _device_partitions(telemetry):
    assert telemetry.device >= 5
    assert telemetry.fallback_fraction <= 0.2


def _tie_fallbacks(telemetry):
    assert telemetry.pre_tie >= 3       # caught before any device dispatch
    assert telemetry.wasted_fraction == 0.0
    summary = telemetry.as_dict()
    assert summary["pre_tie"] == telemetry.pre_tie
    assert 0.0 <= summary["fallback_fraction"] <= 1.0


def _wasted_dispatch_bounded(telemetry):
    assert telemetry.eligible >= 40
    assert telemetry.wasted_fraction <= 0.05, telemetry.as_dict()


def _resident_fallback_bounded(telemetry):
    assert telemetry.eligible >= 20
    assert telemetry.fallback_fraction <= 0.2, telemetry.as_dict()
    assert telemetry.wasted_fraction <= 0.05, telemetry.as_dict()
    assert telemetry.resident_relink <= 0.7 * telemetry.eligible, \
        telemetry.as_dict()


CASES = [("device partitions", _tie_free_deletions, "auto",
          _device_partitions),
         ("tie fallbacks", _tied_insertions, "auto", _tie_fallbacks),
         ("wasted dispatch on a bench-shaped workload", _bench_shaped,
          "auto", _wasted_dispatch_bounded),
         ("resident INS route", _resident_motifs, "wavefront",
          _resident_fallback_bounded)]


@pytest.mark.parametrize("name, build, edit_backend, check", CASES,
                         ids=[case[0] for case in CASES])
def test_telemetry_bounds_and_svim_tpu_counts(tmp_path, name, build,
                                              edit_backend, check):
    genome = tmp_path / "genome.fa"
    rng = random.Random(3)
    sequence = "".join(rng.choice("ACGT") for _ in range(400_000))
    with open(genome, "w") as handle:
        handle.write(">chr1\n")
        for i in range(0, len(sequence), 80):
            handle.write(sequence[i:i + 80] + "\n")
    arguments = ["alignment", str(tmp_path), "x.bam", str(genome),
                 "--edit_backend", edit_backend]
    port_cluster(build(port_signatures), port_parse_arguments(
        arguments=arguments), torch.device("cpu"))
    check(TELEMETRY)
    jax_cluster(build(jax_signatures), jax_parse_arguments(
        arguments=arguments))
    assert TELEMETRY.as_dict() == JAX_TELEMETRY.as_dict()
