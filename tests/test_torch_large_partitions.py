"""Oversized partitions through the port (twin of tests/
test_large_partitions.py): over 100 signatures a partition, so the
fixed-seed subsample (seed 1524, SVIM_clustering.py:129-134) decides which
100 are clustered.  The port's partition_and_cluster must return svim_tpu's
clusters, in order, for a deletion partition (fused route) and for an
insertion partition with edit distances (matrix route, and the resident
route under --edit_backend wavefront)."""

import random

import pytest
import torch

from svim_tpu.cluster import partition_and_cluster as jax_partition_and_cluster
from svim_tpu.config import parse_arguments as jax_parse_arguments
from svim_tpu.signatures import SignatureDeletion as JaxDeletion
from svim_tpu.signatures import SignatureInsertion as JaxInsertion
from svim_tpu_torch.cluster.cluster import partition_and_cluster
from svim_tpu_torch.cluster.reference_path import (
    partition_and_cluster_reference,
)
from svim_tpu_torch.config import parse_arguments
from svim_tpu_torch.signatures import SignatureDeletion, SignatureInsertion

CPU = torch.device("cpu")
torch.set_num_threads(1)


def _options(parse, tmp_path, genome, *flags):
    return parse(arguments=["alignment", str(tmp_path),
                            str(tmp_path / "reads.bam"), str(genome),
                            *flags])


def _plain_genome(tmp_path):
    genome = tmp_path / "genome.fa"
    genome.write_text(">chr1\n" + "A" * 100 + "C" * 100 + "\n")
    return genome


def _dense_del_partition(deletion, n=180):
    rng = random.Random(2)
    return [deletion("chr1", 50000 + rng.randint(-40, 40),
                     50400 + rng.randint(-40, 40), "cigar",
                     "read{0}".format(i))
            for i in range(n)]


def _described(clusters):
    return [(c.contig, c.start, c.end, c.size, c.score,
             tuple(m.read for m in c.members)) for c in clusters]


def test_subsampled_del_partition_equals_svim_tpu(tmp_path):
    genome = _plain_genome(tmp_path)
    want = jax_partition_and_cluster(
        _dense_del_partition(JaxDeletion),
        _options(jax_parse_arguments, tmp_path, genome), "deleted regions")
    options = _options(parse_arguments, tmp_path, genome)
    got = partition_and_cluster(_dense_del_partition(SignatureDeletion),
                                options, "deleted regions", CPU)
    assert _described(got) == _described(want)
    # the sample cap bounds the membership, and a dominant cluster emerged
    assert sum(c.size for c in got) <= 100
    assert max(c.size for c in got) >= 50
    again = partition_and_cluster(_dense_del_partition(SignatureDeletion),
                                  options, "deleted regions", CPU)
    assert _described(again) == _described(got)


def test_subsampling_matches_the_ports_reference_path(tmp_path):
    """The device-batched path draws from the RNG exactly like the scalar
    reference path, so both cluster the same 100 signatures."""
    options = _options(parse_arguments, tmp_path, _plain_genome(tmp_path))
    fast = partition_and_cluster(_dense_del_partition(SignatureDeletion),
                                 options, "deleted regions", CPU)
    slow = partition_and_cluster_reference(
        _dense_del_partition(SignatureDeletion), options, "deleted regions")

    def members(clusters):
        return [(c.start, c.end, c.size,
                 tuple(sorted(m.read for m in c.members))) for c in clusters]

    assert members(fast) == members(slow)


def _large_ins_partition(insertion, tmp_path):
    rng = random.Random(9)
    genome = "".join(rng.choice("ACGT") for _ in range(4000))
    genome_path = tmp_path / "g.fa"
    genome_path.write_text(">chr1\n" + genome + "\n")
    motif = "".join(rng.choice("ACGT") for _ in range(120))
    signatures = []
    for i in range(130):
        noisy = list(motif)
        for _ in range(rng.randint(0, 3)):
            noisy[rng.randrange(len(noisy))] = rng.choice("ACGT")
        signatures.append(insertion(
            "chr1", 2000 + rng.randint(-25, 25), 2120 + rng.randint(-25, 25),
            "cigar", "r{0}".format(i), "".join(noisy)))
    return genome_path, signatures


@pytest.mark.parametrize("edit_backend", ["auto", "wavefront"])
def test_large_ins_partition_with_edit_distances_equals_svim_tpu(
        tmp_path, edit_backend):
    genome, jax_signatures = _large_ins_partition(JaxInsertion, tmp_path)
    want = jax_partition_and_cluster(
        jax_signatures,
        _options(jax_parse_arguments, tmp_path, genome, "--edit_backend",
                 edit_backend), "inserted regions")
    _genome, signatures = _large_ins_partition(SignatureInsertion, tmp_path)
    got = partition_and_cluster(
        signatures, _options(parse_arguments, tmp_path, genome,
                             "--edit_backend", edit_backend),
        "inserted regions", CPU)
    assert _described(got) == _described(want)
    assert max(c.size for c in got) >= 80   # one dominant sampled cluster
