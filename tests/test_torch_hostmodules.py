"""The port's copies of the last host modules against what they were copied
from: cluster/reference_path.py (the scalar per-pair clustering path) gives
the clusters of the port's production CLUSTER on partitions above the
subsampling cap, as svim_tpu's does; cluster/linkage.py agrees with scipy;
sim2.simulate_independent writes the bytes svim_tpu.sim2 writes for one
seed.  Exact equality throughout."""

import random

import numpy as np
import torch

from svim_tpu import sim2 as jax_sim2
from svim_tpu.cluster.reference_path import (
    cluster_sv_signatures_reference as jax_reference,
)
from svim_tpu_torch import sim2 as torch_sim2
from svim_tpu_torch.cluster import linkage
from svim_tpu_torch.cluster.cluster import (
    MAX_PARTITION_SIZE,
    cluster_sv_signatures,
)
from svim_tpu_torch.cluster.reference_path import (
    cluster_sv_signatures_reference,
)
from svim_tpu_torch.signatures import SignatureDeletion, SignatureInsertion

CPU = torch.device("cpu")
torch.set_num_threads(1)


def _signatures(tmp_path):
    """A 180-member DEL partition, a 130-member INS partition of noisy
    copies of one motif, and a small DEL partition behind them."""
    rng = random.Random(2)
    genome = "".join(rng.choice("ACGT") for _ in range(60_000))
    genome_path = tmp_path / "g.fa"
    genome_path.write_text(">chr1\n" + genome + "\n")
    signatures = [SignatureDeletion("chr1", 50_000 + rng.randint(-40, 40),
                                    50_400 + rng.randint(-40, 40), "cigar",
                                    "read{0}".format(i)) for i in range(180)]
    motif = "".join(rng.choice("ACGT") for _ in range(60))
    for i in range(130):
        noisy = list(motif)
        for _ in range(rng.randint(0, 3)):
            noisy[rng.randrange(len(noisy))] = rng.choice("ACGT")
        start = 20_000 + rng.randint(-10, 10)
        signatures.append(SignatureInsertion(
            "chr1", start, start + len(noisy), "cigar", "r{0}".format(i),
            "".join(noisy)))
    signatures += [SignatureDeletion("chr1", 8_000 + i, 8_200 + 2 * i, "cigar",
                                     "small{0}".format(i)) for i in range(5)]
    return signatures, str(genome_path)


def _summary(cluster_lists):
    return [[(c.contig, c.start, c.end, c.score,
              tuple(sorted(m.read for m in c.members))) for c in clusters]
            for clusters in cluster_lists[:3]]


def test_reference_path_gives_the_production_clusters(tmp_path,
                                                      default_options):
    signatures, genome_path = _signatures(tmp_path)
    options = default_options.replace(genome=genome_path)
    production = _summary(cluster_sv_signatures(list(signatures), options,
                                                CPU))
    scalar = _summary(cluster_sv_signatures_reference(list(signatures),
                                                      options))
    assert production == scalar == _summary(jax_reference(list(signatures),
                                                          options))
    # both oversized partitions were cut to the cap by the same draws
    assert sum(len(c[4]) for c in production[0]) \
        == MAX_PARTITION_SIZE + 5
    assert sum(len(c[4]) for c in production[1]) == MAX_PARTITION_SIZE


def test_linkage_merge_heights_equal_scipy():
    from scipy.cluster.hierarchy import linkage as scipy_linkage
    from scipy.spatial.distance import squareform

    rng = np.random.default_rng(4)
    points = rng.random((12, 12))
    matrix = np.triu(points, 1) + np.triu(points, 1).T
    merges = linkage.average_linkage_merge_heights(matrix)
    want = scipy_linkage(squareform(matrix), method="average")
    assert [m[2] for m in merges] == want[:, 2].tolist()
    assert [m[3] for m in merges] == want[:, 3].astype(int).tolist()


def test_sim2_writes_the_bytes_of_the_jax_package(tmp_path):
    config = dict(seed=5, contig_lengths=(400_000, 250_000), coverage=3,
                  n_del=2, n_ins=2, n_inv=1, n_tan=1, n_tan_short=1,
                  n_dup_int=1, n_dup_int_cutpaste=1, n_bnd=1)
    outputs = {}
    for name, module in (("port", torch_sim2), ("jax", jax_sim2)):
        directory = tmp_path / name
        directory.mkdir()
        genome, bam, truth = module.simulate_independent(
            str(directory), module.Sim2Config(**config))
        outputs[name] = (open(genome, "rb").read(), open(bam, "rb").read(),
                         (directory / "truth.bed").read_bytes(),
                         [tuple(entry) for entry in truth])
    assert outputs["port"] == outputs["jax"]
    assert len(outputs["port"][1]) > 10_000 and len(outputs["port"][3]) >= 8
