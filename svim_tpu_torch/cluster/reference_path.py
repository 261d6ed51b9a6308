"""Reference-equivalent clustering path: scalar per-pair loops.

This is the computational shape of the reference implementation
(SVIM_clustering.py:122-180): O(n^2) Python distance calls per partition,
scalar same-read dedup, scipy linkage.  It exists for two reasons:

1. benchmark baseline — "vs single-core SVIM" means against THIS cost model,
   not against our vectorized host path;
2. cluster-level differential oracle — production clustering must produce
   identical clusters (tests/test_torch_hostmodules.py pins the RNG parity
   and cluster equality against this path).
"""

from __future__ import annotations

import logging
from random import sample, seed

import numpy as np
from scipy.cluster.hierarchy import fcluster, linkage

from svim_tpu_torch.cluster.cluster import (
    MAX_PARTITION_SIZE,
    RANDOM_SEED,
    _group_by_labels,
    consolidate_clusters_bilocal,
    consolidate_clusters_unilocal,
)
from svim_tpu_torch.cluster.distance import (
    SAME_READ_WALL,
    span_position_distance,
)
from svim_tpu_torch.cluster.partition import form_partitions
from svim_tpu_torch.io.fasta import FastaFile


def _pairwise_condensed(elements, element_type, reference, options):
    """Condensed pairwise distance vector with the same-read wall applied for
    every type except INV (SVIM_clustering.py:159-169)."""
    distances = []
    for i in range(len(elements) - 1):
        for j in range(i + 1, len(elements)):
            if element_type != "INV" and elements[i].read == elements[j].read:
                distances.append(SAME_READ_WALL)
            else:
                distances.append(span_position_distance(
                    elements[i], elements[j], element_type, reference,
                    options.position_distance_normalizer,
                    options.edit_distance_normalizer,
                    options.cluster_max_distance))
    return distances


def clusters_from_partitions_reference(partitions, reference, options):
    """Scalar-loop twin of cluster.clusters_from_partitions."""
    clusters_final = []
    seed(RANDOM_SEED)
    for partition in partitions:
        if len(partition) > MAX_PARTITION_SIZE:
            partition_sample = sample(partition, MAX_PARTITION_SIZE)
        else:
            partition_sample = partition
        element_type = partition_sample[0].type

        if element_type == "INV":
            deduplicated = partition_sample
        else:
            duplicates = set()
            for i in range(len(partition_sample) - 1):
                for j in range(i + 1, len(partition_sample)):
                    if (partition_sample[i].read == partition_sample[j].read
                            and span_position_distance(
                                partition_sample[i], partition_sample[j],
                                element_type, reference,
                                options.position_distance_normalizer,
                                options.edit_distance_normalizer,
                                options.cluster_max_distance)
                            <= options.cluster_max_distance):
                        duplicates.add(j)
            deduplicated = [partition_sample[i]
                            for i in range(len(partition_sample))
                            if i not in duplicates]

        if len(deduplicated) == 1:
            clusters_final.append([deduplicated[0]])
            continue
        distances = _pairwise_condensed(deduplicated, element_type, reference, options)
        dendrogram = linkage(np.array(distances), method="average")
        labels = list(fcluster(dendrogram, options.cluster_max_distance,
                               criterion="distance"))
        clusters_final.extend(_group_by_labels(deduplicated, labels))
    return clusters_final


def partition_and_cluster_reference(signatures, options, type):
    partitions = form_partitions(signatures, options.partition_max_distance)
    with FastaFile(options.genome) as reference:
        clusters = clusters_from_partitions_reference(partitions, reference, options)
    logging.debug("reference path clustered %s: %d partitions, %d clusters",
                  type, len(partitions), len(clusters))
    if type in ("deleted regions", "inserted regions", "inverted regions"):
        return sorted(consolidate_clusters_unilocal(clusters),
                      key=lambda cluster: (cluster.contig,
                                           (cluster.end + cluster.start) / 2))
    return consolidate_clusters_bilocal(clusters)


def cluster_sv_signatures_reference(sv_signatures, options):
    by_type = {key: [] for key in ("DEL", "INS", "INV", "DUP_TAN", "BND", "DUP_INT")}
    for signature in sv_signatures:
        by_type[signature.type].append(signature)
    return (
        partition_and_cluster_reference(by_type["DEL"], options, "deleted regions"),
        partition_and_cluster_reference(by_type["INS"], options, "inserted regions"),
        partition_and_cluster_reference(by_type["INV"], options, "inverted regions"),
        partition_and_cluster_reference(by_type["DUP_TAN"], options,
                                        "tandem duplicated regions"),
        partition_and_cluster_reference(by_type["DUP_INT"], options,
                                        "inserted regions with detected region of origin"),
        partition_and_cluster_reference(by_type["BND"], options,
                                        "translocation breakpoints"),
    )
