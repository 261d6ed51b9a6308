"""CLUSTER stage driver on the port's device.

Counterpart of the device-touching half of svim_tpu/cluster/cluster.py
(SVIM_clustering.py:122-386): per-partition subsampling to 100 with
random.seed(1524), same-read duplicate removal, average-linkage clustering
cut at cluster_max_distance.  Consolidation, scoring and the exact host
linkage are svim_tpu's (imported); the dispatch/finish halves and the stage
driver are copied here because svim_tpu's reach its JAX device route.
"""

from __future__ import annotations

import logging
from random import sample, seed
from statistics import mean

import numpy as np

from svim_tpu.candidates import CandidateDuplicationInterspersed
from svim_tpu.cluster import accel
from svim_tpu.cluster.cluster import (
    MAX_PARTITION_SIZE,
    RANDOM_SEED,
    _ClusterWork,
    _consolidate_typed,
    _group_by_labels,
    _partition_type,
)
from svim_tpu.cluster.distance import span_position_distance
from svim_tpu.cluster.partition import form_partitions, form_partitions_table
from svim_tpu.cluster.scipy_fast import average_linkage, fcluster_distance
from svim_tpu.io.fasta import FastaFile
from svim_tpu_torch.cluster import device_cluster
from svim_tpu_torch.cluster.accel import precompute_ins_edit_distances
from svim_tpu_torch.state import to_host

_TYPE_LABELS = {
    "DEL": "deleted regions",
    "INS": "inserted regions",
    "INV": "inverted regions",
    "DUP_TAN": "tandem duplicated regions",
    "DUP_INT": "inserted regions with detected region of origin",
    "BND": "translocation breakpoints",
}


def dispatch_clusters_from_partitions(partitions, reference, options,
                                      batcher):
    """Phase 1: subsample, precompute INS edit distances, and register the
    batched device agglomerations on `batcher` (the stage driver runs one
    kernel call per pad bucket for all types and fetches once)."""
    work = _ClusterWork()
    work.partitions = partitions
    seed(RANDOM_SEED)
    # subsample oversized partitions upfront (same RNG consumption order as
    # sampling inside the loop); table views sample POSITIONS, which draws
    # the RNG identically to sampling the members
    for partition in partitions:
        if len(partition) > MAX_PARTITION_SIZE:
            if getattr(partition, "table", None) is not None:
                work.samples.append(partition.take(
                    sample(range(len(partition)), MAX_PARTITION_SIZE)))
            else:
                work.samples.append(sample(partition, MAX_PARTITION_SIZE))
            work.large_partitions += 1
        else:
            work.samples.append(partition)

    device_route = getattr(options, "cluster_backend", "device") != "exact"
    # one batched edit-distance pass over every INS near pair the host path
    # will touch; under the resident route the 3..128-element partitions
    # compute theirs on the device inside dispatch_ins_resident
    if partitions and partitions[0] and _partition_type(partitions[0]) == "INS":
        resident_mode = (device_cluster.ins_resident_enabled(options)
                         and device_route)
        work.ed_cache = precompute_ins_edit_distances(
            [s for s in work.samples
             if len(s) >= 2 and not (resident_mode and 3 <= len(s) <= 128)],
            reference, options, batcher.device)

    if device_route and partitions and partitions[0]:
        element_type = _partition_type(partitions[0])
        if element_type in device_cluster.DEVICE_TYPES:
            work.eligible = [(index, sample_list)
                             for index, sample_list in enumerate(work.samples)
                             if 3 <= len(sample_list) <= 128]
            if work.eligible:
                work.pending = device_cluster.dispatch_partitions_device(
                    [sample_list for _, sample_list in work.eligible],
                    element_type, reference, options, batcher,
                    ed_cache=work.ed_cache)
    return work


def finish_clusters_from_partitions(work, reference, options, fetched=None):
    """Phase 2: consume the fetched device results and run dedup/linkage on
    the exact host path for everything the device could not arbitrate
    (SVIM_clustering.py:122-180)."""
    partitions = work.partitions
    ed_cache = work.ed_cache
    clusters_final = []
    duplicate_signatures = 0

    device_results = {}
    if work.pending is not None:
        per_position = device_cluster.consume_partitions_device(
            work.pending, fetched=fetched)
        device_results = {index: per_position[position]
                          for position, (index, _) in enumerate(work.eligible)}

    for partition_index, partition_sample in enumerate(work.samples):
        if len(partition_sample) == 1:
            if getattr(partition_sample, "table", None) is not None:
                clusters_final.append(partition_sample)
            else:
                clusters_final.append([partition_sample[0]])
            continue
        device_result = device_results.get(partition_index)
        if device_result is not None and device_result.clusters is not None:
            duplicate_signatures += device_result.dropped_count
            clusters_final.extend(device_result.clusters)
            continue
        # float32 could not safely arbitrate (or the exact backend was
        # asked for): run the exact float64 host path
        element_type = _partition_type(partition_sample)
        if element_type not in device_cluster.DEVICE_TYPES:
            raise ValueError("unknown signature type {0}".format(element_type))

        if len(partition_sample) == 2:
            # pair fast path: one scalar distance decides dedup and the cut
            first, second = partition_sample
            is_view = getattr(partition_sample, "table", None) is not None

            def _solo(position):
                return (partition_sample.take([position]) if is_view
                        else [partition_sample[position]])

            if element_type == "INS":
                distance = accel.ins_pair_distance(first, second, reference,
                                                   options, ed_cache)
            else:
                distance = span_position_distance(
                    first, second, element_type, reference,
                    options.position_distance_normalizer,
                    options.edit_distance_normalizer,
                    options.cluster_max_distance)
            if element_type != "INV" and first.read == second.read:
                if distance <= options.cluster_max_distance:
                    duplicate_signatures += 1
                    clusters_final.append(_solo(0))
                else:
                    # same-read wall keeps them apart
                    clusters_final.append(_solo(0))
                    clusters_final.append(_solo(1))
                continue
            if distance <= options.cluster_max_distance:
                clusters_final.append(partition_sample if is_view
                                      else [first, second])
            else:
                clusters_final.append(_solo(0))
                clusters_final.append(_solo(1))
            continue

        # one vectorized distance matrix serves dedup and linkage
        matrix = accel.distance_matrix(partition_sample, element_type,
                                       reference, options, ed_cache=ed_cache)
        reads = accel.read_index_array(partition_sample)
        deduplicated = partition_sample
        if element_type != "INV":
            # inversions keep same-read pairs (complementary flanks)
            duplicates_from_same_read = accel.dedup_same_read(
                matrix, reads, options.cluster_max_distance)
            duplicate_signatures += len(duplicates_from_same_read)
            if duplicates_from_same_read:
                keep = [i for i in range(len(partition_sample))
                        if i not in duplicates_from_same_read]
                if getattr(partition_sample, "table", None) is not None:
                    deduplicated = partition_sample.take(keep)
                else:
                    deduplicated = [partition_sample[i] for i in keep]
                matrix = matrix[np.ix_(keep, keep)]
                reads = reads[keep]

        if len(deduplicated) == 1:
            if getattr(deduplicated, "table", None) is not None:
                clusters_final.append(deduplicated)
            else:
                clusters_final.append([deduplicated[0]])
            continue

        distances = accel.condensed_with_wall(
            matrix, reads, wall_same_read=element_type != "INV")
        dendrogram = average_linkage(distances)
        labels = list(fcluster_distance(dendrogram,
                                        options.cluster_max_distance))
        clusters_final.extend(_group_by_labels(deduplicated, labels))
    if partitions and partitions[0]:
        partition_type = _partition_type(partitions[0])
        logging.debug("%d out of %d partitions for %s exceeded %d elements.",
                      work.large_partitions, len(partitions), partition_type,
                      MAX_PARTITION_SIZE)
        logging.debug("%d %s signatures were removed due to similarity to "
                      "another signature from the same read.",
                      duplicate_signatures, partition_type)
    return clusters_final


def partition_and_cluster_candidates(candidates, options, type, device):
    """Second clustering round over DUP_INT candidates
    (SVIM_clustering.py:306-372)."""
    partitions = form_partitions(candidates, options.partition_max_distance)
    clusters = []
    large_partitions = 0
    seed(RANDOM_SEED)
    partition_samples = []
    for partition in partitions:
        if len(partition) > MAX_PARTITION_SIZE:
            partition_samples.append(sample(partition, MAX_PARTITION_SIZE))
            large_partitions += 1
        else:
            partition_samples.append(partition)

    device_results = {}
    if getattr(options, "cluster_backend", "device") != "exact":
        eligible = [(index, partition_sample) for index, partition_sample
                    in enumerate(partition_samples)
                    if 3 <= len(partition_sample) <= 128]
        if eligible:
            per_position = device_cluster.cluster_candidates_device(
                [partition_sample for _, partition_sample in eligible],
                options, device)
            device_results = {index: per_position[position]
                              for position, (index, _) in enumerate(eligible)}

    for partition_index, partition_sample in enumerate(partition_samples):
        if len(partition_sample) == 1:
            clusters.append([partition_sample[0]])
            continue
        device_result = device_results.get(partition_index)
        if device_result is not None and device_result.clusters is not None:
            clusters.extend(device_result.clusters)
            continue
        # candidate-level DUP_INT distance == the signature-level formula
        # (SVIM_clustering.py:110-119), so the vectorized matrix applies
        matrix = accel.distance_matrix(partition_sample, "DUP_INT", None,
                                       options)
        distances = matrix[accel.triu_indices_cached(len(partition_sample))]
        dendrogram = average_linkage(distances)
        labels = list(fcluster_distance(dendrogram,
                                        options.cluster_max_distance))
        clusters.extend(_group_by_labels(partition_sample, labels))
    if partitions and partitions[0]:
        logging.debug("%d out of %d partitions for %s exceeded %d elements.",
                      large_partitions, len(partitions), partitions[0][0].type,
                      MAX_PARTITION_SIZE)
    logging.info("Clustered {0}: {1} partitions and {2} clusters".format(
        type, len(partitions), len(clusters)))

    final_candidates = []
    for cluster in clusters:
        combined_score = max(candidate.score for candidate in cluster)
        combined_members = [member for candidate in cluster
                            for member in candidate.members]
        stds_span = [candidate.std_span for candidate in cluster
                     if candidate.std_span is not None]
        combined_std_span = mean(stds_span) if stds_span else None
        stds_pos = [candidate.std_pos for candidate in cluster
                    if candidate.std_pos is not None]
        combined_std_pos = mean(stds_pos) if stds_pos else None

        count = len(cluster)
        source_start = sum(c.get_source()[1] for c in cluster) / count
        source_end = sum(c.get_source()[2] for c in cluster) / count
        dest_start = sum(c.get_destination()[1] for c in cluster) / count
        dest_end = sum(c.get_destination()[2] for c in cluster) / count
        cutpaste = any(member.cutpaste for member in cluster)

        if cluster[0].type == "DUP_INT":
            final_candidates.append(CandidateDuplicationInterspersed(
                cluster[0].get_source()[0], int(round(source_start)),
                int(round(source_end)), cluster[0].get_destination()[0],
                int(round(dest_start)), int(round(dest_end)),
                combined_members, combined_score, combined_std_span,
                combined_std_pos, cutpaste))
    return final_candidates


def cluster_sv_signatures(sv_signatures, options, device):
    """Split signatures by type and cluster each (SVIM_CLUSTER.py:7-26).

    `sv_signatures` is a SignatureSoA or a flat Signature list.  All six
    types register their device agglomerations on one batcher before any
    result is fetched (the five coordinate types' kernels run while the INS
    edit distances are prepared), then one fetch brings every result back;
    per-type logging and output order match the reference.

    Returns (deletion, insertion, inversion, tandem_duplication,
    insertion_from, translocation) cluster lists."""
    from svim_tpu.sigtable import SignatureSoA

    soa = sv_signatures if isinstance(sv_signatures, SignatureSoA) else None
    by_type = {key: [] for key in _TYPE_LABELS}
    if soa is None:
        for signature in sv_signatures:
            by_type[signature.type].append(signature)

    dispatch_order = ("DEL", "INV", "DUP_TAN", "BND", "DUP_INT", "INS")
    with FastaFile(options.genome) as reference:
        device_cluster.TELEMETRY.reset()
        batcher = device_cluster.DeviceBatcher(options, device)
        staged = {}
        for key in dispatch_order:
            if key == "INS":
                # run the coordinate types' kernels before the INS prep
                batcher.flush_fused()
            if soa is not None:
                table = soa.tables.get(key)
                partitions = (form_partitions_table(
                    table, options.partition_max_distance)
                    if table is not None else [])
            else:
                partitions = form_partitions(by_type[key],
                                             options.partition_max_distance)
            staged[key] = (partitions, dispatch_clusters_from_partitions(
                partitions, reference, options, batcher))
        fetched = to_host(batcher.device_outputs())
        consolidated = {}
        for key in ("DEL", "INS", "INV", "DUP_TAN", "DUP_INT", "BND"):
            partitions, work = staged[key]
            clusters = finish_clusters_from_partitions(
                work, reference, options, fetched=fetched)
            consolidated[key] = _consolidate_typed(clusters, partitions,
                                                   _TYPE_LABELS[key])
        device_cluster.TELEMETRY.log_summary()
    return (consolidated["DEL"], consolidated["INS"], consolidated["INV"],
            consolidated["DUP_TAN"], consolidated["DUP_INT"],
            consolidated["BND"])
