"""CLUSTER stage driver on the port's device.

Counterpart of the device-touching half of svim_tpu/cluster/cluster.py
(SVIM_clustering.py:122-386): per-partition subsampling to 100 with
random.seed(1524), same-read duplicate removal, average-linkage clustering
cut at cluster_max_distance.  Consolidation, scoring and the exact host
linkage are svim_tpu's host code, copied; the dispatch/finish halves and
the stage driver differ where svim_tpu's reach its JAX device route.
"""

from __future__ import annotations

import logging
from random import sample, seed
from statistics import mean

import numpy as np

from svim_tpu_torch.candidates import CandidateDuplicationInterspersed
from svim_tpu_torch.cluster import accel, device_cluster
from svim_tpu_torch.cluster.accel import precompute_ins_edit_distances
from svim_tpu_torch.cluster.distance import span_position_distance
from svim_tpu_torch.cluster.partition import (
    form_partitions,
    form_partitions_table,
)
from svim_tpu_torch.cluster.scipy_fast import (
    average_linkage,
    fcluster_distance,
)
from svim_tpu_torch.io.fasta import FastaFile
from svim_tpu_torch.signatures import (
    SignatureClusterBiLocal,
    SignatureClusterUniLocal,
)
from svim_tpu_torch.sigtable import LazyMembers, SignatureSoA
from svim_tpu_torch.state import to_host
from svim_tpu_torch.utils import timing
from svim_tpu_torch.utils.exactstats import stdev_half_ints, stdev_ints

RANDOM_SEED = 1524       # fixed for reproducible subsampling (SVIM_clustering.py:129)
MAX_PARTITION_SIZE = 100  # larger partitions are subsampled (SVIM_clustering.py:132)
SUPPORT_CAP = 80          # score support saturates here (SVIM_clustering.py:208-210)
# partitions over MAX_PARTITION_SIZE that CLUSTER subsampled, by signature type
LARGE_PARTITIONS = {}


def _group_by_labels(elements, labels):
    if getattr(elements, "table", None) is not None:
        label_array = np.asarray(labels)
        return [elements.take(np.flatnonzero(label_array == label))
                for label in range(1, int(label_array.max()) + 1)]
    groups = [[] for _ in range(max(labels))]
    for element, label in zip(elements, labels):
        groups[label - 1].append(element)
    return groups


def _partition_type(partition) -> str:
    """Signature type of a partition without materializing members."""
    sig_type = getattr(partition, "type", None)
    return sig_type if sig_type is not None else partition[0].type


class _ClusterWork:
    """State between the dispatch and consume halves of per-type clustering
    (device kernels in flight across types)."""

    __slots__ = ("partitions", "samples", "large_partitions", "ed_cache",
                 "pending", "eligible", "memo_hits")

    def __init__(self):
        self.partitions = []
        self.samples = []
        self.large_partitions = 0
        self.ed_cache = None
        self.pending = None
        self.eligible = []
        self.memo_hits = {}   # partition index -> stored cluster index arrays


_TYPE_LABELS = {
    "DEL": "deleted regions",
    "INS": "inserted regions",
    "INV": "inverted regions",
    "DUP_TAN": "tandem duplicated regions",
    "DUP_INT": "inserted regions with detected region of origin",
    "BND": "translocation breakpoints",
}


def dispatch_clusters_from_partitions(partitions, reference, options,
                                      batcher, memo=None):
    """Phase 1: subsample, precompute INS edit distances, and register the
    batched device agglomerations on `batcher` (the stage driver runs one
    kernel call per pad bucket for all types and fetches once).

    `memo` optionally carries mid-scan incremental results keyed by exact
    partition content (cluster/incremental.py); hit partitions skip every
    phase here and reuse their stored clusters in the finish half."""
    work = _ClusterWork()
    work.partitions = partitions
    if memo:
        for index, partition in enumerate(partitions):
            if not 2 <= len(partition) <= MAX_PARTITION_SIZE:
                # >MAX partitions subsample through the shared RNG stream and
                # are never memoized; singletons are cheaper than the lookup
                continue
            indices = getattr(partition, "indices", None)
            if indices is None:
                continue
            stored = memo.get((_partition_type(partition), indices.tobytes()))
            if stored is not None:
                work.memo_hits[index] = stored
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
            partition_type = _partition_type(partition)
            LARGE_PARTITIONS[partition_type] = LARGE_PARTITIONS.get(
                partition_type, 0) + 1
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
            [s for i, s in enumerate(work.samples)
             if len(s) >= 2 and i not in work.memo_hits
             and not (resident_mode and 3 <= len(s) <= 128)],
            reference, options, batcher.device)

    if device_route and partitions and partitions[0]:
        element_type = _partition_type(partitions[0])
        if element_type in device_cluster.DEVICE_TYPES:
            work.eligible = [(index, sample_list)
                             for index, sample_list in enumerate(work.samples)
                             if 3 <= len(sample_list) <= 128
                             and index not in work.memo_hits]
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
        memo_hit = work.memo_hits.get(partition_index)
        if memo_hit is not None:
            # mid-scan incremental result whose content key matched this
            # exact partition: reuse the stored cluster index arrays
            table = partition_sample.table
            clustered = 0
            for member_indices in memo_hit:
                clusters_final.append(LazyMembers(table, member_indices))
                clustered += len(member_indices)
            duplicate_signatures += len(partition_sample) - clustered
            continue
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


def clusters_from_partitions(partitions, reference, options, device):
    """Cluster each partition with average linkage cut at cluster_max_distance
    (SVIM_clustering.py:122-180), on a batcher of its own on `device`: the
    agglomerations run when the finish half fetches them."""
    work = dispatch_clusters_from_partitions(
        partitions, reference, options,
        device_cluster.DeviceBatcher(options, device))
    return finish_clusters_from_partitions(work, reference, options)


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
    soa = sv_signatures if isinstance(sv_signatures, SignatureSoA) else None
    # mid-scan incremental results (content-addressed; cluster/incremental.py)
    memo = getattr(soa, "cluster_memo", None) if soa is not None else None
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
                with timing.span("dispatch"):
                    batcher.flush_fused()
            with timing.span("partition"):
                if soa is not None:
                    table = soa.tables.get(key)
                    partitions = (form_partitions_table(
                        table, options.partition_max_distance)
                        if table is not None else [])
                else:
                    partitions = form_partitions(
                        by_type[key], options.partition_max_distance)
            with timing.span("dispatch"):
                staged[key] = (partitions, dispatch_clusters_from_partitions(
                    partitions, reference, options, batcher, memo=memo))
        with timing.span("dispatch"):
            outputs = batcher.device_outputs()
        fetched = to_host(outputs)
        consolidated = {}
        for key in ("DEL", "INS", "INV", "DUP_TAN", "DUP_INT", "BND"):
            partitions, work = staged[key]
            with timing.span("finish"):
                clusters = finish_clusters_from_partitions(
                    work, reference, options, fetched=fetched)
            with timing.span("consolidate"):
                consolidated[key] = _consolidate_typed(clusters, partitions,
                                                       _TYPE_LABELS[key])
        device_cluster.TELEMETRY.log_summary()
        if memo:
            hits = sum(len(work.memo_hits)
                       for _partitions, work in staged.values())
            logging.info("Incremental clustering: %d of %d partitions computed "
                         "mid-scan were reused.", hits, len(memo))
    return (consolidated["DEL"], consolidated["INS"], consolidated["INV"],
            consolidated["DUP_TAN"], consolidated["DUP_INT"],
            consolidated["BND"])


def calculate_score(cluster, std_span, std_pos, span, type):
    """Support score with span/position deviation bonuses; INV requires both
    flank directions (reference: SVIM_clustering.py:183-211)."""
    if std_span is None or std_pos is None:
        span_deviation_score = 0
        pos_deviation_score = 0
    else:
        span_deviation_score = 1 - min(1, std_span / span)
        pos_deviation_score = 1 - min(1, std_pos / span)

    if type == "INV":
        table = getattr(cluster, "table", None)
        if table is not None:
            # direction codes follow sigtable.INV_DIRECTIONS: left_fwd=0,
            # left_rev=1, right_fwd=2, right_rev=3, all=4
            codes = table.direction[cluster.indices]
            left = int((codes <= 1).sum())
            right = int(((codes == 2) | (codes == 3)).sum())
            both = int((codes == 4).sum())
        else:
            left = sum(1 for sig in cluster if sig.direction in ("left_fwd", "left_rev"))
            right = sum(1 for sig in cluster if sig.direction in ("right_fwd", "right_rev"))
            both = sum(1 for sig in cluster if sig.direction == "all")
        valid_signatures = min(left, right) + both
        num_signatures = min(SUPPORT_CAP, valid_signatures)
    else:
        num_signatures = min(SUPPORT_CAP, len(cluster))
    return (num_signatures
            + span_deviation_score * (num_signatures / 8)
            + pos_deviation_score * (num_signatures / 8))


def _location_stats_arrays(starts, ends):
    """_location_stats over parallel start/end sequences (columns or lists).
    Sums and stdevs go through exact integer arithmetic either way, so the
    floats equal the object path's bit-for-bit."""
    n = len(starts)
    if isinstance(starts, np.ndarray):
        total_start = int(starts.sum())
        total_end = int(ends.sum())
    else:
        total_start = sum(starts)
        total_end = sum(ends)
    average_start = total_start / n
    average_end = total_end / n
    if n > 1:
        # bit-identical statistics.stdev over the integer spans / half-integer
        # centers, via exact integer arithmetic (utils/exactstats.py)
        spans = np.asarray(ends, dtype=np.int64) - np.asarray(starts, dtype=np.int64)
        doubled_centers = (np.asarray(starts, dtype=np.int64)
                           + np.asarray(ends, dtype=np.int64))
        std_span = stdev_ints(spans.tolist())
        std_pos = stdev_half_ints(doubled_centers.tolist())
    else:
        std_span = None
        std_pos = None
    return average_start, average_end, std_span, std_pos


def _cluster_source_columns(cluster):
    """(starts, ends) of every member's source locus — column slices for
    table views, get_source loops otherwise."""
    table = getattr(cluster, "table", None)
    if table is not None:
        indices = cluster.indices
        return table.start[indices], table.end[indices]
    return ([member.get_source()[1] for member in cluster],
            [member.get_source()[2] for member in cluster])


def _cluster_contig(cluster):
    table = getattr(cluster, "table", None)
    if table is not None:
        return table.contigs.names[int(table.contig_code[cluster.indices[0]])]
    return cluster[0].get_source()[0]


def _cluster_dest_contig(cluster):
    table = getattr(cluster, "table", None)
    if table is not None:
        return table.contigs.names[int(table.contig2_code[cluster.indices[0]])]
    return cluster[0].get_destination()[0]


def consolidate_clusters_unilocal(clusters):
    """Mean/stdev consolidation for single-locus clusters
    (reference: SVIM_clustering.py:214-228)."""
    consolidated_clusters = []
    for cluster in clusters:
        starts, ends = _cluster_source_columns(cluster)
        average_start, average_end, std_span, std_pos = _location_stats_arrays(
            starts, ends)
        cluster_type = _partition_type(cluster)
        score = calculate_score(cluster, std_span, std_pos,
                                average_end - average_start, cluster_type)
        consolidated_clusters.append(SignatureClusterUniLocal(
            _cluster_contig(cluster), int(round(average_start)), int(round(average_end)),
            score, len(cluster), cluster, cluster_type, std_span, std_pos))
    return consolidated_clusters


def consolidate_clusters_bilocal(clusters):
    """Consolidation for two-locus clusters: DUP_TAN / DUP_INT / BND
    (reference: SVIM_clustering.py:231-303)."""
    consolidated_clusters = []
    for cluster in clusters:
        cluster_type = _partition_type(cluster)
        starts, ends = _cluster_source_columns(cluster)
        source_start, source_end, source_std_span, source_std_pos = \
            _location_stats_arrays(starts, ends)
        table = getattr(cluster, "table", None)

        if cluster_type == "DUP_TAN":
            if table is not None:
                max_copies = int(table.copies[cluster.indices].max())
            else:
                max_copies = max(member.copies for member in cluster)
            score = calculate_score(cluster, source_std_span, source_std_pos,
                                    source_end - source_start, cluster_type)
            rounded_start = int(round(source_start))
            rounded_end = int(round(source_end))
            source_contig = _cluster_contig(cluster)
            consolidated_clusters.append(SignatureClusterBiLocal(
                source_contig, rounded_start, rounded_end,
                source_contig, rounded_end,
                rounded_end + max_copies * (rounded_end - rounded_start),
                score, len(cluster), cluster, cluster_type,
                source_std_span, source_std_pos))
        elif cluster_type == "DUP_INT":
            if table is not None:
                # get_destination() = (contig2, pos, pos + source span)
                indices = cluster.indices
                dest_starts = table.pos2[indices]
                dest_ends = dest_starts + (ends - starts)
            else:
                dest_starts = [member.get_destination()[1] for member in cluster]
                dest_ends = [member.get_destination()[2] for member in cluster]
            dest_start, dest_end, dest_std_span, dest_std_pos = \
                _location_stats_arrays(dest_starts, dest_ends)
            if None in (source_std_span, source_std_pos, dest_std_span, dest_std_pos):
                combined_std_span, combined_std_pos = None, None
            else:
                combined_std_span = mean([source_std_span, dest_std_span])
                combined_std_pos = mean([source_std_pos, dest_std_pos])
            score = calculate_score(
                cluster, combined_std_span, combined_std_pos,
                mean([source_end - source_start, dest_end - dest_start]), cluster_type)
            consolidated_clusters.append(SignatureClusterBiLocal(
                _cluster_contig(cluster), int(round(source_start)), int(round(source_end)),
                _cluster_dest_contig(cluster), int(round(dest_start)), int(round(dest_end)),
                score, len(cluster), cluster, cluster_type,
                combined_std_span, combined_std_pos))
        elif cluster_type == "BND":
            if table is not None:
                # get_destination() = (contig2, pos2, pos2 + 1)
                indices = cluster.indices
                dest_starts = table.pos2[indices]
                dest_ends = dest_starts + 1
                directions1 = set("rev" if rev else "fwd"
                                  for rev in np.unique(table.dir1[indices]))
                directions2 = set("rev" if rev else "fwd"
                                  for rev in np.unique(table.dir2[indices]))
            else:
                dest_starts = [member.get_destination()[1] for member in cluster]
                dest_ends = [member.get_destination()[2] for member in cluster]
                directions1 = set(member.direction1 for member in cluster)
                directions2 = set(member.direction2 for member in cluster)
            dest_start, dest_end, _dest_std_span, dest_std_pos = \
                _location_stats_arrays(dest_starts, dest_ends)
            assert len(directions1) == 1 and len(directions2) == 1
            if source_std_pos is None or dest_std_pos is None:
                std_first, std_second = None, None
            else:
                std_first, std_second = source_std_pos, dest_std_pos
            # BND scores use a constant 500 bp span (SVIM_clustering.py:293,297)
            score = calculate_score(cluster, std_first, std_second, 500, cluster_type)
            new_cluster = SignatureClusterBiLocal(
                _cluster_contig(cluster), int(round(source_start)), int(round(source_end)),
                _cluster_dest_contig(cluster), int(round(dest_start)), int(round(dest_end)),
                score, len(cluster), cluster, cluster_type, std_first, std_second)
            new_cluster.direction1 = directions1.pop()
            new_cluster.direction2 = directions2.pop()
            consolidated_clusters.append(new_cluster)
    return consolidated_clusters


def _consolidate_typed(clusters, partitions, type):
    logging.info("Clustered {0}: {1} partitions and {2} clusters".format(
        type, len(partitions), len(clusters)))
    if type in ("deleted regions", "inserted regions", "inverted regions"):
        return sorted(consolidate_clusters_unilocal(clusters),
                      key=lambda cluster: (cluster.contig, (cluster.end + cluster.start) / 2))
    if type in ("tandem duplicated regions",
                "inserted regions with detected region of origin",
                "translocation breakpoints"):
        return consolidate_clusters_bilocal(clusters)
    logging.error("Unknown parameter type={0} to function partition_and_cluster.".format(type))
    return None


def partition_and_cluster(signatures, options, type, device):
    """Full per-type clustering pipeline over a flat signature list
    (SVIM_clustering.py:375-386), on a batcher of its own on `device`."""
    partitions = form_partitions(signatures, options.partition_max_distance)
    with FastaFile(options.genome) as reference:
        clusters = clusters_from_partitions(partitions, reference, options,
                                            device)
    return _consolidate_typed(clusters, partitions, type)
