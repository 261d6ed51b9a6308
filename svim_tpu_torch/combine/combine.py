"""COMBINE driver on the port's device.

Counterpart of svim_tpu/combine/combine.py::combine_clusters
(SVIM_COMBINE.py:332-478).  Candidate creation, BND<->INS merging,
cut&paste flagging, duplication-explained insertion removal and the
insertion consensus are svim_tpu's (imported, host only); the second
DUP_INT candidate clustering round runs through the port's
partition_and_cluster_candidates, because svim_tpu's binds its JAX route.
"""

from __future__ import annotations

import logging

from svim_tpu.candidates import (
    CandidateBreakend,
    CandidateDeletion,
    CandidateDuplicationTandem,
    CandidateInversion,
)
from svim_tpu.combine.combine import (
    _remove_insertions_at_duplications,
    prepare_insertion_candidates,
)
from svim_tpu.combine.merging import (
    flag_cutpaste_candidates,
    merge_translocations_at_insertions,
)
from svim_tpu_torch.cluster.cluster import partition_and_cluster_candidates


def combine_clusters(signature_clusters, options, device):
    """Combine per-type clusters into final candidate lists.

    Returns (deletion, inversion, int_duplication, tan_duplication,
    novel_insertion, breakend) candidates."""
    (deletion_signature_clusters, insertion_signature_clusters,
     inversion_signature_clusters, tandem_duplication_signature_clusters,
     insertion_from_signature_clusters,
     translocation_signature_clusters) = signature_clusters

    inversion_candidates = [
        CandidateInversion(cluster.contig, cluster.start, cluster.end,
                           cluster.members, cluster.score, cluster.std_span,
                           cluster.std_pos)
        for cluster in inversion_signature_clusters]

    tan_dup_candidates = []
    for cluster in tandem_duplication_signature_clusters:
        source_contig, source_start, source_end = cluster.get_source()
        dest_contig, dest_start, dest_end = cluster.get_destination()
        num_copies = int(round((dest_end - dest_start)
                               / (source_end - source_start)))
        fully_covered = bool(sum(sig.fully_covered for sig in cluster.members))
        tan_dup_candidates.append(CandidateDuplicationTandem(
            source_contig, source_start, source_end, num_copies, fully_covered,
            cluster.members, cluster.score, cluster.std_span, cluster.std_pos))

    breakend_candidates = [
        CandidateBreakend(cluster.source_contig, cluster.source_start,
                          cluster.direction1, cluster.dest_contig,
                          cluster.dest_start, cluster.direction2,
                          cluster.members, cluster.score, cluster.std_span,
                          cluster.std_pos)
        for cluster in translocation_signature_clusters]

    logging.info("Combine inserted regions with translocation breakpoints..")
    new_insertion_from_clusters, inserted_regions_to_remove_1 = \
        merge_translocations_at_insertions(translocation_signature_clusters,
                                           insertion_signature_clusters,
                                           options)
    insertion_from_signature_clusters = list(insertion_from_signature_clusters)
    insertion_from_signature_clusters.extend(new_insertion_from_clusters)

    logging.info("Create interspersed duplication candidates and flag "
                 "cut&paste insertions..")
    int_duplication_candidates = flag_cutpaste_candidates(
        insertion_from_signature_clusters, deletion_signature_clusters,
        options)

    inserted_regions_to_remove_2 = _remove_insertions_at_duplications(
        insertion_signature_clusters, int_duplication_candidates,
        tan_dup_candidates)

    for ins_index in sorted(set(inserted_regions_to_remove_1
                                + inserted_regions_to_remove_2), reverse=True):
        del insertion_signature_clusters[ins_index]

    deletion_candidates = [
        CandidateDeletion(cluster.contig, cluster.start, cluster.end,
                          cluster.members, cluster.score, cluster.std_span,
                          cluster.std_pos)
        for cluster in deletion_signature_clusters if cluster.score > 0]

    novel_insertion_candidates = prepare_insertion_candidates(
        insertion_signature_clusters, options)

    logging.info("Cluster interspersed duplication candidates one more time..")
    final_int_duplication_candidates = partition_and_cluster_candidates(
        int_duplication_candidates, options,
        "interspersed duplication candidates", device)

    return (deletion_candidates, inversion_candidates,
            final_int_duplication_candidates, tan_dup_candidates,
            novel_insertion_candidates, breakend_candidates)
