"""COMBINE driver on the port's device.

Counterpart of svim_tpu/combine/combine.py::combine_clusters
(SVIM_COMBINE.py:332-478).  Candidate creation, BND<->INS merging,
cut&paste flagging, duplication-explained insertion removal and the
insertion consensus are svim_tpu's host code, copied; the second DUP_INT
candidate clustering round runs through the port's
partition_and_cluster_candidates on `device`.
"""

from __future__ import annotations

import logging

from svim_tpu_torch.candidates import (
    CandidateBreakend,
    CandidateDeletion,
    CandidateDuplicationTandem,
    CandidateInversion,
    CandidateNovelInsertion,
)
from svim_tpu_torch.cluster.cluster import partition_and_cluster_candidates
from svim_tpu_torch.combine.merging import (
    flag_cutpaste_candidates,
    merge_translocations_at_insertions,
)
from svim_tpu_torch.io.fasta import FastaFile
from svim_tpu_torch.utils import timing


def prepare_insertion_candidates(insertion_signature_clusters, options):
    """Insertion candidates with consensus sequences
    (reference: SVIM_COMBINE.py:257-329).  Clusters with fewer than 3 members
    use the first member's sequence verbatim; consensus failures fall back to
    an empty sequence."""
    novel_insertion_candidates = []

    def candidate_from(cluster, start, end, sequence):
        return CandidateNovelInsertion(cluster.contig, start, end, sequence,
                                       cluster.members, cluster.score,
                                       cluster.std_span, cluster.std_pos)

    if options.skip_consensus:
        logging.info("Skipping computation of insertion consensus sequences "
                     "because of --skip_consensus flag.")
        for ins_cluster in insertion_signature_clusters:
            if ins_cluster.score > 0:
                novel_insertion_candidates.append(candidate_from(
                    ins_cluster, ins_cluster.start, ins_cluster.end, ""))
        return novel_insertion_candidates

    logging.info("Generating and realigning consensus sequence for insertions..")
    import concurrent.futures

    from svim_tpu_torch.combine.consensus import consensus_from_inputs, prepare_consensus_inputs
    from svim_tpu_torch.utils.cores import available_cores

    # plan: small clusters pass through; eligible ones get their reference
    # fetches serially (FastaFile handles are not thread-safe), then the
    # POA + realignment compute runs on a thread pool (native calls release
    # the GIL)
    plan = []  # (ins_cluster, inputs or None)
    with timing.span("prepare"), FastaFile(options.genome) as reference:
        for ins_cluster in insertion_signature_clusters:
            if ins_cluster.score <= 0:
                continue
            if len(ins_cluster.members) < 3:
                plan.append((ins_cluster, None))
                continue
            plan.append((ins_cluster,
                         prepare_consensus_inputs(ins_cluster, reference)))

    eligible = [(index, inputs) for index, (_, inputs) in enumerate(plan)
                if inputs is not None]
    outcomes = {}
    if eligible:
        # COMBINE sharding (round 5): consensus is the dominant COMBINE
        # cost and is per-cluster independent, so distributed runs split
        # the eligible clusters round-robin across ranks and exchange the
        # outcomes — one gather, byte-identical downstream on every rank
        world, rank = 1, 0
        if getattr(options, "distributed", False):
            from svim_tpu_torch.parallel.multihost import (
                process_count,
                process_index,
            )
            world = process_count()
            rank = process_index()
        owned = [item for position, item in enumerate(eligible)
                 if position % world == rank]
        local_outcomes = {}
        if owned:
            workers = min(8, available_cores(), len(owned))
            timing.count("consensus.clusters", len(owned))
            timing.count("consensus.workers", workers)

            def consensus(item):
                with timing.span("consensus_cluster",
                                 mark="consensus:cluster"):
                    return consensus_from_inputs(
                        item[1],
                        maximum_haplotype_length=options.max_consensus_length)

            with timing.span("consensus"), \
                    concurrent.futures.ThreadPoolExecutor(workers) as pool:
                for (index, _), outcome in zip(owned, pool.map(consensus,
                                                               owned)):
                    local_outcomes[index] = outcome
        if world > 1:
            from svim_tpu_torch.parallel.multihost import exchange_consensus_outcomes
            outcomes = exchange_consensus_outcomes(local_outcomes)
        else:
            outcomes = local_outcomes

    # status: 0 successful, 1 skipped, 2 failed, 3 no consensus, 4 multiple
    status_counter = [0, 0, 0, 0, 0]
    for index, (ins_cluster, inputs) in enumerate(plan):
        if inputs is None:
            novel_insertion_candidates.append(candidate_from(
                ins_cluster, ins_cluster.start, ins_cluster.end,
                ins_cluster.members[0].sequence))
            continue
        status, consensus_result = outcomes[index]
        status_counter[status] += 1
        if status == 0:
            realigned_start, realigned_size, insertion_consensus = consensus_result
            novel_insertion_candidates.append(candidate_from(
                ins_cluster, realigned_start, realigned_start + realigned_size,
                insertion_consensus))
        else:
            novel_insertion_candidates.append(candidate_from(
                ins_cluster, ins_cluster.start, ins_cluster.end, ""))
    logging.info("Generated and realigned consensus sequences for {0} insertions "
                 "({1} skipped, {2} failed with an error, {3} failed with no "
                 "consensus, {4} failed with multiple consensuses).".format(*status_counter))
    return novel_insertion_candidates


def _remove_insertions_at_duplications(insertion_signature_clusters,
                                       int_duplication_candidates,
                                       tan_dup_candidates):
    """Indices of insertion clusters explained by a duplication destination of
    similar length: a sorted two-pointer sweep over destinations
    (reference: SVIM_COMBINE.py:404-457, including its quirk of checking
    tandem duplications only once the interspersed iterator is exhausted)."""
    int_duplication_iterator = iter(sorted(int_duplication_candidates,
                                           key=lambda cand: cand.get_destination()))
    tan_duplication_iterator = iter(sorted(tan_dup_candidates,
                                           key=lambda cand: cand.get_destination()))
    current_int_duplication = next(int_duplication_iterator, None)
    current_tan_duplication = next(tan_duplication_iterator, None)
    to_remove = []

    for inserted_region_index, inserted_region in enumerate(insertion_signature_clusters):
        contig1, start1, end1 = inserted_region.get_source()
        length1 = end1 - start1
        if current_int_duplication is not None:
            contig2, start2, end2 = current_int_duplication.get_destination()
            while contig2 < contig1 or (contig2 == contig1 and end2 < start1):
                current_int_duplication = next(int_duplication_iterator, None)
                if current_int_duplication is None:
                    break
                contig2, start2, end2 = current_int_duplication.get_destination()
        if current_int_duplication is not None:
            contig2, start2, end2 = current_int_duplication.get_destination()
            length2 = end2 - start2
            if (contig2 == contig1 and start2 < end1
                    and (length1 - length2) / max(length1, length2) < 0.2):
                to_remove.append(inserted_region_index)
        else:
            if current_tan_duplication is not None:
                contig2, start2, end2 = current_tan_duplication.get_destination()
                while contig2 < contig1 or (contig2 == contig1 and end2 < start1):
                    current_tan_duplication = next(tan_duplication_iterator, None)
                    if current_tan_duplication is None:
                        break
                    contig2, start2, end2 = current_tan_duplication.get_destination()
            if current_tan_duplication is not None:
                contig2, start2, end2 = current_tan_duplication.get_destination()
                length2 = end2 - start2
                if (contig2 == contig1 and start2 < end1
                        and (length1 - length2) / max(length1, length2) < 0.2):
                    to_remove.append(inserted_region_index)
    return to_remove


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
    with timing.span("candidate_round"):
        final_int_duplication_candidates = partition_and_cluster_candidates(
            int_duplication_candidates, options,
            "interspersed duplication candidates", device)

    return (deletion_candidates, inversion_candidates,
            final_int_duplication_candidates, tan_dup_candidates,
            novel_insertion_candidates, breakend_candidates)
