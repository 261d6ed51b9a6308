"""Cross-type disambiguation: translocations vs insertions vs deletions.

Behavioral contract: svim/SVIM_merging.py — flag cut&paste insertions whose
origin overlaps a deletion; pair fwd-fwd/rev-rev breakend clusters flanking an
insertion into interspersed-duplication evidence with a geometric-mean score.
"""

from __future__ import annotations

from bisect import bisect_left
from collections import defaultdict

from svim_tpu_torch.candidates import CandidateDuplicationInterspersed
from svim_tpu_torch.cluster.distance import span_position_distance_clusters
from svim_tpu_torch.signatures import SignatureClusterBiLocal


def flag_cutpaste_candidates(insertion_from_signature_clusters, deletion_signature_clusters, options):
    """Emit DUP_INT candidates, flagging those whose source region has a
    nearby deletion cluster (cut&paste; reference: SVIM_merging.py:12-29)."""
    int_duplication_candidates = []
    for ins_cluster in insertion_from_signature_clusters:
        closest_deletion = min(
            (span_position_distance_clusters(del_cluster, ins_cluster,
                                             options.position_distance_normalizer)
             for del_cluster in deletion_signature_clusters),
            default=float("inf"))
        source_contig, source_start, source_end = ins_cluster.get_source()
        dest_contig, dest_start, dest_end = ins_cluster.get_destination()
        int_duplication_candidates.append(CandidateDuplicationInterspersed(
            source_contig, source_start, source_end,
            dest_contig, dest_start, dest_end,
            ins_cluster.members, ins_cluster.score,
            ins_cluster.std_span, ins_cluster.std_pos,
            cutpaste=closest_deletion <= options.del_ins_dup_max_distance))
    return int_duplication_candidates


def get_closest_index(input_list, input_number):
    """Index of the value closest to input_number in a sorted list; the
    smaller value wins ties (reference: SVIM_merging.py:32-50)."""
    if len(input_list) < 1:
        return None
    pos = bisect_left(input_list, input_number)
    if pos == 0:
        return 0
    if pos == len(input_list):
        return len(input_list) - 1
    before = input_list[pos - 1]
    after = input_list[pos]
    if after - input_number < input_number - before:
        return pos
    return pos - 1


def calculate_score_insertion(main_score, translocation_distances, translocation_stds,
                              destination_stds):
    """Score of an insertion explained by two flanking translocations: the
    geometric mean of six [0,1] quality components scales the main insertion
    score (reference: SVIM_merging.py:57-90)."""

    def scaled(value):
        return 1 if value is None else max(0, 100 - value) / 100

    components = [
        max(0, 100 - translocation_distances[0]) / 100,
        max(0, 100 - translocation_distances[1]) / 100,
        scaled(translocation_stds[0]),
        scaled(translocation_stds[1]),
        scaled(destination_stds[0]),
        scaled(destination_stds[1]),
    ]
    product = 1.0
    for component in components:
        product *= component
    return pow(product, 1 / 6) * main_score


def merge_translocations_at_insertions(translocation_signature_clusters,
                                       insertion_signature_clusters, options):
    """Convert insertions flanked by opposing breakend clusters into DUP_INT
    clusters (reference: SVIM_merging.py:93-159).

    Returns (new DUP_INT clusters, indices of insertion clusters to remove).
    Note: like the reference, this extends translocation_signature_clusters
    in place with the reversed clusters."""
    if len(insertion_signature_clusters) == 0:
        return [], []

    reversed_clusters = []
    for cluster in translocation_signature_clusters:
        reversed_cluster = SignatureClusterBiLocal(
            cluster.dest_contig, cluster.dest_start, cluster.dest_end,
            cluster.source_contig, cluster.source_start, cluster.source_end,
            cluster.score, cluster.size, cluster.members, cluster.type,
            cluster.std_pos, cluster.std_span)
        reversed_cluster.direction1 = "fwd" if cluster.direction2 == "rev" else "rev"
        reversed_cluster.direction2 = "fwd" if cluster.direction1 == "rev" else "rev"
        reversed_clusters.append(reversed_cluster)
    translocation_signature_clusters.extend(reversed_clusters)

    # per-contig, per-direction-pair cluster lists sorted by source position
    fwdfwd_by_contig = defaultdict(list)
    revrev_by_contig = defaultdict(list)
    for cluster in translocation_signature_clusters:
        if cluster.direction1 == "fwd" and cluster.direction2 == "fwd":
            fwdfwd_by_contig[cluster.source_contig].append(cluster)
        elif cluster.direction1 == "rev" and cluster.direction2 == "rev":
            revrev_by_contig[cluster.source_contig].append(cluster)
    for contig in fwdfwd_by_contig:
        fwdfwd_by_contig[contig].sort(key=lambda cluster: cluster.get_key())
    for contig in revrev_by_contig:
        revrev_by_contig[contig].sort(key=lambda cluster: cluster.get_key())

    fwdfwd_positions = {contig: [c.source_start for c in clusters]
                        for contig, clusters in fwdfwd_by_contig.items()}
    revrev_positions = {contig: [c.source_start for c in clusters]
                        for contig, clusters in revrev_by_contig.items()}

    inserted_regions_to_remove = []
    insertion_from_signature_clusters = []
    for insertion_index, ins_cluster in enumerate(insertion_signature_clusters):
        ins_contig, ins_start, ins_end = ins_cluster.get_source()
        if ins_contig not in fwdfwd_positions or ins_contig not in revrev_positions:
            continue
        ff_index = get_closest_index(fwdfwd_positions[ins_contig], ins_start)
        rr_index = get_closest_index(revrev_positions[ins_contig], ins_start)
        ff_mean = fwdfwd_positions[ins_contig][ff_index]
        rr_mean = revrev_positions[ins_contig][rr_index]
        if (abs(ff_mean - ins_start) > options.trans_sv_max_distance
                or abs(rr_mean - ins_start) > options.trans_sv_max_distance):
            continue
        ff_cluster = fwdfwd_by_contig[ins_contig][ff_index]
        rr_cluster = revrev_by_contig[ins_contig][rr_index]
        dest_ff = (ff_cluster.dest_contig, ff_cluster.dest_start)
        dest_rr = (rr_cluster.dest_contig, rr_cluster.dest_start)
        distance = abs(dest_rr[1] - dest_ff[1])
        # the two flank destinations must span the insertion's length
        if dest_rr[0] == dest_ff[0] and 0.95 <= ((ins_end - ins_start + 1) / (distance + 1)) <= 1.1:
            members = ins_cluster.members + ff_cluster.members + rr_cluster.members
            score = calculate_score_insertion(
                ins_cluster.score,
                [abs(ff_mean - ins_start), abs(rr_mean - ins_start)],
                [ff_cluster.std_span, rr_cluster.std_span],
                [ff_cluster.std_pos, rr_cluster.std_pos])
            insertion_from_signature_clusters.append(SignatureClusterBiLocal(
                dest_rr[0], min(dest_rr[1], dest_ff[1]), max(dest_rr[1], dest_ff[1]),
                ins_contig, ins_start, ins_start + distance, score, len(members),
                members, "DUP_INT", ins_cluster.std_span, ins_cluster.std_pos))
            inserted_regions_to_remove.append(insertion_index)

    return insertion_from_signature_clusters, inserted_regions_to_remove
