"""Pairwise signature distances: the core numeric kernel of CLUSTER.

Behavioral contract: svim/SVIM_clustering.py:32-119 (per-type span-position
distance, haplotype edit distance for insertions, cluster- and candidate-level
variants).  Insertions, whose distance takes the haplotypes' edit distance, are
worked out in svbench/reference/cluster.py, which batches those.
"""

from __future__ import annotations

SAME_READ_WALL = 99999
BND_NORMALIZER = 3000  # hardcoded in the reference (SVIM_clustering.py:91)


def _center(signature):
    source = signature.get_source()
    return (source[1] + source[2]) // 2


def _span(signature):
    source = signature.get_source()
    return source[2] - source[1]


def span_position_distance(signature1, signature2, signature_type, reference,
                           position_distance_normalizer, edit_distance_normalizer,
                           cluster_max_distance):
    """Per-type signature distance (reference: SVIM_clustering.py:47-96)."""
    if signature_type in ("DEL", "DUP_TAN", "INV"):
        span1, span2 = _span(signature1), _span(signature2)
        position_distance = abs(_center(signature1) - _center(signature2)) / position_distance_normalizer
        span_distance = abs(span1 - span2) / max(span1, span2)
        return position_distance + span_distance
    if signature_type == "DUP_INT":
        span1, span2 = _span(signature1), _span(signature2)
        position_distance_source = abs(_center(signature1) - _center(signature2)) / position_distance_normalizer
        position_distance_destination = abs(
            signature1.get_destination()[1] - signature2.get_destination()[1]) / position_distance_normalizer
        span_distance = abs(span1 - span2) / max(span1, span2)
        return position_distance_source + position_distance_destination + span_distance
    if signature_type == "BND":
        if (signature1.direction1 == signature2.direction1
                and signature1.direction2 == signature2.direction2):
            dist1 = abs(signature1.get_source()[1] - signature2.get_source()[1])
            dist2 = abs(signature1.get_destination()[1] - signature2.get_destination()[1])
            return (dist1 + dist2) / BND_NORMALIZER
        return SAME_READ_WALL
    return None


def span_position_distance_clusters(cluster1, cluster2, position_distance_normalizer):
    """Cluster-to-cluster distance used when merging (reference:
    SVIM_clustering.py:99-107)."""
    span1 = cluster1.get_source()[2] - cluster1.get_source()[1]
    span2 = cluster2.get_source()[2] - cluster2.get_source()[1]
    position_distance = abs(_center(cluster1) - _center(cluster2)) / position_distance_normalizer
    span_distance = abs(span1 - span2) / max(span1, span2)
    return position_distance + span_distance


def span_position_distance_intdup_candidates(candidate1, candidate2, position_distance_normalizer):
    """Candidate-level DUP_INT distance for the second clustering round
    (reference: SVIM_clustering.py:110-119)."""
    span1 = candidate1.get_source()[2] - candidate1.get_source()[1]
    span2 = candidate2.get_source()[2] - candidate2.get_source()[1]
    position_distance_source = abs(_center(candidate1) - _center(candidate2)) / position_distance_normalizer
    position_distance_destination = abs(
        candidate1.get_destination()[1] - candidate2.get_destination()[1]) / position_distance_normalizer
    span_distance = abs(span1 - span2) / max(span1, span2)
    return position_distance_source + position_distance_destination + span_distance
