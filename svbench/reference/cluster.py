"""CLUSTER, plainly (SVIM_clustering.py): signatures of a type sorted and
cut into partitions, partitions over 100 signatures subsampled with
Python's `random` seeded 1524, same-read duplicates dropped, pairwise
distances in scalar loops, scipy's average linkage cut at
cluster_max_distance, and each cluster consolidated to its mean position,
its standard deviations and its score.  The insertion partitions' edit
distances (of reference-padded haplotypes) are computed together by
`editdist.edit_distances` before the clustering."""

from __future__ import annotations

from random import sample, seed
from statistics import mean, stdev

import numpy as np
from scipy.cluster.hierarchy import fcluster, linkage

from svbench.reference.candidates import CandidateDuplicationInterspersed
from svbench.reference.distance import (
    SAME_READ_WALL,
    span_position_distance,
    span_position_distance_intdup_candidates,
)
from svbench.reference.editdist import edit_distances
from svbench.reference.fasta import FastaFile
from svbench.reference.signatures import (
    SignatureClusterBiLocal,
    SignatureClusterUniLocal,
)

RANDOM_SEED = 1524
MAX_PARTITION_SIZE = 100
SUPPORT_CAP = 80
TYPES = ("DEL", "INS", "INV", "DUP_TAN", "DUP_INT", "BND")


def form_partitions(signatures, max_distance):
    partitions = []
    current = []
    for signature in sorted(signatures, key=lambda item: item.get_key()):
        if current and current[-1].downstream_distance_to(signature) > max_distance:
            partitions.append(current)
            current = []
        current.append(signature)
    if current:
        partitions.append(current)
    return partitions


def _subsampled(partitions):
    """Each partition, those over MAX_PARTITION_SIZE sampled as SVIM samples
    them: Python's `random` seeded once a type (SVIM_clustering.py:129-135)."""
    seed(RANDOM_SEED)
    return [sample(partition, MAX_PARTITION_SIZE)
            if len(partition) > MAX_PARTITION_SIZE else partition
            for partition in partitions]


def _insertion_pairs(partition, fasta, options):
    """{(i, j): (a, b)} for the pairs of an insertion partition whose
    position distance leaves the edit distance to decide: the two
    reference-padded haplotypes of SVIM_clustering.py:32-45 less the
    reference flanks they share, which leaves their Levenshtein distance
    as it is (a common prefix or suffix never changes it)."""
    starts = [member.get_source()[1] for member in partition]
    low, high = min(starts), max(starts)
    region = fasta.fetch(partition[0].contig, max(0, low),
                         max(0, high)).upper()
    limit = 2 * options.cluster_max_distance
    pairs = {}
    for i in range(len(partition) - 1):
        for j in range(i + 1, len(partition)):
            if abs(starts[i] - starts[j]) / options.position_distance_normalizer > limit:
                continue
            first, second = (i, j) if starts[i] <= starts[j] else (j, i)
            middle = region[starts[first] - low:starts[second] - low]
            pairs[(i, j)] = (partition[first].sequence.upper() + middle,
                             middle + partition[second].sequence.upper())
    return pairs


def _insertion_distance(first, second, edit, options):
    """span_position_distance for INS (SVIM_clustering.py:60-75), the edit
    distance given."""
    span1 = first.get_source()[2] - first.get_source()[1]
    span2 = second.get_source()[2] - second.get_source()[1]
    position_distance = abs(first.get_source()[1] - second.get_source()[1]) \
        / options.position_distance_normalizer
    if edit is None:
        return position_distance + abs(span1 - span2) / max(span1, span2)
    return position_distance + edit / max(span1, span2) \
        / options.edit_distance_normalizer


def _matrix(partition, kind, edits, options):
    """The partition's pairwise distances, SVIM_clustering.py:47-96."""
    count = len(partition)
    matrix = np.zeros((count, count))
    for i in range(count - 1):
        for j in range(i + 1, count):
            if kind == "INS":
                value = _insertion_distance(partition[i], partition[j],
                                            edits.get((i, j)), options)
            else:
                value = span_position_distance(
                    partition[i], partition[j], kind, None,
                    options.position_distance_normalizer,
                    options.edit_distance_normalizer,
                    options.cluster_max_distance)
            matrix[i, j] = matrix[j, i] = value
    return matrix


def _cluster_partitions(partitions, edits, options):
    """Average-linkage clusters of each (subsampled) partition, same-read
    duplicates dropped first (SVIM_clustering.py:122-180); `edits` holds
    each insertion partition's edit distances by pair."""
    clusters = []
    for index, partition in enumerate(partitions):
        kind = partition[0].type
        matrix = _matrix(partition, kind, edits.get(index, {}), options)
        if kind == "INV":
            kept = list(range(len(partition)))
        else:
            duplicates = set()
            for i in range(len(partition) - 1):
                for j in range(i + 1, len(partition)):
                    if (partition[i].read == partition[j].read
                            and matrix[i, j] <= options.cluster_max_distance):
                        duplicates.add(j)
            kept = [i for i in range(len(partition)) if i not in duplicates]
        if len(kept) == 1:
            clusters.append([partition[kept[0]]])
            continue
        distances = []
        for x in range(len(kept) - 1):
            for y in range(x + 1, len(kept)):
                i, j = kept[x], kept[y]
                if kind != "INV" and partition[i].read == partition[j].read:
                    distances.append(SAME_READ_WALL)
                else:
                    distances.append(matrix[i, j])
        labels = fcluster(linkage(np.array(distances), method="average"),
                          options.cluster_max_distance, criterion="distance")
        groups = [[] for _ in range(int(max(labels)))]
        for index_kept, label in zip(kept, labels):
            groups[label - 1].append(partition[index_kept])
        clusters.extend(groups)
    return clusters


def _score(cluster, std_span, std_pos, span, kind):
    if std_span is None or std_pos is None:
        span_score = pos_score = 0
    else:
        span_score = 1 - min(1, std_span / span)
        pos_score = 1 - min(1, std_pos / span)
    if kind == "INV":
        left = sum(1 for sig in cluster
                   if sig.direction in ("left_fwd", "left_rev"))
        right = sum(1 for sig in cluster
                    if sig.direction in ("right_fwd", "right_rev"))
        both = sum(1 for sig in cluster if sig.direction == "all")
        count = min(SUPPORT_CAP, min(left, right) + both)
    else:
        count = min(SUPPORT_CAP, len(cluster))
    return count + span_score * (count / 8) + pos_score * (count / 8)


def _stats(starts, ends):
    count = len(starts)
    average_start = sum(starts) / count
    average_end = sum(ends) / count
    if count > 1:
        std_span = stdev([end - start for start, end in zip(starts, ends)])
        std_pos = stdev([(start + end) / 2 for start, end in zip(starts, ends)])
    else:
        std_span = std_pos = None
    return average_start, average_end, std_span, std_pos


def _unilocal(clusters):
    result = []
    for cluster in clusters:
        sources = [member.get_source() for member in cluster]
        start, end, std_span, std_pos = _stats([s[1] for s in sources],
                                               [s[2] for s in sources])
        kind = cluster[0].type
        result.append(SignatureClusterUniLocal(
            sources[0][0], int(round(start)), int(round(end)),
            _score(cluster, std_span, std_pos, end - start, kind),
            len(cluster), cluster, kind, std_span, std_pos))
    return sorted(result, key=lambda item: (item.contig,
                                            (item.end + item.start) / 2))


def _bilocal(clusters):
    result = []
    for cluster in clusters:
        kind = cluster[0].type
        sources = [member.get_source() for member in cluster]
        start, end, std_span, std_pos = _stats([s[1] for s in sources],
                                               [s[2] for s in sources])
        contig = sources[0][0]
        if kind == "DUP_TAN":
            copies = max(member.copies for member in cluster)
            first, last = int(round(start)), int(round(end))
            result.append(SignatureClusterBiLocal(
                contig, first, last, contig, last,
                last + copies * (last - first),
                _score(cluster, std_span, std_pos, end - start, kind),
                len(cluster), cluster, kind, std_span, std_pos))
            continue
        dests = [member.get_destination() for member in cluster]
        dest_start, dest_end, dest_std_span, dest_std_pos = _stats(
            [d[1] for d in dests], [d[2] for d in dests])
        if kind == "DUP_INT":
            if None in (std_span, std_pos, dest_std_span, dest_std_pos):
                span_dev = pos_dev = None
            else:
                span_dev = mean([std_span, dest_std_span])
                pos_dev = mean([std_pos, dest_std_pos])
            result.append(SignatureClusterBiLocal(
                contig, int(round(start)), int(round(end)), dests[0][0],
                int(round(dest_start)), int(round(dest_end)),
                _score(cluster, span_dev, pos_dev,
                       mean([end - start, dest_end - dest_start]), kind),
                len(cluster), cluster, kind, span_dev, pos_dev))
        else:   # BND: a constant 500 bp span (SVIM_clustering.py:293)
            directions1 = {member.direction1 for member in cluster}
            directions2 = {member.direction2 for member in cluster}
            if len(directions1) != 1 or len(directions2) != 1:
                raise ValueError("a BND cluster of mixed directions")
            if std_pos is None or dest_std_pos is None:
                first_dev = second_dev = None
            else:
                first_dev, second_dev = std_pos, dest_std_pos
            merged = SignatureClusterBiLocal(
                contig, int(round(start)), int(round(end)), dests[0][0],
                int(round(dest_start)), int(round(dest_end)),
                _score(cluster, first_dev, second_dev, 500, kind),
                len(cluster), cluster, kind, first_dev, second_dev)
            merged.direction1 = directions1.pop()
            merged.direction2 = directions2.pop()
            result.append(merged)
    return result


def cluster_signatures(signatures, options, device):
    """The six types' consolidated clusters, in the order CLUSTER returns
    them: DEL, INS, INV, DUP_TAN, DUP_INT, BND.  The insertion partitions'
    edit distances are computed together first (editdist.edit_distances
    on `device`)."""
    by_type = {kind: [] for kind in TYPES}
    for signature in signatures:
        by_type[signature.type].append(signature)
    partitions = {kind: _subsampled(form_partitions(
        by_type[kind], options.partition_max_distance)) for kind in TYPES}
    with FastaFile(options.genome) as fasta:
        pairs = {index: _insertion_pairs(partition, fasta, options)
                 for index, partition in enumerate(partitions["INS"])}
    strings = list(dict.fromkeys(pair for by_pair in pairs.values()
                                 for pair in by_pair.values()))
    known = dict(zip(strings, edit_distances(strings, device)))
    edits = {index: {key: known[pair] for key, pair in by_pair.items()}
             for index, by_pair in pairs.items()}
    clusters = {kind: _cluster_partitions(partitions[kind],
                                          edits if kind == "INS" else {},
                                          options)
                for kind in TYPES}
    return (_unilocal(clusters["DEL"]), _unilocal(clusters["INS"]),
            _unilocal(clusters["INV"]), _bilocal(clusters["DUP_TAN"]),
            _bilocal(clusters["DUP_INT"]), _bilocal(clusters["BND"]))


def cluster_candidates(candidates, options):
    """The second round over interspersed-duplication candidates
    (SVIM_clustering.py:306-372)."""
    clusters = []
    seed(RANDOM_SEED)
    for partition in form_partitions(candidates, options.partition_max_distance):
        if len(partition) > MAX_PARTITION_SIZE:
            partition = sample(partition, MAX_PARTITION_SIZE)
        if len(partition) == 1:
            clusters.append([partition[0]])
            continue
        distances = [span_position_distance_intdup_candidates(
            partition[i], partition[j], options.position_distance_normalizer)
            for i in range(len(partition) - 1)
            for j in range(i + 1, len(partition))]
        labels = fcluster(linkage(np.array(distances), method="average"),
                          options.cluster_max_distance, criterion="distance")
        groups = [[] for _ in range(int(max(labels)))]
        for element, label in zip(partition, labels):
            groups[label - 1].append(element)
        clusters.extend(groups)
    final = []
    for cluster in clusters:
        spans = [c.std_span for c in cluster if c.std_span is not None]
        positions = [c.std_pos for c in cluster if c.std_pos is not None]
        count = len(cluster)
        final.append(CandidateDuplicationInterspersed(
            cluster[0].get_source()[0],
            int(round(sum(c.get_source()[1] for c in cluster) / count)),
            int(round(sum(c.get_source()[2] for c in cluster) / count)),
            cluster[0].get_destination()[0],
            int(round(sum(c.get_destination()[1] for c in cluster) / count)),
            int(round(sum(c.get_destination()[2] for c in cluster) / count)),
            [member for c in cluster for member in c.members],
            max(c.score for c in cluster),
            mean(spans) if spans else None,
            mean(positions) if positions else None,
            any(c.cutpaste for c in cluster)))
    return final
