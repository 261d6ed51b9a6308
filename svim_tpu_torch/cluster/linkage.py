"""Average-linkage agglomerative clustering, from scratch.

The reference delegates to scipy's linkage(method="average") + fcluster
(SVIM_clustering.py:170-171).  The host pipeline keeps scipy as the arbiter
for byte-exact parity; this module provides the self-contained implementation
used by the device path (fixed-size matrices, no dynamic allocation), and is
cross-validated against scipy in tests.
"""

from __future__ import annotations

import numpy as np


def average_linkage_merge_heights(distance_matrix: np.ndarray):
    """Run naive average-linkage agglomeration on a full distance matrix.

    Returns a list of merges (i, j, height, size) over cluster ids where the
    two original clusters i and j (ids 0..n-1, merged clusters n, n+1, ...)
    are joined at the given cophenetic height.
    """
    n = distance_matrix.shape[0]
    d = distance_matrix.astype(np.float64).copy()
    np.fill_diagonal(d, np.inf)
    active = list(range(n))
    sizes = {i: 1 for i in range(n)}
    ids = {i: i for i in range(n)}
    merges = []
    next_id = n
    for _ in range(n - 1):
        # find min pair among active clusters
        sub = d[np.ix_(active, active)]
        flat = np.argmin(sub)
        ai, aj = divmod(flat, len(active))
        if ai > aj:
            ai, aj = aj, ai
        i, j = active[ai], active[aj]
        height = d[i, j]
        merges.append((ids[i], ids[j], height, sizes[i] + sizes[j]))
        # average-linkage update: weighted by cluster sizes
        si, sj = sizes[i], sizes[j]
        for k in active:
            if k == i or k == j:
                continue
            d[i, k] = d[k, i] = (si * d[i, k] + sj * d[j, k]) / (si + sj)
        sizes[i] = si + sj
        ids[i] = next_id
        next_id += 1
        active.remove(j)
    return merges


def fcluster_by_distance(distance_matrix: np.ndarray, threshold: float) -> np.ndarray:
    """Flat clusters where cophenetic distance <= threshold (scipy's
    fcluster(criterion='distance') contract).  Labels are 1-based and ordered
    by first occurrence, matching how the pipeline regroups members."""
    n = distance_matrix.shape[0]
    if n == 0:
        return np.zeros(0, dtype=np.int64)
    if n == 1:
        return np.ones(1, dtype=np.int64)
    merges = average_linkage_merge_heights(distance_matrix)
    parent = list(range(2 * n - 1))

    def find(x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    next_id = n
    for i, j, height, _size in merges:
        if height <= threshold:
            parent[find(i)] = next_id
            parent[find(j)] = next_id
        next_id += 1

    labels = np.zeros(n, dtype=np.int64)
    label_of_root = {}
    next_label = 1
    for leaf in range(n):
        root = find(leaf)
        if root not in label_of_root:
            label_of_root[root] = next_label
            next_label += 1
        labels[leaf] = label_of_root[root]
    return labels


def condensed_to_square(condensed, n: int) -> np.ndarray:
    """Expand a condensed (upper-triangle, row-major) distance vector to a
    symmetric square matrix."""
    matrix = np.zeros((n, n), dtype=np.float64)
    idx = 0
    for i in range(n - 1):
        for j in range(i + 1, n):
            matrix[i, j] = matrix[j, i] = condensed[idx]
            idx += 1
    return matrix
