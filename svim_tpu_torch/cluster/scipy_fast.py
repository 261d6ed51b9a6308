"""Self-validating fast paths around scipy's hierarchical-clustering C cores.

The production CLUSTER stage runs one small linkage + one dendrogram cut per
partition — thousands of calls over a whole-genome input.  scipy 1.17's
public ``linkage``/``fcluster`` spend most of each call in array-API
validation (``array_namespace``, ``_is_valid_linkage``, ``inspect.signature``
via ``lazy_apply``), ~0.4 ms per call, which dominates the actual C compute
for partitions of ≤128 elements.  The C cores compute the identical arrays on
contiguous float64 input: ``linkage(y, "average")`` is exactly
``_hierarchy.nn_chain(y, n, code)`` and ``fcluster(Z, t, "distance")`` is
exactly ``_hierarchy.cluster_dist(Z, T, t, n)`` (see scipy's own dispatch).

Because these are private APIs, a one-time self-check compares both paths on
fixtures (including tie-heavy integer grids — scipy's tie-breaking is part of
the reference contract, SVIM_clustering.py:170-171) and permanently falls
back to the public functions on any mismatch or import error, so results are
bit-identical by construction.
"""

from __future__ import annotations

import numpy as np
from scipy.cluster.hierarchy import fcluster, linkage

_STATE = {"checked": False, "core": None}


def _self_check():
    """Validate the private C entry points against the public API once."""
    if _STATE["checked"]:
        return _STATE["core"]
    _STATE["checked"] = True
    try:
        from scipy.cluster import _hierarchy
        from scipy.cluster.hierarchy import _LINKAGE_METHODS

        code = _LINKAGE_METHODS["average"]
        rng = np.random.default_rng(12345)
        for n in (2, 3, 5, 24, 64):
            for tie_grid in (False, True):
                if tie_grid:
                    # integer grid → many exactly-equal distances, the
                    # tie-breaking stress case
                    values = rng.integers(0, 4, size=n).astype(np.float64)
                else:
                    values = rng.normal(size=n)
                delta = np.abs(values[:, None] - values[None, :])
                y = np.ascontiguousarray(
                    delta[np.triu_indices(n, k=1)], dtype=np.float64)
                z_public = linkage(y, method="average")
                z_fast = _hierarchy.nn_chain(y.copy(), n, code)
                if not np.array_equal(z_public, z_fast):
                    return None
                for threshold in (0.5, 1.0, 2.5):
                    t_public = fcluster(z_public, threshold,
                                        criterion="distance")
                    t_fast = np.zeros(n, dtype=np.intc)
                    _hierarchy.cluster_dist(
                        np.ascontiguousarray(z_fast, dtype=np.float64),
                        t_fast, float(threshold), n)
                    if not np.array_equal(np.asarray(t_public),
                                          t_fast.astype(t_public.dtype)):
                        return None
        _STATE["core"] = (_hierarchy, code)
    except Exception:
        _STATE["core"] = None
    return _STATE["core"]


def average_linkage(condensed) -> np.ndarray:
    """``linkage(condensed, method="average")``, bit-identical."""
    core = _self_check()
    y = np.ascontiguousarray(condensed, dtype=np.float64)
    if core is None:
        return linkage(y, method="average")
    hierarchy_core, code = core
    n = int(round((1 + np.sqrt(1 + 8 * len(y))) / 2))
    return hierarchy_core.nn_chain(y, n, code)


def fcluster_distance(z, threshold) -> np.ndarray:
    """``fcluster(z, threshold, criterion="distance")``, bit-identical."""
    core = _self_check()
    if core is None:
        return fcluster(z, threshold, criterion="distance")
    hierarchy_core, _ = core
    z = np.ascontiguousarray(z, dtype=np.float64)
    n = z.shape[0] + 1
    labels = np.zeros(n, dtype=np.intc)
    hierarchy_core.cluster_dist(z, labels, float(threshold), n)
    return labels
