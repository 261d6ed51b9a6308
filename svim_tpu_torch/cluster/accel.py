"""INS edit-distance precompute for CLUSTER (port routing).

Counterpart of svim_tpu/cluster/accel.py::precompute_ins_edit_distances.
The matrix builders, pair enumeration and caches are framework-free and
imported from svim_tpu; only the edit-distance backend routing is the
port's own, so that `--edit_backend wavefront` reaches the port's kernel.

Every INS matrix the port builds through svim_tpu's `distance_matrix` is
handed a COMPLETE `InsEditCache` from here: a missing pair would make that
function compute the distance through svim_tpu's own (JAX) backend.
"""

from __future__ import annotations

import numpy as np

from svim_tpu.cluster import accel
from svim_tpu.cluster.accel import InsEditCache, _pair_key, ins_near_pairs
from svim_tpu_torch.cluster.edit_distance import batch_edit_distances


def precompute_ins_edit_distances(samples, reference, options, device):
    """One batched edit-distance pass over the near pairs of ALL insertion
    partitions (SVIM_clustering.py:64-77).  Returns an InsEditCache.

    "auto" ships indices to svim_tpu's native batch (host only);
    "wavefront" assembles the reference-padded haplotype strings and runs
    them through the port's wavefront driver on `device`; "python" runs the
    pure-Python recurrence."""
    backend = getattr(options, "edit_backend", "auto")
    if backend != "wavefront":
        return accel.precompute_ins_edit_distances(samples, reference, options)

    cache = InsEditCache()
    prepared = []   # (sample, starts, pairs_i, pairs_j, hints)
    for sample in samples:
        if len(sample) < 2:
            continue
        sample_type = getattr(sample, "type", None) or sample[0].type
        if sample_type != "INS":
            continue
        starts, _spans, pairs_i, pairs_j, hints = ins_near_pairs(sample,
                                                                 options)
        if len(pairs_i):
            prepared.append((sample, starts, pairs_i, pairs_j, hints))
    if not prepared:
        return cache

    haplotype_pairs = []
    band_hints = []
    for sample, starts, pairs_i, pairs_j, hints in prepared:
        haplotype_pairs.extend(accel.ins_haplotype_pairs(
            sample, starts, pairs_i, pairs_j, reference))
        band_hints.extend(hints.tolist())
    values = np.asarray(batch_edit_distances(haplotype_pairs, device, backend,
                                             band_hints=band_hints),
                        dtype=np.int64)
    consumed = 0
    for sample, _starts, pairs_i, pairs_j, _hints in prepared:
        part = values[consumed:consumed + len(pairs_i)]
        consumed += len(pairs_i)
        cache.by_partition[id(sample)] = (pairs_i, pairs_j, part)
        if len(sample) <= 2:
            # scalar lookups (ins_pair_distance) happen only on the
            # 2-element fast path; matrix partitions consume the arrays
            for i, j, value in zip(pairs_i.tolist(), pairs_j.tolist(),
                                   part.tolist()):
                key = _pair_key(sample[i], sample[j])
                cache.pairs[key] = value
                cache.pairs[(key[1], key[0])] = value
    return cache
