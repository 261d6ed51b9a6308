"""Process-sharded CLUSTER: per-partition linkage fanned out across ranks.

After the COLLECT exchange every process holds the identical global
SignatureSoA, and partitions are independent of each other (the reference
clusters them one by one, SVIM_clustering.py:122-180), so rank r computes
the groupings only for partitions with index % world == r and ONE gather of
fixed-dtype position arrays rebuilds the identical global cluster list on
every rank.  Counterpart of svim_tpu/parallel/cluster_shard.py; the owned
partitions' device work (the resident INS route and its wavefront kernel
included) runs on the rank's own device.

Exactness: subsampling consumes random.seed(1524) draws in partition order
(SVIM_clustering.py:129-134), so EVERY rank replicates the full subsample
pass (cheap — draws only for >100-member partitions) and owned samples are
then handed to the standard dispatch/finish machinery pre-subsampled; its
internal re-seed draws nothing on <=100-member samples, keeping the RNG
stream byte-identical to the single-process path.  Groupings travel as
positions WITHIN each partition's sample, so the rebuilt views equal the
locally-computed ones row for row (tests/test_torch_multihost.py pins
2-process VCF byte parity through this path)."""

from __future__ import annotations

from random import sample, seed
from typing import Dict, List, Tuple

import numpy as np

from svim_tpu_torch.cluster.cluster import (
    MAX_PARTITION_SIZE,
    RANDOM_SEED,
    _consolidate_typed,
    dispatch_clusters_from_partitions,
    finish_clusters_from_partitions,
)
from svim_tpu_torch.cluster.partition import form_partitions_table
from svim_tpu_torch.io.fasta import FastaFile
from svim_tpu_torch.parallel.multihost import (
    allgather_arrays,
    process_count,
    process_index,
)

_LABELS = {
    "DEL": "deleted regions",
    "INS": "inserted regions",
    "INV": "inverted regions",
    "DUP_TAN": "tandem duplicated regions",
    "DUP_INT": "inserted regions with detected region of origin",
    "BND": "translocation breakpoints",
}
_ORDER = ("DEL", "INS", "INV", "DUP_TAN", "DUP_INT", "BND")
_DISPATCH_ORDER = ("DEL", "INV", "DUP_TAN", "BND", "DUP_INT", "INS")


def _subsample_all(partitions):
    """Replicate dispatch_clusters_from_partitions' subsampling on EVERY
    partition (identical RNG stream to the single-process path)."""
    seed(RANDOM_SEED)
    samples = []
    for partition in partitions:
        if len(partition) > MAX_PARTITION_SIZE:
            samples.append(partition.take(
                sample(range(len(partition)), MAX_PARTITION_SIZE)))
        else:
            samples.append(partition)
    return samples


def _position_groups(owned, clusters):
    """Convert the flat cluster list over the owned samples into
    (partition index, positions-within-sample) pairs.

    Table-view clusters carry global row indices; the pair fast path
    (2-member partitions) returns materialized object lists, which map back
    through the table's object cache (materialize(i) memoizes, so the
    cluster's object IS the sample's object)."""
    row_to_part: Dict[int, int] = {}
    row_to_pos: Dict[int, int] = {}
    object_to_row: Dict[int, int] = {}
    for part_index, sample_view in owned:
        rows = np.asarray(sample_view.indices).tolist()
        for pos, row in enumerate(rows):
            row_to_part[row] = part_index
            row_to_pos[row] = pos
        if len(rows) == 2:
            # the pair fast path materializes; pre-materialize here so the
            # identity map below covers its object clusters
            table = sample_view.table
            for row in rows:
                object_to_row[id(table.materialize(row))] = row
    groups: List[Tuple[int, List[int]]] = []
    for cluster in clusters:
        indices = getattr(cluster, "indices", None)
        if indices is not None:
            rows = np.asarray(indices).tolist()
        else:
            rows = [object_to_row[id(member)] for member in cluster]
        groups.append((row_to_part[rows[0]],
                       [row_to_pos[row] for row in rows]))
    return groups


def _groups_to_arrays(groups) -> dict:
    part_ids = np.asarray([part for part, _ in groups], dtype=np.int64)
    sizes = np.asarray([len(positions) for _, positions in groups],
                       dtype=np.int64)
    members = (np.concatenate([np.asarray(positions, dtype=np.int64)
                               for _, positions in groups])
               if groups else np.zeros(0, dtype=np.int64))
    return {"part": part_ids, "size": sizes, "member": members}


def _arrays_to_groups(arrays):
    groups = []
    offset = 0
    members = arrays["member"]
    for part, size in zip(arrays["part"].tolist(), arrays["size"].tolist()):
        groups.append((part, members[offset:offset + size]))
        offset += size
    return groups


def _apply_groups(samples, groups_by_part):
    """The global cluster list in partition order from every rank's
    groupings (singletons never travel: every rank derives them)."""
    clusters_final = []
    for index, sample_view in enumerate(samples):
        if len(sample_view) == 1:
            clusters_final.append(sample_view)
            continue
        for positions in groups_by_part[index]:
            clusters_final.append(sample_view.take(positions))
    return clusters_final


def cluster_sv_signatures_sharded(soa, options, device):
    """cluster_sv_signatures with per-partition work sharded across the
    process group, each rank's share on its `device`; every rank returns the
    identical six cluster lists (reference flow: SVIM_CLUSTER.py:7-26)."""
    from svim_tpu_torch.cluster.device_cluster import TELEMETRY, DeviceBatcher
    from svim_tpu_torch.state import to_host

    rank = process_index()
    world = process_count()
    with FastaFile(options.genome) as reference:
        TELEMETRY.reset()
        batcher = DeviceBatcher(options, device)
        staged = {}
        for key in _DISPATCH_ORDER:
            if key == "INS":
                batcher.flush_fused()
            table = soa.tables.get(key)
            partitions = (form_partitions_table(
                table, options.partition_max_distance)
                if table is not None else [])
            samples = _subsample_all(partitions)
            owned = [(index, sample_view)
                     for index, sample_view in enumerate(samples)
                     if len(sample_view) > 1 and index % world == rank]
            work = dispatch_clusters_from_partitions(
                [sample_view for _, sample_view in owned], reference,
                options, batcher)
            staged[key] = (partitions, samples, owned, work)
        fetched = to_host(batcher.device_outputs())

        local_arrays = {}
        for key in _ORDER:
            _partitions, _samples, owned, work = staged[key]
            clusters = finish_clusters_from_partitions(work, reference,
                                                       options,
                                                       fetched=fetched)
            for name, array in _groups_to_arrays(
                    _position_groups(owned, clusters)).items():
                local_arrays["{0}.{1}".format(key, name)] = array
        gathered = allgather_arrays(local_arrays)

        consolidated = {}
        for key in _ORDER:
            partitions, samples, _owned, _work = staged[key]
            groups_by_part: Dict[int, List] = {index: []
                                               for index in range(len(samples))}
            for part_arrays in gathered:
                part_groups = _arrays_to_groups(
                    {name: part_arrays["{0}.{1}".format(key, name)]
                     for name in ("part", "size", "member")})
                for part_index, positions in part_groups:
                    groups_by_part[int(part_index)].append(positions)
            clusters_final = _apply_groups(samples, groups_by_part)
            consolidated[key] = _consolidate_typed(clusters_final, partitions,
                                                   _LABELS[key])
        TELEMETRY.log_summary()
    return (consolidated["DEL"], consolidated["INS"], consolidated["INV"],
            consolidated["DUP_TAN"], consolidated["DUP_INT"],
            consolidated["BND"])
