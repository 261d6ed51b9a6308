"""Device clustering: batched agglomeration on the port's device with exact
host parity.

Counterpart of svim_tpu/cluster/device_cluster.py.  Partitions of 3..128
signatures are batched into padded tensors and agglomerated on `device`
(ops.linkage_kernel); the host rebuilds a scipy-format Z from each merge
sequence and cuts it with scipy's fcluster, which reproduces the
reference's flat-cluster numbering exactly.  Every comparison float32 could
arbitrate differently from scipy's float64 is guarded, and those partitions
run the exact host linkage instead, so clusters are bit-identical to the
reference (SVIM_clustering.py:159-171).

Three routes, as in the JAX package:
  * fused (DEL / INV / DUP_TAN / DUP_INT / BND): exact f64 dedup and
    tie/wall arbitration on host at dispatch time; coordinates go to the
    device, which builds the matrices and agglomerates.
  * matrix (INS with host edit distances, and the DUP_INT candidate
    round): host f64 matrices, device agglomeration.
  * resident (INS with --edit_backend wavefront): haplotype edit distances
    computed on the device by the wavefront kernel feed on-device matrix
    assembly and agglomeration; the host sees them once, in the stage's
    single fetch.

A kernel failure on the device ends the run: nothing here reroutes a failed
device route to the host.
"""

from __future__ import annotations

import logging
from typing import List, Optional

import numpy as np
import torch

from svim_tpu_torch.cluster import accel
from svim_tpu_torch.cluster.distance import SAME_READ_WALL
from svim_tpu_torch.cluster.scipy_fast import (
    average_linkage,
    fcluster_distance,
)
from svim_tpu_torch.cluster.accel import precompute_ins_edit_distances
from svim_tpu_torch.ops.linkage_kernel import (
    KIND_BND,
    KIND_DUP_INT,
    KIND_SPAN_POSITION,
    MERGE_CUTOFF,
    TIE_EPS,
    agglomerate_batched,
    ins_matrices_from_pairs,
    span_position_agglomerate_batched,
)
from svim_tpu_torch.parallel.mesh import gather_shards, shard_batch
from svim_tpu_torch.state import to_host
from svim_tpu_torch.utils import timing

_FUSED_KIND = {"DEL": KIND_SPAN_POSITION, "INV": KIND_SPAN_POSITION,
               "DUP_TAN": KIND_SPAN_POSITION, "DUP_INT": KIND_DUP_INT,
               "BND": KIND_BND}

FUSED_TYPES = ("DEL", "INV", "DUP_TAN", "DUP_INT", "BND")
MATRIX_TYPES = ("INS",)
DEVICE_TYPES = FUSED_TYPES + MATRIX_TYPES
PARTITION_BUCKETS = (32, 128)


class FallbackTelemetry:
    """Counts where device-eligible partitions were resolved.

    device: agglomerated on device, labels accepted.
    pre_tie / pre_wall: exact f64 ties / surviving 99999 walls detected at
        dispatch time -> resolved on host over the already-built matrix
        without a device round trip (data properties, not degradation).
    post_tie / post_wall: the kernel ran but f32 could not arbitrate (min_gap
        under TIE_EPS, dedup ambiguity, near-threshold heights) -> re-run on
        host.
    resident_relink: resident-INS partitions whose labeling the f32 guard
        rejected; the device edit distances are reused by the exact host
        re-linkage.
    """

    __slots__ = ("device", "pre_tie", "pre_wall", "post_tie", "post_wall",
                 "resident_relink")

    def __init__(self):
        self.reset()

    def reset(self):
        self.device = 0
        self.pre_tie = 0
        self.pre_wall = 0
        self.post_tie = 0
        self.post_wall = 0
        self.resident_relink = 0

    @property
    def eligible(self):
        return (self.device + self.pre_tie + self.pre_wall
                + self.post_tie + self.post_wall + self.resident_relink)

    @property
    def fallback_fraction(self):
        total = self.eligible
        host = total - self.device - self.resident_relink
        return host / total if total else 0.0

    @property
    def wasted_fraction(self):
        """Partitions that paid a device round trip and then re-ran on host."""
        total = self.eligible
        return (self.post_tie + self.post_wall) / total if total else 0.0

    def as_dict(self):
        return {"device": self.device, "pre_tie": self.pre_tie,
                "pre_wall": self.pre_wall, "post_tie": self.post_tie,
                "post_wall": self.post_wall,
                "resident_relink": self.resident_relink,
                "fallback_fraction": round(self.fallback_fraction, 4),
                "wasted_fraction": round(self.wasted_fraction, 4)}

    def log_summary(self):
        total = self.eligible
        if not total:
            return
        logging.info(
            "Device clustering: {0}/{1} eligible partitions agglomerated on "
            "device; {2} resolved by exact host linkage at dispatch "
            "({3} f64 ties, {4} walls — no device cost); {5} re-linked on "
            "host over device-computed edit distances (near-tied heights); "
            "{6} wasted a device round trip on f32 ambiguity ({7:.2%}).".format(
                self.device, total, self.pre_tie + self.pre_wall,
                self.pre_tie, self.pre_wall, self.resident_relink,
                self.post_tie + self.post_wall, self.wasted_fraction))


TELEMETRY = FallbackTelemetry()


def _bucket(n: int) -> int:
    for bucket in PARTITION_BUCKETS:
        if n <= bucket:
            return bucket
    raise ValueError("partition of {0} exceeds the device pad".format(n))


def _round_up_pow2(value: int, floor: int = 8) -> int:
    result = floor
    while result < value:
        result *= 2
    return result


def labels_from_merges(merge_lo, merge_hi, heights, n_survivors: int,
                       threshold: float,
                       slot_rank=None) -> Optional[np.ndarray]:
    """Reconstruct scipy's linkage matrix Z from a kernel merge sequence and
    cut it with scipy's fcluster — identical flat-cluster numbering to the
    host path.  `slot_rank` maps kernel slot indices to survivor ranks
    (identity when the matrix was pre-compacted).  Returns None when a merge
    height sits too close to the cut threshold for float32 to arbitrate
    (caller falls back to host)."""
    m = n_survivors
    if m == 1:
        return np.ones(1, dtype=np.int64)
    ids = {}
    sizes = {}
    z = np.zeros((m - 1, 4), dtype=np.float64)
    rows = 0
    for k in range(len(heights)):
        height = float(heights[k])
        if height >= MERGE_CUTOFF:
            break
        if abs(height - threshold) < TIE_EPS * max(height, 1.0):
            return None
        a = int(merge_lo[k])
        b = int(merge_hi[k])
        id_a = ids.get(a, slot_rank[a] if slot_rank is not None else a)
        id_b = ids.get(b, slot_rank[b] if slot_rank is not None else b)
        size_a = sizes.get(a, 1)
        size_b = sizes.get(b, 1)
        z[rows, 0] = min(id_a, id_b)
        z[rows, 1] = max(id_a, id_b)
        z[rows, 2] = height
        z[rows, 3] = size_a + size_b
        ids[a] = m + rows
        sizes[a] = size_a + size_b
        rows += 1
    if rows != m - 1:
        return None
    return fcluster_distance(z, threshold)


def _group_survivors(survivors, labels):
    """Group surviving elements by fcluster label (member order within each
    group is ascending position, as the host path's _group_by_labels)."""
    if getattr(survivors, "table", None) is not None:
        labels = np.asarray(labels)
        return [survivors.take(np.flatnonzero(labels == label))
                for label in range(1, int(labels.max()) + 1)]
    groups = [[] for _ in range(int(max(labels)))]
    for element, label in zip(survivors, labels):
        groups[int(label) - 1].append(element)
    return groups


class DeviceClusterResult:
    """Per-partition outcome of a batched device pass."""

    __slots__ = ("clusters", "dropped_count")

    def __init__(self, clusters, dropped_count):
        self.clusters = clusters          # list of clusters, or None => fallback
        self.dropped_count = dropped_count


class DeviceBatcher:
    """Cross-type accumulator for the CLUSTER stage's device work on
    `device`.

    Every type's eligible partitions register here (fused route: coordinate
    rows with a per-row wall flag; matrix route: prebuilt float64 matrices);
    flush() runs ONE kernel call per (route, pad bucket) for the whole
    stage, and device_outputs() exposes the output trees so the driver can
    fetch every result with one to_host."""

    __slots__ = ("options", "device", "fused_rows", "matrix_rows", "outputs",
                 "fused_flushed", "extra_outputs")

    def __init__(self, options, device):
        self.options = options
        self.device = device
        self.fused_rows = {}    # pad -> [(starts, ends, dest, reads, valid, wall, kind)]
        self.matrix_rows = {}   # pad -> [float64 matrix]
        self.outputs = None
        self.fused_flushed = False
        self.extra_outputs = {}  # routes dispatched eagerly (INS resident)

    @property
    def num_shards(self):
        return getattr(self.options, "num_shards", 1)

    def add_fused(self, sample, wall_same_read: bool, element_type: str = "DEL"):
        if self.fused_flushed:
            raise RuntimeError("fused buckets already dispatched; register "
                               "fused types first")
        n = len(sample)
        pad = _bucket(n)
        starts = np.zeros(pad, dtype=np.int32)
        ends = np.zeros(pad, dtype=np.int32)
        dest = np.zeros(pad, dtype=np.int32)
        # padding stays invalid (distinct negative ids would still compare
        # equal across rows of padding)
        reads = np.full(pad, -1, dtype=np.int32)
        valid = np.zeros(pad, dtype=bool)
        sample_starts, sample_ends = accel._source_columns(sample)
        starts[:n] = sample_starts
        ends[:n] = sample_ends
        kind = _FUSED_KIND[element_type]
        if element_type in ("DUP_INT", "BND"):
            dest[:n] = accel._dest_start_column(sample)
        reads[:n] = accel.read_index_array(sample)
        valid[:n] = True
        rows = self.fused_rows.setdefault(pad, [])
        rows.append((starts, ends, dest, reads, valid, wall_same_read, kind))
        return ("fused", pad, len(rows) - 1)

    def add_matrix(self, matrix):
        pad = _bucket(matrix.shape[0])
        rows = self.matrix_rows.setdefault(pad, [])
        rows.append(matrix)
        return ("matrix", pad, len(rows) - 1)

    def flush_fused(self):
        """Run the fused-route buckets accumulated so far.  Called after the
        five coordinate types registered and before the INS staging."""
        if self.outputs is None:
            self.outputs = {}
        options = self.options
        for pad, rows in sorted(self.fused_rows.items()):
            batch = _round_up_pow2(len(rows))
            starts = np.zeros((batch, pad), dtype=np.int32)
            ends = np.zeros((batch, pad), dtype=np.int32)
            dest = np.zeros((batch, pad), dtype=np.int32)
            reads = np.full((batch, pad), -1, dtype=np.int32)
            valid = np.zeros((batch, pad), dtype=bool)
            wall = np.zeros(batch, dtype=bool)
            kinds = np.zeros(batch, dtype=np.int32)
            for row, (row_starts, row_ends, row_dest, row_reads, row_valid,
                      row_wall, row_kind) in enumerate(rows):
                starts[row] = row_starts
                ends[row] = row_ends
                dest[row] = row_dest
                reads[row] = row_reads
                valid[row] = row_valid
                wall[row] = row_wall
                kinds[row] = row_kind
            # --num_shards cuts the partition axis over the shard devices
            normalizer = float(np.float32(
                options.position_distance_normalizer))
            max_distance = float(np.float32(options.cluster_max_distance))
            self.outputs[("fused", pad)] = gather_shards([
                span_position_agglomerate_batched(
                    s_starts, s_ends, s_reads, s_valid, normalizer,
                    max_distance, s_wall, dest=s_dest, kind=s_kinds)
                for (s_starts, s_ends, s_dest, s_reads, s_valid, s_wall,
                     s_kinds) in shard_batch(
                         self.num_shards, self.device, starts, ends, dest,
                         reads, valid, wall, kinds)], self.device)
        self.fused_rows = {}
        self.fused_flushed = True

    def flush(self):
        """Run every accumulated bucket (results stay on the device)."""
        self.flush_fused()
        for pad, matrices_f64 in sorted(self.matrix_rows.items()):
            batch = _round_up_pow2(len(matrices_f64))
            matrices = np.full((batch, pad, pad), 3.0e38, dtype=np.float32)
            valid = np.zeros((batch, pad), dtype=bool)
            for row, matrix in enumerate(matrices_f64):
                n = matrix.shape[0]
                matrices[row, :n, :n] = matrix
                valid[row, :n] = True
            self.outputs[("matrix", pad)] = gather_shards([
                agglomerate_batched(*shard) for shard in shard_batch(
                    self.num_shards, self.device, matrices, valid)],
                self.device)
        self.matrix_rows = {}

    def device_outputs(self):
        """{bucket key: output tree} — fetch with one to_host."""
        self.flush()
        if self.extra_outputs:
            merged = dict(self.outputs)
            merged.update(self.extra_outputs)
            return merged
        return self.outputs


class PendingDeviceClusters:
    """Registered device agglomerations for one signature type."""

    __slots__ = ("samples", "threshold", "batcher", "fused", "matrix",
                 "resident", "ready")

    def __init__(self, samples, threshold, batcher):
        self.samples = samples
        self.threshold = threshold
        self.batcher = batcher
        self.fused = []    # (sample index, survivors, dropped, batcher handle)
        self.matrix = []   # (sample index, survivors, matrix, reads, dropped, handle)
        self.resident = []  # (index, sample, pairs_i, pairs_j, ed offset, pad, row)
        self.ready = {}    # index -> DeviceClusterResult decided at dispatch


def _survivors_after_dedup(sample, matrix, reads, threshold):
    """Exact same-read dedup (SVIM_clustering.py:145-151) on the f64
    matrix: (survivors, matrix, reads, dropped_count)."""
    drop = accel.dedup_same_read(matrix, reads, threshold)
    if not drop:
        return sample, matrix, reads, 0
    keep = [i for i in range(len(sample)) if i not in drop]
    if getattr(sample, "table", None) is not None:
        survivors = sample.take(keep)
    else:
        survivors = [sample[i] for i in keep]
    return survivors, matrix[np.ix_(keep, keep)], reads[keep], len(drop)


def _singleton(survivors, dropped_count):
    if getattr(survivors, "table", None) is not None:
        return DeviceClusterResult([survivors], dropped_count)
    return DeviceClusterResult([[survivors[0]]], dropped_count)


def _has_same_read_pair(reads):
    same = reads[:, None] == reads[None, :]
    np.fill_diagonal(same, False)
    return bool(same.any())


def _dispatch_fused(samples, element_type, reference, options, batcher):
    """DEL / INV / DUP_TAN / DUP_INT / BND: exact host arbitration + device
    agglomeration; only partitions the f32 kernel can provably order are
    dispatched."""
    wall_same_read = element_type != "INV"
    threshold = float(options.cluster_max_distance)
    pending = PendingDeviceClusters(samples, threshold, batcher)
    fallback = pending.ready
    for index, sample in enumerate(samples):
        matrix = accel.distance_matrix(sample, element_type, reference, options)
        reads = accel.read_index_array(sample)
        dropped_count = 0
        survivors = sample
        if wall_same_read:
            survivors, matrix, reads, dropped_count = _survivors_after_dedup(
                sample, matrix, reads, threshold)
        if len(survivors) == 1:
            fallback[index] = _singleton(survivors, dropped_count)
            continue
        if wall_same_read and _has_same_read_pair(reads):
            # surviving same-read pairs put 99999 walls into the linkage
            TELEMETRY.pre_wall += 1
            fallback[index] = DeviceClusterResult(_host_linkage_clusters(
                matrix, reads, survivors, threshold, True), dropped_count)
            continue
        off_diagonal = ~np.eye(len(survivors), dtype=bool)
        if (matrix[off_diagonal] >= SAME_READ_WALL).any():
            # BND direction-mismatch pairs wall the linkage; the device
            # coordinate formula carries no direction info — host arbitrates
            TELEMETRY.pre_wall += 1
            fallback[index] = DeviceClusterResult(_host_linkage_clusters(
                matrix, reads, survivors, threshold, wall_same_read),
                dropped_count)
            continue
        condensed = matrix[accel.triu_indices_cached(len(survivors))]
        if len(np.unique(condensed)) != len(condensed):
            # exact f64 ties: scipy's nn-chain tie-breaking decides these
            TELEMETRY.pre_tie += 1
            fallback[index] = DeviceClusterResult(_host_linkage_clusters(
                matrix, reads, survivors, threshold, wall_same_read),
                dropped_count)
            continue
        pending.fused.append((index, survivors, dropped_count,
                              batcher.add_fused(survivors, wall_same_read,
                                                element_type)))
    return pending


def _consume_fused(pending, fetched):
    results = dict(pending.ready)
    threshold = pending.threshold
    for index, survivors, dropped_count, (_route, pad, row) in pending.fused:
        (merges_lo, merges_hi, heights, min_gap, _dropped, has_wall,
         dedup_ambiguous) = fetched[("fused", pad)]
        if bool(has_wall[row]):
            TELEMETRY.post_wall += 1
            results[index] = DeviceClusterResult(None, 0)
            continue
        if bool(dedup_ambiguous[row]) or float(min_gap[row]) < TIE_EPS:
            TELEMETRY.post_tie += 1
            results[index] = DeviceClusterResult(None, 0)
            continue
        # dedup already happened exactly on host; kernel slots map 1:1 to
        # survivor ranks
        labels = labels_from_merges(merges_lo[row], merges_hi[row],
                                    heights[row], len(survivors), threshold)
        if labels is None:
            TELEMETRY.post_tie += 1
            results[index] = DeviceClusterResult(None, 0)
            continue
        TELEMETRY.device += 1
        results[index] = DeviceClusterResult(
            _group_survivors(survivors, labels), dropped_count)
    return results


def _host_linkage_clusters(matrix, reads, survivors, threshold, wall_same_read):
    """Exact float64 host linkage over an already-built (deduped) matrix."""
    if wall_same_read:
        distances = accel.condensed_with_wall(matrix, reads, wall_same_read=True)
    else:
        distances = matrix[accel.triu_indices_cached(matrix.shape[0])]
    dendrogram = average_linkage(distances)
    labels = fcluster_distance(dendrogram, threshold)
    return _group_survivors(survivors, labels)


def _dispatch_matrix(samples, element_type, reference, options, ed_cache,
                     batcher, dedup_same_read=True, indices=None,
                     pending=None):
    """INS / DUP_INT candidate round: host float64 matrix + exact dedup,
    device agglomeration.  `indices`/`pending` let the resident INS route
    register its same-read partitions here under their original
    positions."""
    threshold = float(options.cluster_max_distance)
    if pending is None:
        pending = PendingDeviceClusters(samples, threshold, batcher)
    fallback = pending.ready
    indexed = enumerate(samples) if indices is None else zip(indices, samples)
    for index, sample in indexed:
        matrix = accel.distance_matrix(sample, element_type, reference,
                                       options, ed_cache=ed_cache)
        dropped_count = 0
        survivors = sample
        reads = None
        if dedup_same_read:
            reads = accel.read_index_array(sample)
            survivors, matrix, reads, dropped_count = _survivors_after_dedup(
                sample, matrix, reads, threshold)
            if len(survivors) > 1 and _has_same_read_pair(reads):
                TELEMETRY.pre_wall += 1
                fallback[index] = DeviceClusterResult(_host_linkage_clusters(
                    matrix, reads, survivors, threshold, True), dropped_count)
                continue
        if len(survivors) == 1:
            fallback[index] = _singleton(survivors, dropped_count)
            continue
        off_diagonal = ~np.eye(len(survivors), dtype=bool)
        if (matrix[off_diagonal] >= SAME_READ_WALL).any():
            TELEMETRY.pre_wall += 1
            fallback[index] = DeviceClusterResult(_host_linkage_clusters(
                matrix, reads, survivors, threshold, dedup_same_read),
                dropped_count)
            continue
        condensed = matrix[accel.triu_indices_cached(len(survivors))]
        if len(np.unique(condensed)) != len(condensed):
            TELEMETRY.pre_tie += 1
            fallback[index] = DeviceClusterResult(_host_linkage_clusters(
                matrix, reads, survivors, threshold, dedup_same_read),
                dropped_count)
            continue
        pending.matrix.append((index, survivors, matrix, reads, dropped_count,
                               batcher.add_matrix(matrix)))
    return pending


def _consume_matrix(pending, fetched, wall_same_read=True):
    results = dict(pending.ready)
    threshold = pending.threshold
    for (index, survivors, matrix, reads, dropped_count,
         (_route, pad, row)) in pending.matrix:
        merges_lo, merges_hi, heights, min_gap = fetched[("matrix", pad)]
        if float(min_gap[row]) < TIE_EPS:
            labels = None
        else:
            labels = labels_from_merges(merges_lo[row], merges_hi[row],
                                        heights[row], len(survivors),
                                        threshold)
        if labels is None:
            # float32 could not arbitrate: exact host linkage over the
            # float64 matrix built at dispatch
            TELEMETRY.post_tie += 1
            clusters = _host_linkage_clusters(
                matrix, reads, survivors, threshold,
                wall_same_read and reads is not None)
            results[index] = DeviceClusterResult(clusters, dropped_count)
            continue
        TELEMETRY.device += 1
        results[index] = DeviceClusterResult(
            _group_survivors(survivors, labels), dropped_count)
    return results


def dispatch_partitions_device(samples: List[list], element_type: str,
                               reference, options, batcher, ed_cache=None):
    """Register the device agglomerations for same-type partitions (each
    3..128 elements) on `batcher`; pair with consume_partitions_device."""
    if element_type in FUSED_TYPES:
        return _dispatch_fused(samples, element_type, reference, options,
                               batcher)
    if element_type in MATRIX_TYPES:
        if ins_resident_enabled(options):
            return dispatch_ins_resident(samples, reference, options, batcher)
        return _dispatch_matrix(samples, element_type, reference, options,
                                ed_cache, batcher)
    raise ValueError("unknown signature type {0}".format(element_type))


def ins_resident_enabled(options) -> bool:
    """Should INS clustering run the device-resident route?  Only under
    --edit_backend wavefront: "auto" stays on the native host batch, as in
    svim_tpu (whose auto opt-in exists for TPU runs only)."""
    return getattr(options, "edit_backend", "auto") == "wavefront"


def dispatch_ins_resident(samples, reference, options, batcher):
    """Device-resident INS route (--edit_backend wavefront;
    SVIM_clustering.py:64-77).

    Near-pair haplotype edit distances compute on the device (wavefront
    kernel; the host-proven band hints make each pow4 band bucket exact in
    one pass), the distance matrices assemble on the device from integer
    columns plus the still-resident edit distances, and the agglomeration is
    the matrix route's kernel.  Partitions with same-read duplicates take
    the classic matrix route under their original indices (exact dedup needs
    the f64 matrix); float32-ambiguous partitions rebuild the exact f64
    matrix at consume time from the fetched integer distances."""
    from svim_tpu_torch.ops.wavefront_kernel import (
        batched_edit_distance_resident,
    )

    device = batcher.device
    threshold = float(options.cluster_max_distance)
    pending = PendingDeviceClusters(samples, threshold, batcher)

    resident = []   # (index, sample, starts, spans, pairs_i, pairs_j, hints)
    classic_indices = []
    classic_samples = []
    for index, sample in enumerate(samples):
        reads = accel.read_index_array(sample)
        if len(np.unique(reads)) != len(reads):
            classic_indices.append(index)
            classic_samples.append(sample)
            continue
        starts, spans, pairs_i, pairs_j, hints = accel.ins_near_pairs(
            sample, options)
        resident.append((index, sample, starts, spans, pairs_i, pairs_j,
                         hints))
    if classic_samples:
        ed_cache = precompute_ins_edit_distances(classic_samples, reference,
                                                 options, device)
        _dispatch_matrix(classic_samples, "INS", reference, options,
                         ed_cache, batcher, indices=classic_indices,
                         pending=pending)
    if not resident:
        return pending

    # one flat haplotype-pair list across every resident partition, as
    # segments of one blob that the card assembles into strings
    pair_offsets = np.cumsum([0] + [len(entry[4]) for entry in resident])
    with timing.span("ins_pairs"):
        all_pairs = accel.ins_haplotype_segments(
            [(sample, starts, pairs_i, pairs_j)
             for _, sample, starts, _, pairs_i, pairs_j, _ in resident],
            reference)
        all_hints = np.concatenate([entry[6] for entry in resident])
    with timing.span("ins_distances"):
        ed_all = (batched_edit_distance_resident(all_pairs, all_hints, device)
                  if len(all_pairs) else torch.zeros(1, dtype=torch.int32,
                                                     device=device))
    batcher.extra_outputs[("ins_ed",)] = ed_all

    buckets = {}
    for slot, entry in enumerate(resident):
        buckets.setdefault(_bucket(len(entry[1])), []).append(slot)
    for pad, slots in sorted(buckets.items()):
        batch = _round_up_pow2(len(slots))
        col_starts = np.zeros((batch, pad), dtype=np.int32)
        col_spans = np.zeros((batch, pad), dtype=np.int32)
        valid = np.zeros((batch, pad), dtype=bool)
        bucket_pairs = []   # (partition row, i, j, flat ed index)
        for row, slot in enumerate(slots):
            index, sample, starts, spans, pairs_i, pairs_j, _hints = \
                resident[slot]
            n = len(sample)
            col_starts[row, :n] = starts
            col_spans[row, :n] = spans
            valid[row, :n] = True
            offset = int(pair_offsets[slot])
            for k in range(len(pairs_i)):
                bucket_pairs.append((row, int(pairs_i[k]), int(pairs_j[k]),
                                     offset + k))
            pending.resident.append((index, sample, pairs_i, pairs_j,
                                     offset, pad, row))
        pair_pad = _round_up_pow2(max(len(bucket_pairs), 1))
        # padding pairs scatter onto (0, 0, 0) — the masked diagonal
        pair_columns = np.zeros((4, pair_pad), dtype=np.int32)
        if bucket_pairs:
            pair_columns[:, :len(bucket_pairs)] = np.asarray(
                bucket_pairs, dtype=np.int32).T
        pair_part, pair_i, pair_j, gather = torch.from_numpy(
            pair_columns).to(device)
        matrices = ins_matrices_from_pairs(
            torch.from_numpy(col_starts).to(device),
            torch.from_numpy(col_spans).to(device), pair_part, pair_i, pair_j,
            ed_all[gather.long()],
            float(np.float32(options.position_distance_normalizer)),
            float(np.float32(options.edit_distance_normalizer)))
        batcher.extra_outputs[("ins_res", pad)] = agglomerate_batched(
            matrices, torch.from_numpy(valid).to(device))
    return pending


def _consume_resident(pending, fetched):
    """Accept kernel labelings the float32 guard clears; rebuild the EXACT
    f64 matrix from the fetched integer edit distances for the rest and run
    exact host linkage."""
    results = {}
    threshold = pending.threshold
    options = pending.batcher.options
    ed_all = fetched.get(("ins_ed",))
    for (index, sample, pairs_i, pairs_j, offset, pad, row) in pending.resident:
        merges_lo, merges_hi, heights, min_gap = fetched[("ins_res", pad)]
        if float(min_gap[row]) < TIE_EPS:
            labels = None
        else:
            labels = labels_from_merges(merges_lo[row], merges_hi[row],
                                        heights[row], len(sample), threshold)
        if labels is None:
            TELEMETRY.resident_relink += 1
            values = np.asarray(ed_all[offset:offset + len(pairs_i)],
                                dtype=np.int64)
            cache = accel.InsEditCache()
            cache.by_partition[id(sample)] = (pairs_i, pairs_j, values)
            # exact f64 matrix, identical op order to the host path (the
            # arrays route touches no reference window)
            matrix = accel.distance_matrix(sample, "INS", None, options,
                                           ed_cache=cache)
            reads = accel.read_index_array(sample)
            results[index] = DeviceClusterResult(_host_linkage_clusters(
                matrix, reads, sample, threshold, True), 0)
            continue
        TELEMETRY.device += 1
        results[index] = DeviceClusterResult(
            _group_survivors(sample, labels), 0)
    return results


def consume_partitions_device(pending: PendingDeviceClusters, fetched=None):
    """Reconstruct clusters from the batcher's fetched outputs ({bucket key:
    numpy arrays}, from one to_host over pending.batcher.device_outputs());
    fetched here when None.

    Returns {index: DeviceClusterResult}; clusters=None means float32 could
    not safely arbitrate that partition and the caller must re-run it
    through the exact host path."""
    if fetched is None:
        fetched = to_host(pending.batcher.device_outputs())
    if pending.fused:
        return _consume_fused(pending, fetched)
    results = _consume_matrix(pending, fetched)
    if pending.resident:
        results.update(_consume_resident(pending, fetched))
    return results


def cluster_candidates_device(samples: List[list], options, device):
    """Device agglomeration for the second DUP_INT candidate round
    (SVIM_clustering.py:306-372 — no dedup, no walls)."""
    pending = _dispatch_matrix(samples, "DUP_INT", None, options, None,
                               DeviceBatcher(options, device),
                               dedup_same_read=False)
    fetched = to_host(pending.batcher.device_outputs())
    return _consume_matrix(pending, fetched, wall_same_read=False)
