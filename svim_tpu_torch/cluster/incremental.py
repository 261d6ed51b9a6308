"""Mid-scan incremental clustering: overlap CLUSTER with the BAM scan.

The reference clusters strictly after COLLECT finishes (svim/svim:131 runs
only when SVIM_COLLECT.py:132-167 has consumed the whole file).  On a
coordinate-sorted input, though, most partitions are already complete long
before the scan ends: a partition whose last anchor position lies more than
partition_max_distance behind the scan frontier can only gain members from
SPLIT-READ signatures (emitted at their primary's position, possibly far
from the signature's own locus) — never from CIGAR-indel signatures, whose
positions are bounded below by the emitting record's position.

This module therefore clusters *predicted-final* partitions WHILE the native
scan session's background threads still inflate the remainder of the file,
and records the results in a content-addressed memo:

    {(sig type, partition row-index bytes) -> (cluster index array, ...)}

The CLUSTER stage (cluster/cluster.py) reuses a memo entry only when the
final partition's exact ordered member-index tuple matches the key, so a
mispredicted partition (late split-read member, bridged gap) simply misses
the memo and is recomputed through the unchanged exact path — predictions
can be WRONG but never UNSOUND.  Output is bit-identical with the feature
off (tests/test_torch_incremental.py).

Copy of the JAX package's cluster/incremental.py with the device passed in
and one deliberate difference: `observe` lets every error through (see its
docstring), where the original disables itself after any exception.

Index stability: TableBuilder.finalize() orders rows by globally increasing
row tags, and every future chunk carries strictly larger tags than all
already-consumed ones, so a row's index in a mid-scan prefix finalize equals
its index in the final table (sigtable.py:312-390).

Partitions larger than MAX_PARTITION_SIZE are never memoized: their
subsampling consumes the shared seed(1524) RNG stream in partition order
(SVIM_clustering.py:129-134), which is only known once every partition is.
"""

from __future__ import annotations

import logging

import numpy as np

from svim_tpu_torch.cluster.cluster import MAX_PARTITION_SIZE, clusters_from_partitions
from svim_tpu_torch.cluster.partition import form_partitions_table


def incremental_enabled(options) -> bool:
    """Mid-scan clustering applies to single-process runs with a genome (the
    INS distance needs reference windows); distributed ranks exchange and
    re-merge tables, which invalidates local row indices."""
    return (getattr(options, "incremental_cluster", "auto") != "off"
            and not getattr(options, "distributed", False)
            and getattr(options, "genome", None) is not None)


class IncrementalClusterer:
    """Observes the accumulating SoAState between scan batches and clusters
    partitions that are final behind the frontier.  All work runs on the
    consumer thread while the scan session's inflate+walk threads own the
    file — the cluster cost rides inside the scan's wall time."""

    __slots__ = ("options", "device", "get_tid", "reference", "memo",
                 "rows_seen", "tid_of_code", "computed_partitions")

    def __init__(self, options, header, device):
        self.options = options
        self.device = device           # torch.device of the CLUSTER ops
        self.get_tid = header.get_tid
        self.reference = None          # FastaFile, opened lazily
        self.memo = {}                 # (type, key bytes) -> tuple of index arrays
        self.rows_seen = {}            # type -> rows covered by the last observe
        self.tid_of_code = {}          # StringPool code -> BAM tid (or -1)
        self.computed_partitions = 0

    def _tid(self, contigs, code: int):
        tid = self.tid_of_code.get(code)
        if tid is None:
            tid = self.get_tid(contigs.names[code])
            self.tid_of_code[code] = -1 if tid is None else tid
        return tid

    def _fasta(self):
        if self.reference is None:
            from svim_tpu_torch.io.fasta import FastaFile
            self.reference = FastaFile(self.options.genome)
        return self.reference

    def observe(self, state, frontier_tid: int, frontier_pos: int):
        """Cluster newly-final partitions of every type.  `frontier` is the
        position of the first row the consumer has NOT yet folded into
        `state` — every future CIGAR-indel signature lies at or beyond it.

        Nothing is caught here: an error of a device op, of a kernel's build
        or launch, or of the host code around them ends COLLECT.  The
        clustering this runs is the CLUSTER stage's own, so whatever fails
        here would fail there too, and carrying on without the memo would
        hide a broken kernel behind a byte-equal VCF."""
        max_distance = self.options.partition_max_distance
        todo = []   # (memo key, LazyMembers partition)
        for sig_type, builder in state.builders.items():
            n_rows = sum(len(tags) for tags, _, _ in builder.chunks)
            if not n_rows or n_rows == self.rows_seen.get(sig_type):
                continue
            self.rows_seen[sig_type] = n_rows
            table = builder.finalize()
            if sig_type == "DUP_INT":
                contig_col, anchor_col = table.contig2_code, table.pos2
            elif sig_type in ("INS", "BND"):
                contig_col, anchor_col = table.contig_code, table.start
            else:   # DEL / INV / DUP_TAN sort and gap on end
                contig_col, anchor_col = table.contig_code, table.end
            for partition in form_partitions_table(table, max_distance):
                indices = partition.indices
                if not 2 <= len(indices) <= MAX_PARTITION_SIZE:
                    continue
                tid = self._tid(table.contigs, int(contig_col[indices[0]]))
                if tid < 0:
                    continue
                if tid > frontier_tid or (
                        tid == frontier_tid
                        and int(anchor_col[indices].max()) + max_distance
                        >= frontier_pos):
                    continue
                key = (sig_type, indices.tobytes())
                if key not in self.memo:
                    todo.append((key, partition))
        # one clusters_from_partitions call per type: row indices are
        # per-type table coordinates, and the dispatch half keys its routes
        # off the first partition's type
        by_type = {}
        for key, partition in todo:
            by_type.setdefault(key[0], []).append((key, partition))
        for typed_todo in by_type.values():
            self._cluster(typed_todo)

    def _cluster(self, todo):
        """Run the ordinary per-partition pipeline over the predicted-final
        same-type partitions and file each partition's ordered cluster-index
        arrays under its content key."""
        clusters = clusters_from_partitions([part for _, part in todo],
                                            self._fasta(), self.options,
                                            self.device)
        owner = {}
        for position, (_key, partition) in enumerate(todo):
            for index in partition.indices.tolist():
                owner[index] = position
        grouped = [[] for _ in todo]
        for cluster in clusters:
            indices = getattr(cluster, "indices", None)
            if indices is None:  # pragma: no cover - table inputs yield views
                return  # index-less cluster: nothing attributable this round
            grouped[owner[int(indices[0])]].append(
                np.asarray(indices, dtype=np.int64))
        for (key, _partition), arrays in zip(todo, grouped):
            if arrays:
                self.memo[key] = tuple(arrays)
                self.computed_partitions += 1

    def finish(self):
        """Close the reference handle; return the memo (None when empty)."""
        if self.reference is not None:
            self.reference.close()
            self.reference = None
        if self.memo:
            logging.debug("incremental clustering computed %d partitions "
                          "mid-scan", self.computed_partitions)
            return self.memo
        return None
