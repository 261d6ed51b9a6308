"""Struct-of-arrays signature tables: the COLLECT->CLUSTER fast path.

The reference pipeline materializes one Python object per signature
(SVSignature.py) and every downstream stage pays per-object attribute access:
sorting by get_key, gap-cut partitioning, subsampling, distance matrices.
The tables here keep each type's signatures as integer/byte columns in
emission order; partitioning, sampling, device dispatch, and consolidation
all run on the columns, and Signature objects are materialized lazily — only
when COMBINE or a writer actually touches a cluster's members.

Parity contract: `materialize(i)` reconstructs exactly the object the host
path would have built (same strings, same canonical BND ordering), and the
row order of each table equals the per-type order of the object path's
signature list — so partitions, random.seed(1524) subsampling, clustering,
and all downstream output are identical (tests/test_soa.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from svim_tpu_torch.signatures import (
    SignatureDeletion,
    SignatureDuplicationTandem,
    SignatureInsertion,
    SignatureInsertionFrom,
    SignatureInversion,
    SignatureTranslocation,
)

SIG_TYPES = ("DEL", "INS", "INV", "DUP_TAN", "DUP_INT", "BND")
INV_DIRECTIONS = ("left_fwd", "left_rev", "right_fwd", "right_rev", "all")
SOURCES = ("cigar", "suppl")

_INV_DIRECTION_CODE = {name: code for code, name in enumerate(INV_DIRECTIONS)}
_SOURCE_CODE = {name: code for code, name in enumerate(SOURCES)}


class StringPool:
    """Interned strings with integer codes (read names, contig names)."""

    __slots__ = ("names", "codes")

    def __init__(self):
        self.names: List[str] = []
        self.codes: Dict[str, int] = {}

    def code(self, name: str) -> int:
        code = self.codes.get(name)
        if code is None:
            code = self.codes.setdefault(name, len(self.names))
            self.names.append(name)
        return code

    def encode_all(self, names) -> np.ndarray:
        """Codes for a list of strings (one dict probe per element)."""
        code = self.code
        return np.fromiter((code(name) for name in names), dtype=np.int32,
                           count=len(names))

    def lexicographic_rank(self) -> np.ndarray:
        """rank[code] = rank of the string among all pooled strings — sorting
        by rank equals sorting by the string itself (partition key order)."""
        order = sorted(range(len(self.names)), key=self.names.__getitem__)
        rank = np.empty(len(self.names), dtype=np.int32)
        for position, code in enumerate(order):
            rank[code] = position
        return rank


def _bnd_from_canonical(contig1, pos1, direction1, contig2, pos2, direction2,
                        signature, read):
    """Build a SignatureTranslocation from already-canonical fields WITHOUT
    re-running the constructor's ordering swap (feeding canonical fields with
    pos1 == pos2 back through it would flip the directions again)."""
    obj = object.__new__(SignatureTranslocation)
    obj.contig, obj.start = contig1, pos1
    obj.direction1 = direction1
    obj.contig2, obj.pos2 = contig2, pos2
    obj.direction2 = direction2
    obj.end = pos1 + 1
    obj.signature, obj.read = signature, read
    return obj


class SignatureTable:
    """Columns for one signature type, in the object path's emission order."""

    __slots__ = ("type", "n", "contig_code", "start", "end", "read_code",
                 "source_code", "direction", "copies", "fully_covered",
                 "contig2_code", "pos2", "dir1", "dir2",
                 "seq_blob", "seq_off", "seq_len",
                 "contigs", "reads", "objects")

    def __init__(self, sig_type, n, contig_code, start, end, read_code,
                 source_code, contigs: StringPool, reads: StringPool,
                 direction=None, copies=None, fully_covered=None,
                 contig2_code=None, pos2=None, dir1=None, dir2=None,
                 seq_blob=None, seq_off=None, seq_len=None, objects=None):
        self.type = sig_type
        self.n = n
        self.contig_code = contig_code
        self.start = start
        self.end = end
        self.read_code = read_code
        self.source_code = source_code
        self.direction = direction
        self.copies = copies
        self.fully_covered = fully_covered
        self.contig2_code = contig2_code
        self.pos2 = pos2
        self.dir1 = dir1
        self.dir2 = dir2
        self.seq_blob = seq_blob
        self.seq_off = seq_off
        self.seq_len = seq_len
        self.contigs = contigs
        self.reads = reads
        # sparse cache: split-read signatures arrive as prebuilt objects and
        # everything else materializes on demand
        self.objects = objects if objects is not None else {}

    def __len__(self):
        return self.n

    def sequence(self, i: int) -> str:
        off = int(self.seq_off[i])
        return self.seq_blob[off:off + int(self.seq_len[i])].decode()

    def materialize(self, i: int):
        i = int(i)
        obj = self.objects.get(i)
        if obj is not None:
            return obj
        contig = self.contigs.names[int(self.contig_code[i])]
        start = int(self.start[i])
        end = int(self.end[i])
        source = SOURCES[int(self.source_code[i])]
        read = self.reads.names[int(self.read_code[i])]
        sig_type = self.type
        if sig_type == "DEL":
            obj = SignatureDeletion(contig, start, end, source, read)
        elif sig_type == "INS":
            obj = SignatureInsertion(contig, start, end, source, read,
                                     self.sequence(i))
        elif sig_type == "INV":
            obj = SignatureInversion(contig, start, end, source, read,
                                     INV_DIRECTIONS[int(self.direction[i])])
        elif sig_type == "DUP_TAN":
            obj = SignatureDuplicationTandem(
                contig, start, end, int(self.copies[i]),
                bool(self.fully_covered[i]), source, read)
        elif sig_type == "DUP_INT":
            obj = SignatureInsertionFrom(
                contig, start, end,
                self.contigs.names[int(self.contig2_code[i])],
                int(self.pos2[i]), source, read)
        elif sig_type == "BND":
            obj = _bnd_from_canonical(
                contig, start, "rev" if self.dir1[i] else "fwd",
                self.contigs.names[int(self.contig2_code[i])],
                int(self.pos2[i]), "rev" if self.dir2[i] else "fwd",
                source, read)
        else:
            raise ValueError("unknown signature type {0}".format(sig_type))
        self.objects[i] = obj
        return obj

    def materialize_list(self, indices):
        materialize = self.materialize
        return [materialize(i) for i in indices]


class LazyMembers:
    """Sequence view over signature rows; materializes Signature objects only
    when iterated/indexed (COMBINE, BED/VCF writers).

    Doubles as the CLUSTER stage's partition container: partitioning,
    subsampling, distance matrices, and device dispatch read the columns
    through `.table`/`.indices` (cluster/accel.py fast paths) and derive
    sub-views with `take()`, so no Signature object exists until a consumer
    actually touches a member."""

    __slots__ = ("table", "indices")

    def __init__(self, table: SignatureTable, indices):
        self.table = table
        self.indices = np.asarray(indices, dtype=np.int64)

    @property
    def type(self) -> str:
        return self.table.type

    def take(self, positions) -> "LazyMembers":
        """Sub-view at the given positions (within this view), in order."""
        return LazyMembers(self.table,
                           self.indices[np.asarray(positions, dtype=np.int64)])

    def column(self, name: str) -> np.ndarray:
        """This view's slice of a table column."""
        return getattr(self.table, name)[self.indices]

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, item):
        if isinstance(item, slice):
            return self.table.materialize_list(self.indices[item])
        return self.table.materialize(self.indices[item])

    def __iter__(self):
        materialize = self.table.materialize
        for i in self.indices:
            yield materialize(i)

    def __add__(self, other):
        return list(self) + list(other)

    def __radd__(self, other):
        return list(other) + list(self)

    def __eq__(self, other):
        if isinstance(other, (list, tuple, LazyMembers)):
            return list(self) == list(other)
        return NotImplemented

    def __repr__(self):
        return "LazyMembers({0} x {1})".format(len(self.indices),
                                               self.table.type)


class TableBuilder:
    """Accumulates per-type rows as chunks; finalize() restores the object
    path's emission order (stable sort by packed-row tag)."""

    __slots__ = ("sig_type", "chunks", "contigs", "reads")

    def __init__(self, sig_type, contigs: StringPool, reads: StringPool):
        self.sig_type = sig_type
        self.chunks = []   # (row_tags, columns dict, objects list | None)
        self.contigs = contigs
        self.reads = reads

    def add_chunk(self, row_tags, columns, objects=None):
        self.chunks.append((np.asarray(row_tags, dtype=np.int64), columns,
                            objects))

    def add_objects(self, row_tags, signatures):
        """Append prebuilt Signature objects (split-read path) — columns are
        extracted here so partitioning/clustering never touches the object."""
        if not signatures:
            return
        sig_type = self.sig_type
        n = len(signatures)
        columns = {
            "contig_code": np.fromiter(
                (self.contigs.code(s.contig) for s in signatures),
                dtype=np.int32, count=n),
            "start": np.fromiter((s.start for s in signatures),
                                 dtype=np.int64, count=n),
            "end": np.fromiter((s.end for s in signatures),
                               dtype=np.int64, count=n),
            "read_code": np.fromiter(
                (self.reads.code(s.read) for s in signatures),
                dtype=np.int32, count=n),
            "source_code": np.fromiter(
                (_SOURCE_CODE[s.signature] for s in signatures),
                dtype=np.int8, count=n),
        }
        if sig_type == "INS":
            blob = "".join(s.sequence for s in signatures).encode()
            lens = np.fromiter((len(s.sequence) for s in signatures),
                               dtype=np.int64, count=n)
            off = np.zeros(n, dtype=np.int64)
            np.cumsum(lens[:-1], out=off[1:])
            columns["seq_blob"] = blob
            columns["seq_off"] = off
            columns["seq_len"] = lens
        elif sig_type == "INV":
            columns["direction"] = np.fromiter(
                (_INV_DIRECTION_CODE[s.direction] for s in signatures),
                dtype=np.int8, count=n)
        elif sig_type == "DUP_TAN":
            columns["copies"] = np.fromiter((s.copies for s in signatures),
                                            dtype=np.int64, count=n)
            columns["fully_covered"] = np.fromiter(
                (bool(s.fully_covered) for s in signatures), dtype=bool,
                count=n)
        elif sig_type == "DUP_INT":
            columns["contig2_code"] = np.fromiter(
                (self.contigs.code(s.contig2) for s in signatures),
                dtype=np.int32, count=n)
            columns["pos2"] = np.fromiter((s.pos for s in signatures),
                                          dtype=np.int64, count=n)
        elif sig_type == "BND":
            columns["contig2_code"] = np.fromiter(
                (self.contigs.code(s.contig2) for s in signatures),
                dtype=np.int32, count=n)
            columns["pos2"] = np.fromiter((s.pos2 for s in signatures),
                                          dtype=np.int64, count=n)
            columns["dir1"] = np.fromiter(
                (s.direction1 == "rev" for s in signatures), dtype=bool,
                count=n)
            columns["dir2"] = np.fromiter(
                (s.direction2 == "rev" for s in signatures), dtype=bool,
                count=n)
        self.add_chunk(np.asarray(row_tags, dtype=np.int64), columns,
                       list(signatures))

    def finalize(self) -> SignatureTable:
        sig_type = self.sig_type
        if not self.chunks:
            empty64 = np.zeros(0, dtype=np.int64)
            kwargs = {}
            if sig_type == "INS":
                kwargs = {"seq_blob": b"", "seq_off": empty64,
                          "seq_len": empty64}
            elif sig_type == "INV":
                kwargs = {"direction": np.zeros(0, dtype=np.int8)}
            elif sig_type == "DUP_TAN":
                kwargs = {"copies": empty64,
                          "fully_covered": np.zeros(0, dtype=bool)}
            elif sig_type in ("DUP_INT", "BND"):
                kwargs = {"contig2_code": np.zeros(0, dtype=np.int32),
                          "pos2": empty64}
                if sig_type == "BND":
                    kwargs["dir1"] = np.zeros(0, dtype=bool)
                    kwargs["dir2"] = np.zeros(0, dtype=bool)
            return SignatureTable(sig_type, 0, np.zeros(0, dtype=np.int32),
                                  empty64, empty64,
                                  np.zeros(0, dtype=np.int32),
                                  np.zeros(0, dtype=np.int8),
                                  self.contigs, self.reads, **kwargs)
        row_tags = np.concatenate([tags for tags, _, _ in self.chunks])
        order = np.argsort(row_tags, kind="stable")
        n = len(row_tags)

        def gather(name, dtype=None):
            parts = [columns[name] for _, columns, _ in self.chunks]
            merged = np.concatenate(parts) if len(parts) > 1 else parts[0]
            if dtype is not None:
                merged = merged.astype(dtype, copy=False)
            return merged[order]

        kwargs = {}
        objects: Dict[int, object] = {}
        if sig_type == "INS":
            # blob offsets shift per chunk; the blob itself stays unsorted
            # (seq_off/seq_len are reordered with the rows)
            blob_parts = []
            off_parts = []
            base = 0
            for _, columns, _ in self.chunks:
                blob_parts.append(columns["seq_blob"])
                off_parts.append(columns["seq_off"] + base)
                base += len(columns["seq_blob"])
            merged_off = (np.concatenate(off_parts) if len(off_parts) > 1
                          else off_parts[0])
            kwargs["seq_blob"] = b"".join(blob_parts)
            kwargs["seq_off"] = merged_off[order]
            kwargs["seq_len"] = gather("seq_len")
        elif sig_type == "INV":
            kwargs["direction"] = gather("direction")
        elif sig_type == "DUP_TAN":
            kwargs["copies"] = gather("copies")
            kwargs["fully_covered"] = gather("fully_covered")
        elif sig_type in ("DUP_INT", "BND"):
            kwargs["contig2_code"] = gather("contig2_code")
            kwargs["pos2"] = gather("pos2")
            if sig_type == "BND":
                kwargs["dir1"] = gather("dir1")
                kwargs["dir2"] = gather("dir2")

        # map prebuilt objects through the sort (inverse permutation)
        position_of = np.empty(n, dtype=np.int64)
        position_of[order] = np.arange(n)
        base = 0
        for tags, _, chunk_objects in self.chunks:
            if chunk_objects is not None:
                for local, obj in enumerate(chunk_objects):
                    objects[int(position_of[base + local])] = obj
            base += len(tags)

        return SignatureTable(
            sig_type, n, gather("contig_code"),
            gather("start", np.int64), gather("end", np.int64),
            gather("read_code"), gather("source_code"),
            self.contigs, self.reads, objects=objects, **kwargs)


class SignatureSoA:
    """All six types' tables from one COLLECT run (plus shared pools).

    `cluster_memo` optionally carries mid-scan incremental clustering results
    (cluster/incremental.py): {(type, indices bytes) -> cluster index arrays},
    keyed by exact partition content so CLUSTER can only ever reuse a result
    whose inputs match the final table bit-for-bit."""

    __slots__ = ("tables", "contigs", "reads", "cluster_memo")

    def __init__(self, tables: Dict[str, SignatureTable], contigs: StringPool,
                 reads: StringPool, cluster_memo=None):
        self.tables = tables
        self.contigs = contigs
        self.reads = reads
        self.cluster_memo = cluster_memo

    def count(self, sig_type: str) -> int:
        table = self.tables.get(sig_type)
        return table.n if table is not None else 0

    def total(self) -> int:
        return sum(table.n for table in self.tables.values())

    def materialize_all(self) -> list:
        """Flat per-type-interleaved object list in the object path's order
        (for differential tests and object-path consumers).

        Note: the object path's sv_signatures interleaves types by emission
        row; reconstruct that by merging on the original row order.  Tables
        drop row tags at finalize, so this returns signatures grouped by type
        in table order — callers needing the exact interleaved order should
        use the object path instead."""
        out = []
        for sig_type in SIG_TYPES:
            table = self.tables.get(sig_type)
            if table is not None:
                out.extend(table.materialize_list(range(table.n)))
        return out


def soa_from_signatures(signatures) -> SignatureSoA:
    """Build a SignatureSoA from an object list (testing / host-path
    interop).  Per-type row order = order within `signatures`."""
    contigs = StringPool()
    reads = StringPool()
    builders = {sig_type: TableBuilder(sig_type, contigs, reads)
                for sig_type in SIG_TYPES}
    by_type = {sig_type: [] for sig_type in SIG_TYPES}
    for position, signature in enumerate(signatures):
        by_type[signature.type].append((position, signature))
    for sig_type, rows in by_type.items():
        if rows:
            builders[sig_type].add_objects([tag for tag, _ in rows],
                                           [sig for _, sig in rows])
    return SignatureSoA(
        {sig_type: builder.finalize()
         for sig_type, builder in builders.items()}, contigs, reads)


_CONCAT_EXTRA = {
    "DEL": (),
    "INS": ("seq_off", "seq_len"),
    "INV": ("direction",),
    "DUP_TAN": ("copies", "fully_covered"),
    "DUP_INT": ("contig2_code", "pos2"),
    "BND": ("contig2_code", "pos2", "dir1", "dir2"),
}


def concat_soa(soas) -> SignatureSoA:
    """Concatenate SignatureSoA tables in serial input order.

    Mirrors the reference's list-input semantics (svim:68-82:
    sv_signatures.extend(...) per file, then split by type) — the per-type
    row order is file order, within-file emission order.  String-pool codes
    are remapped into merged pools; cached Signature objects keep their
    rows."""
    soas = [soa for soa in soas if soa is not None]
    if not soas:
        raise ValueError("concat_soa needs at least one table set")
    if len(soas) == 1:
        return soas[0]
    contigs = StringPool()
    reads = StringPool()
    remaps = []
    for soa in soas:
        remaps.append((
            np.asarray([contigs.code(name) for name in soa.contigs.names],
                       dtype=np.int32)
            if soa.contigs.names else np.zeros(0, dtype=np.int32),
            np.asarray([reads.code(name) for name in soa.reads.names],
                       dtype=np.int32)
            if soa.reads.names else np.zeros(0, dtype=np.int32)))

    tables = {}
    for sig_type in SIG_TYPES:
        parts = [(soa.tables.get(sig_type), cmap, rmap)
                 for soa, (cmap, rmap) in zip(soas, remaps)
                 if soa.tables.get(sig_type) is not None
                 and soa.tables[sig_type].n > 0]
        if not parts:
            tables[sig_type] = TableBuilder(sig_type, contigs,
                                            reads).finalize()
            continue
        merged = {
            "contig_code": np.concatenate(
                [cmap[t.contig_code] for t, cmap, _ in parts]),
            "start": np.concatenate([t.start for t, _, _ in parts]),
            "end": np.concatenate([t.end for t, _, _ in parts]),
            "read_code": np.concatenate(
                [rmap[t.read_code] for t, _, rmap in parts]),
            "source_code": np.concatenate(
                [t.source_code for t, _, _ in parts]),
        }
        kwargs = {}
        extras = _CONCAT_EXTRA[sig_type]
        for name in extras:
            if name == "contig2_code":
                kwargs[name] = np.concatenate(
                    [cmap[t.contig2_code] for t, cmap, _ in parts])
            elif name != "seq_off":
                kwargs[name] = np.concatenate(
                    [getattr(t, name) for t, _, _ in parts])
        if sig_type == "INS":
            blob_parts = []
            off_parts = []
            base = 0
            for t, _, _ in parts:
                blob_parts.append(t.seq_blob)
                off_parts.append(t.seq_off + base)
                base += len(t.seq_blob)
            kwargs["seq_blob"] = b"".join(blob_parts)
            kwargs["seq_off"] = np.concatenate(off_parts)
        objects = {}
        base = 0
        for t, _, _ in parts:
            for row, obj in t.objects.items():
                objects[base + int(row)] = obj
            base += t.n
        tables[sig_type] = SignatureTable(
            sig_type, len(merged["start"]), merged["contig_code"],
            merged["start"], merged["end"], merged["read_code"],
            merged["source_code"], contigs, reads, objects=objects,
            **kwargs)
    return SignatureSoA(tables, contigs, reads)
