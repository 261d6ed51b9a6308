"""Multi-process execution: torch.distributed wiring, per-rank BAM-range
ingestion, and fixed-dtype table exchange.

Counterpart of svim_tpu/parallel/multihost.py:
  * every process joins one Gloo group (coordinator from SVIM_COORDINATOR /
    SVIM_NUM_PROCESSES / SVIM_PROCESS_ID); the group only ever carries host
    bytes, so it is Gloo over CPU tensors whatever device the ranks compute
    on, and several ranks may share one card;
  * each process ingests its contiguous BAM block range
    (collect.packed.collect_soa_pipelined_range) and runs the SAME local
    COLLECT passes as the single-process path on its device;
  * per-process signature SoA tables and genotyping columns are exchanged
    with ONE allgather_blobs round as fixed-dtype numpy columns (int/bool
    arrays, one sequence blob, string pools as joined byte blobs); NO pickled
    Python objects cross the wire.  They are concatenated in rank order:
    ranges are contiguous file slices, so rank order IS the serial file
    order and every downstream stage sees exactly the single-process stream;
  * CLUSTER shards per-partition linkage across processes
    (parallel/cluster_shard.py); COMBINE shards the insertion consensus
    (exchange_consensus_outcomes) and runs the rest redundantly (cheap,
    deterministic); only process 0 writes.

The reference has no multi-process analog (README.rst:73 single-threaded);
the merge semantics preserved here: COLLECT is per-read independent,
clustering needs each (type, contig) partition co-located, COMBINE needs the
global cross-type view.
"""

from __future__ import annotations

import datetime
import io
import logging
import os
import time

import numpy as np
import torch

from svim_tpu_torch.sigtable import (
    SIG_TYPES,
    SignatureSoA,
    SignatureTable,
    StringPool,
)

# A collective whose peer died fails after this long instead of hanging.  It
# must outlast the skew between the fastest and the slowest rank's COLLECT.
GROUP_TIMEOUT_SECONDS = 1800


def env_process_info():
    """(coordinator, num_processes, process_id) from the environment, or
    None when not launched as part of a multi-process job."""
    coordinator = os.environ.get("SVIM_COORDINATOR")
    num_processes = os.environ.get("SVIM_NUM_PROCESSES")
    process_id = os.environ.get("SVIM_PROCESS_ID")
    if coordinator is None or num_processes is None or process_id is None:
        return None
    return coordinator, int(num_processes), int(process_id)


def initialize_from_env() -> int:
    """Join the Gloo group the SVIM_* variables describe; returns this
    process's rank (0 for single-process runs, which join nothing)."""
    import torch.distributed as dist

    info = env_process_info()
    if info is None:
        return 0
    coordinator, num_processes, process_id = info
    if num_processes <= 1:
        return 0
    if not dist.is_initialized():
        dist.init_process_group(
            "gloo", init_method="tcp://{0}".format(coordinator),
            world_size=num_processes, rank=process_id,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_SECONDS))
    return process_id


def shutdown() -> None:
    """Leave the group initialize_from_env joined (a no-op without one)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _group():
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist
    return None


def process_index() -> int:
    dist = _group()
    return dist.get_rank() if dist is not None else 0


def process_count() -> int:
    dist = _group()
    return dist.get_world_size() if dist is not None else 1


class ExchangeStats:
    """Bytes shipped through allgather_blobs."""

    __slots__ = ("sent", "received", "rounds")

    def __init__(self):
        self.reset()

    def reset(self):
        self.sent = 0
        self.received = 0
        self.rounds = 0


EXCHANGE = ExchangeStats()


def allgather_blobs(blob: bytes):
    """All-to-all exchange of one opaque byte blob per process; returns the
    list of every process's blob in rank order (two collective rounds over
    CPU tensors: an int64 length gather, then the padded uint8 payload
    gather)."""
    dist = _group()
    if dist is None or dist.get_world_size() == 1:
        return [blob]
    world = dist.get_world_size()
    length = torch.from_numpy(np.asarray([len(blob)], dtype=np.int64))
    lengths = [torch.zeros(1, dtype=torch.int64) for _ in range(world)]
    dist.all_gather(lengths, length)
    lengths = [int(item[0]) for item in lengths]
    pad = max(max(lengths), 1)
    padded = np.zeros(pad, dtype=np.uint8)
    if blob:
        padded[:len(blob)] = np.frombuffer(blob, dtype=np.uint8)
    gathered = [torch.zeros(pad, dtype=torch.uint8) for _ in range(world)]
    dist.all_gather(gathered, torch.from_numpy(padded))
    EXCHANGE.sent += len(blob)
    EXCHANGE.received += sum(lengths)
    EXCHANGE.rounds += 1
    return [gathered[rank].numpy()[:lengths[rank]].tobytes()
            for rank in range(world)]


def arrays_to_bytes(arrays) -> bytes:
    """Serialize a {name: numpy array} dict WITHOUT pickle (fixed dtypes
    only; np.savez rejects object arrays under allow_pickle=False)."""
    buffer = io.BytesIO()
    np.savez(buffer, **arrays)
    return buffer.getvalue()


def bytes_to_arrays(blob: bytes):
    return dict(np.load(io.BytesIO(blob), allow_pickle=False))


def allgather_arrays(arrays):
    """One collective round shipping a {name: array} dict per process;
    returns every process's dict in rank order."""
    return [bytes_to_arrays(blob)
            for blob in allgather_blobs(arrays_to_bytes(arrays))]


# ---------------------------------------------------------------------------
# Signature SoA <-> fixed-dtype arrays
# ---------------------------------------------------------------------------

_BASE_COLUMNS = ("contig_code", "start", "end", "read_code", "source_code")
_EXTRA_COLUMNS = {
    "DEL": (),
    "INS": ("seq_off", "seq_len"),
    "INV": ("direction",),
    "DUP_TAN": ("copies", "fully_covered"),
    "DUP_INT": ("contig2_code", "pos2"),
    "BND": ("contig2_code", "pos2", "dir1", "dir2"),
}


def _encode_names(names):
    """(uint8 blob, int32 lengths) — numpy unicode arrays cost 4 bytes per
    char at the MAX name length; a joined byte blob is ~10x smaller for
    typical read names."""
    blob = "\x00".join(names).encode() if names else b""
    lengths = np.asarray([len(name.encode()) for name in names],
                         dtype=np.int32)
    return np.frombuffer(blob, dtype=np.uint8), lengths


def _decode_names(blob, lengths):
    if not len(lengths):
        return []
    text = blob.tobytes().decode()
    return text.split("\x00")


def soa_to_arrays(soa: SignatureSoA, twins, geno_columns) -> dict:
    """Flatten one rank's COLLECT output into fixed-dtype arrays.

    twins (all_bnds SignatureTranslocation objects, already canonical) are
    encoded against the SAME pools as the tables; geno_columns is the
    genotyping column dict from _table_genotype_columns."""
    arrays = {}
    for sig_type in SIG_TYPES:
        table = soa.tables.get(sig_type)
        if table is None or table.n == 0:
            arrays["{0}.n".format(sig_type)] = np.asarray([0], dtype=np.int64)
            continue
        arrays["{0}.n".format(sig_type)] = np.asarray([table.n],
                                                      dtype=np.int64)
        for column in _BASE_COLUMNS + _EXTRA_COLUMNS[sig_type]:
            arrays["{0}.{1}".format(sig_type, column)] = getattr(table, column)
        if sig_type == "INS":
            arrays["INS.seq_blob"] = np.frombuffer(table.seq_blob,
                                                   dtype=np.uint8)
    # all_bnds twins as columns (pool codes may grow the pools here — codes
    # already assigned to table rows are unaffected)
    arrays["twin.contig_code"] = np.asarray(
        [soa.contigs.code(t.contig) for t in twins], dtype=np.int32)
    arrays["twin.pos1"] = np.asarray([t.start for t in twins], dtype=np.int64)
    arrays["twin.dir1"] = np.asarray([t.direction1 == "rev" for t in twins],
                                     dtype=bool)
    arrays["twin.contig2_code"] = np.asarray(
        [soa.contigs.code(t.contig2) for t in twins], dtype=np.int32)
    arrays["twin.pos2"] = np.asarray([t.pos2 for t in twins], dtype=np.int64)
    arrays["twin.dir2"] = np.asarray([t.direction2 == "rev" for t in twins],
                                     dtype=bool)
    arrays["twin.source"] = np.asarray(
        [t.signature == "suppl" for t in twins], dtype=bool)
    arrays["twin.read_code"] = np.asarray(
        [soa.reads.code(t.read) for t in twins], dtype=np.int32)
    # pools AFTER twin encoding (they may have appended)
    (arrays["pool.contigs"], arrays["pool.contigs_len"]) = _encode_names(
        soa.contigs.names)
    (arrays["pool.reads"], arrays["pool.reads_len"]) = _encode_names(
        soa.reads.names)
    for key in ("ref_id", "ref_start", "ref_end", "mapq", "flag"):
        arrays["geno.{0}".format(key)] = geno_columns[key]
    (arrays["geno.names"], arrays["geno.names_len"]) = _encode_names(
        geno_columns["names"])
    return arrays


def merge_gathered_soa(parts):
    """Rebuild the GLOBAL (SignatureSoA, twins, genotype columns) from every
    rank's arrays, in rank order (= serial file order)."""
    from svim_tpu_torch.sigtable import _bnd_from_canonical

    contigs = StringPool()
    reads = StringPool()
    remaps = []
    for part in parts:
        contig_names = _decode_names(part["pool.contigs"],
                                     part["pool.contigs_len"])
        read_names = _decode_names(part["pool.reads"],
                                   part["pool.reads_len"])
        remaps.append((
            np.asarray([contigs.code(name) for name in contig_names],
                       dtype=np.int32)
            if contig_names else np.zeros(0, dtype=np.int32),
            np.asarray([reads.code(name) for name in read_names],
                       dtype=np.int32)
            if read_names else np.zeros(0, dtype=np.int32)))

    tables = {}
    for sig_type in SIG_TYPES:
        chunks = []   # (part, columns dict with remapped codes)
        for part, (contig_remap, read_remap) in zip(parts, remaps):
            if int(part["{0}.n".format(sig_type)][0]) == 0:
                continue
            columns = {name: part["{0}.{1}".format(sig_type, name)]
                       for name in _BASE_COLUMNS + _EXTRA_COLUMNS[sig_type]}
            columns["contig_code"] = contig_remap[columns["contig_code"]]
            columns["read_code"] = read_remap[columns["read_code"]]
            if "contig2_code" in columns:
                columns["contig2_code"] = contig_remap[columns["contig2_code"]]
            if sig_type == "INS":
                columns["seq_blob"] = part["INS.seq_blob"].tobytes()
            chunks.append(columns)
        if not chunks:
            tables[sig_type] = None
            continue
        merged = {}
        for name in _BASE_COLUMNS + _EXTRA_COLUMNS[sig_type]:
            merged[name] = np.concatenate([c[name] for c in chunks])
        kwargs = {name: merged[name] for name in _EXTRA_COLUMNS[sig_type]}
        if sig_type == "INS":
            # blob offsets shift by the concatenation base per rank
            blob_parts = []
            offsets = []
            base = 0
            for c in chunks:
                blob_parts.append(c["seq_blob"])
                offsets.append(c["seq_off"] + base)
                base += len(c["seq_blob"])
            kwargs["seq_blob"] = b"".join(blob_parts)
            kwargs["seq_off"] = np.concatenate(offsets)
        n = len(merged["start"])
        tables[sig_type] = SignatureTable(
            sig_type, n, merged["contig_code"],
            merged["start"], merged["end"], merged["read_code"],
            merged["source_code"], contigs, reads, **kwargs)
    # drop empty types the same way SoAState.finalize would keep them:
    # SignatureSoA.count handles missing tables, but cluster_sv_signatures
    # reads soa.tables.get(key) — build empty tables for uniformity
    from svim_tpu_torch.sigtable import TableBuilder
    for sig_type in SIG_TYPES:
        if tables[sig_type] is None:
            tables[sig_type] = TableBuilder(sig_type, contigs,
                                            reads).finalize()
    soa = SignatureSoA(tables, contigs, reads)

    twins = []
    for part, (contig_remap, read_remap) in zip(parts, remaps):
        count = len(part["twin.pos1"])
        for i in range(count):
            twins.append(_bnd_from_canonical(
                contigs.names[int(contig_remap[int(part["twin.contig_code"][i])])],
                int(part["twin.pos1"][i]),
                "rev" if part["twin.dir1"][i] else "fwd",
                contigs.names[int(contig_remap[int(part["twin.contig2_code"][i])])],
                int(part["twin.pos2"][i]),
                "rev" if part["twin.dir2"][i] else "fwd",
                "suppl" if part["twin.source"][i] else "cigar",
                reads.names[int(read_remap[int(part["twin.read_code"][i])])]))

    names = []
    for part in parts:
        names.extend(_decode_names(part["geno.names"],
                                   part["geno.names_len"]))
    merged_geno = MergedGenotypeTable(
        ref_id=np.concatenate([p["geno.ref_id"] for p in parts]),
        ref_start=np.concatenate([p["geno.ref_start"] for p in parts]),
        ref_end=np.concatenate([p["geno.ref_end"] for p in parts]),
        mapq=np.concatenate([p["geno.mapq"] for p in parts]),
        flag=np.concatenate([p["geno.flag"] for p in parts]),
        names=names)
    return soa, twins, merged_geno


class MergedGenotypeTable:
    """Global alignment-interval table assembled from per-process columns;
    fetch/column-compatible with genotype_packed_multi (ref_id/ref_start/
    ref_end/mapq/flag columns + names list)."""

    def __init__(self, ref_id, ref_start, ref_end, mapq, flag, names):
        self.ref_id = ref_id
        self.ref_start = ref_start
        self.ref_end = ref_end
        self.mapq = mapq
        self.flag = flag
        self.names = names


class MergedAlignmentIndex:
    """aln_file stand-in for the distributed pipeline: header surface +
    packed table for genotyping (mirrors io.packed_fetch.PackedAlignmentIndex
    without re-sorting, which the genotyper does itself)."""

    def __init__(self, table: MergedGenotypeTable, header):
        self.packed = table
        self.header = header

    @property
    def references(self):
        return self.header.references

    @property
    def lengths(self):
        return self.header.lengths


def _table_genotype_columns(table):
    """Genotype columns from a pipelined-scan GenotypeTable.  The scan
    session already dropped unmapped/secondary/sub-mapq rows, so the flag
    column is uniformly zero (the genotyper's eligibility re-filter keeps
    every row either way)."""
    n = len(table.ref_id)
    return {
        "ref_id": np.asarray(table.ref_id, dtype=np.int32),
        "ref_start": np.asarray(table.ref_start, dtype=np.int64),
        "ref_end": np.asarray(table.ref_end, dtype=np.int64),
        "mapq": np.asarray(table.mapq, dtype=np.int32),
        "flag": np.zeros(n, dtype=np.int32),
        "names": list(table.names),
    }


def exchange_consensus_outcomes(local_outcomes):
    """All-gather per-rank insertion-consensus outcomes (COMBINE sharding).

    `local_outcomes` maps eligible-cluster index -> (status, result) where
    result is (realigned_start, realigned_size, consensus_str) when status
    is 0, else ().  Every rank computes a disjoint index subset
    (index % world == rank); the gather hands all ranks the identical
    merged dict, so the rest of COMBINE stays byte-deterministic.  Fixed
    dtypes only — same transport as the signature exchange."""
    indices = sorted(local_outcomes)
    statuses = np.array([local_outcomes[i][0] for i in indices],
                        dtype=np.int8)
    starts = np.zeros(len(indices), dtype=np.int64)
    sizes = np.zeros(len(indices), dtype=np.int64)
    seqs = []
    for row, index in enumerate(indices):
        status, result = local_outcomes[index]
        if status == 0:
            starts[row], sizes[row], sequence = result
            seqs.append(sequence)
        else:
            seqs.append("")
    blob = "".join(seqs).encode()
    arrays = {
        "index": np.asarray(indices, dtype=np.int64),
        "status": statuses,
        "start": starts,
        "size": sizes,
        "seq_len": np.array([len(s) for s in seqs], dtype=np.int64),
        "seq_blob": np.frombuffer(blob, dtype=np.uint8),
    }
    merged = {}
    for part in allgather_arrays(arrays):
        offsets = np.concatenate([[0], np.cumsum(part["seq_len"])])
        part_blob = part["seq_blob"].tobytes()
        for row, index in enumerate(part["index"]):
            status = int(part["status"][row])
            if status == 0:
                sequence = part_blob[offsets[row]:offsets[row + 1]].decode()
                merged[int(index)] = (0, (int(part["start"][row]),
                                          int(part["size"][row]), sequence))
            else:
                merged[int(index)] = (status, ())
    return merged


def collect_distributed(options, device):
    """Per-process ranged COLLECT on `device` + global fixed-dtype exchange.

    Returns (MergedAlignmentIndex, SignatureSoA, twins) where the SoA
    equals the single-process COLLECT output on the whole file."""
    from svim_tpu_torch.collect.packed import collect_soa_pipelined_range

    rank = process_index()
    world = process_count()
    t0 = time.perf_counter()
    header, table, local_soa, local_twins = collect_soa_pipelined_range(
        options.bam_file, options, world, rank, device)
    geno_columns = _table_genotype_columns(table)
    t_scan = time.perf_counter()
    logging.info("Process {0}/{1}: collected {2} local signatures from "
                 "{3} records".format(rank, world, local_soa.total(),
                                      len(table.ref_id)))

    arrays = soa_to_arrays(local_soa, local_twins, geno_columns)
    t_pack = time.perf_counter()
    gathered = allgather_arrays(arrays)
    t_gather = time.perf_counter()
    soa, twins, merged = merge_gathered_soa(gathered)
    t_merge = time.perf_counter()
    logging.info("Exchange: {0} bytes sent, {1} bytes received over {2} "
                 "gather rounds (fixed-dtype columns, no pickle)".format(
                     EXCHANGE.sent, EXCHANGE.received, EXCHANGE.rounds))
    logging.info("Distributed collect phases: scan {0:.2f}s, pack {1:.2f}s, "
                 "gather {2:.2f}s (straggler wait included), merge {3:.2f}s"
                 .format(t_scan - t0, t_pack - t_scan, t_gather - t_pack,
                         t_merge - t_gather))
    return MergedAlignmentIndex(merged, header), soa, twins
