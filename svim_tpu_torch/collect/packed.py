"""Array-path COLLECT on the port's device: packed batches -> kernels ->
signature tables.

Counterpart of svim_tpu/collect/packed.py for every input the `alignment`
mode takes:
  * a coordinate-sorted BGZF BAM up to STREAMING_THRESHOLD_BYTES: the
    one-shot pipelined path (collect_soa_from_bam -> collect_soa_pipelined),
    where the native scan session inflates and walks the BAM in background
    threads while this thread packs each delivered row range and runs its
    COLLECT + split-read classify passes on `device`;
  * a larger BAM, or --stream_input: the streaming scanner
    (io.bamstream.collect_streaming), batch by batch into one SoAState;
  * SAM text (collect_signatures_packed) and queryname-sorted input
    (collect_signatures_packed_querysorted): parsed records packed into one
    batch, Signature objects out.
The emitters that turn fetched events into signatures (_emit_*, SoAState,
_parse_sa_segments) are svim_tpu's, copied, so row order and contents are
identical.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List

import numpy as np
import torch

from svim_tpu_torch.collect.collect import bam_iterator, retrieve_other_alignments
from svim_tpu_torch.collect.inter import (
    _Emitter,
    _merge_tandem_runs,
    _pair_translocations,
    analyze_read_segments,
)
from svim_tpu_torch.io import cigar as cigar_utils
from svim_tpu_torch.io.bamstream import GenotypeTable
from svim_tpu_torch.io.packing import (
    FSECONDARY,
    FSUPPLEMENTARY,
    FUNMAP,
    pack_alignments,
)
from svim_tpu_torch.signatures import (
    SignatureDeletion,
    SignatureInsertion,
    SignatureInversion,
    SignatureTranslocation,
)
from svim_tpu_torch.state import packed_to_torch, to_host
from svim_tpu_torch.utils import timing

_INV_DIRECTIONS = ("left_fwd", "left_rev", "right_fwd", "right_rev")
MAX_SEGMENTS = 64  # reads with more alignments fall back to the host analyzer
# each re-run of _consume_collect: (the batch's true event count, the table
# size it overflowed, the table size of the re-run)
RERUNS = []


class _SATagSegment:
    """A supplementary alignment reconstructed from one SA-tag entry,
    carrying just the geometry the pair classifier needs."""

    __slots__ = ("ref_id", "ref_start", "ref_end", "mapq", "is_reverse",
                 "q_start", "q_end")

    def __init__(self, ref_id, ref_start, cigar_string, mapq, is_reverse):
        tuples = cigar_utils.parse_cigar(cigar_string)
        (_bases, _ops, ref_len, _q_len, read_length,
         qa_start, qa_end) = cigar_utils.derived_stats(tuples)
        self.ref_id = ref_id
        self.ref_start = ref_start
        self.ref_end = ref_start + ref_len
        self.mapq = mapq
        self.is_reverse = is_reverse
        if is_reverse:
            self.q_start = read_length - qa_end
            self.q_end = read_length - qa_start
        else:
            self.q_start = qa_start
            self.q_end = qa_end


def _parse_sa_segments(sa_tag: str, header_get_tid, mapq_min: int):
    segments = []
    for element in sa_tag.split(";"):
        if element == "":
            continue
        fields = element.split(",")
        if len(fields) != 6:
            continue
        mapq = int(fields[4])
        if not (0 <= mapq <= 255):
            mapq = 0
        if mapq < mapq_min:
            continue
        segments.append(_SATagSegment(header_get_tid(fields[0]), int(fields[1]) - 1,
                                      fields[3], mapq, fields[2] == "-"))
    return segments


# streaming exists for bounded memory: the one-shot scanner holds the whole
# uncompressed stream (~12x the compressed size for long-read BAMs).  After
# the round-4 window-buffer pool + prefetch pipeline, streaming BEATS the
# one-shot above ~100 MB compressed (measured: 199 MB BAM 1.1 s streaming vs
# 1.4-5.2 s one-shot — the multi-GB resident buffer pays this kernel's page
# churn; 99 MB is a tie; 25 MB one-shot wins 0.165 vs 0.19), so the
# threshold sits at the crossover and --stream_input forces streaming below
# it.
STREAMING_THRESHOLD_BYTES = 96 * 1024 * 1024


def _slice_sequence(sequences, row, start, end):
    """Window of a row's sequence; lazy containers decode only the window."""
    slicer = getattr(sequences, "slice", None)
    if slicer is not None:
        return slicer(row, start, end)
    sequence = sequences[row]
    return sequence[start:end] if sequence is not None else ""


def _slice_sequences_batch(sequences, rows, starts, ends):
    """Many windows at once; vectorized for lazy containers."""
    batch = getattr(sequences, "slice_batch", None)
    if batch is not None:
        return batch(rows, starts, ends)
    return [_slice_sequence(sequences, int(row), int(start), int(end))
            for row, start, end in zip(rows, starts, ends)]


def _take_names(names, rows):
    """Many read names at once; vectorized for lazy containers."""
    take = getattr(names, "take", None)
    if take is not None:
        return take(rows)
    return [names[int(row)] for row in rows]


def _emit_indel_events(packed, events, getrname, options,
                       per_row_sigs, per_row_twins):
    """Materialize CIGAR indel events (the dense COLLECT output) into
    Signature objects, batching every per-event decode: insertion windows and
    read names come from single vectorized passes instead of per-event numpy
    calls.  Emission order is event order, identical to the host scan."""
    rows, pos_ref, pos_read, lengths, is_ins = events
    rows = np.asarray(rows)
    if rows.size == 0:
        return
    pos_ref = np.asarray(pos_ref, dtype=np.int64)
    lengths_arr = np.asarray(lengths, dtype=np.int64)
    ins_mask = np.asarray(is_ins, dtype=bool)
    seqs = iter(())
    if ins_mask.any():
        ins_read_pos = np.asarray(pos_read, dtype=np.int64)[ins_mask]
        seqs = iter(_slice_sequences_batch(
            packed.sequences, rows[ins_mask], ins_read_pos,
            ins_read_pos + lengths_arr[ins_mask]))
    names = _take_names(packed.names, rows)
    contig_of = {}
    row_tids = np.asarray(packed.ref_id)[rows].tolist()
    event_starts = (np.asarray(packed.ref_start, dtype=np.int64)[rows]
                    + pos_ref).tolist()
    for row, tid, start, length, ins, name in zip(
            rows.tolist(), row_tids, event_starts, lengths_arr.tolist(),
            ins_mask.tolist(), names):
        contig = contig_of.get(tid)
        if contig is None:
            contig = contig_of.setdefault(tid, getrname(tid))
        sigs = per_row_sigs.setdefault(row, [])
        if ins:
            sigs.append(SignatureInsertion(contig, start, start + length,
                                           "cigar", name, next(seqs)))
        else:
            sigs.append(SignatureDeletion(contig, start, start + length,
                                          "cigar", name))
            if options.all_bnds:
                per_row_twins.setdefault(row, []).append(SignatureTranslocation(
                    contig, start, "fwd", contig, start + length, "fwd",
                    "cigar", name))


def _emit_indel_events_soa(packed, events, getrname, options, builders,
                           contigs_pool, reads_pool, twin_rows,
                           tag_offset=0):
    """SoA materialization of CIGAR indel events: the whole batch becomes
    table columns in a few vectorized passes — no Signature objects, no
    per-event Python loop for DEL/INS (all_bnds twins stay objects: rare and
    clustered separately).  Row order parity with _emit_indel_events comes
    from the row tags (TableBuilder.finalize stable-sorts by packed row)."""
    rows, pos_ref, pos_read, lengths, is_ins = events
    rows = np.asarray(rows, dtype=np.int64)
    if rows.size == 0:
        return
    lengths_arr = np.asarray(lengths, dtype=np.int64)
    ins_mask = np.asarray(is_ins, dtype=bool)
    tids = np.asarray(packed.ref_id)[rows]
    starts = np.asarray(packed.ref_start, dtype=np.int64)[rows] + np.asarray(
        pos_ref, dtype=np.int64)
    names = _take_names(packed.names, rows)
    read_codes = reads_pool.encode_all(names)
    # tid -> contig pool code via a tiny lookup table
    unique_tids = np.unique(tids)
    lut = np.zeros(int(unique_tids.max()) + 1 if unique_tids.size else 1,
                   dtype=np.int32)
    for tid in unique_tids.tolist():
        lut[tid] = contigs_pool.code(getrname(tid))
    contig_codes = lut[tids]

    del_mask = ~ins_mask
    if del_mask.any():
        builders["DEL"].add_chunk(rows[del_mask] + tag_offset, {
            "contig_code": contig_codes[del_mask],
            "start": starts[del_mask],
            "end": starts[del_mask] + lengths_arr[del_mask],
            "read_code": read_codes[del_mask],
            "source_code": np.zeros(int(del_mask.sum()), dtype=np.int8),
        })
        if options.all_bnds:
            del_rows = rows[del_mask].tolist()
            del_starts = starts[del_mask].tolist()
            del_ends = (starts[del_mask] + lengths_arr[del_mask]).tolist()
            contig_names = [contigs_pool.names[code]
                            for code in contig_codes[del_mask].tolist()]
            del_names = [name for name, ins in zip(names, ins_mask.tolist())
                         if not ins]
            for row, contig, start, end, name in zip(
                    del_rows, contig_names, del_starts, del_ends, del_names):
                twin_rows.append((row + tag_offset, SignatureTranslocation(
                    contig, start, "fwd", contig, end, "fwd", "cigar", name)))
    if ins_mask.any():
        ins_read_pos = np.asarray(pos_read, dtype=np.int64)[ins_mask]
        seqs = _slice_sequences_batch(
            packed.sequences, rows[ins_mask], ins_read_pos,
            ins_read_pos + lengths_arr[ins_mask])
        blob = "".join(seqs).encode()
        seq_lens = np.fromiter(map(len, seqs), dtype=np.int64, count=len(seqs))
        seq_off = np.zeros(len(seqs), dtype=np.int64)
        if len(seqs) > 1:
            np.cumsum(seq_lens[:-1], out=seq_off[1:])
        builders["INS"].add_chunk(rows[ins_mask] + tag_offset, {
            "contig_code": contig_codes[ins_mask],
            "start": starts[ins_mask],
            "end": starts[ins_mask] + lengths_arr[ins_mask],
            "read_code": read_codes[ins_mask],
            "source_code": np.zeros(int(ins_mask.sum()), dtype=np.int8),
            "seq_blob": blob,
            "seq_off": seq_off,
            "seq_len": seq_lens,
        })


class SoAState:
    """Shared accumulation state for multi-batch SoA COLLECT (streaming):
    every batch appends to the same builders/pools with globally increasing
    row tags; finalize() restores the sequential emission order once."""

    __slots__ = ("builders", "contigs_pool", "reads_pool", "twin_rows")

    def __init__(self):
        from svim_tpu_torch.sigtable import SIG_TYPES, StringPool, TableBuilder

        self.contigs_pool = StringPool()
        self.reads_pool = StringPool()
        self.builders = {sig_type: TableBuilder(sig_type, self.contigs_pool,
                                                self.reads_pool)
                         for sig_type in SIG_TYPES}
        self.twin_rows = []  # (global row tag, SignatureTranslocation)

    def finalize(self):
        from svim_tpu_torch.sigtable import SignatureSoA

        self.twin_rows.sort(key=lambda pair: pair[0])
        twins = [twin for _, twin in self.twin_rows]
        soa = SignatureSoA(
            {t: b.finalize() for t, b in self.builders.items()},
            self.contigs_pool, self.reads_pool)
        return soa, twins


def _emit_classified(group_rows, group_sizes, fetched, packed, getrname,
                     options, per_row_sigs, per_row_twins):
    """Consume fetched pair-classification outputs and assemble per-read
    signatures in reference order."""
    (code, p1, p2, aux, contig2, qpos, twin_mask, twin_p1, twin_p2,
     twin_aux, is_reverse, ref_id) = fetched

    for g, row in enumerate(group_rows):
        if not (code[g] != 0).any() and not twin_mask[g].any():
            continue
        emit = _Emitter(packed.names[row], options)
        n_pairs = group_sizes[g] - 1
        for pair in range(n_pairs):
            event = int(code[g, pair])
            if twin_mask[g, pair] and options.all_bnds:
                taux = int(twin_aux[g, pair])
                emit.all_bnds.append(SignatureTranslocation(
                    getrname(int(ref_id[g, pair])), int(twin_p1[g, pair]),
                    "rev" if taux & 1 else "fwd",
                    getrname(int(ref_id[g, pair])), int(twin_p2[g, pair]),
                    "rev" if taux & 2 else "fwd", "suppl", emit.read_name))
            if event == 0:
                continue
            contig = getrname(int(ref_id[g, pair]))
            if event == 1:  # INS
                anchor, deviation = int(p1[g, pair]), int(p2[g, pair])
                position = int(qpos[g, pair])
                if is_reverse[g, pair]:
                    position = int(packed.read_len[row]) - position
                sequence = _slice_sequence(packed.sequences, row, position,
                                           position + deviation)
                emit.signatures.append(SignatureInsertion(
                    contig, anchor, anchor + deviation, "suppl",
                    emit.read_name, sequence))
            elif event == 2:  # DEL
                anchor, length = int(p1[g, pair]), int(p2[g, pair])
                emit.signatures.append(SignatureDeletion(
                    contig, anchor, anchor + length, "suppl", emit.read_name))
            elif event == 3:  # INV
                emit.signatures.append(SignatureInversion(
                    contig, int(p1[g, pair]), int(p2[g, pair]), "suppl",
                    emit.read_name, _INV_DIRECTIONS[int(aux[g, pair])]))
            elif event == 4:  # tandem duplication run entry
                bits = int(aux[g, pair])
                emit.tandem_runs.append((contig, int(p1[g, pair]), int(p2[g, pair]),
                                         bool(bits & 1), bool(bits & 2)))
            elif event == 5:  # BND
                bits = int(aux[g, pair])
                emit.bnd(contig, int(p1[g, pair]), "rev" if bits & 1 else "fwd",
                         getrname(int(contig2[g, pair])), int(p2[g, pair]),
                         "rev" if bits & 2 else "fwd")
        _merge_tandem_runs(emit)
        _pair_translocations(emit)
        per_row_sigs.setdefault(row, []).extend(emit.signatures)
        if options.all_bnds:
            per_row_twins.setdefault(row, []).extend(emit.all_bnds)


def collect_soa_from_bam(bam_path: str, options, device):
    """COLLECT straight from a BGZF BAM into struct-of-arrays tables.

    Returns (header, GenotypeTable, SignatureSoA, twins).  Inputs above
    STREAMING_THRESHOLD_BYTES, or --stream_input, stream with bounded
    memory; smaller ones take the one-shot pipelined path."""
    from svim_tpu_torch import native

    native.get_library()   # both scanners are native; raises when it cannot build
    if (getattr(options, "stream_input", False)
            or os.path.getsize(bam_path) > STREAMING_THRESHOLD_BYTES):
        from svim_tpu_torch.io.bamstream import collect_streaming

        return collect_streaming(bam_path, options, device)
    return collect_soa_pipelined(bam_path, options, device)


def collect_soa_pipelined(bam_path: str, options, device):
    """One-shot SoA COLLECT pipelined against the native scan session."""
    with open(bam_path, "rb") as handle:
        compressed = handle.read()
    return _collect_soa_pipelined_stream(compressed, options, device)


def collect_soa_pipelined_range(bam_path: str, options, num_processes: int,
                                process_id: int, device):
    """Pipelined SoA COLLECT over ONE process's record range (--distributed).

    Same contract as io.bamrange.scan_bam_range (concatenating per-rank
    outputs in rank order reproduces the serial stream exactly: both ends of
    every boundary run the identical deterministic record-chain scan), but
    through the native scan session: the rank's stream is header blocks +
    its owned blocks + a small overhang, the session's walker skips to
    walk_start and stops at walk_end (inflated coordinates), and
    inflate/walk/device passes overlap exactly as in the single-process
    pipelined path.  Mid-scan clustering is off for a rank: the exchange
    re-merges the tables."""
    import struct

    from svim_tpu_torch.io.bamrange import BamRangePlan

    plan = BamRangePlan(bam_path)
    comp = plan.compressed
    offs = plan.block_offsets
    n_blocks = len(offs) - 1
    b_lo, b_hi = plan.block_range(num_processes, process_id)

    def isize(j):
        # BGZF ISIZE field: inflated size of block j
        return struct.unpack_from("<I", comp, offs[j + 1] - 4)[0]

    if b_lo >= b_hi:
        return _empty_rank_collect(plan)
    range_infl = sum(isize(j) for j in range(b_lo, b_hi))
    if b_lo == 0:
        head = b""
        head_infl = 0
        my_first = plan.first_record_offset
    else:
        head = comp[:offs[plan.header_blocks]]
        head_infl = plan.header_inflated_len
        my_first = plan._range_first_record(b_lo)
        if my_first is None or my_first >= range_infl:
            # whole range is the interior of one giant upstream record
            return _empty_rank_collect(plan)
    parts = [head, comp[offs[b_lo]:offs[b_hi]]]
    walk_end = -1
    if b_hi < n_blocks:
        next_first = plan._range_first_record(b_hi)
        if next_first is None:
            # everything after this range is a straddling tail we own
            parts.append(comp[offs[b_hi]:])
        else:
            tail_infl = 0
            j = b_hi
            while tail_infl < next_first:
                tail_infl += isize(j)
                j += 1
            parts.append(comp[offs[b_hi]:offs[j]])
            walk_end = head_infl + range_infl + next_first
    return _collect_soa_pipelined_stream(
        b"".join(parts), options, device, allow_incremental=False,
        walk_start=head_infl + my_first, walk_end=walk_end)


def _empty_rank_collect(plan):
    """(header, empty GenotypeTable, empty SoA, no twins) for a rank that
    owns no whole record."""
    from svim_tpu_torch.io.bamstream import _parse_header

    header, _offset = _parse_header(plan.header_bytes)
    soa, twins = SoAState().finalize()
    return header, GenotypeColumns().table(), soa, twins


def _collect_soa_pipelined_stream(compressed: bytes, options, device,
                                  allow_incremental: bool = True,
                                  walk_start: int = -1, walk_end: int = -1):
    """collect_soa_pipelined over in-memory BGZF bytes, with optional walker
    bounds in inflated coordinates (a rank's byte range).

    Unless --incremental_cluster is off (or `allow_incremental` is false),
    partitions that are final behind the scan frontier are clustered between
    batches, while the session's threads scan ahead; the results ride on the
    returned SoA as `cluster_memo` (cluster/incremental.py)."""
    from svim_tpu_torch import native
    from svim_tpu_torch.cluster.incremental import (
        IncrementalClusterer,
        incremental_enabled,
    )
    from svim_tpu_torch.io.bamstream import _batch_from_columns, _parse_header
    from svim_tpu_torch.io.packing import bucket_size

    # the scan session shares the host cores with the torch CPU ops when the
    # device is the CPU (native default: cores - 2); a card leaves them all
    # to inflate + walk
    scan_workers = 0
    if device.type != "cpu":
        scan_workers = native._scan_workers(reserve=0)
    session = native.BamScanSession(compressed, options.min_mapq,
                                    options.min_sv_size,
                                    n_threads=scan_workers,
                                    walk_start=walk_start, walk_end=walk_end)

    batch_reads = max(1, int(getattr(options, "batch_reads", 4096)))
    header = None
    staged: List = []   # (StagedCollectSoA, global row start, real rows)
    state = SoAState()
    consumed = 0        # staged entries already fetched + consumed mid-scan
    incremental = None  # mid-scan clustering (cluster/incremental.py)
    try:
        while True:
            with timing.span("input_wait"):
                row_start, n, max_ops, _body, done = session.next_rows(
                    batch_reads)
            if header is None:
                # the walker parsed the header before delivering any rows
                header, _offset = _parse_header(session.data)
                if allow_incremental and incremental_enabled(options):
                    incremental = IncrementalClusterer(options, header, device)
            if n:
                with timing.span("read"):
                    batch = _batch_from_columns(
                        session.data, *session.fill(
                            row_start, n, bucket_size(max(1, max_ops))),
                        row_offset=row_start)
                stage = stage_signatures_soa(batch.packed, batch.sa_tags,
                                             header, options, device)
                timing.count("collect.batches")
                if stage is not None:
                    staged.append((stage, row_start, n))
            # consume every stage but the newest while the walker threads
            # scan ahead: the fetch and the host-side emit ride inside the
            # scan's wall time
            advanced = False
            while len(staged) - consumed >= 2:
                stage, stage_start, _sn = staged[consumed]
                consume_signatures_soa(stage, to_host(stage.device_tree()),
                                       header, options, state,
                                       row_tag_offset=stage_start)
                consumed += 1
                advanced = True
            if advanced and incremental is not None and consumed < len(staged):
                # cluster partitions already final behind the frontier (the
                # first un-consumed row) while the walker threads own the
                # scan; the CLUSTER stage reuses whatever still matches
                next_packed = staged[consumed][0].packed
                incremental.observe(state, int(next_packed.ref_id[0]),
                                    int(next_packed.ref_start[0]))
            if done:
                break
    except BaseException:
        if incremental is not None:
            incremental.finish()
        session.close()
        raise

    for stage, row_start, _n in staged[consumed:]:
        consume_signatures_soa(stage, to_host(stage.device_tree()), header,
                               options, state, row_tag_offset=row_start)
    with timing.span("finalize"):
        soa, twins = state.finalize()
        columns = GenotypeColumns()
        for stage, _row_start, n_real in staged:
            columns.add(stage.packed, n_real)
        table = columns.table()
    if incremental is not None:
        soa.cluster_memo = incremental.finish()
    session.close()
    return header, table, soa, twins


class GenotypeColumns:
    """The per-record columns GENOTYPE reads (ref_id, ref_start, ref_end,
    mapq, names), gathered from the real rows of packed batches after their
    COLLECT pass; `table()` joins them into one GenotypeTable."""

    _KEYS = ("ref_id", "ref_start", "ref_end", "mapq")

    def __init__(self):
        self.parts = {key: [] for key in self._KEYS}
        self.names: List[str] = []

    def add(self, packed, n_real):
        for key in self._KEYS:
            self.parts[key].append(np.asarray(getattr(packed, key)[:n_real]))
        take = getattr(packed.names, "take", None)
        self.names.extend(take(np.arange(n_real)) if take is not None
                          else packed.names[:n_real])

    def table(self):
        if not self.parts["ref_id"]:
            return GenotypeTable(np.zeros(0, np.int32), np.zeros(0, np.int64),
                                 np.zeros(0, np.int64), np.zeros(0, np.int32),
                                 [])
        return GenotypeTable(*(np.concatenate(self.parts[key])
                               for key in self._KEYS), self.names)


def collect_signatures_packed(bam, options, device):
    """COLLECT over an opened AlignmentFile (SAM text) with the device
    passes.  Returns (sv_signatures, translocation_signatures_all_bnds),
    Signature objects in the order of analyze_alignment_file_coordsorted."""
    keep = [record for record in bam.fetch(until_eof=True)
            if not (record.flag & (FUNMAP | FSECONDARY))
            and record.mapping_quality >= options.min_mapq]
    if not keep:
        return [], []
    packed = pack_alignments(keep, min_sv_size=options.min_sv_size)
    sa_tags = [record.get_tag("SA") if record.has_tag("SA") else None
               for record in keep]
    return signatures_from_packed(packed, sa_tags, bam, options, device)


def collect_signatures_packed_querysorted(bam, options, device):
    """COLLECT over a queryname-sorted file with the device passes.

    Groups records per read (reference: SVIM_COLLECT.py:96-129): exactly one
    mapped primary above min_mapq, real supplementary records (SA tags are
    ignored on this path), secondaries dropped.  Segment geometry comes from
    the COLLECT pass, so no per-record CIGAR walking happens on the host."""
    keep_records = []
    group_sizes = []   # rows per kept read group (primary first)
    for primary_aln, suppl_aln, _sec in bam_iterator(bam):
        if (len(primary_aln) != 1 or primary_aln[0].is_unmapped
                or primary_aln[0].mapping_quality < options.min_mapq):
            continue
        good_suppl = [aln for aln in suppl_aln
                      if not aln.is_unmapped
                      and aln.mapping_quality >= options.min_mapq]
        keep_records.append(primary_aln[0])
        keep_records.extend(good_suppl)
        group_sizes.append(1 + len(good_suppl))
    if not keep_records:
        return [], []
    packed = pack_alignments(keep_records, min_sv_size=options.min_sv_size)
    return _signatures_from_grouped_packed(packed, group_sizes, bam, options,
                                           device)


def _getrname(name_table):
    return (name_table.getrname if hasattr(name_table, "getrname")
            else name_table.get_reference_name)


def _in_row_order(per_row_sigs, per_row_twins):
    """Flatten per-row signature lists in row order (events are sparse:
    only rows that produced signatures are visited)."""
    sv_signatures = []
    twins = []
    for row in sorted(set(per_row_sigs) | set(per_row_twins)):
        sv_signatures.extend(per_row_sigs.get(row, ()))
        twins.extend(per_row_twins.get(row, ()))
    return sv_signatures, twins


def _signatures_from_grouped_packed(packed, group_sizes, name_table, options,
                                    device):
    """COLLECT over per-read row groups (row 0 of each group is the
    primary); every slot of a split-read group is a packed row."""
    getrname = _getrname(name_table)
    per_row_sigs: Dict[int, List] = {}
    per_row_twins: Dict[int, List] = {}

    rerun, collect_outputs, max_events = dispatch_collect_scan(
        packed, options, device)
    group_rows: List[int] = []
    slot_rows: List[List[int]] = []
    row_base = 0
    for size in group_sizes:
        if size >= 2:
            group_rows.append(row_base)  # split sigs attach to the primary
            slot_rows.append(list(range(row_base, row_base + size)))
        row_base += size

    classify_outputs = None
    if group_rows:
        classify_outputs = _dispatch_classify_fused(
            packed, group_rows, [], collect_outputs, options, device,
            slot_rows=slot_rows)
    fetched_collect, fetched_classify = to_host((collect_outputs,
                                                 classify_outputs))
    events = _consume_collect(packed, rerun, max_events, fetched_collect)
    _emit_indel_events(packed, events, getrname, options, per_row_sigs,
                       per_row_twins)

    if fetched_classify is not None:
        split_sigs: Dict[int, List] = {}
        split_twins: Dict[int, List] = {}
        group_n = [min(len(slot_list), MAX_SEGMENTS) for slot_list in slot_rows]
        _emit_classified(group_rows, group_n, fetched_classify, packed,
                         getrname, options, split_sigs, split_twins)
        # reference order within a read: primary indels, supplementary
        # indels, split signatures — so they go after the group's last row
        group_end = {}
        row_base = 0
        for size in group_sizes:
            group_end[row_base] = row_base + size - 1
            row_base += size
        for primary_row, sigs in split_sigs.items():
            per_row_sigs.setdefault(group_end[primary_row], []).extend(sigs)
        for primary_row, twin_sigs in split_twins.items():
            per_row_twins.setdefault(group_end[primary_row], []).extend(
                twin_sigs)
    return _in_row_order(per_row_sigs, per_row_twins)


@timing.spanned("upload")
def dispatch_collect_scan(packed, options, device):
    """Enqueue the fused geometry+events pass on `device` (row-sharded under
    --num_shards when the rows divide) without waiting for it, as
    svim_tpu's dispatch does: returns (rerun, result, max_events) for
    _consume_collect, where `result` is the output tuple (tensors on
    `device`, events in a table of max_events entries) and rerun(bound)
    runs the pass again with a larger table."""
    from svim_tpu_torch.ops.cigar_kernel import event_bound
    from svim_tpu_torch.parallel.mesh import collect_scan_sharded

    columns = _device_columns(packed, device)

    def rerun(max_events):
        return collect_scan_sharded(
            getattr(options, "num_shards", 1), device,
            columns["cigar_words"], columns["ref_start"],
            int(options.min_sv_size), max_events)

    max_events = event_bound(packed.n)
    return rerun, rerun(max_events), max_events


def _device_columns(packed, device):
    """The batch's packed_to_torch columns, uploaded by the first pass that
    needs them (on the thread that runs the kernels)."""
    if packed.device_cigars is None:
        packed.device_cigars = packed_to_torch(packed, device)
    return packed.device_cigars


def _consume_collect(packed, rerun, max_events, fetched):
    """Consume a fetched COLLECT result (re-running with a larger event
    bound when the true count overflowed the table), fill the geometry
    columns, return (rows, pos_ref, pos_read, lengths, is_insertion) in
    (row, op) order."""
    from svim_tpu_torch.ops.cigar_kernel import round_up_pow2

    while True:
        (ref_end, read_len, qa_start, qa_end, has_hard, rows, pos_ref,
         pos_read, lengths, is_ins, count) = fetched
        if count <= max_events:
            break
        bound = round_up_pow2(int(count))
        RERUNS.append((int(count), max_events, bound))
        timing.count("collect.reruns")
        max_events = bound
        fetched = to_host(rerun(max_events))
    packed.ref_end = np.asarray(ref_end)
    packed.read_len = np.asarray(read_len)
    packed.qa_start = np.asarray(qa_start)
    packed.qa_end = np.asarray(qa_end)
    packed.has_hard_clip = np.asarray(has_hard)
    count = int(count)
    return (rows[:count], pos_ref[:count], pos_read[:count], lengths[:count],
            is_ins[:count])


class StagedCollectSoA:
    """One packed batch's device outputs plus the host context needed to
    consume them later (the pipelined driver fetches them after the scan
    has moved on)."""

    __slots__ = ("packed", "dispatched", "classify_outputs", "group_rows",
                 "group_sa_segments", "fallback_rows")

    def __init__(self, packed, dispatched, classify_outputs, group_rows,
                 group_sa_segments, fallback_rows):
        self.packed = packed
        self.dispatched = dispatched
        self.classify_outputs = classify_outputs
        self.group_rows = group_rows
        self.group_sa_segments = group_sa_segments
        self.fallback_rows = fallback_rows

    def device_tree(self):
        """(collect result, classify outputs or None) — fetch with one
        to_host, then hand to consume_signatures_soa."""
        _rerun, result, _max_events = self.dispatched
        return (result, self.classify_outputs)


@timing.spanned("split_reads")
def stage_signatures_soa(packed, sa_tags, name_table, options, device,
                         dispatched=None):
    """Enqueue the COLLECT + classify passes for one packed batch on
    `device` (`dispatched`: a COLLECT pass already dispatched, as
    dispatch_collect_scan returns it) and return the StagedCollectSoA to
    consume later.  Returns None for an empty batch
    (after installing empty geometry columns)."""
    get_tid = name_table.get_tid

    if packed.n == 0:
        if packed.ref_end is None:
            empty = np.zeros(0, dtype=np.int32)
            packed.ref_end = empty
            packed.read_len = empty
            packed.qa_start = empty
            packed.qa_end = empty
            packed.has_hard_clip = np.zeros(0, dtype=bool)
        return None

    if dispatched is None:
        dispatched = dispatch_collect_scan(packed, options, device)

    supplementary = (packed.flag & FSUPPLEMENTARY) != 0
    sa_parsed: Dict[int, List] = {}
    present = getattr(sa_tags, "present_rows", None)
    sa_rows = present().tolist() if present is not None else range(packed.n)
    for row in sa_rows:
        sa_tag = sa_tags[row]
        if sa_tag is None or supplementary[row]:
            continue
        segments_supplementary = _parse_sa_segments(sa_tag, get_tid,
                                                    options.min_mapq)
        if segments_supplementary:
            sa_parsed[row] = segments_supplementary

    group_rows: List[int] = []
    group_sa_segments: List[List] = []
    fallback_rows: List[int] = []
    for row, segments_supplementary in sa_parsed.items():
        size = 1 + len(segments_supplementary)
        if size > MAX_SEGMENTS:
            if packed.records is not None:
                # pathological chimeras of parsed records: the sequential
                # host analyzer runs later, after the indel events
                fallback_rows.append(row)
                continue
            # batches from a BAM scanner carry no records: the device sorts
            # all segments and keeps the first MAX_SEGMENTS
            logging.warning("read %s has %d alignment segments; truncating "
                            "to %d", packed.names[row], size, MAX_SEGMENTS)
        group_rows.append(row)
        group_sa_segments.append(segments_supplementary)

    classify_outputs = None
    if group_rows:
        classify_outputs = _dispatch_classify_fused(
            packed, group_rows, group_sa_segments, dispatched[1], options,
            device)
    return StagedCollectSoA(packed, dispatched, classify_outputs, group_rows,
                            group_sa_segments, fallback_rows)


def _split_read_signatures(staged, fetched_classify, name_table, options):
    """Split-read signatures of one staged batch, per packed row: the host
    analyzer's for the fallback rows, then the classify pass's."""
    split_sigs: Dict[int, List] = {}
    split_twins: Dict[int, List] = {}
    for row in staged.fallback_rows:
        record = staged.packed.records[row]
        supplementary_records = [
            aln for aln in retrieve_other_alignments(record, name_table)
            if not aln.is_unmapped and aln.mapping_quality >= options.min_mapq]
        sigs, twin_sigs = analyze_read_segments(record, supplementary_records,
                                                name_table, options)
        split_sigs.setdefault(row, []).extend(sigs)
        split_twins.setdefault(row, []).extend(twin_sigs)
    if fetched_classify is not None:
        group_sizes = [min(1 + len(segs), MAX_SEGMENTS)
                       for segs in staged.group_sa_segments]
        _emit_classified(staged.group_rows, group_sizes, fetched_classify,
                         staged.packed, _getrname(name_table), options,
                         split_sigs, split_twins)
    return split_sigs, split_twins


@timing.spanned("emit")
def consume_signatures_soa(staged, fetched, name_table, options, state,
                           row_tag_offset=0):
    """Consume one staged batch's fetched outputs into a SoAState.

    `fetched` is to_host(staged.device_tree()):
    (collect outputs, classify outputs or None)."""
    packed = staged.packed
    fetched_collect, fetched_classify = fetched
    rerun, _result, max_events = staged.dispatched
    events = _consume_collect(packed, rerun, max_events, fetched_collect)
    _emit_indel_events_soa(packed, events, _getrname(name_table), options,
                           state.builders, state.contigs_pool,
                           state.reads_pool, state.twin_rows,
                           tag_offset=row_tag_offset)

    # split-read signatures stay on the object emitters (sparse); they join
    # the tables with row tags so ordering matches the object path
    split_sigs, split_twins = _split_read_signatures(
        staged, fetched_classify, name_table, options)
    if split_sigs:
        per_type: Dict[str, List] = {}
        for row, sigs in split_sigs.items():
            for sig in sigs:
                per_type.setdefault(sig.type, []).append((row, sig))
        for sig_type, tagged in per_type.items():
            state.builders[sig_type].add_objects(
                [tag + row_tag_offset for tag, _ in tagged],
                [sig for _, sig in tagged])
    for row, twin_list in split_twins.items():
        for twin in twin_list:
            state.twin_rows.append((row + row_tag_offset, twin))


def signatures_from_packed_soa(packed, sa_tags, name_table, options, device,
                               dispatched=None, state=None,
                               row_tag_offset=0):
    """One packed batch into struct-of-arrays tables.

    Returns (SignatureSoA, twins); with a shared `state` (the streaming
    scanner: batches under globally increasing row tags) the caller
    finalizes once and this returns (None, None)."""
    shared = state is not None
    if state is None:
        state = SoAState()
    staged = stage_signatures_soa(packed, sa_tags, name_table, options,
                                  device, dispatched=dispatched)
    if staged is not None:
        consume_signatures_soa(staged, to_host(staged.device_tree()),
                               name_table, options, state,
                               row_tag_offset=row_tag_offset)
    return (None, None) if shared else state.finalize()


def signatures_from_packed(packed, sa_tags, name_table, options, device):
    """One packed batch into Signature objects (the SAM-text path).

    name_table provides get_tid and the reference-name lookup (an
    AlignmentFile or an AlignmentHeader).  Returns (signatures, twins) in
    the order of the sequential host path."""
    staged = stage_signatures_soa(packed, sa_tags, name_table, options,
                                  device)
    if staged is None:
        return [], []
    fetched_collect, fetched_classify = to_host(staged.device_tree())
    per_row_sigs: Dict[int, List] = {}
    per_row_twins: Dict[int, List] = {}
    rerun, _result, max_events = staged.dispatched
    events = _consume_collect(packed, rerun, max_events, fetched_collect)
    _emit_indel_events(packed, events, _getrname(name_table), options,
                       per_row_sigs, per_row_twins)
    split_sigs, split_twins = _split_read_signatures(
        staged, fetched_classify, name_table, options)
    for row, sigs in split_sigs.items():
        per_row_sigs.setdefault(row, []).extend(sigs)
    for row, twin_sigs in split_twins.items():
        per_row_twins.setdefault(row, []).extend(twin_sigs)
    return _in_row_order(per_row_sigs, per_row_twins)


def _pow2(value: int, floor: int) -> int:
    result = floor
    while result < value:
        result *= 2
    return result


def _dispatch_classify_fused(packed, group_rows, group_sa_segments,
                             collect_outputs, options, device,
                             slot_rows=None):
    """Run the sort+classify pass on `device`.

    Slot 0 of each group is the primary row (geometry gathered from the
    COLLECT outputs still on the device); the remaining slots carry
    host-parsed SA-tag segment geometry.  `slot_rows` replaces that layout
    with real packed rows per slot (queryname-sorted input): then
    group_sa_segments is empty and no hard-clip gate applies.  Oversized
    groups are sorted fully, then truncated to the first MAX_SEGMENTS."""
    from svim_tpu_torch.ops.segments_kernel import classify_groups_fused

    # pow2 buckets, as the JAX package (padded groups carry valid=False)
    n_groups = _pow2(len(group_rows), 8)
    if slot_rows is not None:
        s_pad = _pow2(max(2, max(len(slots) for slots in slot_rows)), 2)
    else:
        s_pad = _pow2(max(2, max(1 + len(segs)
                                 for segs in group_sa_segments)), 2)

    slot_row = np.full((n_groups, s_pad), -1, dtype=np.int32)
    geometry = np.zeros((5, n_groups, s_pad), dtype=np.int32)
    is_reverse = np.zeros((n_groups, s_pad), dtype=bool)
    valid = np.zeros((n_groups, s_pad), dtype=bool)
    hard_gate = np.full(n_groups, -1, dtype=np.int32)
    if slot_rows is not None:
        for g, slots in enumerate(slot_rows):
            slot_row[g, :len(slots)] = slots
            valid[g, :len(slots)] = True
    else:
        hard_gate[:len(group_rows)] = group_rows
        for g, (row, segments) in enumerate(zip(group_rows,
                                                group_sa_segments)):
            slot_row[g, 0] = row
            valid[g, 0] = True
            for s, seg in enumerate(segments, start=1):
                geometry[:, g, s] = (seg.q_start, seg.q_end, seg.ref_id,
                                     seg.ref_start, seg.ref_end)
                is_reverse[g, s] = seg.is_reverse
                valid[g, s] = True

    def put(values):
        return torch.from_numpy(values).to(device)

    q_start, q_end, ref_id, ref_start, ref_end = put(geometry)
    columns = _device_columns(packed, device)
    ref_end_dev, read_len_dev, qa_start_dev, qa_end_dev, has_hard_dev = (
        collect_outputs[:5])
    return classify_groups_fused(
        put(slot_row), q_start, q_end, ref_id, ref_start, ref_end,
        put(is_reverse), put(valid), put(hard_gate),
        columns["ref_id"], columns["ref_start"], columns["is_reverse"],
        ref_end_dev, read_len_dev, qa_start_dev, qa_end_dev, has_hard_dev,
        int(options.min_sv_size), int(options.max_sv_size),
        int(options.segment_gap_tolerance),
        int(options.segment_overlap_tolerance), max_segments=MAX_SEGMENTS)
