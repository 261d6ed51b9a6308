"""Array-path COLLECT on the port's device: packed batches -> kernels ->
signature tables.

Counterpart of the one-shot pipelined path of svim_tpu/collect/packed.py
(collect_soa_from_bam -> collect_soa_pipelined): the native scan session
inflates and walks the BAM in background threads while this thread packs
each delivered row range and runs its COLLECT + split-read classify passes
on `device`.  The emitters that turn fetched events into SoA tables are
svim_tpu's (imported), so row order and table contents are identical.
"""

from __future__ import annotations

import logging
import os
from typing import Dict, List

import numpy as np
import torch

from svim_tpu.collect.packed import (
    MAX_SEGMENTS,
    STREAMING_THRESHOLD_BYTES,
    SoAState,
    _emit_classified,
    _emit_indel_events_soa,
    _parse_sa_segments,
)
from svim_tpu.io.packing import FSUPPLEMENTARY
from svim_tpu_torch.state import packed_to_torch, to_host


def collect_soa_from_bam(bam_path: str, options, device):
    """COLLECT straight from a BGZF BAM into struct-of-arrays tables.

    Returns (header, GenotypeTable, SignatureSoA, twins).  Inputs above
    STREAMING_THRESHOLD_BYTES, or --stream_input, need the streaming
    scanner, which the port does not have yet."""
    if (getattr(options, "stream_input", False)
            or os.path.getsize(bam_path) > STREAMING_THRESHOLD_BYTES):
        raise NotImplementedError(
            "streaming COLLECT (inputs over {0} MiB or --stream_input) is not "
            "ported yet: ROADMAP Queue 1 item 7".format(
                STREAMING_THRESHOLD_BYTES >> 20))
    from svim_tpu_torch.native import host_library

    host_library()   # the scan session is native; raises when it cannot build
    return collect_soa_pipelined(bam_path, options, device)


def collect_soa_pipelined(bam_path: str, options, device):
    """One-shot SoA COLLECT pipelined against the native scan session."""
    with open(bam_path, "rb") as handle:
        compressed = handle.read()
    return _collect_soa_pipelined_stream(compressed, options, device)


def _collect_soa_pipelined_stream(compressed: bytes, options, device):
    """collect_soa_pipelined over in-memory BGZF bytes.

    Mid-scan incremental clustering stays off: svim_tpu's clusterer binds
    the JAX CLUSTER path, and its output is byte-equal with the feature off
    (tests/test_incremental_cluster.py)."""
    from svim_tpu import native
    from svim_tpu.io.bamscan import LazySequences, LazyStrings
    from svim_tpu.io.bamstream import GenotypeTable, _parse_header, _row_bucket
    from svim_tpu.io.packing import bucket_size
    from svim_tpu_torch.io.bamscan import build_packed

    if getattr(options, "incremental_cluster", "auto") != "off":
        logging.info("Mid-scan incremental clustering is off in the PyTorch "
                     "port (output is identical either way).")
    # the scan session shares the host cores with the torch CPU ops when the
    # device is the CPU (native default: cores - 2); a card leaves them all
    # to inflate + walk
    scan_workers = 0
    if device.type != "cpu":
        scan_workers = native._scan_workers(reserve=0)
    session = native.BamScanSession(compressed, options.min_mapq,
                                    options.min_sv_size,
                                    n_threads=scan_workers)

    batch_reads = max(1, int(getattr(options, "batch_reads", 4096)))
    header = None
    staged: List = []   # (StagedCollectSoA, global row start, real rows)
    state = SoAState()
    consumed = 0        # staged entries already fetched + consumed mid-scan
    try:
        while True:
            row_start, n, max_ops, _body, done = session.next_rows(batch_reads)
            if header is None:
                # the walker parsed the header before delivering any rows
                header, _offset = _parse_header(session.data)
            if n:
                k = bucket_size(max(1, max_ops))
                (cigar_words, ref_id, pos, mapq, flag, name_off, name_len,
                 seq_off, seq_len, sa_off, sa_len) = session.fill(
                    row_start, n, k)
                n_pad = _row_bucket(n)

                def pad(values, dtype, fill=0):
                    out = np.full(n_pad, fill, dtype=dtype)
                    out[:n] = values
                    return out

                padded_words = np.zeros((n_pad, k), dtype=np.int32)
                padded_words[:n] = cigar_words
                packed = build_packed(
                    pad(ref_id, np.int32, -1), pad(pos, np.int32),
                    pad(mapq, np.int32), pad(flag, np.int32), padded_words,
                    LazyStrings(session.data, pad(name_off, np.int64, -1),
                                pad(name_len, np.int64)),
                    LazySequences(session.data, pad(seq_off, np.int64),
                                  pad(seq_len, np.int64)),
                    device)
                sa_tags = LazyStrings(session.data,
                                      pad(sa_off, np.int64, -1),
                                      pad(sa_len, np.int64),
                                      none_when_negative=True)
                stage = stage_signatures_soa(packed, sa_tags, header, options,
                                             device)
                if stage is not None:
                    staged.append((stage, row_start, n))
            # consume every stage but the newest while the walker threads
            # scan ahead: the fetch and the host-side emit ride inside the
            # scan's wall time
            while len(staged) - consumed >= 2:
                stage, stage_start, _sn = staged[consumed]
                consume_signatures_soa(stage, to_host(stage.device_tree()),
                                       header, options, state,
                                       row_tag_offset=stage_start)
                consumed += 1
            if done:
                break
    except BaseException:
        session.close()
        raise

    for stage, row_start, _n in staged[consumed:]:
        consume_signatures_soa(stage, to_host(stage.device_tree()), header,
                               options, state, row_tag_offset=row_start)
    soa, twins = state.finalize()

    ref_id_parts, ref_start_parts, ref_end_parts, mapq_parts = [], [], [], []
    names_all: List[str] = []
    for stage, _row_start, n_real in staged:
        packed = stage.packed
        ref_id_parts.append(np.asarray(packed.ref_id[:n_real]))
        ref_start_parts.append(np.asarray(packed.ref_start[:n_real]))
        ref_end_parts.append(np.asarray(packed.ref_end[:n_real]))
        mapq_parts.append(np.asarray(packed.mapq[:n_real]))
        names_all.extend(packed.names.take(np.arange(n_real)))
    if ref_id_parts:
        table = GenotypeTable(np.concatenate(ref_id_parts),
                              np.concatenate(ref_start_parts),
                              np.concatenate(ref_end_parts),
                              np.concatenate(mapq_parts), names_all)
    else:
        table = GenotypeTable(np.zeros(0, np.int32), np.zeros(0, np.int64),
                              np.zeros(0, np.int64), np.zeros(0, np.int32), [])
    session.close()
    return header, table, soa, twins


def dispatch_collect_scan(packed, options, device):
    """Run the fused geometry+events pass on `device`; returns its output
    tuple (tensors) for _consume_collect."""
    from svim_tpu_torch.ops.cigar_kernel import collect_scan

    columns = _device_columns(packed, device)
    return collect_scan(columns["cigar_words"], columns["ref_start"],
                        int(options.min_sv_size))


def _device_columns(packed, device):
    """The batch's packed_to_torch columns (built once per batch)."""
    if packed.device_cigars is None:
        packed.device_cigars = packed_to_torch(packed, device)
    return packed.device_cigars


def _consume_collect(packed, fetched):
    """Consume a fetched COLLECT result: fill the geometry columns, return
    (rows, pos_ref, pos_read, lengths, is_insertion) in (row, op) order."""
    (ref_end, read_len, qa_start, qa_end, has_hard, rows, pos_ref,
     pos_read, lengths, is_ins, count) = fetched
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
                 "group_sa_segments")

    def __init__(self, packed, dispatched, classify_outputs, group_rows,
                 group_sa_segments):
        self.packed = packed
        self.dispatched = dispatched
        self.classify_outputs = classify_outputs
        self.group_rows = group_rows
        self.group_sa_segments = group_sa_segments

    def device_tree(self):
        """(collect outputs, classify outputs or None) — fetch with one
        to_host, then hand to consume_signatures_soa."""
        return (self.dispatched, self.classify_outputs)


def stage_signatures_soa(packed, sa_tags, name_table, options, device):
    """Run the COLLECT + classify passes for one packed batch on `device`
    and return the StagedCollectSoA to consume later.  Returns None for an
    empty batch (after installing empty geometry columns)."""
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
    for row, segments_supplementary in sa_parsed.items():
        size = 1 + len(segments_supplementary)
        if size > MAX_SEGMENTS:
            # packed batches from the scan session carry no records for the
            # sequential host analyzer: the device sorts all segments and
            # keeps the first MAX_SEGMENTS (as svim_tpu does here)
            logging.warning("read %s has %d alignment segments; truncating "
                            "to %d", packed.names[row], size, MAX_SEGMENTS)
        group_rows.append(row)
        group_sa_segments.append(segments_supplementary)

    classify_outputs = None
    if group_rows:
        classify_outputs = _dispatch_classify_fused(
            packed, group_rows, group_sa_segments, dispatched, options,
            device)
    return StagedCollectSoA(packed, dispatched, classify_outputs, group_rows,
                            group_sa_segments)


def consume_signatures_soa(staged, fetched, name_table, options, state,
                           row_tag_offset=0):
    """Consume one staged batch's fetched outputs into a SoAState.

    `fetched` is to_host(staged.device_tree()):
    (collect outputs, classify outputs or None)."""
    packed = staged.packed
    getrname = (name_table.getrname if hasattr(name_table, "getrname")
                else name_table.get_reference_name)

    fetched_collect, fetched_classify = fetched
    events = _consume_collect(packed, fetched_collect)
    _emit_indel_events_soa(packed, events, getrname, options, state.builders,
                           state.contigs_pool, state.reads_pool,
                           state.twin_rows, tag_offset=row_tag_offset)

    # split-read signatures stay on the object emitters (sparse); they join
    # the tables with row tags so ordering matches the object path
    split_sigs: Dict[int, List] = {}
    split_twins: Dict[int, List] = {}
    if fetched_classify is not None:
        group_sizes = [min(1 + len(segs), MAX_SEGMENTS)
                       for segs in staged.group_sa_segments]
        _emit_classified(staged.group_rows, group_sizes, fetched_classify,
                         packed, getrname, options, split_sigs, split_twins)
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


def _pow2(value: int, floor: int) -> int:
    result = floor
    while result < value:
        result *= 2
    return result


def _dispatch_classify_fused(packed, group_rows, group_sa_segments,
                             collect_outputs, options, device):
    """Run the sort+classify pass on `device`.

    Slot 0 of each group is the primary row (geometry gathered from the
    COLLECT outputs still on the device); the remaining slots carry
    host-parsed SA-tag segment geometry.  Oversized groups are sorted fully,
    then truncated to the first MAX_SEGMENTS."""
    from svim_tpu_torch.ops.segments_kernel import classify_groups_fused

    # pow2 buckets, as the JAX package (padded groups carry valid=False)
    n_groups = _pow2(len(group_rows), 8)
    s_pad = _pow2(max(2, max(1 + len(segs) for segs in group_sa_segments)), 2)

    slot_row = np.full((n_groups, s_pad), -1, dtype=np.int32)
    geometry = np.zeros((5, n_groups, s_pad), dtype=np.int32)
    is_reverse = np.zeros((n_groups, s_pad), dtype=bool)
    valid = np.zeros((n_groups, s_pad), dtype=bool)
    hard_gate = np.full(n_groups, -1, dtype=np.int32)
    hard_gate[:len(group_rows)] = group_rows
    for g, (row, segments) in enumerate(zip(group_rows, group_sa_segments)):
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
