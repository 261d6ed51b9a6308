#!/usr/bin/env python3
"""Streaming vs one-shot COLLECT of the PyTorch/CUDA port on bench's
workload, stage-timed: the counterpart of
scripts/profile_stream_vs_oneshot.py, with the same keys.

Answers: where does io/bamstream.collect_streaming spend its wall time at
bench scale, and how does the one-shot path compare?  Each round times the
host-only stream drain (prefetch thread + row building, no device), the
whole streaming COLLECT, the one-shot native scan of the BAM, its CIGAR scan
on the device (dispatched and fetched), the signatures' materialization
(the split-read pass and the host emit) and CLUSTER on the streamed
signatures.

    python3 scripts/profile_stream_vs_oneshot_torch.py

Workload: svim_tpu_torch.workloads.bench_workload at SVIM_BENCH_READS reads
(8,192), or the copy in SVIM_BENCH_WORKLOAD_DIR.  Runs on the card unless
SVIM_TORCH_DEVICE=cpu asks for the CPU.  Prints the device, then one JSON
line a round (3).
"""
import json
import logging
import os
import shutil
import sys
import tempfile
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

N_READS = int(os.environ.get("SVIM_BENCH_READS", "8192"))
ROUNDS = 3


def oneshot_scan(bam_path, min_mapq, min_sv_size):
    """The whole BAM inflated and walked natively in one pass, as one packed
    batch: (header, packed, sa_tags)."""
    from svim_tpu_torch import native
    from svim_tpu_torch.io.bamstream import _batch_from_columns, _parse_header
    from svim_tpu_torch.io.packing import bucket_size

    with open(bam_path, "rb") as handle:
        compressed = handle.read()
    data, counted = native.bam_scan_fused(compressed, min_mapq, min_sv_size)
    columns = native.bamscan_native(data, min_mapq, bucket_size, min_sv_size,
                                    counted=counted)
    header, _offset = _parse_header(data)
    batch = _batch_from_columns(data, *columns[3:], row_offset=0)
    return header, batch.packed, batch.sa_tags


def main():
    from svim_tpu_torch.utils.device import select_device

    logging.disable(logging.INFO)
    device = select_device()   # raises without a card unless CPU is asked
    tmp_dir = tempfile.mkdtemp(prefix="svim_profile_sv1_")
    try:
        profile(device, tmp_dir)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)


def profile(device, tmp_dir):
    import torch

    from svim_tpu_torch import workloads
    from svim_tpu_torch.cluster.cluster import cluster_sv_signatures
    from svim_tpu_torch.collect.packed import (
        dispatch_collect_scan,
        signatures_from_packed_soa,
    )
    from svim_tpu_torch.config import parse_arguments
    from svim_tpu_torch.io.bamstream import collect_streaming, stream_bam
    from svim_tpu_torch.state import to_host
    from svim_tpu_torch.utils.device import describe

    bam_path, genome_path = workloads.shared_bench_workload(
        os.environ.get("SVIM_BENCH_WORKLOAD_DIR") or tmp_dir, N_READS)
    options = parse_arguments(arguments=["alignment", tmp_dir, bam_path,
                                         genome_path])
    print("platform:", describe(device), flush=True)

    def synchronize():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    # warm: native library, kernels, page cache
    collect_streaming(bam_path, options, device)

    for _round in range(ROUNDS):
        t = {}
        t0 = time.perf_counter()
        stream = stream_bam(bam_path, options.min_mapq, options.batch_reads,
                            min_sv_size=options.min_sv_size)
        next(stream)
        n_batches = 0
        for _batch in stream:
            n_batches += 1
        t["stream_host_only"] = time.perf_counter() - t0
        t["n_batches"] = n_batches

        t0 = time.perf_counter()
        _h, _table, sigs, _tw = collect_streaming(bam_path, options, device)
        t["collect_streaming"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        header, packed, sa_tags = oneshot_scan(bam_path, options.min_mapq,
                                               options.min_sv_size)
        t["oneshot_scan"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dispatched = dispatch_collect_scan(packed, options, device)
        to_host(dispatched[1])
        t["oneshot_device"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        sigs2, _tw2 = signatures_from_packed_soa(packed, sa_tags, header,
                                                 options, device,
                                                 dispatched=dispatched)
        t["oneshot_materialize"] = time.perf_counter() - t0
        t["sig_parity"] = sigs.total() == sigs2.total()

        t0 = time.perf_counter()
        cluster_sv_signatures(sigs, options, device)
        synchronize()
        t["cluster"] = time.perf_counter() - t0
        print(json.dumps(t), flush=True)


if __name__ == "__main__":
    main()
