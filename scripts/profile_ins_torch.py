#!/usr/bin/env python3
"""Fine-grained breakdown of the PyTorch/CUDA port's INS clustering route on
bench's workload: the counterpart of scripts/profile_ins_tpu.py, with the
same keys.

Times, per warm round: partition forming, the INS edit-distance batch
(cluster/accel.py: pair building and the native host batch), the matrix
builds and the agglomeration dispatch on the device
(dispatch_partitions_device), consume and fallback
(consume_partitions_device), and the whole route for comparison.

    python3 scripts/profile_ins_torch.py

Workload: svim_tpu_torch.workloads.bench_workload at SVIM_BENCH_READS reads
(8,192), or the copy in SVIM_BENCH_WORKLOAD_DIR.  Runs on the card unless
SVIM_TORCH_DEVICE=cpu asks for the CPU.  Prints the device and the INS
signature count, then one JSON line a round (3).
"""
import json
import logging
import os
import shutil
import sys
import tempfile
import time
from random import sample, seed

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

N_READS = int(os.environ.get("SVIM_BENCH_READS", "8192"))
ROUNDS = 3


def main():
    from svim_tpu_torch.utils.device import select_device

    logging.disable(logging.INFO)
    device = select_device()   # raises without a card unless CPU is asked
    tmp_dir = tempfile.mkdtemp(prefix="svim_profile_ins_")
    try:
        profile(device, tmp_dir)
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)


def profile(device, tmp_dir):
    import torch

    from svim_tpu_torch import workloads
    from svim_tpu_torch.cluster import accel
    from svim_tpu_torch.cluster import cluster as cl
    from svim_tpu_torch.cluster.device_cluster import (
        DeviceBatcher,
        consume_partitions_device,
        dispatch_partitions_device,
    )
    from svim_tpu_torch.cluster.partition import form_partitions
    from svim_tpu_torch.collect.packed import collect_soa_from_bam
    from svim_tpu_torch.config import parse_arguments
    from svim_tpu_torch.io.fasta import FastaFile
    from svim_tpu_torch.utils.device import describe

    bam_path, genome_path = workloads.shared_bench_workload(
        os.environ.get("SVIM_BENCH_WORKLOAD_DIR") or tmp_dir, N_READS)
    options = parse_arguments(arguments=["alignment", tmp_dir, bam_path,
                                         genome_path])
    print("platform:", describe(device), flush=True)

    def synchronize():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    _h, _t, soa, _tw = collect_soa_from_bam(bam_path, options, device)
    ins = [s for s in soa.materialize_all() if s.type == "INS"]
    print("n_ins:", len(ins), flush=True)

    for _round in range(ROUNDS):
        t = {}
        t0 = time.perf_counter()
        partitions = form_partitions(ins, options.partition_max_distance)
        t["form_partitions"] = time.perf_counter() - t0

        seed(cl.RANDOM_SEED)
        samples = []
        for partition in partitions:
            if len(partition) > cl.MAX_PARTITION_SIZE:
                samples.append(sample(partition, cl.MAX_PARTITION_SIZE))
            else:
                samples.append(partition)

        with FastaFile(options.genome) as reference:
            t0 = time.perf_counter()
            multi = [s for s in samples if len(s) >= 2]
            ed_cache = accel.precompute_ins_edit_distances(multi, reference,
                                                           options, device)
            t["ed_precompute"] = time.perf_counter() - t0
            t["n_pairs"] = len(ed_cache.pairs) // 2

            t0 = time.perf_counter()
            eligible = [s for s in samples if 3 <= len(s) <= 128]
            pending = dispatch_partitions_device(
                eligible, "INS", reference, options,
                DeviceBatcher(options, device), ed_cache=ed_cache)
            synchronize()
            t["matrix_prep+dispatch"] = time.perf_counter() - t0

            t0 = time.perf_counter()
            per_pos = consume_partitions_device(pending)
            t["consume"] = time.perf_counter() - t0
            t["n_fallback"] = sum(1 for r in per_pos.values()
                                  if r.clusters is None)

            # the whole route for comparison
            t0 = time.perf_counter()
            cl.clusters_from_partitions(partitions, reference, options,
                                        device)
            synchronize()
            t["full_route"] = time.perf_counter() - t0
        print(json.dumps(t), flush=True)


if __name__ == "__main__":
    main()
