#!/usr/bin/env python3
"""svim-tpu's PyTorch/CUDA port benchmark: aligned reads/s through signature
extraction + clustering, the counterpart of bench.py.

    python3 bench_torch.py                         # on the card
    SVIM_TORCH_DEVICE=cpu python3 bench_torch.py   # plain versions on the CPU

Workload: bench.py's synthetic long-read BAM
(svim_tpu_torch.workloads.bench_workload, byte-equal to bench.make_workload)
at SVIM_BENCH_READS reads (8,192).  Above 33,333 reads the generator places
reads past chr1's LN, so such counts are refused before anything is written;
workloads.sample_workload is the larger input.  SVIM_BENCH_WORKLOAD_DIR names
a directory that holds that workload, or gets it, so that several runs share
one copy.

Gate: before any timing the port's CLI runs once on the workload at its
defaults.  At 8,192 reads its variants.vcf (##fileDate lines left out) must
hash to svim_tpu's (workloads.BENCH_VCF_SHA256), or the script exits
non-zero; other read counts are ungated and say so.

Array path, in a child process under a timeout as in bench.py:
collect_soa_from_bam + cluster_sv_signatures on the device select_device()
gives, at the CLI's defaults (mid-scan clustering on), one warm-up round,
then SVIM_BENCH_REPEATS rounds (9), each clock stopped after
torch.cuda.synchronize(); the best round counts.  A card run that fails or
hangs ends the script non-zero with the child's stderr: there is no CPU
retry.  Without a card the script raises unless SVIM_TORCH_DEVICE=cpu asks
for the CPU.

Baseline: the port's record-based host path over the same stages
(collect/collect.py, intra.py, inter.py, cluster/reference_path.py), best of
2, over SVIM_BENCH_BASELINE_READS reads (0: all of them), charged over all
reads the single-threaded native ingest bound (bam_scan_fused +
bamscan_native, best of 2).  bench.py's reference-SVIM subprocess has no
counterpart yet: its pysam shim imports svim_tpu.

Prints the card, the gate, the rounds, the kernel launches of the timed
rounds and the baseline on earlier lines, then ONE JSON line:
  {"metric": ..., "value": reads/s, "unit": "reads/s", "vs_baseline": x}
"""

import json
import logging
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

from svim_tpu_torch import workloads  # noqa: E402

N_READS = int(os.environ.get("SVIM_BENCH_READS", "8192"))
# 0 = run the baseline over the full workload (clustering cost is nonlinear
# in signature density, so subsampled baselines extrapolate wrong)
BASELINE_SAMPLE = int(os.environ.get("SVIM_BENCH_BASELINE_READS", "0"))
REPEATS = int(os.environ.get("SVIM_BENCH_REPEATS", "9"))
WORKLOAD_DIR = os.environ.get("SVIM_BENCH_WORKLOAD_DIR")
TIMEOUT_S = 2100   # the gate's CLI run and the array child, each
# read count -> sha256 of svim_tpu's variants.vcf on that workload
PINS = {workloads.BENCH_PINNED_READS: workloads.BENCH_VCF_SHA256}


def _synchronize(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def collect_and_cluster(bam, options, device):
    """One round of the array path: (signatures, clusters, collect seconds,
    cluster seconds), each clock stopped once the device is done."""
    from svim_tpu_torch.cluster.cluster import cluster_sv_signatures
    from svim_tpu_torch.collect.packed import collect_soa_from_bam

    started = time.perf_counter()
    _header, _table, signatures, _twins = collect_soa_from_bam(bam, options,
                                                                device)
    _synchronize(device)
    collect_s = time.perf_counter() - started
    started = time.perf_counter()
    clusters = cluster_sv_signatures(signatures, options, device)
    _synchronize(device)
    return signatures, clusters, collect_s, time.perf_counter() - started


def array_measurement(work_dir, bam, genome):
    """The array path's rounds; prints ONE json line {platform, collect_s,
    cluster_s, launches}."""
    import torch

    from svim_tpu_torch.config import parse_arguments
    from svim_tpu_torch.ops import launch_counts, reset_launch_counts
    from svim_tpu_torch.utils.device import select_device

    logging.disable(logging.INFO)
    device = select_device()
    platform = "cpu"
    if device.type == "cuda":
        platform = "cuda " + torch.cuda.get_device_name(device)
    options = parse_arguments(arguments=["alignment", work_dir, bam, genome])
    collect_and_cluster(bam, options, device)   # warm-up
    reset_launch_counts()
    seconds = []
    for _ in range(REPEATS):
        # the round's buffers are released before the next scan, so the
        # native inflate pool can recycle them
        seconds.append(collect_and_cluster(bam, options, device)[2:])
    print(json.dumps({"platform": platform,
                      "collect_s": [collect for collect, _ in seconds],
                      "cluster_s": [cluster for _, cluster in seconds],
                      "launches": launch_counts()}))


def _run(command, what):
    """`command` under TIMEOUT_S; its stdout.  A failure or a timeout ends
    this script non-zero with the command's stderr."""
    try:
        proc = subprocess.run(command, capture_output=True, text=True,
                              timeout=TIMEOUT_S, cwd=ROOT)
    except subprocess.TimeoutExpired as error:
        sys.stderr.write(str(error.stderr or "")[-6000:])
        raise SystemExit("bench_torch: {0} did not end within {1} s".format(
            what, TIMEOUT_S))
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-6000:])
        raise SystemExit("bench_torch: {0} exited with {1}".format(
            what, proc.returncode))
    return proc.stdout


def run_gate(work_dir, bam, genome):
    """The port's CLI once on the workload at its defaults; exits non-zero
    unless its variants.vcf hashes to the pin of this read count."""
    working_dir = os.path.join(work_dir, "gate")
    started = time.perf_counter()
    _run([sys.executable, "-m", "svim_tpu_torch", "alignment", working_dir,
          bam, genome], "the gate's CLI run")
    seconds = time.perf_counter() - started
    digest = workloads.vcf_sha256(os.path.join(working_dir, "variants.vcf"))
    pin = PINS.get(N_READS)
    if pin is None:
        print("gate: none: svim_tpu's VCF is pinned at {0} reads, not {1}; "
              "this run is ungated (variants.vcf sha256 {2}; CLI run {3} "
              "s)".format(", ".join(map(str, sorted(PINS))), N_READS, digest,
                          seconds), flush=True)
    elif digest != pin:
        raise SystemExit("bench_torch: variants.vcf sha256 {0} differs from "
                         "svim_tpu's {1} at {2} reads: no time counts".format(
                             digest, pin, N_READS))
    else:
        print("gate: held: variants.vcf sha256 {0} equals svim_tpu's at {1} "
              "reads (CLI run {2} s)".format(digest, N_READS, seconds),
              flush=True)


def run_array(work_dir, bam, genome):
    """array_measurement in a child process (a hung card run cannot take
    this one down); its json line."""
    started = time.perf_counter()
    stdout = _run([sys.executable, os.path.abspath(__file__), "--array",
                   work_dir, bam, genome], "the array path")
    return dict(json.loads(stdout.strip().splitlines()[-1]),
                child_s=time.perf_counter() - started)


def ingest_bound(bam, options):
    """Best of 2 of the single-threaded native inflate + record walk +
    column decode: a strict lower bound on the BAM ingest the reference pays
    inside COLLECT, which the host loop below does not (its AlignmentFile
    decodes the records before the clock starts)."""
    from svim_tpu_torch import native
    from svim_tpu_torch.io.packing import bucket_size

    with open(bam, "rb") as handle:
        compressed = handle.read()
    best = float("inf")
    for _ in range(2):
        started = time.perf_counter()
        data, counted = native.bam_scan_fused(compressed, options.min_mapq, 0,
                                              n_threads=1)
        native.bamscan_native(data, options.min_mapq, bucket_size, 0,
                              counted=counted, n_threads=1)
        best = min(best, time.perf_counter() - started)
    return best


def baseline_signatures(bam_host, records, options):
    """bench.py's host COLLECT loop over the port's record-based copies."""
    from svim_tpu_torch.collect.collect import retrieve_other_alignments
    from svim_tpu_torch.collect.inter import analyze_read_segments
    from svim_tpu_torch.collect.intra import analyze_alignment_indel

    signatures = []
    for record in records:
        supplementary = [aln for aln in retrieve_other_alignments(record,
                                                                  bam_host)
                         if aln.mapping_quality >= options.min_mapq]
        sigs, _ = analyze_alignment_indel(record, bam_host, record.query_name,
                                          options)
        signatures.extend(sigs)
        sigs, _ = analyze_read_segments(record, supplementary, bam_host,
                                        options)
        signatures.extend(sigs)
    return signatures


def baseline_measurement(bam, options):
    """(reads, best seconds, seconds decoding the records) of the host
    COLLECT + the scalar clustering path; the first pass warms one-time
    costs, best of 2."""
    from svim_tpu_torch.cluster.reference_path import (
        cluster_sv_signatures_reference,
    )
    from svim_tpu_torch.io.sam import AlignmentFile

    started = time.perf_counter()
    bam_host = AlignmentFile(bam)
    records = list(bam_host.fetch(until_eof=True))
    if BASELINE_SAMPLE:
        records = records[:BASELINE_SAMPLE]
    decode_s = time.perf_counter() - started
    best = float("inf")
    for _ in range(2):
        started = time.perf_counter()
        signatures = baseline_signatures(bam_host, records, options)
        cluster_sv_signatures_reference(signatures, options)
        best = min(best, time.perf_counter() - started)
    return len(records), best, decode_s


def _card():
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def main():
    from svim_tpu_torch.config import parse_arguments
    from svim_tpu_torch.utils.device import select_device

    if N_READS > workloads.BENCH_MAX_READS:
        raise SystemExit(
            "bench_torch: SVIM_BENCH_READS={0} is refused: above {1} reads "
            "bench's generator places reads past chr1's LN; "
            "svim_tpu_torch.workloads.sample_workload is the larger "
            "input".format(N_READS, workloads.BENCH_MAX_READS))
    logging.disable(logging.INFO)
    device = select_device()   # raises without a card unless CPU is asked
    if device.type == "cuda":
        print("card: " + _card(), flush=True)
    else:
        print("card: none; SVIM_TORCH_DEVICE=cpu: the plain versions on the "
              "CPU", flush=True)
    work_dir = tempfile.mkdtemp(prefix="svim_bench_torch_")
    try:
        bam, genome = workloads.shared_bench_workload(
            WORKLOAD_DIR or work_dir, N_READS)
        options = parse_arguments(arguments=["alignment", work_dir, bam,
                                             genome])
        run_gate(work_dir, bam, genome)
        ingest_s = 0.0 if BASELINE_SAMPLE else ingest_bound(bam, options)
        # the array path first, as in bench.py: the baseline leaves the
        # host's page cache and allocator churned
        array = run_array(work_dir, bam, genome)
        totals = [collect + cluster for collect, cluster
                  in zip(array["collect_s"], array["cluster_s"])]
        print("rounds: " + json.dumps({
            "collect_s": array["collect_s"], "cluster_s": array["cluster_s"],
            "median_collect_s": statistics.median(array["collect_s"]),
            "median_cluster_s": statistics.median(array["cluster_s"]),
            "best_s": min(totals), "child_s": array["child_s"]}), flush=True)
        print("launches: " + json.dumps(array["launches"]), flush=True)
        array_reads_per_s = N_READS / min(totals)
        baseline_reads, baseline_s, decode_s = baseline_measurement(
            bam, options)
        baseline_reads_per_s = baseline_reads / (baseline_s + ingest_s)
        print("baseline: " + json.dumps({
            "reads": baseline_reads, "best_s": baseline_s,
            "ingest_s": ingest_s, "reads_per_s": baseline_reads_per_s,
            "decode_s": decode_s}), flush=True)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    print(json.dumps({
        "metric": "aligned reads/s through signature extraction+clustering "
                  "(1 chip: {0})".format(array["platform"]),
        "value": array_reads_per_s,
        "unit": "reads/s",
        "vs_baseline": array_reads_per_s / baseline_reads_per_s}))


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--array":
        array_measurement(*sys.argv[2:5])
    else:
        main()
