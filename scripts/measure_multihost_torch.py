#!/usr/bin/env python3
"""Two-rank scaling of the PyTorch/CUDA port: wall clock and exchange bytes,
the counterpart of scripts/measure_multihost.py.

Runs bench's workload (svim_tpu_torch.workloads.bench_workload at
SVIM_SCALE_READS reads, 8,192) through `python -m svim_tpu_torch alignment`
once as one process and once as a two-rank `--distributed` job (Gloo over
host bytes, parallel/multihost.py: each rank scans its BAM block range, one
fixed-dtype exchange, sharded CLUSTER), reads the stage seconds and the
exchange totals that --profile logs, and prints ONE JSON line:

  {"single_s", "two_proc_s", "efficiency", "collect_cluster_single_s",
   "collect_cluster_two_proc_s", "collect_cluster_efficiency",
   "exchange_sent_bytes", "exchange_rounds", "payload_soa_bytes",
   "payload_pickle_bytes_round3_design", "n_reads", "pinned", "caveat"}

Efficiency is strong-scaling T1 / (2 * T2).  CAVEAT: both ranks share the
one card and the host's cores, so host-bound stages contend, and the card
is not split between them; the number is a correctness-side measurement,
not a multi-card scaling figure.  Every process runs on the card unless
SVIM_TORCH_DEVICE=cpu asks for the CPU.

SVIM_SCALE_PINNED=1 pins the single-rank control to cores
SVIM_SCALE_SINGLE_CORES (0,1) and each rank to a disjoint set of
SVIM_SCALE_RANK_CORES (0,1;2,3), so every process has the same core budget.
SVIM_SCALE_WORKLOAD_DIR holds the workload, or gets it, so that runs share
one copy.

measure_multihost.py first runs each side once untimed to fill JAX's
compilation cache; the port compiles nothing a shape, so this script builds
the native library and, on a card, every kernel once in its own process
before the timed runs instead.
"""

import json
import os
import re
import shutil
import socket
import subprocess
import sys
import tempfile
import time

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO_ROOT)

N_READS = int(os.environ.get("SVIM_SCALE_READS", "8192"))
PINNED = os.environ.get("SVIM_SCALE_PINNED") == "1"
# disjoint 2-core sets; override for hosts with a different topology
SINGLE_CORES = os.environ.get("SVIM_SCALE_SINGLE_CORES", "0,1")
RANK_CORES = os.environ.get("SVIM_SCALE_RANK_CORES", "0,1;2,3").split(";")
RUN_TIMEOUT = 1800   # seconds, each process


def _pin(cores):
    """taskset prefix pinning a subprocess to `cores` (pinned mode only)."""
    return ["taskset", "-c", cores] if PINNED else []


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _logged_json(log_text, label):
    """The JSON of the last `<label>: {...}` line --profile logged."""
    found = re.findall(re.escape(label) + r": (\{.*\})", log_text)
    if not found:
        raise RuntimeError("no '{0}' line in the run's log".format(label))
    return json.loads(found[-1])


def _payload_sizes(bam, genome, tmp_dir, device):
    """(fixed-dtype exchange bytes, object-pickle bytes) of one rank's whole
    COLLECT output: the round-3 design of svim_tpu pickled Signature
    object lists."""
    import pickle

    from svim_tpu_torch.collect.packed import collect_soa_from_bam
    from svim_tpu_torch.config import parse_arguments
    from svim_tpu_torch.parallel.multihost import (
        _table_genotype_columns,
        arrays_to_bytes,
        soa_to_arrays,
    )

    options = parse_arguments(arguments=["alignment", tmp_dir, bam, genome])
    _header, table, soa, twins = collect_soa_from_bam(bam, options, device)
    geno = _table_genotype_columns(table)
    soa_bytes = len(arrays_to_bytes(soa_to_arrays(soa, twins, geno)))
    pickled = pickle.dumps({"sigs": soa.materialize_all(), "twins": twins,
                            "columns": geno}, protocol=4)
    return soa_bytes, len(pickled)


def _build(device):
    """The native host library and, on a card, every kernel, built now so
    that no timed run pays for a build."""
    from svim_tpu_torch import native
    from svim_tpu_torch.ops import _build as kernels

    native.get_library()
    if device.type == "cuda":
        kernels.build(kernels.KERNEL_SOURCES)


def main():
    from svim_tpu_torch.utils.device import select_device

    device = select_device()   # raises without a card unless CPU is asked
    tmp_dir = tempfile.mkdtemp(prefix="svim_scale_torch_")
    try:
        print(json.dumps(_measure(device, tmp_dir)))
    finally:
        shutil.rmtree(tmp_dir, ignore_errors=True)


def _measure(device, tmp_dir):
    from svim_tpu_torch import workloads

    bam, genome = workloads.shared_bench_workload(
        os.environ.get("SVIM_SCALE_WORKLOAD_DIR") or tmp_dir, N_READS)
    _build(device)
    soa_bytes, pickle_bytes = _payload_sizes(bam, genome, tmp_dir, device)

    base_env = dict(os.environ)
    base_env["PYTHONPATH"] = REPO_ROOT
    common = ["--profile", "--skip_genotyping"]

    started = time.perf_counter()
    single = subprocess.run(
        _pin(SINGLE_CORES)
        + [sys.executable, "-m", "svim_tpu_torch", "alignment",
           os.path.join(tmp_dir, "wd_single"), bam, genome] + common,
        env=base_env, capture_output=True, text=True, timeout=RUN_TIMEOUT)
    single_s = time.perf_counter() - started
    if single.returncode != 0:
        raise RuntimeError("single-process run failed:\n"
                           + single.stderr[-4000:])
    single_stages = _logged_json(single.stdout + single.stderr,
                                 "Stage seconds")

    coordinator = "127.0.0.1:{0}".format(_free_port())
    ranks = []
    started = time.perf_counter()
    for rank in range(2):
        env = dict(base_env)
        # both ranks on this host: Gloo over the loopback interface
        env.update({"SVIM_COORDINATOR": coordinator,
                    "SVIM_NUM_PROCESSES": "2",
                    "SVIM_PROCESS_ID": str(rank),
                    "GLOO_SOCKET_IFNAME": "lo"})
        ranks.append(subprocess.Popen(
            _pin(RANK_CORES[rank % len(RANK_CORES)])
            + [sys.executable, "-m", "svim_tpu_torch", "alignment",
               os.path.join(tmp_dir, "wd_multi"), bam, genome,
               "--distributed"] + common,
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        outputs = [proc.communicate(timeout=RUN_TIMEOUT)[0] for proc in ranks]
    finally:
        for proc in ranks:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    two_proc_s = time.perf_counter() - started
    for rank, proc in enumerate(ranks):
        if proc.returncode != 0:
            raise RuntimeError("rank {0} failed:\n{1}".format(
                rank, outputs[rank][-4000:]))
    multi_stages = _logged_json(outputs[0], "Stage seconds")
    exchange = _logged_json(outputs[0], "Exchange totals")

    single_cc = single_stages["collect"] + single_stages["cluster"]
    multi_cc = multi_stages["collect"] + multi_stages["cluster"]
    return {
        "single_s": single_s,
        "two_proc_s": two_proc_s,
        "efficiency": single_s / (2 * two_proc_s),
        "collect_cluster_single_s": single_cc,
        "collect_cluster_two_proc_s": multi_cc,
        "collect_cluster_efficiency": single_cc / (2 * multi_cc),
        "exchange_sent_bytes": exchange["sent"],
        "exchange_rounds": exchange["rounds"],
        "payload_soa_bytes": soa_bytes,
        "payload_pickle_bytes_round3_design": pickle_bytes,
        "n_reads": N_READS,
        "pinned": PINNED,
        "device": str(device),
        "caveat": ("single rank pinned to cores {0}; ranks pinned to "
                   "disjoint sets {1}; both ranks share one {2}".format(
                       SINGLE_CORES, ";".join(RANK_CORES), device.type)
                   if PINNED else
                   "both ranks share one {0} and this host's cores: "
                   "host-bound stages contend and the device is not split, "
                   "so this is no multi-card scaling figure".format(
                       "card" if device.type == "cuda" else "CPU")),
    }


if __name__ == "__main__":
    main()
