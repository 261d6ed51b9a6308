"""The port's measuring scripts, the counterparts of
scripts/measure_multihost.py, profile_stream_vs_oneshot.py and
profile_ins_tpu.py, run to their JSON lines on the CPU at 256 reads of
bench's workload, with the keys their originals print; the workload is
written once and shared through SVIM_SCALE_WORKLOAD_DIR /
SVIM_BENCH_WORKLOAD_DIR."""

import json
import os
import subprocess
import sys

import pytest

from svim_tpu_torch import workloads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
READS = 256
MULTIHOST_KEYS = {"single_s", "two_proc_s", "efficiency",
                  "collect_cluster_single_s", "collect_cluster_two_proc_s",
                  "collect_cluster_efficiency", "exchange_sent_bytes",
                  "exchange_rounds", "payload_soa_bytes",
                  "payload_pickle_bytes_round3_design", "n_reads", "pinned",
                  "caveat"}
STREAM_KEYS = ["stream_host_only", "n_batches", "collect_streaming",
               "oneshot_scan", "oneshot_device", "oneshot_materialize",
               "sig_parity", "cluster"]
INS_KEYS = ["form_partitions", "ed_precompute", "n_pairs",
            "matrix_prep+dispatch", "consume", "n_fallback", "full_route"]


@pytest.fixture(scope="module")
def shared(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("bench"))
    workloads.bench_workload(directory, READS)
    return directory


def _run(script, tmp_path, **environment):
    env = dict(os.environ, SVIM_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1",
               TMPDIR=str(tmp_path), **environment)
    env.pop("PYTHONPATH", None)
    result = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", script)],
        capture_output=True, text=True, timeout=600, env=env, cwd=tmp_path)
    assert result.returncode == 0, result.stderr[-4000:]
    assert os.listdir(tmp_path) == []   # its temporary directory is removed
    return result.stdout.strip().splitlines()


def test_measure_multihost_torch(tmp_path, shared):
    lines = _run("measure_multihost_torch.py", tmp_path,
                 SVIM_SCALE_READS=str(READS), SVIM_SCALE_WORKLOAD_DIR=shared)
    result = json.loads(lines[-1])
    assert MULTIHOST_KEYS <= set(result)
    assert result["n_reads"] == READS and result["device"] == "cpu"
    assert result["single_s"] > 0 and result["two_proc_s"] > 0
    assert result["collect_cluster_single_s"] > 0
    assert result["collect_cluster_two_proc_s"] > 0
    # the COLLECT exchange, then CLUSTER's and COMBINE's
    assert result["exchange_rounds"] >= 2
    assert result["exchange_sent_bytes"] > 0
    assert result["payload_soa_bytes"] > 0
    assert "share one CPU" in result["caveat"]


@pytest.mark.parametrize("script, keys, header", [
    ("profile_stream_vs_oneshot_torch.py", STREAM_KEYS, ["platform: cpu"]),
    ("profile_ins_torch.py", INS_KEYS, ["platform: cpu", "n_ins: 192"])])
def test_profile_scripts(tmp_path, shared, script, keys, header):
    lines = _run(script, tmp_path, SVIM_BENCH_READS=str(READS),
                 SVIM_BENCH_WORKLOAD_DIR=shared)
    assert lines[:len(header)] == header
    rounds = [json.loads(line) for line in lines[len(header):]]
    assert len(rounds) == 3
    for entry in rounds:
        assert list(entry) == keys
        assert entry.get("sig_parity", True) is True
        assert entry.get("n_fallback", 0) == 0
