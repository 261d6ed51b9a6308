"""bench_torch.py, the port's counterpart of bench.py, at 256 reads on the
CPU: its array path gives bench.py's signatures and clusters under JAX, its
baseline loop gives bench.py's host-loop signatures, the script prints
bench.py's four keys, refuses to run without a card unless the CPU is asked
for, refuses read counts whose reads pass chr1's LN before writing anything,
and a VCF that misses the pin ends it before any timing."""

import importlib.util
import json
import os
import subprocess
import sys

import pytest
import torch

from svim_tpu.collect.packed import collect_soa_from_bam as jax_collect
from svim_tpu.config import parse_arguments as jax_arguments
from svim_tpu_torch import workloads
from svim_tpu_torch.config import parse_arguments
from svim_tpu_torch.sigtable import SIG_TYPES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "bench_torch.py")
READS = 256
CPU = torch.device("cpu")
KEYS = {"metric", "value", "unit", "vs_baseline"}


def _module(name, path, **environment):
    """`path` imported as `name` with `environment` set while it loads."""
    previous = {key: os.environ.get(key) for key in environment}
    os.environ.update(environment)
    try:
        spec = importlib.util.spec_from_file_location(name, path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        for key, value in previous.items():
            if value is None:
                del os.environ[key]
            else:
                os.environ[key] = value
    return module


@pytest.fixture(scope="module")
def workload(tmp_path_factory):
    directory = tmp_path_factory.mktemp("bench")
    bam, genome = workloads.bench_workload(str(directory), READS)
    return str(directory), bam, genome


def _signature_strings(soa):
    return {sig_type: [s.as_string() for s in soa.tables[sig_type]
                       .materialize_list(range(soa.tables[sig_type].n))]
            for sig_type in SIG_TYPES}


def _bed_entries(cluster_lists):
    return [[(c.get_bed_entries() if hasattr(c, "get_bed_entries")
              else c.get_bed_entry()) for c in clusters]
            for clusters in cluster_lists]


def test_array_path_equals_bench_py_under_jax(workload):
    """collect_and_cluster on the CPU: bench.py's collect_soa_from_bam +
    run_cluster signatures and clusters, in order."""
    directory, bam, genome = workload
    arguments = ["alignment", directory, bam, genome]
    bench = _module("_bench_256", os.path.join(REPO, "bench.py"),
                    SVIM_BENCH_READS=str(READS))
    bench_torch = _module("_bench_torch_256", SCRIPT,
                          SVIM_BENCH_READS=str(READS))
    jax_options = jax_arguments(arguments=arguments)
    _h, _t, jax_signatures, _tw = jax_collect(bam, jax_options)
    jax_clusters = bench.run_cluster(jax_signatures, jax_options)

    signatures, clusters, collect_s, cluster_s = \
        bench_torch.collect_and_cluster(bam, parse_arguments(
            arguments=arguments), CPU)
    assert collect_s > 0 and cluster_s > 0
    expected = _signature_strings(jax_signatures)
    assert len(expected["DEL"]) > 0 and len(expected["INS"]) > 0
    assert _signature_strings(signatures) == expected
    assert sum(map(len, jax_clusters)) > 0
    assert _bed_entries(clusters) == _bed_entries(jax_clusters)


def test_baseline_loop_equals_bench_py_host_loop(workload):
    """baseline_signatures over the port's record-based copies: the
    signatures of bench.py's host loop over svim_tpu's, and the scalar
    clustering path's clusters on them."""
    from svim_tpu.cluster.reference_path import (
        cluster_sv_signatures_reference as jax_reference,
    )
    from svim_tpu.collect.collect import retrieve_other_alignments
    from svim_tpu.collect.inter import analyze_read_segments
    from svim_tpu.collect.intra import analyze_alignment_indel
    from svim_tpu.io.sam import AlignmentFile as JaxAlignmentFile

    from svim_tpu_torch.cluster.reference_path import (
        cluster_sv_signatures_reference,
    )
    from svim_tpu_torch.io.sam import AlignmentFile

    directory, bam, genome = workload
    arguments = ["alignment", directory, bam, genome]
    bench_torch = _module("_bench_torch_256", SCRIPT,
                          SVIM_BENCH_READS=str(READS))
    options = jax_arguments(arguments=arguments)
    bam_host = JaxAlignmentFile(bam)
    expected = []
    for record in bam_host.fetch(until_eof=True):   # bench.py's host loop
        supplementary = [aln for aln in retrieve_other_alignments(record,
                                                                  bam_host)
                         if aln.mapping_quality >= options.min_mapq]
        sigs, _ = analyze_alignment_indel(record, bam_host, record.query_name,
                                          options)
        expected.extend(sigs)
        sigs, _ = analyze_read_segments(record, supplementary, bam_host,
                                        options)
        expected.extend(sigs)

    port_options = parse_arguments(arguments=arguments)
    port_bam = AlignmentFile(bam)
    got = bench_torch.baseline_signatures(
        port_bam, list(port_bam.fetch(until_eof=True)), port_options)
    assert len(expected) > 0
    assert [s.as_string() for s in got] == [s.as_string() for s in expected]
    assert (_bed_entries(cluster_sv_signatures_reference(got, port_options))
            == _bed_entries(jax_reference(expected, options)))


def _run_script(tmp_path, **environment):
    env = dict(os.environ, OMP_NUM_THREADS="1", TMPDIR=str(tmp_path),
               SVIM_BENCH_READS=str(READS), SVIM_BENCH_REPEATS="1")
    env.update(environment)
    env.pop("PYTHONPATH", None)
    for key in [key for key, value in environment.items() if value is None]:
        env.pop(key)
    return subprocess.run([sys.executable, SCRIPT], capture_output=True,
                          text=True, timeout=600, env=env, cwd=tmp_path)


def test_script_prints_bench_py_keys_on_the_cpu(tmp_path):
    result = _run_script(tmp_path, SVIM_TORCH_DEVICE="cpu")
    assert result.returncode == 0, result.stderr[-4000:]
    lines = result.stdout.strip().splitlines()
    last = json.loads(lines[-1])
    assert set(last) == KEYS
    assert last["value"] > 0 and last["vs_baseline"] > 0
    assert last["unit"] == "reads/s"
    assert last["metric"] == ("aligned reads/s through signature extraction"
                              "+clustering (1 chip: cpu)")
    earlier = {line.split(": ", 1)[0]: line.split(": ", 1)[1]
               for line in lines[:-1]}
    assert earlier["gate"].startswith("none: ")
    rounds = json.loads(earlier["rounds"])
    assert len(rounds["collect_s"]) == len(rounds["cluster_s"]) == 1
    launches = json.loads(earlier["launches"])
    assert launches["collect_scan"] == launches["classify_segments"] == 0
    baseline = json.loads(earlier["baseline"])
    assert baseline["best_s"] > 0 and baseline["ingest_s"] > 0
    assert last["value"] == READS / rounds["best_s"]
    assert os.listdir(tmp_path) == []   # its working directory is removed


def test_script_needs_a_card_unless_the_cpu_is_asked(tmp_path):
    result = _run_script(tmp_path, SVIM_TORCH_DEVICE=None,
                         CUDA_VISIBLE_DEVICES="")
    assert result.returncode != 0
    assert "SVIM_TORCH_DEVICE=cpu" in result.stderr
    assert not any(line.startswith("{") for line in
                   result.stdout.splitlines())
    assert os.listdir(tmp_path) == []


def test_script_refuses_reads_past_chr1_before_writing(tmp_path):
    shared = tmp_path / "shared"
    result = _run_script(tmp_path, SVIM_TORCH_DEVICE="cpu",
                         SVIM_BENCH_READS="40000",
                         SVIM_BENCH_WORKLOAD_DIR=str(shared))
    assert result.returncode != 0
    assert "workloads.sample_workload" in result.stderr
    assert result.stdout == ""
    assert os.listdir(tmp_path) == []


def test_a_changed_pin_fails_the_gate_before_any_timing(tmp_path,
                                                        monkeypatch, workload):
    directory, _bam, _genome = workload
    bench_torch = _module("_bench_torch_gate", SCRIPT,
                          SVIM_BENCH_READS=str(READS),
                          SVIM_BENCH_WORKLOAD_DIR=directory)
    monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(bench_torch.tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(bench_torch, "PINS", {READS: "0" * 64})

    def timed(*_args):
        raise AssertionError("timed behind a failed gate")

    monkeypatch.setattr(bench_torch, "ingest_bound", timed)
    monkeypatch.setattr(bench_torch, "run_array", timed)
    with pytest.raises(SystemExit, match="differs from svim_tpu's"):
        bench_torch.main()
    assert os.listdir(tmp_path) == []


def test_launch_counts_read_and_reset_every_kernel_counter(monkeypatch):
    """The counters bench_torch.py, the CLI's --profile line and
    chip_smoke.py read: every wrapper module's, by kernel name."""
    import importlib

    from svim_tpu_torch import ops

    modules = {name: importlib.import_module("svim_tpu_torch.ops." + module)
               for name, (module, _) in ops.KERNEL_COUNTERS.items()}
    for number, (name, (_, attribute)) in enumerate(
            ops.KERNEL_COUNTERS.items(), start=1):
        monkeypatch.setattr(modules[name], attribute, number)
    assert ops.launch_counts() == {
        name: number for number, name in enumerate(ops.KERNEL_COUNTERS, 1)}
    assert set(ops.KERNEL_COUNTERS) == {
        "wavefront_banded_distance", "span_distance_matrix", "agglomerate",
        "collect_scan", "classify_segments", "genotype_support",
        "ins_matrices", "gotoh_align"}
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}
