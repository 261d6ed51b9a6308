"""Mid-scan incremental clustering in the port (svim_tpu_torch.cluster.
incremental, collect.packed): the memo must only ever reproduce what the
ordinary CLUSTER stage computes, and what the JAX package computes.

The inputs are those of tests/test_incremental_cluster.py (DEL and INS
pileups that finalize behind the scan frontier, split reads that land
anywhere), with the scan delivered in chunks of 24 rows so that the
mid-scan path runs.  Tolerance: exact (VCF and BED bytes, integer index
arrays).  Where svim_tpu's clusterer disables itself after any error, the
port's lets the error through."""

import logging
import random

import numpy as np
import pytest
import torch

from svim_tpu.cli import main as jax_main
from svim_tpu_torch import cli as torch_cli
from svim_tpu_torch import workloads
from svim_tpu_torch.cluster import device_cluster
from svim_tpu_torch.cluster.cluster import clusters_from_partitions
from svim_tpu_torch.cluster.partition import form_partitions_table
from svim_tpu_torch.collect.packed import collect_soa_from_bam
from svim_tpu_torch.config import parse_arguments
from svim_tpu_torch.io.fasta import FastaFile

from tests.test_incremental_cluster import _strip_date, _write_inputs

CPU = torch.device("cpu")
torch.set_num_threads(1)
BEDS = ("del.bed", "ins.bed", "inv.bed", "dup_tan_source.bed",
        "dup_tan_dest.bed", "dup_int.bed", "trans.bed")


@pytest.mark.parametrize("edit_backend", ["auto", "wavefront"])
def test_memo_populates_and_matches_fresh(tmp_path, edit_backend):
    """collect_soa_from_bam attaches a non-empty memo under small batches,
    and every memo entry equals a fresh clustering of that partition."""
    bam_path, genome_path = _write_inputs(tmp_path, random.Random(11))
    options = parse_arguments(arguments=[
        "alignment", str(tmp_path), bam_path, genome_path,
        "--batch_reads", "24", "--edit_backend", edit_backend])
    with workloads.chunked_scan(24):
        _header, _table, soa, _twins = collect_soa_from_bam(bam_path, options,
                                                            CPU)
    memo = soa.cluster_memo
    assert memo, "no partitions were memoized mid-scan"

    hits = 0
    with FastaFile(genome_path) as reference:
        for sig_type, table in soa.tables.items():
            for partition in form_partitions_table(
                    table, options.partition_max_distance):
                stored = memo.get((sig_type, partition.indices.tobytes()))
                if stored is None:
                    continue
                hits += 1
                fresh = clusters_from_partitions([partition], reference,
                                                 options, CPU)
                assert [list(array) for array in stored] == \
                    [np.asarray(cluster.indices).tolist() for cluster in fresh]
    assert hits > 0, "memo never matched a final partition"


def test_incremental_off_attaches_no_memo(tmp_path):
    bam_path, genome_path = _write_inputs(tmp_path, random.Random(11))
    options = parse_arguments(arguments=[
        "alignment", str(tmp_path), bam_path, genome_path,
        "--batch_reads", "24", "--incremental_cluster", "off"])
    with workloads.chunked_scan(24):
        _header, _table, soa, _twins = collect_soa_from_bam(bam_path, options,
                                                            CPU)
    assert soa.cluster_memo is None


def _reused(working_dir):
    """(reused, memoized) from the run's log line, or None without one."""
    for path in sorted(working_dir.glob("SVIM_*.log")):
        for line in path.read_text().splitlines():
            if "Incremental clustering: " in line:
                words = line.split("Incremental clustering: ", 1)[1].split()
                return int(words[0]), int(words[2])
    return None


def _detach_log_handlers(before):
    root = logging.getLogger()
    for handler in root.handlers[:]:
        if handler not in before:
            root.removeHandler(handler)
            handler.close()


@pytest.mark.parametrize("extra", [[], ["--all_bnds"],
                                   ["--edit_backend", "wavefront"]])
def test_incremental_pipeline_byte_parity(tmp_path, monkeypatch, extra):
    """The port's CLI with mid-scan clustering on and off, and svim_tpu's:
    byte-equal VCFs and signature BEDs (only ##fileDate may differ), with
    memo partitions reused in the `auto` run."""
    monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")
    bam_path, genome_path = _write_inputs(tmp_path, random.Random(13))
    wd_auto, wd_off, wd_jax = (tmp_path / name
                               for name in ("wd_auto", "wd_off", "wd_jax"))
    common = ["--batch_reads", "24"] + extra
    before = list(logging.getLogger().handlers)
    try:
        with workloads.chunked_scan(24):
            assert torch_cli.main(["alignment", str(wd_auto), bam_path,
                                   genome_path] + common) == 0
            assert torch_cli.main(["alignment", str(wd_off), bam_path,
                                   genome_path, "--incremental_cluster",
                                   "off"] + common) == 0
        assert jax_main(["alignment", str(wd_jax), bam_path, genome_path]
                        + common) == 0
    finally:
        _detach_log_handlers(before)
    reused, memoized = _reused(wd_auto)
    assert 0 < reused <= memoized
    assert _reused(wd_off) is None
    assert _strip_date(wd_auto / "variants.vcf") \
        == _strip_date(wd_off / "variants.vcf") \
        == _strip_date(wd_jax / "variants.vcf")
    for name in BEDS:
        assert (wd_auto / "signatures" / name).read_bytes() \
            == (wd_off / "signatures" / name).read_bytes() \
            == (wd_jax / "signatures" / name).read_bytes(), name


def test_device_error_inside_observe_propagates(tmp_path, monkeypatch):
    """A device op that fails mid-scan ends COLLECT with that error (the
    JAX package's clusterer would log it and carry on without a memo)."""
    bam_path, genome_path = _write_inputs(tmp_path, random.Random(11))
    options = parse_arguments(arguments=[
        "alignment", str(tmp_path), bam_path, genome_path,
        "--batch_reads", "24"])
    calls = []

    def failing_op(*args, **kwargs):
        calls.append(args)
        raise RuntimeError("device op failed mid-scan")

    monkeypatch.setattr(device_cluster, "span_position_agglomerate_batched",
                        failing_op)
    with workloads.chunked_scan(24):
        with pytest.raises(RuntimeError, match="device op failed mid-scan"):
            collect_soa_from_bam(bam_path, options, CPU)
    assert len(calls) == 1
    # with the feature off COLLECT never reaches the op
    off = options.replace(incremental_cluster="off")
    with workloads.chunked_scan(24):
        collect_soa_from_bam(bam_path, off, CPU)
    assert len(calls) == 1
