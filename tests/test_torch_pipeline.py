"""The port's slice end to end on the CPU: `python -m svim_tpu_torch
alignment` on the golden workload writes a variants.vcf byte-equal to
tests/golden/variants.golden.vcf (with the default and the wavefront edit
backend) and signature BED files equal to svim_tpu's, resolving its
clustering partitions by the same routes (FallbackTelemetry); the
device-resident INS route clusters exactly like svim_tpu's; --device_backend
cpu and host and --profile_trace write the same VCF bytes (tpu is refused by
name); no input that svim_tpu runs raises NotImplementedError."""

import importlib.util
import json
import logging
import os
import random

import numpy as np
import pytest
import torch

from svim_tpu.cli import main as jax_main
from svim_tpu.cluster import accel
from svim_tpu.cluster import device_cluster as jax_cluster
from svim_tpu.config import parse_arguments
from svim_tpu.signatures import SignatureInsertion
from svim_tpu.sim import SimConfig, simulate
from svim_tpu_torch import cli as torch_cli
from svim_tpu_torch.cluster import device_cluster as torch_cluster

CPU = torch.device("cpu")
# one intra-op thread: the suite runs several pytest workers, and the
# plain versions are many small ops that oversubscribed threads stall
torch.set_num_threads(1)
TESTS = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(TESTS, "golden", "variants.golden.vcf")
# the SimConfig of tests/test_golden_vcf.py
_SIM = dict(seed=42, genome_length=900_000, second_contig_length=250_000,
            coverage=9, n_del=3, n_ins=3, n_inv=2, n_tan=2, n_dup_int=2,
            n_bnd=2, n_background=50)


def _normalize(path):
    with open(path) as handle:
        return [line for line in handle if not line.startswith("##fileDate")]


def _telemetry(module):
    counts = module.TELEMETRY.as_dict()
    return {key: value for key, value in counts.items()
            if not key.endswith("_fraction")}


def _smoke_golden_telemetry():
    """chip_smoke.GOLDEN_TELEMETRY: what the smoke holds the card's golden
    run to."""
    spec = importlib.util.spec_from_file_location(
        "_chip_smoke", os.path.join(os.path.dirname(TESTS), "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.GOLDEN_TELEMETRY


@pytest.fixture(scope="module")
def golden_run(tmp_path_factory):
    """The golden workload and svim_tpu's own runs over it, with the
    default and the wavefront edit backend (their clustering telemetry by
    backend)."""
    directory = tmp_path_factory.mktemp("golden")
    genome, bam, _truth = simulate(str(directory), SimConfig(**_SIM))
    jax_wd = directory / "jax"
    assert jax_main(["alignment", str(jax_wd), bam, genome]) == 0
    telemetry = {"auto": _telemetry(jax_cluster)}
    assert jax_main(["alignment", str(directory / "jax_wavefront"), bam,
                     genome, "--edit_backend", "wavefront"]) == 0
    telemetry["wavefront"] = _telemetry(jax_cluster)
    return directory, bam, genome, jax_wd, telemetry


@pytest.mark.parametrize("edit_backend", ["auto", "wavefront"])
def test_port_writes_golden_vcf_and_jax_signature_beds(golden_run,
                                                       edit_backend,
                                                       monkeypatch):
    directory, bam, genome, jax_wd, jax_telemetry = golden_run
    monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")
    wd = directory / "port_{0}".format(edit_backend)
    assert torch_cli.main(["alignment", str(wd), bam, genome,
                           "--edit_backend", edit_backend]) == 0
    assert _normalize(wd / "variants.vcf") == _normalize(GOLDEN)
    assert _telemetry(torch_cluster) == jax_telemetry[edit_backend]
    if edit_backend == "wavefront":
        assert jax_telemetry[edit_backend] == _smoke_golden_telemetry()
    beds = sorted(name for name in os.listdir(jax_wd / "signatures")
                  if name.endswith(".bed"))
    assert len(beds) >= 6
    for name in beds:
        assert (wd / "signatures" / name).read_bytes() \
            == (jax_wd / "signatures" / name).read_bytes(), name


def _drop_log_handlers(before):
    root = logging.getLogger()
    for handler in root.handlers[:]:
        if handler not in before:
            root.removeHandler(handler)
            handler.close()


@pytest.mark.parametrize("device_backend", ["cpu", "host"])
def test_device_backend_cpu_and_host_write_the_golden_vcf(golden_run,
                                                          device_backend,
                                                          monkeypatch):
    """`cpu` asks for the CPU through the flag alone; `host` takes the
    record-based COLLECT and GENOTYPE (CLUSTER stays on the selected
    device, here the CPU through the environment)."""
    directory, bam, genome, jax_wd, _telemetry_by_backend = golden_run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if device_backend == "cpu":
        monkeypatch.delenv("SVIM_TORCH_DEVICE", raising=False)
    else:
        monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")
    from svim_tpu_torch.collect import packed as collect_packed
    from svim_tpu_torch.ops import genotype_kernel

    if device_backend == "host":
        def no_device_pass(*args, **kwargs):
            raise AssertionError("--device_backend host ran a device pass")

        monkeypatch.setattr(collect_packed, "collect_soa_from_bam",
                            no_device_pass)
        monkeypatch.setattr(genotype_kernel, "genotype_ref_support_device",
                            no_device_pass)
    wd = directory / "port_backend_{0}".format(device_backend)
    before = list(logging.getLogger().handlers)
    try:
        assert torch_cli.main(["alignment", str(wd), bam, genome,
                               "--device_backend", device_backend]) == 0
    finally:
        _drop_log_handlers(before)
    assert _normalize(wd / "variants.vcf") == _normalize(GOLDEN) \
        == _normalize(jax_wd / "variants.vcf")
    log = "".join(path.read_text() for path in wd.glob("SVIM_*.log"))
    assert "DEVICE: cpu" in log
    assert ("packed array COLLECT path" in log) == (device_backend == "cpu")


def test_profile_trace_writes_traces_and_the_same_vcf(golden_run,
                                                      monkeypatch):
    directory, bam, genome, _jax_wd, _telemetry_by_backend = golden_run
    monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")
    wd = directory / "port_traced"
    before = list(logging.getLogger().handlers)
    try:
        assert torch_cli.main(["alignment", str(wd), bam, genome,
                               "--profile_trace"]) == 0
    finally:
        _drop_log_handlers(before)
    assert _normalize(wd / "variants.vcf") == _normalize(GOLDEN)
    for stage in ("collect", "cluster"):
        trace = json.loads((wd / "traces" / (stage + ".json")).read_text())
        assert trace["traceEvents"], stage
    assert sorted(os.listdir(wd / "traces")) == ["cluster.json",
                                                 "collect.json"]
    log = "".join(path.read_text() for path in wd.glob("SVIM_*.log"))
    assert "--profile_trace instruments host threads" in log
    assert "Stage timings" in log
    # without the flag nothing is traced
    assert not (directory / "port_auto" / "traces").exists()


def test_help_text_names_no_other_framework(capsys):
    with pytest.raises(SystemExit):
        torch_cli.main(["alignment", "--help"])
    text = capsys.readouterr().out
    assert "--device_backend" in text and "--profile_trace" in text
    assert "jax" not in text.lower()


class _Reference:
    """Deterministic fake genome: fetch is a pure function of coordinates."""

    def fetch(self, contig, start, end):
        rng = random.Random(hash((contig, 9)) & 0xFFFF)
        block = "".join(rng.choice("ACGT") for _ in range(512))
        return "".join(block[pos % len(block)] for pos in range(start, end))


def _partition(rng, n, base, motif_len, read_offset=0, same_read_dup=False):
    motif = "".join(rng.choice("ACGT") for _ in range(motif_len))
    elements = []
    for k in range(n):
        seq = list(motif)
        for _ in range(rng.randint(0, 3)):
            seq[rng.randrange(len(seq))] = rng.choice("ACGT")
        start = base + rng.randint(-6, 6)
        elements.append(SignatureInsertion(
            "chr1", start, start + len(seq), "cigar",
            "read{0}".format(read_offset + k), "".join(seq)))
    if same_read_dup:
        first = elements[0]
        elements.append(SignatureInsertion(
            "chr1", first.start + 1, first.start + 1 + motif_len, "cigar",
            first.read, first.sequence))
    return elements


def _flatten(results, count):
    return [[[(e.read, e.start, e.end) for e in cluster]
             for cluster in results[index].clusters]
            for index in range(count)]


def test_resident_ins_route_equals_jax():
    """The cases of tests/test_ins_resident.py through both packages'
    device-resident INS routes (wavefront edit distances, on-device
    matrices, agglomeration)."""
    rng = random.Random(77)
    reference = _Reference()
    options = parse_arguments(arguments=["alignment", "/tmp", "/tmp/x.bam",
                                         "/tmp/g.fa", "--edit_backend",
                                         "wavefront"])
    samples = [
        _partition(rng, 8, 50_000, 120, read_offset=0),
        _partition(rng, 5, 90_000, 60, read_offset=100),
        (_partition(rng, 4, 140_000, 90, read_offset=200)
         + _partition(rng, 4, 141_500, 90, read_offset=300)),
        _partition(rng, 6, 200_000, 80, read_offset=400, same_read_dup=True),
        [SignatureInsertion("chr1", 70_000, 70_080, "cigar",
                            "tie{0}".format(k), "ACGTACGTAA" * 8)
         for k in range(6)],
    ]
    jax_cluster.TELEMETRY.reset()
    want = jax_cluster.consume_partitions_device(
        jax_cluster.dispatch_ins_resident(samples, reference, options,
                                          jax_cluster.DeviceBatcher(options)))
    torch_cluster.TELEMETRY.reset()
    batcher = torch_cluster.DeviceBatcher(options, CPU)
    got = torch_cluster.consume_partitions_device(
        torch_cluster.dispatch_ins_resident(samples, reference, options,
                                            batcher))
    assert _flatten(got, len(samples)) == _flatten(want, len(samples))
    assert torch_cluster.TELEMETRY.as_dict() == jax_cluster.TELEMETRY.as_dict()
    # the edit distances the device route used are the exact ones
    ed_all = batcher.extra_outputs[("ins_ed",)].numpy()
    starts, _spans, pairs_i, pairs_j, _hints = accel.ins_near_pairs(
        samples[0], options)
    pairs = accel.ins_haplotype_pairs(samples[0], starts, pairs_i, pairs_j,
                                      reference)
    from svim_tpu.cluster.edit_distance import edit_distance
    np.testing.assert_array_equal(ed_all[:len(pairs)],
                                  [edit_distance(a, b) for a, b in pairs])


def test_inputs_outside_the_slice_raise(tmp_path, monkeypatch):
    """Nothing svim_tpu runs is refused any more: `reads` mode,
    --num_shards and --distributed are ported (tests/test_torch_reads.py,
    test_torch_parallel.py, test_torch_multihost.py), and the gate that
    raised NotImplementedError for them is gone.  What is still refused is
    what svim_tpu refuses too, and the TPU backend."""
    monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")
    assert not hasattr(torch_cli, "check_supported")
    assert not hasattr(torch_cli, "_not_ported")
    with open(torch_cli.__file__) as handle:
        assert "NotImplementedError" not in handle.read()
    # the port has no TPU backend: refused by name, pointing at `auto`
    with pytest.raises(ValueError, match="--device_backend tpu.*auto"):
        torch_cli.main(["alignment", str(tmp_path / "tpu"), "x.bam", "g.fa",
                        "--device_backend", "tpu"])
    assert not (tmp_path / "tpu").exists()
    # an unsorted input is refused as svim_tpu refuses it: logged, exit 1
    sam = tmp_path / "x.sam"
    sam.write_text("@HD\tVN:1.6\tSO:unsorted\n@SQ\tSN:chr1\tLN:1000\n")
    genome = tmp_path / "g.fa"
    genome.write_text(">chr1\n" + "ACGT" * 250 + "\n")
    for main in (torch_cli.main, jax_main):
        assert main(["alignment", str(tmp_path / main.__module__), str(sam),
                     str(genome)]) == 1
    assert torch_cli._collect(parse_arguments(arguments=[
        "alignment", str(tmp_path), str(sam), str(genome)]), CPU) is None
