"""The port's slice end to end on the CPU: `python -m svim_tpu_torch
alignment` on the golden workload writes a variants.vcf byte-equal to
tests/golden/variants.golden.vcf (with the default and the wavefront edit
backend) and signature BED files equal to svim_tpu's, resolving its
clustering partitions by the same routes (FallbackTelemetry); the
device-resident INS route clusters exactly like svim_tpu's; inputs outside
the slice raise NotImplementedError naming their ROADMAP item."""

import importlib.util
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
    monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")

    def options(*extra, sub="alignment"):
        if sub == "reads":
            return parse_arguments(arguments=["reads", str(tmp_path),
                                              "r.fa", "g.fa"])
        return parse_arguments(arguments=["alignment", str(tmp_path),
                                          "x.bam", "g.fa", *extra])

    for bad, item in ((options(sub="reads"), "Queue 1 item 8"),
                      (options("--num_shards", "2"), "Queue 1 item 10"),
                      (options("--distributed"), "Queue 1 item 10"),
                      (options("--device_backend", "host"),
                       "Queue 1 item 11")):
        with pytest.raises(NotImplementedError, match=item):
            torch_cli.check_supported(bad)
    torch_cli.check_supported(options("--edit_backend", "wavefront"))
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
