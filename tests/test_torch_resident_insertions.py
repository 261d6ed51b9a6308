"""CLUSTER's resident insertion route (`--edit_backend wavefront`: the
near pairs' haplotype strings assembled on the host, their edit distances
computed by the wavefront, on the CPU its plain PyTorch version, and left
on the device for the matrices and the agglomeration) against the
benchmark's plain reference (svbench/reference), on a small seeded sample
made by the benchmark's maker with the long-tail cell's plan seed: every
pair's distance against the reference's own edit distance, the signature
clusters and variants.vcf against the reference's pipeline.  The job's
--profile record holds the route's spans (`cluster.ins_pairs`,
`cluster.ins_distances`) and counts (`wavefront.pairs`, `wavefront.cells`),
and the readers of `ins_pairs_s` and `ins_distance_s` read them; it also
holds the CPU the job cost the host (`host.cpu_ms`).  The card assembles each pair's strings from
byte segments (accel.ins_haplotype_segments), which spell the strings that
accel.ins_haplotype_pairs builds.

The long tail itself (the collapsed repeat's 100-signature partitions, the
16.7-30 kb inserts) is left to the benchmark's cell on the card: on the
CPU the plain wavefront takes minutes for it."""

import importlib.util
import json
import logging
import os

import pytest
import torch

from svbench import compare, maker
from svbench.reference.editdist import edit_distances
from svim_tpu_torch import cli
from svim_tpu_torch.cluster import accel
from svim_tpu_torch.config import parse_arguments
from svim_tpu_torch.ops import wavefront_kernel

torch.set_num_threads(1)
CPU = torch.device("cpu")
ARGUMENTS = ["--edit_backend", "wavefront"]
KNOBS = dict(plan_seed=1, contig_length=600_000, partner_length=200_000,
             depth=8, ins_sizes=(50, 1000), pileup=None, long_ins=None)
SEED = 7
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _StageSeconds(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.seen = []

    def emit(self, record):
        if record.msg == "Stage seconds: %s":
            self.seen.append(json.loads(record.args[0]))


def _reader(name):
    path = os.path.join(ROOT, "svbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("reader_" + name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _outputs(workdir):
    """What a job wrote: the signature clusters, the candidates and
    variants.vcf without its ##fileDate line."""
    written = {}
    for sub in ("signatures", "candidates"):
        for name in sorted(os.listdir(os.path.join(workdir, sub))):
            with open(os.path.join(workdir, sub, name), "rb") as handle:
                written[sub + "/" + name] = handle.read()
    with open(os.path.join(workdir, "variants.vcf"), "rb") as handle:
        written["variants.vcf"] = b"".join(
            line for line in handle if not line.startswith(b"##fileDate"))
    return written


@pytest.fixture(scope="module")
def made(tmp_path_factory):
    directory = str(tmp_path_factory.mktemp("resident"))
    bam, genome = maker.make(directory, seed=SEED, digest=False, **KNOBS)
    return directory, bam, genome


@pytest.fixture(scope="module")
def job(made):
    """One job with --profile; the pairs the route sent to the wavefront
    and the distances it left on the device."""
    directory, bam, genome = made
    seen = []
    original = wavefront_kernel.batched_edit_distance_resident
    original_segments = accel.ins_haplotype_segments

    def recorded(pairs, band_hints, device):
        out = original(pairs, band_hints, device)
        seen.append((list(pairs), out.tolist()))
        return out

    def spelled(partitions, reference):
        segments = original_segments(partitions, reference)
        strings = [pair for sample, starts, pairs_i, pairs_j in partitions
                   for pair in accel.ins_haplotype_pairs(
                       sample, starts, pairs_i, pairs_j, reference)]
        spellings.append((list(segments), strings))
        return segments

    spellings = []

    handler = _StageSeconds()
    root = logging.getLogger()
    level = root.level
    root.addHandler(handler)
    root.setLevel(logging.INFO)
    wavefront_kernel.batched_edit_distance_resident = recorded
    accel.ins_haplotype_segments = spelled
    try:
        workdir = os.path.join(directory, "job")
        options = parse_arguments(arguments=[
            "alignment", workdir, bam, genome, *ARGUMENTS, "--profile"])
        assert cli.run_pipeline(options, CPU) == 0
    finally:
        wavefront_kernel.batched_edit_distance_resident = original
        accel.ins_haplotype_segments = original_segments
        root.removeHandler(handler)
        root.setLevel(level)
    return {"bam": bam, "genome": genome, "workdir": workdir, "seen": seen,
            "spellings": spellings, "record": handler.seen[-1]}


def test_the_segments_spell_the_haplotype_strings(job):
    """The card's assembly reads the pairs that the string route builds
    (accel.ins_haplotype_pairs), pair for pair."""
    assert job["spellings"]
    for segments, strings in job["spellings"]:
        assert segments == strings


def test_the_strings_built_on_the_host_give_the_same_outputs(job, made,
                                                            monkeypatch):
    """The same job with every pair's strings spelled out on the host and
    their distances from the native host batch (as ins_haplotype_pairs
    and the `auto` backend would give them) writes the same bytes."""
    from svim_tpu_torch import native

    directory, bam, genome = made

    def on_the_host(pairs, band_hints, device):
        values = native.aligner.edit_distance_batch(list(pairs))
        return torch.as_tensor(values, dtype=torch.int32).to(device)

    monkeypatch.setattr(wavefront_kernel, "batched_edit_distance_resident",
                        on_the_host)
    workdir = os.path.join(directory, "host_strings")
    options = parse_arguments(arguments=[
        "alignment", workdir, bam, genome, *ARGUMENTS])
    assert cli.run_pipeline(options, CPU) == 0
    assert _outputs(workdir) == _outputs(job["workdir"])


def test_every_pair_distance_equals_the_reference(job):
    pairs = [pair for call, _ in job["seen"] for pair in call]
    values = [value for _, call in job["seen"] for value in call]
    assert len(pairs) > 100
    assert max(max(map(len, pair)) for pair in pairs) > 400
    assert values == edit_distances(pairs, "cpu")


def test_the_clusters_and_the_vcf_equal_the_reference(job):
    numbers = compare.check(job["workdir"], job["bam"], job["genome"],
                            ARGUMENTS, "cpu", SEED, threads=1)
    for name in ("signatures", "clusters", "records", "poa", "consensus"):
        assert numbers[name]["value"] == 0, (name, numbers)
    assert numbers["unapplied"]["value"] <= numbers["unapplied"]["limit"]


def test_the_record_holds_the_routes_spans_and_counts(job):
    record = job["record"]
    spans, counts = record["spans"], record["counts"]
    assert 0 < spans["cluster.ins_pairs"] < record["cluster"]
    assert 0 < spans["cluster.ins_distances"] < record["cluster"]
    pairs = [pair for call, _ in job["seen"] for pair in call]
    assert counts["wavefront.pairs"] == sum(1 for a, b in pairs if a and b)
    # a pair covers at least its strings' band of the DP and at most the
    # padded square
    lengths = [max(len(a), len(b)) for a, b in pairs]
    assert sum(lengths) < counts["wavefront.cells"]
    assert counts["wavefront.cells"] <= sum(
        wavefront_kernel._pow2_at_least(n, 512) ** 2 for n in lengths)
    # the CPU the job cost the host
    assert counts["host.cpu_ms"] > 0
    trace = {"stages": [record]}
    assert _reader("ins_pairs_s").read(trace) == spans["cluster.ins_pairs"]
    assert _reader("ins_distance_s").read(trace) == \
        spans["cluster.ins_distances"]
    assert _reader("ins_pairs_s").read({"stages": [{"spans": {}}]}) is None


@pytest.mark.parametrize("length,band", [(512, 64), (1024, 256),
                                         (4096, 4096), (4096, 100000)])
def test_a_launch_covers_the_band_cells_of_its_padded_square(length, band):
    expected = sum(min(length, i + band) - max(1, i - band) + 1
                   for i in range(1, length + 1))
    assert wavefront_kernel.covered_cells(length, band) == expected
