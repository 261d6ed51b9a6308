"""The sample with loci of all six classes
(svim_tpu_torch.workloads.sample_classes_workload: sample_workload with
loci of INV, DUP:TANDEM, DUP:INT and BND beside its DEL and INS loci) at a
small size on the CPU: a 3 Mb host at 10x, five loci a split-read class,
one of them wide (the 128-slot bucket), three of the DUP:INT loci copies of
one source.

The generator draws each read's breakpoints so that no split-read
partition has an exact float64 tie: the offset generators are checked
against cluster/accel.py's distances, and through the CLI no INV, DUP_TAN,
DUP_INT or BND partition is resolved on the host for a tie (pre_tie by
type).  Every segment of every read (the primary and each SA:Z entry) lies
inside its contig's LN, and the truth set lists every locus.  Through
--stream_input, svim_tpu and the port write byte-equal variants.vcf files
with equal clustering telemetry and accepted labelings by route, and the
port's device route receives partitions of all five fused types, one of 128
slots, and a DUP_INT candidate partition of three or more."""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from svim_tpu.cli import main as jax_main
from svim_tpu.cluster import device_cluster as jax_cluster
from svim_tpu_torch import cli as torch_cli
from svim_tpu_torch import workloads
from svim_tpu_torch.cluster import accel
from svim_tpu_torch.cluster import device_cluster as torch_cluster
from svim_tpu_torch.config import Config
from svim_tpu_torch.io import bam as bamio
from svim_tpu_torch.sim import evaluate_vcf

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(contig_length=3_000_000, partner_length=1_000_000, depth=10,
             ins_sizes=(50, 600), split_loci=5)
SPLIT_TYPES = ("INV", "DUP_TAN", "DUP_INT", "BND")
ROUTES = {"fused": "_consume_fused", "matrix": "_consume_matrix",
          "resident": "_consume_resident"}


def _made(directory):
    with open(os.path.join(directory, workloads.SAMPLE_FILE)) as handle:
        return json.load(handle)


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    """(directory, bam, genome, the records as io.bam reads them)."""
    directory = str(tmp_path_factory.mktemp("sample_classes"))
    bam, genome = workloads.sample_classes_workload(directory, 1, **SMALL)
    _header, records = bamio.read_bam(bam)
    return directory, bam, genome, records


@pytest.mark.parametrize("n", [12, 30, 41, 60])
def test_golomb_marks_differ_pairwise(n):
    marks = np.asarray(workloads._golomb_marks(n))
    assert len(marks) == n and marks[0] == 0
    assert np.diff(marks).min() >= 2
    differences = (marks[None, :] - marks[:, None])[np.triu_indices(n, 1)]
    assert len(set(differences.tolist())) == len(differences)


def test_ruler_offsets_give_bnd_partitions_no_tie():
    rng = np.random.default_rng(7)
    for n in (12, 30, 60):
        first, second = workloads._ruler_offsets(rng, n)
        assert (np.diff(first) > 0).all() and (np.diff(second) > 0).all()
        # BND's distance (cluster/accel.py), from the offsets of both ends
        distance = (np.abs(first[:, None] - first[None, :])
                    + np.abs(second[:, None] - second[None, :])) \
            / accel.BND_NORMALIZER
        condensed = distance[np.triu_indices(n, 1)]
        assert len(np.unique(condensed)) == len(condensed)


@pytest.mark.parametrize("columns", [2, 3])
def test_span_offsets_give_partitions_no_tie(columns):
    rng = np.random.default_rng(11)
    for n, size in ((30, 300), (100, 2_500)):
        offsets = workloads._span_offsets(rng, n, size, n, columns)
        assert offsets.shape == (columns, n)
        assert all(len(set(column.tolist())) == n for column in offsets)
        starts, ends = 10_001 + offsets[0], 10_001 + size + offsets[1]
        position, span = accel._span_position_terms(
            starts, ends, Config().position_distance_normalizer)
        distance = position + span
        if columns == 3:
            dest = offsets[2]
            distance = (position + np.abs(dest[:, None] - dest[None, :])
                        / Config().position_distance_normalizer + span)
        condensed = distance[np.triu_indices(n, 1)]
        assert len(np.unique(condensed)) == len(condensed)


def test_every_segment_lies_inside_its_contig(sample):
    directory, bam, _genome, records = sample
    header = bamio.read_bam(bam)[0]
    lengths = dict(zip(header.references, header.lengths))
    host, partner = workloads.SAMPLE_CONTIGS
    assert lengths == {host: SMALL["contig_length"],
                       partner: SMALL["partner_length"]}
    segments = 0
    for record in records:
        assert record.reference_id == 0
        assert 0 <= record.reference_start < record.reference_end \
            <= lengths[host]
        for entry in record.tags.get("SA", ("",))[0].split(";"):
            if not entry:
                continue
            contig, position, _strand, cigar = entry.split(",")[:4]
            aligned = sum(int(length) for length, op
                          in re.findall(r"(\d+)([MIDNSHP=X])", cigar)
                          if op in "MDN=X")
            assert 1 <= int(position)
            assert int(position) - 1 + aligned <= lengths[contig]
            segments += 1
    assert segments > _made(directory)["split_reads"]


def test_the_truth_lists_every_locus(sample):
    directory, _bam, _genome, _records = sample
    truth = workloads.load_truth(directory)
    made = _made(directory)
    loci = SMALL["split_loci"]
    assert {svtype: made["loci"][svtype] for svtype
            in workloads.SAMPLE_SPLIT_CLASSES} \
        == dict.fromkeys(workloads.SAMPLE_SPLIT_CLASSES, loci)
    count = {}
    for variant in truth:
        count[variant.svtype] = count.get(variant.svtype, 0) + 1
    # each DUP:INT has its four breakend records, each BND its mirror
    assert count["INV"] == count["DUP:TANDEM"] == count["DUP:INT"] == loci
    assert count["BND"] == 4 * loci + 2 * loci
    dup_int = [variant for variant in truth if variant.svtype == "DUP:INT"]
    copies = workloads.SAMPLE_DUP_COPIES[0]
    assert len({variant.start for variant in dup_int}) \
        == loci - copies + 1
    for variant in dup_int:
        assert variant.start - variant.dest_pos \
            >= workloads.SAMPLE_SOURCE_DISTANCE
    starts = sorted(variant.start for variant in truth
                    if variant.svtype in ("INV", "DUP:TANDEM"))
    assert min(starts) >= workloads.SAMPLE_MARGIN


def test_the_same_seed_gives_the_same_stream_without_svim_tpu(sample,
                                                              tmp_path):
    script = (
        "import json, sys\n"
        "sys.path.insert(0, {root!r})\n"
        "from svim_tpu_torch import workloads\n"
        "workloads.sample_classes_workload(sys.argv[1], 1,\n"
        "                                  **json.loads(sys.argv[2]))\n"
        "print(sorted(name for name in sys.modules if name.split('.')[0] in "
        "('jax', 'jaxlib', 'svim_tpu')))\n").format(root=ROOT)
    again = str(tmp_path / "again")
    loaded = subprocess.run(
        [sys.executable, "-c", script, again, json.dumps(SMALL)],
        capture_output=True, text=True, check=True, timeout=300).stdout
    assert loaded.strip() == "[]"
    assert _made(again)["inflated_sha256"] \
        == _made(sample[0])["inflated_sha256"]


def _count_routes(module, monkeypatch):
    accepted = {route: 0 for route in ROUTES}
    for route, name in ROUTES.items():
        original = getattr(module, name)

        def counted(*args, _original=original, _route=route, **kwargs):
            before = module.TELEMETRY.device
            results = _original(*args, **kwargs)
            accepted[_route] += module.TELEMETRY.device - before
            return results

        monkeypatch.setattr(module, name, counted)
    return accepted


def _pre_tie_by_type(module, monkeypatch):
    by_type = {}
    original = module._dispatch_fused

    def counted(samples, element_type, *args, **kwargs):
        before = module.TELEMETRY.pre_tie
        pending = original(samples, element_type, *args, **kwargs)
        by_type[element_type] = (by_type.get(element_type, 0)
                                 + module.TELEMETRY.pre_tie - before)
        return pending

    monkeypatch.setattr(module, "_dispatch_fused", counted)
    return by_type


def _telemetry(module):
    return {key: value for key, value in module.TELEMETRY.as_dict().items()
            if not key.endswith("_fraction")}


def _normalized(path):
    with open(path) as handle:
        return [line for line in handle if not line.startswith("##fileDate")]


def test_port_equals_svim_tpu_and_the_device_sees_every_class(
        sample, monkeypatch, tmp_path):
    directory, bam, genome, _records = sample
    truth = workloads.load_truth(directory)
    jax_dir = str(tmp_path / "jax")
    jax_accepted = _count_routes(jax_cluster, monkeypatch)
    jax_pre_tie = _pre_tie_by_type(jax_cluster, monkeypatch)
    assert jax_main(["alignment", jax_dir, bam, genome,
                     "--stream_input"]) == 0
    jax_telemetry = _telemetry(jax_cluster)

    monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")
    accepted = _count_routes(torch_cluster, monkeypatch)
    pre_tie = _pre_tie_by_type(torch_cluster, monkeypatch)
    fused = []
    add_fused = torch_cluster.DeviceBatcher.add_fused

    def spied_add_fused(self, sample_rows, wall_same_read,
                        element_type="DEL"):
        handle = add_fused(self, sample_rows, wall_same_read, element_type)
        fused.append((element_type, handle[1]))
        return handle

    monkeypatch.setattr(torch_cluster.DeviceBatcher, "add_fused",
                        spied_add_fused)
    candidates = []
    cluster_candidates = torch_cluster.cluster_candidates_device

    def spied_candidates(samples, *args, **kwargs):
        candidates.extend(len(partition) for partition in samples)
        return cluster_candidates(samples, *args, **kwargs)

    monkeypatch.setattr(torch_cluster, "cluster_candidates_device",
                        spied_candidates)
    working_dir = str(tmp_path / "port")
    assert torch_cli.main(["alignment", working_dir, bam, genome,
                           "--stream_input"]) == 0

    vcf = _normalized(os.path.join(working_dir, "variants.vcf"))
    assert vcf == _normalized(os.path.join(jax_dir, "variants.vcf"))
    assert _telemetry(torch_cluster) == jax_telemetry
    assert accepted == jax_accepted
    assert pre_tie == jax_pre_tie
    classes = evaluate_vcf(os.path.join(working_dir, "variants.vcf"), truth)
    for svtype in workloads.SAMPLE_SPLIT_CLASSES:
        assert classes[svtype][0] >= 0.9 * sum(
            variant.svtype == svtype for variant in truth)
    # the device route got every fused type, the 128-slot bucket, and a
    # candidate partition of the multi-copy DUP:INT
    assert {element_type for element_type, _pad in fused} \
        == {"DEL", "INV", "DUP_TAN", "DUP_INT", "BND"}
    assert any(pad == 128 for _element_type, pad in fused)
    assert max(candidates) >= 3
    # no split-read partition of the sample has an exact float64 tie
    assert {element_type: pre_tie[element_type]
            for element_type in SPLIT_TYPES} == dict.fromkeys(SPLIT_TYPES, 0)
    assert accepted["fused"] > 0
