"""The sample workload (svim_tpu_torch.workloads.sample_workload: a
chromosome of a 30x ONT-like sample, ~114,000 reads at its defaults) at a
small size on the CPU: a 2 Mb host contig at 10x with insertions of at most
600 bp (the JAX wavefront's CPU time grows with the insert length).

The generator writes the BAM's record bytes itself: they must be the bytes
io.bam's writer gives the same records, the same seed must give the same
inflated stream (also in a process that holds nothing of svim_tpu), every
read must lie inside its contig's LN (check_inside refuses one that does
not: bench.py's generator places reads past chr1's LN above 33,333 reads)
and the truth set must list every locus the reads carry.  Through
--stream_input, svim_tpu and the port must write byte-equal variants.vcf
files with either edit backend, with equal per-class counts, clustering
telemetry and accepted labelings by route.

The port's plain wavefront distance is a Python loop, minutes on the CPU at
these insertion lengths, so the wavefront case hands the port's resident
route exact distances from the native batch (the values the kernel returns:
its band hints are proven), as tests/test_torch_tiefree.py does."""

import hashlib
import json
import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from svim_tpu.cli import main as jax_main
from svim_tpu.cluster import device_cluster as jax_cluster
from svim_tpu_torch import cli as torch_cli
from svim_tpu_torch import native, workloads
from svim_tpu_torch.cluster import device_cluster as torch_cluster
from svim_tpu_torch.io import bam as bamio
from svim_tpu_torch.io.bamstream import scan_bgzf_blocks
from svim_tpu_torch.ops import wavefront_kernel
from svim_tpu_torch.sim import evaluate_vcf

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(contig_length=2_000_000, partner_length=1_000_000, depth=10,
             ins_sizes=(50, 600))
FLAGS = {"auto": [], "wavefront": ["--edit_backend", "wavefront",
                                   "--incremental_cluster", "off"]}
ROUTES = {"fused": "_consume_fused", "matrix": "_consume_matrix",
          "resident": "_consume_resident"}


def _inflated(bam):
    with open(bam, "rb") as handle:
        data = handle.read()
    view = memoryview(data)
    return b"".join(zlib.decompress(view[offset:offset + size], 31)
                    for offset, size, _ in scan_bgzf_blocks(data))


def _made(directory):
    with open(os.path.join(directory, workloads.SAMPLE_FILE)) as handle:
        return json.load(handle)


@pytest.fixture(scope="module")
def sample(tmp_path_factory):
    """(directory, bam, genome, the records as io.bam reads them)."""
    directory = str(tmp_path_factory.mktemp("sample"))
    bam, genome = workloads.sample_workload(directory, 1, **SMALL)
    _header, records = bamio.read_bam(bam)
    return directory, bam, genome, records


def test_records_are_the_bam_writers_bytes(sample):
    directory, bam, _genome, records = sample
    inflated = _inflated(bam)
    made = _made(directory)
    assert made["inflated_bytes"] == len(inflated)
    assert made["inflated_sha256"] == hashlib.sha256(inflated).hexdigest()
    assert inflated.endswith(b"".join(bamio._encode_record(record)
                                      for record in records))
    assert made["reads"] == len(records)
    assert all(len(record.cigartuples) == workloads.SAMPLE_OPS
               for record in records)
    assert [record.reference_start for record in records] == sorted(
        record.reference_start for record in records)


def test_the_same_seed_gives_the_same_stream_without_svim_tpu(sample,
                                                              tmp_path):
    directory = sample[0]
    script = (
        "import json, sys\n"
        "sys.path.insert(0, {root!r})\n"
        "from svim_tpu_torch import workloads\n"
        "workloads.sample_workload(sys.argv[1], 1,\n"
        "                          **json.loads(sys.argv[2]))\n"
        "print(sorted(name for name in sys.modules if name.split('.')[0] in "
        "('jax', 'jaxlib', 'svim_tpu')))\n").format(root=ROOT)
    again = str(tmp_path / "again")
    loaded = subprocess.run(
        [sys.executable, "-c", script, again, json.dumps(SMALL)],
        capture_output=True, text=True, check=True, timeout=300).stdout
    assert loaded.strip() == "[]"
    first, second = _made(directory), _made(again)
    assert second["inflated_sha256"] == first["inflated_sha256"]
    for name in ("genome.fa", workloads.TRUTH_FILE):
        with open(os.path.join(directory, name), "rb") as one, \
                open(os.path.join(again, name), "rb") as other:
            assert one.read() == other.read()
    other_seed = str(tmp_path / "seed2")
    workloads.sample_workload(other_seed, 2, **SMALL)
    assert _made(other_seed)["inflated_sha256"] != first["inflated_sha256"]


def test_every_read_lies_inside_its_contig(sample):
    _directory, bam, _genome, records = sample
    header = bamio.read_bam(bam)[0]
    lengths = dict(zip(header.references, header.lengths))
    assert lengths == dict(zip(workloads.SAMPLE_CONTIGS,
                               (SMALL["contig_length"],
                                SMALL["partner_length"])))
    host, partner = workloads.SAMPLE_CONTIGS
    split = 0
    for record in records:
        assert record.reference_id == 0
        assert 0 <= record.reference_start
        assert record.reference_end <= lengths[host]
        if "SA" in record.tags:
            split += 1
            contig, position, strand, cigar = record.tags["SA"][0].split(
                ",")[:4]
            assert (contig, strand) == (partner, "+")
            assert 1 <= int(position)
            assert int(position) - 1 + workloads.SAMPLE_SPLIT_SPAN \
                <= lengths[partner]
            assert cigar == "{0}S{1}M".format(
                len(record.query_sequence) - workloads.SAMPLE_SPLIT_SPAN,
                workloads.SAMPLE_SPLIT_SPAN)
    assert split == _made(_directory)["split_reads"] > 0


def test_check_inside_refuses_a_read_past_ln():
    length = 200_000_000
    workloads.check_inside([0, length - 16_895], [16_895, 16_895], length,
                           "chr1")
    # bench.py's fault: reads drawn up to N_READS * 6,000 bp, past chr1's
    # LN once there are more than 33,333 of them
    for starts in ([length - 16_894], [length + 1], [-1]):
        with pytest.raises(ValueError, match="outside chr1"):
            workloads.check_inside(starts, [16_895], length, "chr1")


def test_unknown_fields_and_loci_that_do_not_fit_are_refused(tmp_path):
    with pytest.raises(TypeError, match="unknown sample fields"):
        workloads.sample_workload(str(tmp_path / "a"), 1, reads=10)
    with pytest.raises(ValueError, match="do not fit"):
        workloads.sample_workload(str(tmp_path / "b"), 1,
                                  contig_length=200_000, loci=20)


def _sv_ops(records, op):
    """(position of the SV op on the reference, its length, the read) of
    every read's op `op` of 20 bp or more (the noise is 1-8 bp)."""
    found = []
    for record in records:
        position = record.reference_start
        for kind, length in record.cigartuples:
            if kind == op and length >= 20:
                found.append((position, length, record))
            if kind in (0, 2):
                position += length
    return found


def test_the_truth_lists_every_locus(sample):
    directory, _bam, _genome, records = sample
    truth = workloads.load_truth(directory)
    made = _made(directory)
    loci = round(SMALL["contig_length"] / (2 * workloads.SAMPLE_LOCUS_SPAN))
    assert made["loci"] == {"DEL": loci, "INS": loci}
    assert sorted(variant.svtype for variant in truth) \
        == ["DEL"] * loci + ["INS"] * loci
    low, high = workloads.SAMPLE_COVERAGE
    carried = {"DEL": _sv_ops(records, 2), "INS": _sv_ops(records, 1)}
    assert sum(map(len, carried.values())) == made["supporting_reads"]
    starts = sorted(variant.start for variant in truth)
    assert min(starts) >= workloads.SAMPLE_MARGIN
    assert all(b - a >= workloads.SAMPLE_LOCUS_GAP
               for a, b in zip(starts, starts[1:]))
    for variant in truth:
        jitter = max(workloads.TIEFREE_POSITION_JITTER[variant.svtype[0]],
                     high // 2)
        reach = max(int(variant.length * workloads.TIEFREE_SIZE_JITTER), high)
        reads = [(position, length, record) for position, length, record
                 in carried[variant.svtype]
                 if abs(position - variant.start) <= jitter
                 and abs(length - variant.length) <= reach]
        assert low <= len(reads) <= high
        # no two reads of a locus share a position or a size
        assert len({position for position, _, _ in reads}) == len(reads)
        assert len({length for _, length, _ in reads}) == len(reads)
        if variant.svtype == "INS":
            inserts = [_insert(record) for _, _, record in reads]
            shortest = min(map(len, inserts))
            first = np.frombuffer(inserts[0][:shortest].encode(), np.uint8)
            for insert in inserts[1:]:
                other = np.frombuffer(insert[:shortest].encode(), np.uint8)
                # at most four substituted bases a read
                assert int((first != other).sum()) <= 8


def _insert(record):
    offset = 0
    for kind, length in record.cigartuples:
        if kind == 1 and length >= 20:
            return record.query_sequence[offset:offset + length]
        if kind in (0, 1, 4):
            offset += length
    raise AssertionError("no insertion")


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


def _telemetry(module):
    return {key: value for key, value in module.TELEMETRY.as_dict().items()
            if not key.endswith("_fraction")}


def _normalized(path):
    with open(path) as handle:
        return [line for line in handle if not line.startswith("##fileDate")]


def _native_resident_distances(pairs, band_hints, device):
    values = native.aligner.edit_distance_batch(list(pairs))
    return torch.as_tensor(np.asarray(values, dtype=np.int32)).to(device)


@pytest.mark.parametrize("path", sorted(FLAGS))
def test_port_equals_svim_tpu_on_the_streamed_sample(sample, path,
                                                     monkeypatch, tmp_path):
    directory, bam, genome, _records = sample
    truth = workloads.load_truth(directory)
    jax_dir = str(tmp_path / "jax")
    jax_accepted = _count_routes(jax_cluster, monkeypatch)
    assert jax_main(["alignment", jax_dir, bam, genome, "--stream_input"]
                    + FLAGS[path]) == 0
    jax_telemetry = _telemetry(jax_cluster)

    monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")
    if path == "wavefront":
        monkeypatch.setattr(wavefront_kernel,
                            "batched_edit_distance_resident",
                            _native_resident_distances)
    accepted = _count_routes(torch_cluster, monkeypatch)
    working_dir = str(tmp_path / "port")
    assert torch_cli.main(["alignment", working_dir, bam, genome,
                           "--stream_input"] + FLAGS[path]) == 0
    vcf = _normalized(os.path.join(working_dir, "variants.vcf"))
    assert vcf == _normalized(os.path.join(jax_dir, "variants.vcf"))
    classes = evaluate_vcf(os.path.join(working_dir, "variants.vcf"), truth)
    assert classes == evaluate_vcf(os.path.join(jax_dir, "variants.vcf"),
                                   truth)
    assert classes["ALL"][0] >= len(truth) - 2
    assert _telemetry(torch_cluster) == jax_telemetry
    assert accepted == jax_accepted
    # the device labels partitions here, on the fused route and on the
    # matrix (auto) or resident (wavefront) one
    assert accepted["fused"] > 0
    assert accepted["resident" if path == "wavefront" else "matrix"] > 0
