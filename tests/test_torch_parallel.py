"""--num_shards through svim_tpu_torch, on the CPU.

The port cuts the leading axis of its batched ops over shards by hand
(parallel/mesh.py) where svim_tpu lets the compiler split them over a device
mesh.  Held here: the three sharded call sites (the CLUSTER batcher's two
flushes, the GENOTYPE interval join, the row-sharded COLLECT scan) return
tensors torch.equal to the unsharded ones at 1, 2, 4 and 8 shards and with
a leading axis that does not divide; run_collect_step equals
svim_tpu.parallel.mesh.run_collect_step on the inputs of
tests/test_parallel.py (the JAX side on conftest's 8 virtual CPU devices);
`--num_shards 8` writes a variants.vcf byte-equal to the port's unsharded
run and to svim_tpu's on a workload whose partitions straddle shard
boundaries; entry() and dryrun_multichip(8) run.  Everything is integers,
bytes and bit-equal float32: the tolerance is exact equality.
"""

import logging
import random

import numpy as np
import pytest
import torch

from svim_tpu.cli import main as jax_main
from svim_tpu.parallel import mesh as jax_mesh
from svim_tpu_torch import cli as torch_cli
from svim_tpu_torch import entry
from svim_tpu_torch.cluster.device_cluster import DeviceBatcher
from svim_tpu_torch.collect import packed as collect_packed
from svim_tpu_torch.config import parse_arguments
from svim_tpu_torch.io import bam as bamio
from svim_tpu_torch.io.packing import pack_alignments
from svim_tpu_torch.io.sam import AlignmentFile
from svim_tpu_torch.ops import genotype_kernel
from svim_tpu_torch.parallel import mesh
from svim_tpu_torch.signatures import SignatureDeletion

CPU = torch.device("cpu")
torch.set_num_threads(1)
SHARDS = [1, 2, 4, 8]


def _options(num_shards):
    return parse_arguments(arguments=["alignment", ".", "x.bam", "g.fa",
                                      "--num_shards", str(num_shards)])


def _same_tree(got, want):
    assert len(got) == len(want)
    for index, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.device == b.device, index
        assert torch.equal(a, b), index


def test_shard_devices_wrap_round_the_visible_cards(monkeypatch):
    assert mesh.shard_devices(4, CPU) == [CPU] * 4
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    card = torch.device("cuda", 0)
    assert [d.index for d in mesh.shard_devices(8, card)] \
        == [0, 1, 2, 0, 1, 2, 0, 1]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert set(mesh.shard_devices(8, card)) == {card}


@pytest.mark.parametrize("rows, num_shards, blocks", [
    (16, 1, 1), (16, 2, 2), (16, 8, 8), (12, 8, 1), (0, 4, 1), (7, 7, 7)])
def test_shard_batch_cuts_contiguous_blocks_or_stays_whole(rows, num_shards,
                                                           blocks):
    values = np.arange(rows * 3, dtype=np.int32).reshape(rows, 3)
    flags = torch.arange(rows) % 2 == 0
    shards = mesh.shard_batch(num_shards, CPU, values, flags)
    assert len(shards) == blocks
    _same_tree(mesh.gather_shards(shards, CPU),
               (torch.from_numpy(values), flags))
    assert all(len(shard[0]) == rows // blocks for shard in shards)


def _deletion_samples(rng, count, most):
    samples = []
    for index in range(count):
        base = 10_000 * (index + 1)
        samples.append([
            SignatureDeletion("chr1", base + rng.randint(-40, 40),
                              base + 300 + rng.randint(-40, 40), "cigar",
                              "read{0}_{1}".format(index, member))
            for member in range(rng.randint(3, most))])
    return samples


def _batcher_outputs(num_shards, samples, matrices):
    batcher = DeviceBatcher(_options(num_shards), CPU)
    for index, sample in enumerate(samples):
        batcher.add_fused(sample, index % 3 != 0, "DEL")
    for matrix in matrices:
        batcher.add_matrix(matrix)
    return batcher.device_outputs()


@pytest.mark.parametrize("num_shards", SHARDS + [3, 16])
def test_sharded_batcher_flushes_equal_unsharded(num_shards):
    """flush_fused and flush: coordinate partitions in both pad buckets and
    9 matrices (a batch of 16); a batch of 8 does not divide over 3 or 16
    shards and stays whole."""
    rng = random.Random(31)
    samples = _deletion_samples(rng, 5, 30) + _deletion_samples(rng, 9, 120)
    generator = np.random.default_rng(32)
    matrices = []
    for _ in range(9):
        n = int(generator.integers(3, 33))
        upper = np.triu(generator.random((n, n)), 1)
        matrices.append(upper + upper.T)
    want = _batcher_outputs(1, samples, matrices)
    got = _batcher_outputs(num_shards, samples, matrices)
    assert sorted(got) == sorted(want) and len(want) == 3
    for key in want:
        _same_tree(got[key], want[key])
    assert any(float(tree[2].min()) < 1.0e30 for tree in want.values())


def _genotype_jobs(rng, candidates):
    rows = 4000
    starts = np.sort(rng.integers(0, 400_000, size=rows))
    ends = starts + rng.integers(500, 8000, size=rows)
    ids = rng.integers(0, 900, size=rows)
    per_tid = {0: (starts, ends, ids, int((ends - starts).max()))}
    jobs = []
    for _ in range(candidates):
        start = int(rng.integers(2000, 390_000))
        type_class = int(rng.integers(0, 2))
        end = start if type_class else start + int(rng.integers(50, 3000))
        support = np.unique(rng.integers(0, 900, size=5)).tolist()
        jobs.append((0, start, end, type_class, support, 500_000))
    jobs.append((3, 100, 200, 0, [], None))   # a contig without alignments
    return jobs, per_tid


@pytest.mark.parametrize("num_shards", SHARDS)
@pytest.mark.parametrize("candidates", [64, 61])
def test_sharded_genotype_join_equals_unsharded(num_shards, candidates):
    """64 candidates divide over every shard count; 61 divide over none
    above 1 and stay whole."""
    jobs, per_tid = _genotype_jobs(np.random.default_rng(33), candidates)
    want = genotype_kernel.genotype_ref_support_device(jobs, per_tid, CPU)
    got = genotype_kernel.genotype_ref_support_device(jobs, per_tid, CPU,
                                                      num_shards)
    assert got == want
    assert want[-1] == 0 and max(want) > 0 and None not in want


def _packed_batch(rows):
    rng = random.Random(34)
    lines = []
    for index in range(rows):
        start = rng.randint(0, 100_000)
        cigar = rng.choice(["500M{0}D500M", "300M{0}I700M",
                            "200M{0}D300M45I500M", "1000M"])
        cigar = cigar.format(rng.randint(20, 200))
        lines.append("r{0}\t0\tchr1\t{1}\t60\t{2}\t*\t0\t0\t*\t*".format(
            index, start + 1, cigar))
    lines.sort(key=lambda line: int(line.split("\t")[3]))
    return "@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:1000000\n" \
        + "\n".join(lines) + "\n"


@pytest.mark.parametrize("num_shards", SHARDS)
@pytest.mark.parametrize("rows", [64, 52])
def test_row_sharded_collect_scan_equals_unsharded(tmp_path, num_shards,
                                                   rows):
    """dispatch_collect_scan: the events come back in (row, op) order with
    global rows whatever the number of shards; 52 rows divide over 1, 2 and
    4 shards and stay whole at 8."""
    sam = tmp_path / "scan.sam"
    sam.write_text(_packed_batch(rows))
    records = list(AlignmentFile(str(sam)).fetch(until_eof=True))

    def scan(shards):
        packed = pack_alignments(records, min_sv_size=40)
        return collect_packed.dispatch_collect_scan(packed, _options(shards),
                                                    CPU)

    want = scan(1)
    _same_tree(scan(num_shards), want)
    assert int(want[10]) == len(want[5]) > rows // 2
    assert want[5].tolist() == sorted(want[5].tolist())


def _step_inputs(case, n_devices):
    """The inputs of tests/test_parallel.py's three collect-step tests."""
    if case == "one_deletion_a_read":
        n, k = 8 * n_devices, 128
        words = np.zeros((n, k), dtype=np.int32)
        words[:, 0] = (50 << 4) | 0
        words[:, 1] = (60 << 4) | 2
        words[:, 2] = (50 << 4) | 0
        ref_start = np.arange(n, dtype=np.int32) * 10
        return (words, ref_start, ref_start + 160, np.asarray(
            [[0, 10_000], [100_000, 100_100]], dtype=np.int32))
    if case == "depth":
        n, k = 32, 128
        rng = np.random.default_rng(7)
        words = np.zeros((n, k), dtype=np.int32)
        words[:, 0] = (100 << 4) | 0
        ref_start = rng.integers(0, 5000, size=n, dtype=np.int32)
        return (words, ref_start, ref_start + 100, np.asarray(
            [[1000, 1200], [2000, 2500], [4800, 4900]], dtype=np.int32))
    n, k, events = 16, 64, 8
    words = np.zeros((n, k), dtype=np.int32)
    for e in range(events):
        words[:, 2 * e] = (50 << 4) | 0
        words[:, 2 * e + 1] = (60 << 4) | (2 if e % 3 else 1)
    words[:, 2 * events] = (50 << 4) | 0
    ref_start = np.arange(n, dtype=np.int32) * 10_000
    ref_end = ref_start + 50 * (events + 1) + 60 * events
    return (words, ref_start, ref_end,
            np.asarray([[0, 10_000_000]], dtype=np.int32))


@pytest.mark.parametrize("case, n_devices", [
    ("one_deletion_a_read", 1), ("one_deletion_a_read", 2),
    ("one_deletion_a_read", 4), ("one_deletion_a_read", 8), ("depth", 4),
    ("many_events_a_read", 4)])
def test_run_collect_step_equals_jax(case, n_devices):
    inputs = _step_inputs(case, n_devices)
    want = jax_mesh.run_collect_step(jax_mesh.make_mesh(n_devices), *inputs,
                                     events_per_shard=2)
    got = mesh.run_collect_step(mesh.shard_devices(n_devices, CPU), *inputs)
    assert len(got) == 6
    for index, (a, b) in enumerate(zip(got, want)):
        b = np.asarray(b)
        assert a.dtype == b.dtype, index
        assert np.array_equal(a, b), index
    rows = inputs[0].shape[0]
    assert got[5].dtype == np.int32 and len(got[5]) == n_devices
    assert int(got[5].sum()) == len(got[0])
    assert got[3].tolist() == sorted(got[3].tolist())
    if case != "depth":
        assert len(got[0]) >= rows
    with pytest.raises(ValueError, match="must divide"):
        mesh.run_collect_step(mesh.shard_devices(3, CPU), *inputs)


def _boundary_workload(tmp_path, n_loci=8, coverage=32):
    """The workload of tests/test_parallel.py: a coordinate-sorted BAM where
    the reads of every locus interleave, so partitions straddle the rows at
    which 8 shards cut the batch."""
    rng = random.Random(99)
    lines = []
    read_no = 0
    for locus in range(n_loci):
        position = 50_000 + locus * 9_000
        size = 80 + locus * 15
        for _ in range(coverage):
            start = position + rng.randint(-300, 300)
            lines.append("r{0}\t0\tchr1\t{1}\t60\t400M{2}D400M\t*\t0\t0\t{3}\t*"
                         .format(read_no, start + 1,
                                 size + rng.randint(-2, 2), "A" * 800))
            read_no += 1
    lines.sort(key=lambda line: int(line.split("\t")[3]))
    sam_path = tmp_path / "boundary.sam"
    sam_path.write_text("@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:1000000\n"
                        + "\n".join(lines) + "\n")
    af = AlignmentFile(str(sam_path))
    bam_path = tmp_path / "boundary.bam"
    bamio.write_bam(str(bam_path), af.header, list(af.fetch(until_eof=True)))
    genome_path = tmp_path / "genome.fa"
    rng2 = random.Random(5)
    genome_path.write_text(">chr1\n" + "".join(
        rng2.choice("ACGT") for _ in range(200_000)) + "\n")
    return str(bam_path), str(genome_path)


def _port_main(arguments):
    """The port's CLI; detaches the log handlers the run added."""
    root = logging.getLogger()
    before = list(root.handlers)
    try:
        return torch_cli.main(arguments)
    finally:
        for handler in root.handlers[:]:
            if handler not in before:
                root.removeHandler(handler)
                handler.close()


def _vcf_body(path):
    with open(path) as handle:
        return [line for line in handle if not line.startswith("##fileDate")]


def test_full_pipeline_num_shards_byte_parity(tmp_path, monkeypatch):
    monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")
    bam_path, genome_path = _boundary_workload(tmp_path)
    assert _port_main(["alignment", str(tmp_path / "wd1"), bam_path,
                       genome_path]) == 0
    assert _port_main(["alignment", str(tmp_path / "wd8"), bam_path,
                       genome_path, "--num_shards", "8"]) == 0
    assert jax_main(["alignment", str(tmp_path / "jax8"), bam_path,
                     genome_path, "--num_shards", "8"]) == 0
    body1 = _vcf_body(tmp_path / "wd1" / "variants.vcf")
    assert body1 == _vcf_body(tmp_path / "wd8" / "variants.vcf")
    assert body1 == _vcf_body(tmp_path / "jax8" / "variants.vcf")
    assert sum(1 for line in body1 if not line.startswith("#")) >= 8
    log = "".join(path.read_text()
                  for path in (tmp_path / "wd8").glob("SVIM_*.log"))
    assert "8 shards over 1 device(s)" in log
    assert "shards over" not in "".join(
        path.read_text() for path in (tmp_path / "wd1").glob("SVIM_*.log"))


def test_entry_runs_the_fused_collect_pass(monkeypatch):
    monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")
    function, arguments = entry.entry()
    outputs = function(*arguments)
    assert len(outputs) == 11 and int(outputs[10]) == len(outputs[5]) > 0
    assert all(argument.device == CPU for argument in arguments)


@pytest.mark.parametrize("n_devices", [1, 8])
def test_dryrun_multichip(monkeypatch, n_devices):
    monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")
    for name in ("SVIM_COORDINATOR", "SVIM_NUM_PROCESSES", "SVIM_PROCESS_ID"):
        monkeypatch.delenv(name, raising=False)
    entry.dryrun_multichip(n_devices)
