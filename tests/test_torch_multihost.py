"""--distributed through svim_tpu_torch, on the CPU, against svim_tpu.

The port's multihost module (torch.distributed, Gloo over host bytes)
against svim_tpu.parallel.multihost on one simulated dataset (the one of
tests/test_multihost.py, plus one DEL and one INS locus of 130 reads each so
that two partitions exceed MAX_PARTITION_SIZE and draw from the shared
subsampling RNG): the fixed-dtype exchange arrays key by key, the merge
round trip, the per-rank record ranges, the sharded CLUSTER at world 1, and
REAL two-process runs wired through torch.distributed: allgather_blobs with
unequal and empty blobs, the consensus-outcome exchange, run_collect_step
and dryrun_multichip across the process boundary, and `python -m
svim_tpu_torch alignment ... --distributed` whose variants.vcf must be
byte-equal to the port's single-process run and to svim_tpu's.  Everything
is integers and bytes: the tolerance is exact equality.
"""

import hashlib
import json
import logging
import os
import random
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from svim_tpu.cli import main as jax_main
from svim_tpu.cluster import cluster_sv_signatures as jax_cluster_sv_signatures
from svim_tpu.collect.packed import collect_soa_from_bam as jax_collect
from svim_tpu.parallel import multihost as jax_multihost
from svim_tpu.sim import SimConfig, simulate
from svim_tpu_torch import cli as torch_cli
from svim_tpu_torch.cluster.cluster import (
    MAX_PARTITION_SIZE,
    cluster_sv_signatures,
)
from svim_tpu_torch.cluster.partition import form_partitions_table
from svim_tpu_torch.collect.packed import (
    collect_soa_from_bam,
    collect_soa_pipelined,
    collect_soa_pipelined_range,
)
from svim_tpu_torch.config import parse_arguments
from svim_tpu_torch.io import bam as bamio
from svim_tpu_torch.io.sam import AlignmentFile, parse_sam_line
from svim_tpu_torch.parallel import multihost
from svim_tpu_torch.parallel.cluster_shard import cluster_sv_signatures_sharded
from svim_tpu_torch.sigtable import SIG_TYPES

CPU = torch.device("cpu")
torch.set_num_threads(1)
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT = 300   # seconds, each rank subprocess


def _free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def launch_ranks(world, command, cwd=None, timeout=RANK_TIMEOUT):
    """Start `command` (an argv list) once per rank with the SVIM_* variables
    of a `world`-process group on the CPU; returns [(returncode, output)].
    Every rank has its own timeout; on any failure all are killed."""
    coordinator = "127.0.0.1:{0}".format(_free_port())
    procs = []
    for rank in range(world):
        env = dict(os.environ)
        env.pop("PYTHONPATH", None)
        env.update({
            "SVIM_TORCH_DEVICE": "cpu", "OMP_NUM_THREADS": "1",
            "GLOO_SOCKET_IFNAME": "lo", "PYTHONPATH": REPO_ROOT,
            "SVIM_COORDINATOR": coordinator,
            "SVIM_NUM_PROCESSES": str(world), "SVIM_PROCESS_ID": str(rank)})
        procs.append(subprocess.Popen(
            command, env=env, cwd=cwd, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    results = []
    try:
        for proc in procs:
            output, _ = proc.communicate(timeout=timeout)
            results.append((proc.returncode, output))
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    return results


def _dense_locus_lines(rng, genome_sequence):
    """130 reads over one DEL locus and 130 over one INS locus (noisy copies
    of one motif): two partitions above MAX_PARTITION_SIZE."""
    lines = []
    motif = "".join(rng.choice("ACGT") for _ in range(44))
    for i in range(130):
        start = 90_000 + rng.randint(-300, 300)
        lines.append("bigdel{0}\t0\tchr1\t{1}\t60\t400M{2}D400M\t*\t0\t0\t{3}\t*"
                     .format(i, start + 1, 150 + rng.randint(-3, 3),
                             genome_sequence[start:start + 800]))
        start = 140_000 + rng.randint(-5, 5)
        noisy = list(motif)
        for _ in range(rng.randint(0, 3)):
            noisy[rng.randrange(len(noisy))] = rng.choice("ACGT")
        lines.append("bigins{0}\t0\tchr1\t{1}\t60\t400M{2}I400M\t*\t0\t0\t{3}\t*"
                     .format(i, start + 1, len(noisy),
                             genome_sequence[start:start + 400]
                             + "".join(noisy)
                             + genome_sequence[start + 400:start + 800]))
    return lines


def _drop_log_handlers(before):
    root = logging.getLogger()
    for handler in root.handlers[:]:
        if handler not in before:
            root.removeHandler(handler)
            handler.close()


def _port_main(arguments):
    before = list(logging.getLogger().handlers)
    try:
        return torch_cli.main(arguments)
    finally:
        _drop_log_handlers(before)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    out = tmp_path_factory.mktemp("torch_multihost")
    config = SimConfig(genome_length=600_000, second_contig_length=200_000,
                       coverage=6, n_del=4, n_ins=4, n_inv=2, n_tan=2,
                       n_dup_int=2, n_bnd=2, n_background=50, seed=23)
    genome, simulated_bam, _ = simulate(str(out), config)
    with open(genome) as handle:
        handle.readline()
        chr1 = []
        for line in handle:
            if line.startswith(">"):
                break
            chr1.append(line.strip())
    source = AlignmentFile(simulated_bam)
    records = list(source.fetch(until_eof=True))
    records.extend(parse_sam_line(line, source.header)
                   for line in _dense_locus_lines(random.Random(5),
                                                  "".join(chr1)))
    records.sort(key=lambda r: (r.reference_id, r.reference_start))
    bam = str(out / "reads_dense.bam")
    bamio.write_bam(bam, source.header, records)
    return str(out), bam, genome


def _options(dataset, *extra):
    out, bam, genome = dataset
    return parse_arguments(arguments=["alignment", out, bam, genome, *extra])


def _geno_columns(table):
    return {"ref_id": np.asarray(table.ref_id, np.int32),
            "ref_start": np.asarray(table.ref_start, np.int64),
            "ref_end": np.asarray(table.ref_end, np.int64),
            "mapq": np.asarray(table.mapq, np.int32),
            "flag": np.zeros(len(table.ref_id), np.int32),
            "names": list(table.names)}


def test_dataset_has_partitions_above_the_subsampling_cap(dataset):
    options = _options(dataset)
    _header, _table, soa, _twins = collect_soa_from_bam(dataset[1], options,
                                                        CPU)
    for sig_type in ("DEL", "INS"):
        sizes = [len(partition) for partition in form_partitions_table(
            soa.tables[sig_type], options.partition_max_distance)]
        assert max(sizes) > MAX_PARTITION_SIZE, sig_type


def test_soa_to_arrays_equals_jax_key_by_key(dataset):
    out, bam, genome = dataset
    options = _options(dataset, "--all_bnds")
    _header, table, soa, twins = collect_soa_from_bam(bam, options, CPU)
    got = multihost.soa_to_arrays(soa, twins, _geno_columns(table))
    from svim_tpu.config import parse_arguments as jax_parse

    jax_options = jax_parse(arguments=["alignment", out, bam, genome,
                                       "--all_bnds"])
    _jheader, jax_table, jax_soa, jax_twins = jax_collect(bam, jax_options)
    want = jax_multihost.soa_to_arrays(jax_soa, jax_twins,
                                       _geno_columns(jax_table))
    assert len(twins) > 0
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        assert np.array_equal(got[key], want[key]), key
    assert multihost.arrays_to_bytes(got) == jax_multihost.arrays_to_bytes(want)


def test_merge_gathered_soa_round_trip(dataset):
    """The fixed-dtype column exchange reproduces tables, twins and genotype
    columns exactly, and the merged SoA clusters like the original."""
    _out, bam, _genome = dataset
    options = _options(dataset, "--all_bnds")
    _header, table, soa, twins = collect_soa_from_bam(bam, options, CPU)
    geno = _geno_columns(table)
    blob = multihost.arrays_to_bytes(multihost.soa_to_arrays(soa, twins, geno))
    merged_soa, merged_twins, merged_geno = multihost.merge_gathered_soa(
        [multihost.bytes_to_arrays(blob)])
    for sig_type in SIG_TYPES:
        original = soa.tables[sig_type]
        rebuilt = merged_soa.tables[sig_type]
        assert original.n == rebuilt.n
        assert ([s.as_string() for s in
                 original.materialize_list(range(original.n))]
                == [s.as_string() for s in
                    rebuilt.materialize_list(range(rebuilt.n))])
    assert ([t.as_string() for t in twins]
            == [t.as_string() for t in merged_twins])
    assert merged_geno.names == geno["names"]
    assert _bed_entries(cluster_sv_signatures(soa, options, CPU)) \
        == _bed_entries(cluster_sv_signatures(merged_soa, options, CPU))


def _bed_entries(cluster_lists):
    return [[(c.get_bed_entries() if hasattr(c, "get_bed_entries")
              else c.get_bed_entry()) for c in clusters]
            for clusters in cluster_lists]


@pytest.mark.parametrize("world", [2, 3, 7])
def test_range_pipelined_collect_tiles_exactly(dataset, world):
    """collect_soa_pipelined_range tiles the file: concatenating per-rank
    signature tables and genotype columns in rank order equals the
    single-process pipelined collect."""
    _out, bam, _genome = dataset
    options = _options(dataset)
    _header, table, soa, twins = collect_soa_pipelined(bam, options, CPU)
    gathered = []
    for rank in range(world):
        _h, r_table, r_soa, r_twins = collect_soa_pipelined_range(
            bam, options, world, rank, CPU)
        assert getattr(r_soa, "cluster_memo", None) is None
        gathered.append(multihost.soa_to_arrays(
            r_soa, r_twins, multihost._table_genotype_columns(r_table)))
    merged_soa, merged_twins, merged_geno = multihost.merge_gathered_soa(
        gathered)
    assert ([s.as_string() for s in merged_soa.materialize_all()]
            == [s.as_string() for s in soa.materialize_all()])
    assert merged_geno.names == list(table.names)
    assert np.array_equal(np.asarray(merged_geno.ref_start),
                          np.asarray(table.ref_start))
    assert len(merged_twins) == len(twins)


def test_consensus_outcome_exchange_round_trip():
    local = {0: (0, (1234, 56, "ACGTACGT")), 2: (1, ()),
             5: (0, (99, 0, "")), 7: (4, ())}
    assert multihost.exchange_consensus_outcomes(local) == local
    assert multihost.process_count() == 1 and multihost.process_index() == 0


@pytest.mark.parametrize("edit_backend", ["auto", "wavefront"])
def test_sharded_cluster_at_world_one_equals_unsharded_and_jax(dataset,
                                                               edit_backend):
    out, bam, genome = dataset
    options = _options(dataset, "--edit_backend", edit_backend)
    _header, _table, soa, _twins = collect_soa_from_bam(bam, options, CPU)
    unsharded = _bed_entries(cluster_sv_signatures(soa, options, CPU))
    sharded = _bed_entries(cluster_sv_signatures_sharded(soa, options, CPU))
    assert sharded == unsharded
    from svim_tpu.config import parse_arguments as jax_parse

    jax_options = jax_parse(arguments=["alignment", out, bam, genome,
                                       "--edit_backend", edit_backend])
    _jh, _jt, jax_soa, _jtw = jax_collect(bam, jax_options)
    assert sharded == _bed_entries(jax_cluster_sv_signatures(jax_soa,
                                                             jax_options))


_FUNCTIONS_RANK = """
import json, sys
import numpy as np
from svim_tpu_torch import entry
from svim_tpu_torch.parallel import multihost
from svim_tpu_torch.parallel.mesh import run_collect_step, shard_devices
import torch

rank = multihost.initialize_from_env()
report = {"rank": rank, "index": multihost.process_index(),
          "count": multihost.process_count()}
mine = b"" if rank == 0 else bytes(range(256)) * 40 + b"tail"
report["blobs"] = [blob.hex() for blob in multihost.allgather_blobs(mine)]
report["empty"] = [blob.hex() for blob in multihost.allgather_blobs(b"")]
local = ({0: (0, (1234, 56, "ACGTACGT")), 2: (1, ())} if rank == 0
         else {1: (0, (99, 0, "")), 3: (4, ()), 5: (0, (7, 3, "TTT"))})
merged = multihost.exchange_consensus_outcomes(local)
report["outcomes"] = sorted((k, v[0], list(v[1])) for k, v in merged.items())
report["exchange"] = [multihost.EXCHANGE.sent, multihost.EXCHANGE.received,
                      multihost.EXCHANGE.rounds]
n, k = 16, 64
words = np.zeros((n, k), dtype=np.int32)
for e in range(8):
    words[:, 2 * e] = (50 << 4) | 0
    words[:, 2 * e + 1] = (60 << 4) | (2 if e % 2 else 1)
words[:, 16] = (50 << 4) | 0
ref_start = np.arange(n, dtype=np.int32) * 10_000
ref_end = ref_start + 1000
loci = np.asarray([[0, 10_000_000], [0, 25_000]], dtype=np.int32)
report["collect"] = [part.tolist() for part in run_collect_step(
    shard_devices(4, torch.device("cpu")), words, ref_start, ref_end, loci)]
entry.dryrun_multichip(8)
report["jax"] = sorted(name for name in sys.modules
                       if name.split(".")[0] in ("jax", "jaxlib", "svim_tpu"))
print("REPORT " + json.dumps(report))
"""


@pytest.fixture(scope="module")
def two_rank_functions():
    """One real two-process group exercising the module's functions; the
    tests below read its per-rank reports."""
    results = launch_ranks(2, [sys.executable, "-c", _FUNCTIONS_RANK])
    reports = []
    for code, output in results:
        assert code == 0, output[-4000:]
        line = [line for line in output.splitlines()
                if line.startswith("REPORT ")][-1]
        reports.append(json.loads(line[len("REPORT "):]))
    return reports


def test_allgather_blobs_unequal_and_empty_across_two_processes(
        two_rank_functions):
    want = ["", (bytes(range(256)) * 40 + b"tail").hex()]
    for rank, report in enumerate(two_rank_functions):
        assert (report["rank"], report["index"], report["count"]) \
            == (rank, rank, 2)
        assert report["blobs"] == want
        assert report["empty"] == ["", ""]
        assert report["jax"] == []
    # three gathers: two blob rounds and the outcome exchange
    sent = [report["exchange"][0] for report in two_rank_functions]
    received = [report["exchange"][1] for report in two_rank_functions]
    assert received[0] == received[1] == sum(sent)
    assert [report["exchange"][2] for report in two_rank_functions] == [3, 3]


def test_consensus_outcomes_merge_across_two_processes(two_rank_functions):
    want = [[0, 0, [1234, 56, "ACGTACGT"]], [1, 0, [99, 0, ""]], [2, 1, []],
            [3, 4, []], [5, 0, [7, 3, "TTT"]]]
    for report in two_rank_functions:
        assert report["outcomes"] == want


def test_run_collect_step_across_two_processes_equals_one_process(
        two_rank_functions):
    """Rank r computes shards 2r and 2r+1 of four; both ranks hold the
    tables of a one-process run."""
    from svim_tpu_torch.parallel.mesh import run_collect_step, shard_devices

    n, k = 16, 64
    words = np.zeros((n, k), dtype=np.int32)
    for e in range(8):
        words[:, 2 * e] = (50 << 4) | 0
        words[:, 2 * e + 1] = (60 << 4) | (2 if e % 2 else 1)
    words[:, 16] = (50 << 4) | 0
    ref_start = np.arange(n, dtype=np.int32) * 10_000
    loci = np.asarray([[0, 10_000_000], [0, 25_000]], dtype=np.int32)
    want = [part.tolist() for part in run_collect_step(
        shard_devices(4, CPU), words, ref_start, ref_start + 1000, loci)]
    assert len(want[0]) == n * 8 and want[5] == [32] * 4 and want[4] == [n, 3]
    for report in two_rank_functions:
        assert report["collect"] == want


def _vcf_digest(working_dir):
    with open(os.path.join(working_dir, "variants.vcf")) as handle:
        body = [line for line in handle if not line.startswith("##fileDate")]
    return hashlib.sha256("".join(body).encode()).hexdigest(), len(
        [line for line in body if not line.startswith("#")])


def _logged_json(working_dir, rank, marker):
    logs = sorted(name for name in os.listdir(working_dir)
                  if name.endswith(".p{0}.log".format(rank)))
    with open(os.path.join(working_dir, logs[-1])) as handle:
        for line in handle:
            if marker in line:
                return json.loads(line.split(marker, 1)[1])
    raise AssertionError("no {0!r} in rank {1}'s log".format(marker, rank))


@pytest.mark.parametrize("edit_backend", ["wavefront", "auto"])
def test_two_process_cli_vcf_equals_single_process_and_jax(dataset,
                                                           edit_backend,
                                                           monkeypatch):
    out, bam, genome = dataset
    monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")
    extra = ["--edit_backend", edit_backend, "--profile"]
    single = os.path.join(out, "single_" + edit_backend)
    assert _port_main(["alignment", single, bam, genome,
                       "--incremental_cluster", "off"] + extra) == 0
    from svim_tpu_torch.cluster import device_cluster

    single_eligible = device_cluster.TELEMETRY.eligible
    jax_wd = os.path.join(out, "jax_" + edit_backend)
    assert jax_main(["alignment", jax_wd, bam, genome, "--edit_backend",
                     edit_backend]) == 0

    multi = os.path.join(out, "multi_" + edit_backend)
    results = launch_ranks(2, [sys.executable, "-m", "svim_tpu_torch",
                               "alignment", multi, bam, genome,
                               "--distributed"] + extra)
    for rank, (code, output) in enumerate(results):
        assert code == 0, "rank {0}:\n{1}".format(rank, output[-4000:])
    digest, calls = _vcf_digest(multi)
    assert calls >= 10
    assert digest == _vcf_digest(single)[0] == _vcf_digest(jax_wd)[0]
    # both ranks logged under their own name and only rank 0 wrote
    assert len([name for name in os.listdir(multi)
                if name.endswith(".log")]) == 2
    eligible = [_logged_json(multi, rank, "Cluster telemetry: ")["eligible"]
                for rank in range(2)]
    assert min(eligible) > 0 and sum(eligible) == single_eligible
    exchange = [_logged_json(multi, rank, "Exchange totals: ")
                for rank in range(2)]
    # COLLECT tables, CLUSTER groupings, insertion consensus outcomes
    assert [entry["rounds"] for entry in exchange] == [3, 3]
    assert exchange[0]["received"] == exchange[1]["received"] \
        == exchange[0]["sent"] + exchange[1]["sent"]


def test_distributed_refuses_an_input_that_is_not_bgzf(dataset, monkeypatch):
    out, bam, genome = dataset
    monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")
    sam = os.path.join(out, "plain.sam")
    with open(sam, "w") as handle:
        handle.write("@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:1000\n")
    assert _port_main(["alignment", os.path.join(out, "refused"), sam,
                       genome, "--distributed"]) == 1
