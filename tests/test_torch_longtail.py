"""The long tail of a real sample (svim_tpu_torch.workloads.longtail_workload
and longtail_region_workload: a collapsed repeat far above the background
depth and ultra-long reads across long insertions) at a small size on the
CPU: a 700 kb host at 10x, the collapsed repeat at 400x, two insertion loci.

The two knobs (`pileup`, `long_ins`) draw from a stream of their own, so
at None the sample and the six-class sample keep their bytes.  On the cut
region, svim_tpu's CLI and the port's write one VCF, one-shot (mid-scan
clustering at the CLI's defaults) and with --stream_input; COLLECT re-runs
batches whose events overflow the first table, and the signatures equal
svim_tpu's in order; the partitions over 100 signatures are subsampled to
svim_tpu's members in order; GENOTYPE joins candidates on the device and
on the host in one run and gives svim_tpu's genotypes.  At this size no
candidate's table slice is wider than MAX_WINDOW_ROWS (8,192), so the test
lowers it to 2,048 on both packages' genotype_kernel modules, inside the
test only: the collapsed repeat's candidates then take the host join, the
others the device join.  Every comparison is exact."""

import json
import os

import numpy as np
import pytest
import torch

from svim_tpu import cli as jax_cli
from svim_tpu import genotype as jax_genotype
from svim_tpu.cluster import cluster as jax_cluster
from svim_tpu.ops import genotype_kernel as jax_genotype_kernel
from svim_tpu_torch import cli as torch_cli
from svim_tpu_torch import genotype as torch_genotype
from svim_tpu_torch import workloads
from svim_tpu_torch.cluster import cluster as torch_cluster
from svim_tpu_torch.collect import packed as torch_packed
from svim_tpu_torch.ops import genotype_kernel as torch_genotype_kernel

torch.set_num_threads(1)
CUT = dict(contig_length=700_000, partner_length=300_000, depth=10,
           pileup=400, long_ins=2)
WINDOW_ROWS = 2048
# the small samples of tests/test_torch_sample_workload.py and
# tests/test_torch_sample_classes.py, and their inflated streams before the
# long tail's knobs existed
SMALL = dict(contig_length=2_000_000, partner_length=1_000_000, depth=10,
             ins_sizes=(50, 600))
SMALL_INFLATED_SHA256 = ("dd4429efee07f07126433db4d41ad785"
                         "b7c7d1fc03b46cbe35da564fda3c48d4")
SMALL_CLASSES = dict(SMALL, contig_length=3_000_000, split_loci=5)
SMALL_CLASSES_INFLATED_SHA256 = ("209a033cef20d65fd9bbd0ca7b819ef6"
                                 "de954c4eaf2490fff50d910b8506427f")


def _made(directory):
    with open(os.path.join(directory, workloads.SAMPLE_FILE)) as handle:
        return json.load(handle)


def _normalized(path):
    with open(path) as handle:
        return [line for line in handle if not line.startswith("##fileDate")]


def _signature_fields(signature):
    names = [name for cls in type(signature).__mro__
             for name in getattr(cls, "__slots__", ())]
    return (type(signature).__name__,) + tuple(
        getattr(signature, name, None) for name in names)


def _signatures(soa):
    """Every signature of a SignatureSoA, by type, in table order."""
    return {sig_type: [_signature_fields(signature) for signature in
                       table.materialize_list(range(table.n))]
            for sig_type, table in soa.tables.items()}


def _members(sample):
    if getattr(sample, "table", None) is not None:
        sample = sample.table.materialize_list(sample.indices)
    return [_signature_fields(signature) for signature in sample]


class _Run:
    """One CLI run of a package with what the test compares recorded: the
    signatures COLLECT handed to CLUSTER, the subsampled partitions (their
    members, in order) and the candidates joined on the device and on the
    host."""

    def __init__(self, cli, cluster, genotype, monkeypatch):
        self.signatures = None
        self.large = []
        self.joined = {"kernel": 0, "host": 0}
        cluster_stage = cli.cluster_sv_signatures

        def recorded_cluster(signatures, *args, **kwargs):
            if self.signatures is None:
                self.signatures = _signatures(signatures)
            return cluster_stage(signatures, *args, **kwargs)

        dispatch = cluster.dispatch_clusters_from_partitions

        def recorded_dispatch(partitions, *args, **kwargs):
            work = dispatch(partitions, *args, **kwargs)
            self.large += [_members(sample) for partition, sample
                           in zip(partitions, work.samples)
                           if len(partition) > cluster.MAX_PARTITION_SIZE]
            return work

        finish = genotype._finish_genotype_jobs

        def recorded_finish(pending, counts, *args, **kwargs):
            for count in counts:
                self.joined["host" if count is None else "kernel"] += 1
            return finish(pending, counts, *args, **kwargs)

        monkeypatch.setattr(cli, "cluster_sv_signatures", recorded_cluster)
        monkeypatch.setattr(cluster, "dispatch_clusters_from_partitions",
                            recorded_dispatch)
        monkeypatch.setattr(genotype, "_finish_genotype_jobs",
                            recorded_finish)


@pytest.fixture(scope="module")
def region(tmp_path_factory):
    """(directory, bam, genome) of the cut long-tail region."""
    directory = str(tmp_path_factory.mktemp("longtail"))
    bam, genome = workloads.longtail_region_workload(directory, 1, **CUT)
    return directory, bam, genome


@pytest.fixture(scope="module")
def jax_run(region, tmp_path_factory):
    """svim_tpu's CLI at its defaults on the cut region, with
    MAX_WINDOW_ROWS lowered: (working dir, _Run)."""
    _directory, bam, genome = region
    monkeypatch = pytest.MonkeyPatch()
    try:
        monkeypatch.setattr(jax_genotype_kernel, "MAX_WINDOW_ROWS",
                            WINDOW_ROWS)
        run = _Run(jax_cli, jax_cluster, jax_genotype, monkeypatch)
        working_dir = str(tmp_path_factory.mktemp("jax") / "wd")
        assert jax_cli.main(["alignment", working_dir, bam, genome]) == 0
    finally:
        monkeypatch.undo()
    return working_dir, run


@pytest.mark.parametrize("changes, pinned", [
    (SMALL, SMALL_INFLATED_SHA256),
    (SMALL_CLASSES, SMALL_CLASSES_INFLATED_SHA256)],
    ids=["sample", "sample_classes"])
def test_the_knobs_at_none_keep_the_samples_bytes(changes, pinned, tmp_path):
    workloads.sample_workload(str(tmp_path), 1, pileup=None, long_ins=None,
                              **changes)
    assert _made(str(tmp_path))["inflated_sha256"] == pinned


def test_the_region_holds_the_long_tail(region):
    directory, bam, _genome = region
    made = _made(directory)
    from svim_tpu_torch.collect.packed import STREAMING_THRESHOLD_BYTES

    assert os.path.getsize(bam) < STREAMING_THRESHOLD_BYTES
    # 3 to 12 DEL and INS a pileup read, about 9 on average
    low, mean, high = made["pileup"]["events_per_read"]
    assert 3 <= low and high <= 12 and 8 <= mean <= 10
    assert made["pileup"]["reads"] == round(
        CUT["pileup"] * workloads.PILEUP_SPAN / workloads.PILEUP_READ_SPAN)
    (_, first, _), (_, second, _) = made["long_ins"]
    assert workloads.LONG_INS_SIZES[0][0] <= first \
        <= workloads.LONG_INS_SIZES[0][1]
    assert workloads.LONG_INS_SIZES[1][0] <= second \
        <= workloads.LONG_INS_SIZES[1][1]
    truth = workloads.load_truth(directory)
    assert sum(record.svtype == "INS" and record.length >= 5_000
               for record in truth) == CUT["long_ins"]


@pytest.mark.parametrize("stream", [False, True],
                         ids=["one-shot", "stream_input"])
def test_port_equals_svim_tpu_on_the_long_tail(region, jax_run, stream,
                                               monkeypatch, tmp_path):
    _directory, bam, genome = region
    jax_dir, jax_recorded = jax_run
    monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(torch_genotype_kernel, "MAX_WINDOW_ROWS", WINDOW_ROWS)
    run = _Run(torch_cli, torch_cluster, torch_genotype, monkeypatch)
    reruns_before = len(torch_packed.RERUNS)
    working_dir = str(tmp_path / "port")
    assert torch_cli.main(["alignment", working_dir, bam, genome]
                          + (["--stream_input"] if stream else [])) == 0
    assert _normalized(os.path.join(working_dir, "variants.vcf")) \
        == _normalized(os.path.join(jax_dir, "variants.vcf"))
    # COLLECT re-ran a batch at a larger table, and its signatures are
    # svim_tpu's, in order
    reruns = torch_packed.RERUNS[reruns_before:]
    assert reruns
    for count, before, after in reruns:
        assert before < count <= after
    assert run.signatures == jax_recorded.signatures
    # the subsampled partitions hold svim_tpu's members, in order
    assert len(run.large) >= 2 * 50
    assert all(len(members) == torch_cluster.MAX_PARTITION_SIZE
               for members in run.large)
    assert run.large == jax_recorded.large
    # one GENOTYPE run joined candidates on the device and on the host,
    # as svim_tpu's did; the VCF above holds the genotypes
    assert run.joined == jax_recorded.joined
    assert run.joined["kernel"] and run.joined["host"]


def test_the_ports_route_counters_count_the_routes(region, jax_run, monkeypatch,
                                             tmp_path):
    """The port's own counters (collect.packed.RERUNS, genotype.JOINED,
    cluster.LARGE_PARTITIONS) count what the test's wrappers count."""
    _directory, bam, genome = region
    jax_dir, jax_recorded = jax_run
    monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")
    monkeypatch.setattr(torch_genotype_kernel, "MAX_WINDOW_ROWS", WINDOW_ROWS)
    monkeypatch.setattr(torch_genotype, "JOINED", {"kernel": 0, "host": 0})
    monkeypatch.setattr(torch_cluster, "LARGE_PARTITIONS", {})
    working_dir = str(tmp_path / "port")
    assert torch_cli.main(["alignment", working_dir, bam, genome,
                           "--incremental_cluster", "off"]) == 0
    assert _normalized(os.path.join(working_dir, "variants.vcf")) \
        == _normalized(os.path.join(jax_dir, "variants.vcf"))
    assert torch_genotype.JOINED == jax_recorded.joined
    large = torch_cluster.LARGE_PARTITIONS
    assert set(large) == {"DEL", "INS"}
    assert large["DEL"] + large["INS"] == len(jax_recorded.large)
    assert np.all(np.asarray(list(large.values())) > 0)
