"""The tie-free workload (svim_tpu_torch.workloads.tiefree_workload) through
svim_tpu and through the port on the CPU: the workload whose partitions the
device labels, so that merge sequences from the agglomeration ops decide
bytes of the VCF.

With the default edit backend (about 1,000 reads; the fused route for the
deletions, the matrix route for the insertions, both pad buckets) and with
--edit_backend wavefront (a smaller sample without the wide loci; the
resident route for the insertions), always with --incremental_cluster off:
variants.vcf byte-equal, every signature and candidate BED file equal (the
signatures and the clusters in order), the clustering telemetry equal, with
labelings accepted on both routes and rejected ones beside them.  The same
under --num_shards 4, where the batcher's two flushes hold rows to cut.
The generator is deterministic and imports nothing of svim_tpu.

The port's plain wavefront distance is a Python loop of 2 L dependent
steps, minutes on the CPU at these insertion lengths, so the wavefront case
hands the port's resident route exact distances from the native batch (the
values the kernel would return: its band hints are proven).  svim_tpu runs
its own jit-compiled wavefront."""

import hashlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from svim_tpu.cli import main as jax_main
from svim_tpu.cluster import device_cluster as jax_cluster
from svim_tpu_torch import cli as torch_cli
from svim_tpu_torch import native, workloads
from svim_tpu_torch.cluster import device_cluster as torch_cluster
from svim_tpu_torch.ops import wavefront_kernel

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (reads, wide loci) by edit backend
SAMPLES = {"auto": (1000, workloads.TIEFREE_WIDE_LOCI), "wavefront": (400, 0)}
ROUTES = {"fused": "_consume_fused", "matrix": "_consume_matrix",
          "resident": "_consume_resident"}


def _normalized(path):
    with open(path) as handle:
        return [line for line in handle if not line.startswith("##fileDate")]


def _telemetry(module):
    return {key: value for key, value in module.TELEMETRY.as_dict().items()
            if not key.endswith("_fraction")}


def _count_routes(module, monkeypatch):
    """Accepted labelings (TELEMETRY.device) by the route that consumed
    them, counted while the returned dict's run lasts."""
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


def _bed_files(working_dir):
    found = {}
    for folder in ("signatures", "candidates"):
        for name in sorted(os.listdir(os.path.join(working_dir, folder))):
            if name.endswith(".bed"):
                with open(os.path.join(working_dir, folder, name),
                          "rb") as handle:
                    found[folder + "/" + name] = handle.read()
    return found


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """{edit backend: (bam, genome, svim_tpu's working dir, its telemetry,
    its accepted labelings by route)}."""
    runs = {}
    for backend, (reads, wide_loci) in SAMPLES.items():
        directory = tmp_path_factory.mktemp("tiefree_" + backend)
        bam, genome = workloads.tiefree_workload(str(directory), reads,
                                                 wide_loci=wide_loci)
        with pytest.MonkeyPatch.context() as patch:
            accepted = _count_routes(jax_cluster, patch)
            working_dir = str(directory / "jax")
            assert jax_main(["alignment", working_dir, bam, genome,
                             "--edit_backend", backend,
                             "--incremental_cluster", "off"]) == 0
        runs[backend] = (bam, genome, working_dir, _telemetry(jax_cluster),
                         accepted)
    return runs


def _native_resident_distances(pairs, band_hints, device):
    """Exact distances of the haplotype pairs from the native batch, as the
    int32 tensor the resident route expects."""
    values = native.aligner.edit_distance_batch(list(pairs))
    return torch.as_tensor(np.asarray(values, dtype=np.int32)).to(device)


@pytest.mark.parametrize("flags", [(), ("--num_shards", "4")],
                         ids=["one_device", "num_shards_4"])
@pytest.mark.parametrize("backend", sorted(SAMPLES))
def test_port_equals_svim_tpu_on_the_tiefree_workload(jax_runs, backend,
                                                      flags, monkeypatch,
                                                      tmp_path):
    bam, genome, jax_dir, jax_telemetry, jax_accepted = jax_runs[backend]
    monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")
    if backend == "wavefront":
        monkeypatch.setattr(wavefront_kernel,
                            "batched_edit_distance_resident",
                            _native_resident_distances)
    accepted = _count_routes(torch_cluster, monkeypatch)
    working_dir = str(tmp_path / "port")
    assert torch_cli.main(["alignment", working_dir, bam, genome,
                           "--edit_backend", backend,
                           "--incremental_cluster", "off", *flags]) == 0
    vcf = _normalized(os.path.join(working_dir, "variants.vcf"))
    assert vcf == _normalized(os.path.join(jax_dir, "variants.vcf"))
    assert sum(1 for line in vcf if not line.startswith("#")) >= 16
    assert _bed_files(working_dir) == _bed_files(jax_dir)
    telemetry = _telemetry(torch_cluster)
    assert telemetry == jax_telemetry
    assert accepted == jax_accepted
    # the device decides partitions on both routes, and is overruled on some
    assert accepted["fused"] > 0
    assert accepted["resident" if backend == "wavefront" else "matrix"] > 0
    assert telemetry["post_tie"] + telemetry["resident_relink"] > 0
    if backend == "auto":
        assert telemetry["post_tie"] > 0
        assert accepted["resident"] == 0


def test_sharded_flushes_hold_rows_on_this_workload(jax_runs, monkeypatch,
                                                    tmp_path):
    """--num_shards 4 cuts both of the batcher's flushes here (on the bench
    and golden workloads every partition is resolved before the flush)."""
    bam, genome = jax_runs["auto"][:2]
    monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")
    cut = {"fused": 0, "matrix": 0}
    shard_batch = torch_cluster.shard_batch

    def counted(num_shards, device, *arrays):
        shards = shard_batch(num_shards, device, *arrays)
        if len(shards) == num_shards == 4:
            cut["fused" if len(arrays) == 7 else "matrix"] += 1
        return shards

    monkeypatch.setattr(torch_cluster, "shard_batch", counted)
    assert torch_cli.main(["alignment", str(tmp_path / "port"), bam, genome,
                           "--incremental_cluster", "off", "--num_shards",
                           "4"]) == 0
    # both pad buckets of both routes
    assert cut == {"fused": 2, "matrix": 2}


def test_generator_is_deterministic_and_imports_nothing_of_svim_tpu(
        tmp_path):
    script = (
        "import hashlib, sys\n"
        "sys.path.insert(0, {root!r})\n"
        "from svim_tpu_torch import workloads\n"
        "bam, genome = workloads.tiefree_workload(sys.argv[1], 300, "
        "wide_loci=1)\n"
        "loaded = sorted(name for name in sys.modules if name.split('.')[0] "
        "in ('jax', 'jaxlib', 'svim_tpu'))\n"
        "print(hashlib.sha256(open(bam, 'rb').read()).hexdigest(), "
        "hashlib.sha256(open(genome, 'rb').read()).hexdigest(), loaded)\n"
    ).format(root=ROOT)
    outputs = []
    for name in ("first", "second"):
        directory = tmp_path / name
        directory.mkdir()
        outputs.append(subprocess.run(
            [sys.executable, "-c", script, str(directory)],
            capture_output=True, text=True, check=True,
            timeout=300).stdout.strip())
    assert outputs[0] == outputs[1]
    assert outputs[0].endswith("[]")
    # and in this process, which did import svim_tpu, the same bytes
    directory = tmp_path / "here"
    directory.mkdir()
    bam, genome = workloads.tiefree_workload(str(directory), 300, wide_loci=1)
    with open(bam, "rb") as handle:
        assert hashlib.sha256(handle.read()).hexdigest() \
            == outputs[0].split()[0]
