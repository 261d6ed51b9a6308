"""Whole-pipeline byte parity of the port with svim_tpu on the datasets of
tests/test_pipeline_parity.py: the 150-read mix and the randomized inputs
of its three output-flag combinations, each a coordinate-sorted BAM run
through both CLIs; variants.vcf must be byte-equal (##fileDate aside).
The slow tier also runs the port against the unmodified reference SVIM, the
way tests/test_reference_diff.py runs svim_tpu (skipped where the reference
is not installed)."""


import random

import pytest
import torch

from svim_tpu.cli import main as jax_main
from svim_tpu.io import bam as bamio
from svim_tpu.io.sam import AlignmentFile
from svim_tpu_torch import cli as torch_cli
from test_packed_collect import _random_sam

# one intra-op thread: the suite runs several pytest workers
torch.set_num_threads(1)


def _strip_date(path):
    with open(path) as handle:
        return [line for line in handle if not line.startswith("##fileDate")]


@pytest.mark.parametrize("seed,n_reads,extra_flags", [
    (21, 150, []),
    (33, 90, ["--all_bnds"]),
    (44, 90, ["--read_names", "--insertion_sequences", "--zmws"]),
    (55, 90, ["--tandem_duplications_as_insertions",
              "--interspersed_duplications_as_insertions"]),
])
def test_port_vcf_equals_jax(tmp_path, seed, n_reads, extra_flags,
                             monkeypatch):
    monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")
    sam_path = tmp_path / "input.sam"
    sam_path.write_text(_random_sam(random.Random(seed), n_reads))
    alignments = AlignmentFile(str(sam_path))
    bam_path = str(tmp_path / "input.bam")
    bamio.write_bam(bam_path, alignments.header,
                    list(alignments.fetch(until_eof=True)))
    # the genome of each dataset, as tests/test_pipeline_parity.py makes it
    genome_path = tmp_path / "genome.fa"
    rng = random.Random(5 if seed == 21 else seed + 1)
    with open(genome_path, "w") as handle:
        for contig in ("chr1", "chr2"):
            handle.write(">{0}\n".format(contig))
            for _ in range(600000 // 60):
                handle.write("".join(rng.choice("ACGT") for _ in range(60))
                             + "\n")

    assert jax_main(["alignment", str(tmp_path / "jax"), bam_path,
                     str(genome_path)] + extra_flags) == 0
    assert torch_cli.main(["alignment", str(tmp_path / "port"), bam_path,
                           str(genome_path)] + extra_flags) == 0
    vcf = _strip_date(tmp_path / "port" / "variants.vcf")
    assert vcf == _strip_date(tmp_path / "jax" / "variants.vcf")
    assert len(vcf) > 30


@pytest.mark.slow
def test_port_outputs_equal_the_unmodified_reference(tmp_path, monkeypatch):
    """variants.vcf and every signature and candidate file of the port equal
    the unmodified reference SVIM's on the simulated dataset of
    tests/test_reference_diff.py."""
    import test_reference_diff as reference_diff
    from svim_tpu.sim import SimConfig, simulate

    # that module's own skip condition: the reference is not installed
    not_installed = reference_diff.pytestmark[1]
    if not_installed.args[0]:
        pytest.skip(not_installed.kwargs["reason"])
    monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")
    config = SimConfig(genome_length=700_000, second_contig_length=250_000,
                       coverage=7, n_del=5, n_ins=5, n_inv=3, n_tan=3,
                       n_dup_int=2, n_bnd=2, n_background=60, seed=11)
    genome, bam, _ = simulate(str(tmp_path), config)
    wd_ref = str(tmp_path / "wd_ref")
    wd_port = str(tmp_path / "wd_port")
    reference_diff._run_reference(wd_ref, bam, genome)
    assert torch_cli.main(["alignment", wd_port, bam, genome]) == 0
    assert reference_diff._diff_tree(wd_ref, wd_port) >= 15
