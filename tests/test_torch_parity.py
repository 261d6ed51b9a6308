"""Whole-pipeline byte parity of the port with svim_tpu on the datasets of
tests/test_pipeline_parity.py: the 150-read mix and the randomized inputs
of its three output-flag combinations, each a coordinate-sorted BAM run
through both CLIs; variants.vcf must be byte-equal (##fileDate aside)."""

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
