"""Port twins of tests/test_end_to_end.py: the same synthetic dataset (a
100 kb genome with a homozygous DEL and a heterozygous INS, SAM input) and
the header-only BAM through svim_tpu's CLI and svim_tpu_torch's on the CPU;
variants.vcf must be byte-equal (##fileDate aside) with each flag set of
that file, and the empty input must reach neither COLLECT op (a zero-row
batch dispatches nothing)."""

import pytest
import torch

from svim_tpu.cli import main as jax_main
from svim_tpu_torch import cli as torch_cli
from test_end_to_end import synthetic_dataset  # noqa: F401 (a fixture)

torch.set_num_threads(1)


def _strip_date(path):
    with open(path) as handle:
        return [line for line in handle if not line.startswith("##fileDate")]


def _both(tmp_path, name, arguments):
    """variants.vcf lines of svim_tpu and of the port on `arguments`."""
    jax_dir = tmp_path / (name + "_jax")
    port_dir = tmp_path / (name + "_port")
    assert jax_main(["alignment", str(jax_dir)] + arguments) == 0
    assert torch_cli.main(["alignment", str(port_dir)] + arguments) == 0
    return (_strip_date(port_dir / "variants.vcf"),
            _strip_date(jax_dir / "variants.vcf"))


@pytest.mark.parametrize("flags,records", [
    ([], 2),
    (["--symbolic_alleles", "--skip_genotyping", "--skip_consensus"], 2),
    (["--types", "DEL"], 1),
    (["--types", "INS"], 1),
])
def test_port_vcf_equals_jax_on_the_synthetic_dataset(
        synthetic_dataset, monkeypatch, flags, records):  # noqa: F811
    monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")
    tmp_path, sam_path, genome_path, _genome, _ins_seq = synthetic_dataset
    got, want = _both(tmp_path, "run", [sam_path, genome_path] + flags)
    assert got == want
    assert len([line for line in got if not line.startswith("#")]) == records


def test_port_empty_input_equals_jax_and_dispatches_nothing(tmp_path,
                                                            monkeypatch):
    from svim_tpu.io import bam as bamio
    from svim_tpu.io.sam import AlignmentFile
    from svim_tpu_torch.ops import segments_kernel
    from svim_tpu_torch.parallel import mesh

    monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")
    sam_path = tmp_path / "empty.sam"
    sam_path.write_text("@HD\tVN:1.6\tSO:coordinate\n"
                        "@SQ\tSN:chr1\tLN:100000\n")
    genome_path = tmp_path / "g.fa"
    genome_path.write_text(">chr1\n" + "ACGT" * 2500 + "\n")
    bam_path = tmp_path / "empty.bam"
    bamio.write_bam(str(bam_path), AlignmentFile(str(sam_path)).header, [])

    def dispatched(*args, **kwargs):
        raise AssertionError("a COLLECT op ran on an empty input")

    monkeypatch.setattr(mesh, "collect_scan", dispatched)
    monkeypatch.setattr(segments_kernel, "classify_groups_fused", dispatched)
    got, want = _both(tmp_path, "empty", [str(bam_path), str(genome_path)])
    assert got == want
    assert got[0].startswith("##fileformat=VCF")
    assert not [line for line in got if not line.startswith("#")]
