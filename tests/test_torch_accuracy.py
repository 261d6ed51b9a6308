"""Accuracy through the port's CLI, against svim_tpu on the same inputs:
the stress harness of tests/test_accuracy.py (12% read noise, repeats,
three contigs, cut&paste DUP:INT; seed 5) and its all-classes simulations
(seeds 1 and 7), and the donor-genome projection of
tests/test_accuracy2.py's nested/adjacent stress (seed 17).  Each run's
variants.vcf must be byte-equal to svim_tpu's (##fileDate aside), with
equal per-class (tp, fp, fn), and pass the JAX tests' bounds.

The port's inputs come from svim_tpu_torch.workloads.stress_workload and
independent_workload at these smaller sizes (the JAX side's from
svim_tpu.sim and sim2): the genome text, the decoded BAM records and the
truth set must be equal, and the truth set must read back from the JSON
the generators write beside the BAM."""

import os

import pytest
import torch

from svim_tpu import sim as jax_sim
from svim_tpu import sim2 as jax_sim2
from svim_tpu.cli import main as jax_main
from svim_tpu.io.sam import AlignmentFile as JaxAlignmentFile
from svim_tpu_torch import sim as port_sim
from svim_tpu_torch import workloads
from svim_tpu_torch.cli import main as port_main
from svim_tpu_torch.io.sam import AlignmentFile as PortAlignmentFile

# one intra-op thread: the suite runs several pytest workers
torch.set_num_threads(1)

# the stress SimConfig of tests/test_accuracy.py, as changes to
# workloads.STRESS_SIM (every field of which it sets)
STRESS_CHANGES = dict(genome_length=3_000_000, second_contig_length=800_000,
                      extra_contigs=(2_000_000,), coverage=10, n_del=6,
                      n_ins=6, n_inv=5, n_tan=5, n_dup_int=3,
                      n_dup_int_cutpaste=3, n_bnd=4, n_background=300,
                      error_rate=0.12, repeat_fraction=0.15)
# the Sim2Config of tests/test_accuracy2.py::test_nested_adjacent_sv_accuracy
NESTED_CHANGES = dict(coverage=14, n_del=3, n_ins=3, n_inv=2, n_tan=2,
                      n_tan_short=2, n_dup_int=2, n_dup_int_cutpaste=1,
                      n_bnd=2, n_ins_in_inv=3, n_del_in_tan=3, n_replace=3,
                      n_close_del_pair=3)


def _records(alignment_file, path):
    alignments = alignment_file(path)
    return [workloads._sam_line(record, alignments.header)
            for record in alignments.fetch(until_eof=True)]


def _same_inputs(port, reference):
    """Two simulators' (genome, bam, truth): equal genome text, decoded
    records and truth records."""
    with open(port[0]) as a, open(reference[0]) as b:
        assert a.read() == b.read()
    assert _records(PortAlignmentFile, port[1]) \
        == _records(JaxAlignmentFile, reference[1])
    assert [tuple(variant) for variant in port[2]] \
        == [tuple(variant) for variant in reference[2]]


def _run_both(tmp_path, monkeypatch, port_input, jax_input, truth):
    """Both CLIs at their defaults: the port's per-class counts, after
    checking its VCF bytes and counts equal svim_tpu's."""
    monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")
    texts, results = [], []
    for name, main, (genome, bam) in (("jax", jax_main, jax_input),
                                      ("port", port_main, port_input)):
        workdir = str(tmp_path / ("wd_" + name))
        assert main(["alignment", workdir, bam, genome]) == 0
        vcf = os.path.join(workdir, "variants.vcf")
        with open(vcf) as handle:
            texts.append([line for line in handle
                          if not line.startswith("##fileDate")])
        results.append(port_sim.evaluate_vcf(vcf, truth))
    assert texts[1] == texts[0]
    assert results[1] == results[0]
    return results[1], texts[1]


def test_stress_harness(tmp_path, monkeypatch):
    """The repeat-rich, 12%-noise, three-contig stress simulation: every
    class above F1 0.9, every miss a truth-set collision, every cut&paste
    DUP:INT flagged, as tests/test_accuracy.py asks of svim_tpu."""
    port_dir, jax_dir = tmp_path / "port_input", tmp_path / "jax_input"
    port_dir.mkdir()
    jax_dir.mkdir()
    port = workloads.stress_workload(str(port_dir), 5, **STRESS_CHANGES)
    reference = jax_sim.simulate(str(jax_dir), jax_sim.SimConfig(
        seed=5, **STRESS_CHANGES))
    _same_inputs(port, reference)
    truth = workloads.load_truth(str(port_dir))
    assert truth == port[2]
    results, vcf = _run_both(tmp_path, monkeypatch, port[:2], reference[:2],
                             truth)
    for svtype, (tp, fp, fn) in results.items():
        assert port_sim.f1(tp, fp, fn) >= 0.9, (svtype, tp, fp, fn)
    assert results["ALL"][2] <= len(port_sim.truth_collisions(truth))
    assert sum("CUTPASTE" in line for line in vcf) \
        >= STRESS_CHANGES["n_dup_int_cutpaste"]


@pytest.mark.parametrize("seed", [1, 7])
def test_all_classes(tmp_path, monkeypatch, seed):
    config = dict(seed=seed, genome_length=2_000_000,
                  second_contig_length=500_000, coverage=10, n_del=6,
                  n_ins=6, n_inv=5, n_tan=5, n_dup_int=4, n_bnd=4,
                  n_background=80)
    port_dir, jax_dir = tmp_path / "port_input", tmp_path / "jax_input"
    port_dir.mkdir()
    jax_dir.mkdir()
    port = port_sim.simulate(str(port_dir), port_sim.SimConfig(**config))
    reference = jax_sim.simulate(str(jax_dir), jax_sim.SimConfig(**config))
    _same_inputs(port, reference)
    results, _ = _run_both(tmp_path, monkeypatch, port[:2], reference[:2],
                           port[2])
    for svtype, (tp, fp, fn) in results.items():
        assert port_sim.f1(tp, fp, fn) >= 0.9, (seed, svtype, tp, fp, fn)
    assert port_sim.f1(*results["ALL"]) >= 0.95, results["ALL"]


def test_independent_harness_nested_sites(tmp_path, monkeypatch):
    """The donor-genome projection with nested and adjacent sites: every
    class but DUP:TANDEM recalled in full, precision as
    tests/test_accuracy2.py pins it (a short tandem copy represented as an
    INS, at most n_tan_short times either way)."""
    port_dir, jax_dir = tmp_path / "port_input", tmp_path / "jax_input"
    port_dir.mkdir()
    jax_dir.mkdir()
    port = workloads.independent_workload(str(port_dir), 17,
                                          **NESTED_CHANGES)
    reference = jax_sim2.simulate_independent(
        str(jax_dir), jax_sim2.Sim2Config(seed=17, **NESTED_CHANGES))
    _same_inputs(port, reference)
    truth = workloads.load_truth(str(port_dir))
    assert truth == port[2]
    results, _ = _run_both(tmp_path, monkeypatch, port[:2], reference[:2],
                           truth)
    short = NESTED_CHANGES["n_tan_short"]
    for svtype, (tp, fp, fn) in results.items():
        if svtype not in ("DUP:TANDEM", "ALL"):
            assert fn == 0, (svtype, results)
    missed = results["DUP:TANDEM"][2]
    assert missed <= short, results
    for svtype in ("DEL", "INV", "DUP:TANDEM", "DUP:INT", "BND"):
        assert results[svtype][1] == 0, (svtype, results)
    assert missed <= results["INS"][1] <= short, results
    assert port_sim.f1(*results["ALL"]) >= 0.95, results["ALL"]
