"""Output flags, COMBINE's representation choices and the tandem-run
quirk through the port, each against svim_tpu on the same input: the
cases of tests/test_output_flags.py (READS/SEQS/ZMWS tags,
--duplications_as_insertions representations, the insertion-removal
sweep, --plot_histtype bar), of tests/test_all_bnds.py (--all_bnds twin
breakends, and none without the flag) and the two unit cases of
tests/test_tandem_direction.py (the stale run direction of the tandem
merger).  Whole runs go through both CLIs on the CPU and must write
byte-equal variants.vcf files (##fileDate aside) that pass the JAX tests'
checks."""

import os
import random

import pytest
import torch

from svim_tpu import candidates as jax_candidates
from svim_tpu import plots as jax_plots
from svim_tpu import signatures as jax_signatures
from svim_tpu.cli import main as jax_main
from svim_tpu.collect import inter as jax_inter
from svim_tpu.combine import combine as jax_combine
from svim_tpu.config import parse_arguments as jax_parse_arguments
from svim_tpu_torch import candidates as port_candidates
from svim_tpu_torch import plots as port_plots
from svim_tpu_torch import signatures as port_signatures
from svim_tpu_torch.cli import main as port_main
from svim_tpu_torch.collect import inter as port_inter
from svim_tpu_torch.combine import combine as port_combine
from svim_tpu_torch.config import parse_arguments as port_parse_arguments

# one intra-op thread: the suite runs several pytest workers
torch.set_num_threads(1)


def _write_genome(path, genome, wrapped=True):
    with open(path, "w") as handle:
        handle.write(">chr1\n")
        if not wrapped:
            handle.write(genome + "\n")
            return
        for i in range(0, len(genome), 60):
            handle.write(genome[i:i + 60] + "\n")


def _sam(path, length, lines):
    lines.sort(key=lambda line: int(line.split("\t")[3]))
    path.write_text("@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:{0}\n"
                    .format(length) + "\n".join(lines) + "\n")
    return str(path)


def _both(tmp_path, monkeypatch, sam_path, genome_path, flags):
    """Both CLIs on one input: the port's variants.vcf records (split
    fields), after checking its bytes equal svim_tpu's, ##fileDate aside."""
    monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")
    texts = []
    for name, main in (("jax", jax_main), ("port", port_main)):
        workdir = tmp_path / ("wd_" + name)
        assert main(["alignment", str(workdir), sam_path, genome_path]
                    + flags) == 0
        with open(workdir / "variants.vcf") as handle:
            texts.append([line for line in handle
                          if not line.startswith("##fileDate")])
    assert texts[1] == texts[0]
    return [line.rstrip("\n").split("\t") for line in texts[1]
            if not line.startswith("#")]


def test_reads_seqs_zmws_tags(tmp_path, monkeypatch):
    rng = random.Random(31)
    genome = "".join(rng.choice("ACGT") for _ in range(60000))
    genome_path = str(tmp_path / "genome.fa")
    _write_genome(genome_path, genome)
    ins_seq = "".join(rng.choice("ACGT") for _ in range(80))
    lines = []
    for i in range(4):
        start = 19000 - 17 * i
        left = genome[start:20000]
        right = genome[20000:20000 + 1200]
        # PacBio-style movie/zmw/range names; reads pairwise share a ZMW
        name = "m54238_1/{0}/{1}_5000".format(100 + i // 2, i)
        lines.append("{0}\t0\tchr1\t{1}\t60\t{2}M80I{3}M\t*\t0\t0\t{4}\t*"
                     .format(name, start + 1, len(left), len(right),
                             left + ins_seq + right))
    sam_path = _sam(tmp_path / "ins.sam", 60000, lines)
    (record,) = _both(tmp_path, monkeypatch, sam_path, genome_path,
                      ["--read_names", "--insertion_sequences", "--zmws",
                       "--skip_genotyping"])
    info = record[7]
    assert "READS=" in info
    assert info.count("m54238_1/") >= 4
    assert "SEQS=" in info
    assert ins_seq in info
    assert "ZMWS=2" in info  # 4 reads, 2 distinct wells


def _representation_entries(signatures, candidates):
    members = [signatures.SignatureInsertion("chr1", 100, 150, "suppl", "r1",
                                             "A" * 50)]
    tan = candidates.CandidateDuplicationTandem("chr1", 100, 150, 1, True,
                                                members, 5, None, None)
    dup_int = candidates.CandidateDuplicationInterspersed(
        "chr1", 100, 150, "chr2", 900, 950, members, 5, None, None,
        cutpaste=True)
    return (tan.get_vcf_entry_as_dup(), tan.get_vcf_entry_as_ins(),
            dup_int.get_vcf_entry_as_ins())


def test_duplications_as_insertions_representation():
    entry_dup, entry_ins, entry_int = _representation_entries(
        port_signatures, port_candidates)
    assert (entry_dup, entry_ins, entry_int) == _representation_entries(
        jax_signatures, jax_candidates)
    assert "SVTYPE=DUP:TANDEM" in entry_dup and "\tGT:CN:DP:AD\t" in entry_dup
    assert "SVTYPE=INS" in entry_ins and "SVLEN=50" in entry_ins
    assert "SVTYPE=INS;CUTPASTE;" in entry_int
    assert entry_int.split("\t")[0] == "chr2"


def _removals(signatures, candidates, combine):
    """An insertion whose locus and length match a DUP_INT destination is
    dropped, a distant one survives; a length mismatch of 20% or more
    keeps it (SVIM_COMBINE.py:404-457)."""
    def cluster(start):
        return signatures.SignatureClusterUniLocal(
            "chr1", start, start + 100, 10, 3, [], "INS", None, None)

    explained, unrelated = cluster(5000), cluster(40000)
    members = [signatures.SignatureInsertion("chr1", 5000, 5100, "suppl",
                                             "r", "A" * 100)]
    dup = candidates.CandidateDuplicationInterspersed(
        "chr2", 100, 200, "chr1", 4990, 5090, members, 8, None, None)
    short_dup = candidates.CandidateDuplicationInterspersed(
        "chr2", 100, 160, "chr1", 4990, 5050, members, 8, None, None)
    return (combine._remove_insertions_at_duplications(
                [explained, unrelated], [dup], []),
            combine._remove_insertions_at_duplications(
                [explained], [short_dup], []))


def test_insertion_removal_sweep():
    removed = _removals(port_signatures, port_candidates, port_combine)
    assert removed == ([0], [])
    assert removed == _removals(jax_signatures, jax_candidates, jax_combine)


class _Stub:
    def __init__(self, length, score=8):
        self.score = score
        self._length = length

    def get_source(self):
        return ("chr1", 1000, 1000 + self._length)

    def get_destination(self):
        return ("chr1", 1000, 1000 + self._length)


def test_plot_histtype_bar(tmp_path):
    """--plot_histtype bar: the reference renderer's hist/legend calls run
    and write both plots, as svim_tpu's do."""
    pytest.importorskip("matplotlib")
    candidates = [_Stub(60), _Stub(300), _Stub(1500), _Stub(12000)]
    written = []
    for name, plots in (("jax", jax_plots), ("port", port_plots)):
        class _Options:
            working_dir = str(tmp_path / name)
            plot_histtype = "bar"

        os.makedirs(_Options.working_dir)
        plots.plot_sv_lengths(candidates, candidates[:2], candidates[:1],
                              candidates[:3], candidates, _Options())
        written.append(sorted(os.listdir(_Options.working_dir)))
    assert written[1] == written[0] == ["sv-lengths-q10.png",
                                        "sv-lengths-q5.png"]


def _deletion_dataset(directory, wrapped):
    rng = random.Random(44)
    genome = "".join(rng.choice("ACGT") for _ in range(50000))
    genome_path = str(directory / "genome.fa")
    _write_genome(genome_path, genome, wrapped)
    lines = []
    for i in range(5):
        start = 9000 - 19 * i
        left = genome[start:10000]
        right = genome[10400:10400 + 1100]
        lines.append("del{0}\t0\tchr1\t{1}\t60\t{2}M400D{3}M\t*\t0\t0\t{4}"
                     "\t*".format(i, start + 1, len(left), len(right),
                                  left + right))
    return _sam(directory / "dels.sam", 50000, lines), genome_path


def _svtype(record):
    return [entry for entry in record[7].split(";")
            if entry.startswith("SVTYPE=")][0][7:]


def test_all_bnds_emits_twin_breakends(tmp_path, monkeypatch):
    sam_path, genome_path = _deletion_dataset(tmp_path, wrapped=True)
    records = _both(tmp_path, monkeypatch, sam_path, genome_path,
                    ["--all_bnds", "--skip_genotyping", "--symbolic_alleles"])
    svtypes = [_svtype(record) for record in records]
    assert svtypes.count("DEL") == 1
    # the deletion's twin breakend pair, one record a side, anchored at
    # (del_start, del_end) 0-based, +1 in the VCF (SVIM_intra.py:44)
    assert svtypes.count("BND") == 2
    assert sorted(int(record[1]) for record in records
                  if _svtype(record) == "BND") == [10001, 10401]


def test_without_all_bnds_no_twins(tmp_path, monkeypatch):
    sam_path, genome_path = _deletion_dataset(tmp_path, wrapped=False)
    records = _both(tmp_path, monkeypatch, sam_path, genome_path,
                    ["--skip_genotyping", "--symbolic_alleles"])
    assert records and all(_svtype(record) != "BND" for record in records)


@pytest.mark.parametrize("directions, copies", [
    # [fwd, rev, rev]: the reference flushes on every rev entry, because
    # the direction it compares with stays the first run's fwd
    ((True, False, False), [1, 1, 1]),
    # [fwd, rev, fwd]: the third entry matches the stale fwd direction and
    # merges into the rev-seeded run
    ((True, False, True), [1, 2])])
def test_stale_tandem_direction(directions, copies):
    results = []
    for inter, parse in ((port_inter, port_parse_arguments),
                         (jax_inter, jax_parse_arguments)):
        emit = inter._Emitter("read1", parse(
            arguments=["alignment", "wd", "reads.bam", "genome.fa"]))
        emit.tandem_runs = [
            ("chr1", 1000, 1500, True, directions[0]),
            ("chr1", 3000, 3500, True, directions[1]),
            ("chr1", 3000, 3500, True, directions[2])]
        inter._merge_tandem_runs(emit)
        results.append([signature.as_string() for signature
                        in emit.signatures if signature.type == "DUP_TAN"])
        assert [signature.copies for signature in emit.signatures
                if signature.type == "DUP_TAN"] == copies
    assert results[0] == results[1]
