"""The port's other `alignment` inputs against svim_tpu's: SAM text
(collect_signatures_packed) and queryname-sorted SAM or BAM
(collect_signatures_packed_querysorted, the grouped path whose classify
slots are real supplementary rows) give the same signatures, and through
the CLI byte-equal variants.vcf and signature BED files, on the seeds of
tests/test_packed_collect.py and tests/test_querysorted_packed.py, with and
without --all_bnds."""

import os
import random

import numpy as np
import pytest
import torch

from svim_tpu.cli import main as jax_main
from svim_tpu.collect import packed as jax_packed
from svim_tpu.config import parse_arguments
from svim_tpu.io import bam as bamio
from svim_tpu.io.sam import AlignmentFile
from svim_tpu_torch import cli as torch_cli
from svim_tpu_torch.collect import packed as torch_packed
from test_packed_collect import _random_sam
from test_querysorted_packed import _random_querysorted_sam

CPU = torch.device("cpu")
# one intra-op thread: the suite runs several pytest workers
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def genome(tmp_path_factory):
    """chr1 and chr2 at the lengths of both generators' headers."""
    path = tmp_path_factory.mktemp("genome") / "genome.fa"
    rng = np.random.default_rng(5)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    with open(path, "wb") as handle:
        for contig, length in (("chr1", 1_000_000), ("chr2", 800_000)):
            rows = bases[rng.integers(0, 4, size=length)].reshape(-1, 50)
            handle.write(">{0}\n".format(contig).encode())
            handle.write(b"\n".join(row.tobytes() for row in rows) + b"\n")
    return str(path)


def _write_input(directory, kind, seed, as_bam):
    if kind == "coordinate":
        text = _random_sam(random.Random(seed), all_split=seed % 2 == 0)
    else:
        text = _random_querysorted_sam(random.Random(seed))
    sam = directory / "input.sam"
    sam.write_text(text)
    if not as_bam:
        return str(sam)
    alignments = AlignmentFile(str(sam))
    bam = directory / "input.bam"
    bamio.write_bam(str(bam), alignments.header,
                    list(alignments.fetch(until_eof=True)))
    return str(bam)


CASES = [("coordinate", 1, False, False), ("coordinate", 2, True, False),
         ("coordinate", 3, False, False),
         ("queryname", 1, False, False), ("queryname", 2, False, True),
         ("queryname", 3, False, False), ("queryname", 5, True, False)]


@pytest.mark.parametrize("kind,seed,all_bnds,as_bam", CASES)
def test_signatures_equal_jax(tmp_path, kind, seed, all_bnds, as_bam):
    path = _write_input(tmp_path, kind, seed, as_bam)
    options = parse_arguments(arguments=["alignment", str(tmp_path), path,
                                         "g.fa"] + (["--all_bnds"]
                                                    if all_bnds else []))
    port, jax = {
        "coordinate": (torch_packed.collect_signatures_packed,
                       jax_packed.collect_signatures_packed),
        "queryname": (torch_packed.collect_signatures_packed_querysorted,
                      jax_packed.collect_signatures_packed_querysorted),
    }[kind]
    got = port(AlignmentFile(path), options, CPU)
    want = jax(AlignmentFile(path), options)
    for got_list, want_list in zip(got, want):
        assert ([s.as_string() for s in got_list]
                == [s.as_string() for s in want_list])
    assert len(got[0]) > 20
    assert len(got[1]) > 0 if all_bnds else not got[1]


def _strip_date(path):
    with open(path) as handle:
        return [line for line in handle if not line.startswith("##fileDate")]


@pytest.mark.parametrize("kind,seed,all_bnds,as_bam", CASES)
def test_pipeline_outputs_equal_jax(tmp_path, genome, kind, seed, all_bnds,
                                    as_bam, monkeypatch):
    monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")
    path = _write_input(tmp_path, kind, seed, as_bam)
    extra = ["--all_bnds"] if all_bnds else []
    assert jax_main(["alignment", str(tmp_path / "jax"), path, genome]
                    + extra) == 0
    assert torch_cli.main(["alignment", str(tmp_path / "port"), path, genome]
                          + extra) == 0
    vcf = _strip_date(tmp_path / "port" / "variants.vcf")
    assert vcf == _strip_date(tmp_path / "jax" / "variants.vcf")
    assert sum(1 for line in vcf if not line.startswith("#")) >= 5
    beds = sorted(name for name in os.listdir(tmp_path / "jax" / "signatures")
                  if name.endswith(".bed"))
    assert len(beds) >= 6
    for name in beds:
        assert (tmp_path / "port" / "signatures" / name).read_bytes() \
            == (tmp_path / "jax" / "signatures" / name).read_bytes(), name
