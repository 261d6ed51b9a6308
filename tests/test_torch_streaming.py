"""Parity of the port's streaming COLLECT (svim_tpu_torch.io.bamstream) with
svim_tpu's collect_streaming(..., soa=True) on the cases of
tests/test_streaming.py: equal signature tables, twins and genotype tables
at several batch sizes, across tiny decompression windows, through the
carve path (a header spanning windows) and the pure-Python record walk;
and a streaming variants.vcf byte-equal to the one-shot one through the
port's CLI."""

import random

import pytest
import torch

from svim_tpu import native
from svim_tpu.config import parse_arguments
from svim_tpu.io import bam as bamio
from svim_tpu.io.bamstream import collect_streaming as jax_collect_streaming
from svim_tpu.io.sam import AlignmentFile
from svim_tpu_torch import cli as torch_cli
from svim_tpu_torch.io import bamstream
from test_packed_collect import _random_sam
from test_torch_collect import _assert_same_collect

CPU = torch.device("cpu")
# one intra-op thread: the suite runs several pytest workers
torch.set_num_threads(1)


def _make_bam(directory, n_reads=300, comment_bytes=0):
    """tests/test_streaming.py's BAM; `comment_bytes` adds a @CO header line
    of that length (a header larger than one BGZF block)."""
    text = _random_sam(random.Random(77), n_reads)
    if comment_bytes:
        first, rest = text.split("\n", 1)
        text = "{0}\n@CO\t{1}\n{2}".format(first, "x" * comment_bytes, rest)
    sam_path = directory / "s.sam"
    sam_path.write_text(text)
    alignments = AlignmentFile(str(sam_path))
    bam_path = directory / "s.bam"
    bamio.write_bam(str(bam_path), alignments.header,
                    list(alignments.fetch(until_eof=True)))
    return str(bam_path)


def _options(directory, bam, *extra):
    return parse_arguments(arguments=["alignment", str(directory), bam,
                                      "genome.fa", *extra])


@pytest.mark.parametrize("batch_reads,all_bnds", [(1, False), (7, True),
                                                  (64, False)])
def test_streaming_soa_equals_jax(tmp_path, batch_reads, all_bnds):
    bam = _make_bam(tmp_path, n_reads=150 if batch_reads == 1 else 300)
    extra = ["--batch_reads", str(batch_reads)] + (
        ["--all_bnds"] if all_bnds else [])
    options = _options(tmp_path, bam, *extra)
    before = bamstream.BATCHES
    got = bamstream.collect_streaming(bam, options, CPU)
    assert bamstream.BATCHES - before >= 150 // batch_reads
    _assert_same_collect(got, jax_collect_streaming(bam, options, soa=True))


@pytest.mark.parametrize("window", [64 * 1024, 1])
def test_streaming_across_window_boundaries(tmp_path, window, monkeypatch):
    """Records carved across tiny decompression windows survive intact;
    window 1 also isolates the BGZF EOF block in a final window."""
    bam = _make_bam(tmp_path, n_reads=200)
    options = _options(tmp_path, bam, "--batch_reads", "64")
    want = jax_collect_streaming(bam, options, soa=True)
    monkeypatch.setattr(bamstream, "WINDOW_UNCOMPRESSED", window)
    _assert_same_collect(bamstream.collect_streaming(bam, options, CPU), want)


def test_header_spanning_windows_takes_the_carve_path(tmp_path, monkeypatch):
    bam = _make_bam(tmp_path, n_reads=200, comment_bytes=100_000)
    options = _options(tmp_path, bam, "--batch_reads", "64")
    want = jax_collect_streaming(bam, options, soa=True)
    carved = []
    carve = bamstream._stream_bam_carve

    def spy(*args):
        carved.append(True)
        return carve(*args)

    monkeypatch.setattr(bamstream, "_stream_bam_carve", spy)
    # one BGZF block per window: the first holds only part of the header
    monkeypatch.setattr(bamstream, "WINDOW_UNCOMPRESSED", 1)
    _assert_same_collect(bamstream.collect_streaming(bam, options, CPU), want)
    assert carved


def test_pure_python_walk_equals_jax(tmp_path, monkeypatch):
    """Without the native library the port walks records in Python."""
    bam = _make_bam(tmp_path, n_reads=200)
    options = _options(tmp_path, bam, "--batch_reads", "64")
    want = jax_collect_streaming(bam, options, soa=True)
    monkeypatch.setattr(native, "get_library", lambda: None)
    _assert_same_collect(bamstream.collect_streaming(bam, options, CPU), want)


def _strip_date(path):
    with open(path) as handle:
        return [line for line in handle if not line.startswith("##fileDate")]


def test_streaming_vcf_equals_oneshot_through_the_cli(tmp_path, monkeypatch):
    monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")
    bam = _make_bam(tmp_path)
    rng = random.Random(5)
    genome = tmp_path / "genome.fa"
    with open(genome, "w") as handle:
        for contig in ("chr1", "chr2"):
            handle.write(">{0}\n".format(contig))
            for _ in range(600000 // 60):
                handle.write("".join(rng.choice("ACGT") for _ in range(60))
                             + "\n")
    before = bamstream.BATCHES
    assert torch_cli.main(["alignment", str(tmp_path / "wd_stream"), bam,
                           str(genome), "--stream_input", "--batch_reads",
                           "64"]) == 0
    assert bamstream.BATCHES - before == 5
    assert torch_cli.main(["alignment", str(tmp_path / "wd_oneshot"), bam,
                           str(genome)]) == 0
    assert bamstream.BATCHES - before == 5
    streamed = _strip_date(tmp_path / "wd_stream" / "variants.vcf")
    assert streamed == _strip_date(tmp_path / "wd_oneshot" / "variants.vcf")
    assert len(streamed) > 30
