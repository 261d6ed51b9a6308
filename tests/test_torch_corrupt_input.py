"""Malformed-input diagnostics of the port (twin of tests/
test_corrupt_input.py): a truncated BAM, a truncated BGZF member and garbage
input end the port's CLI with exit code 1 and a logged error that names the
problem ("truncated or corrupt", "not valid SAM"), never a raw
struct.error, on the one-shot path and under --stream_input, as they end
svim_tpu's.  And the window inflate of the streaming path hides nothing: an
error of the native build raised inside _decompress_window reaches the
caller (only a window the native inflate declines, by returning None, goes
to gzip)."""

import gzip
import logging

import pytest

from svim_tpu.cli import main as jax_main
from svim_tpu_torch import native
from svim_tpu_torch.cli import main
from svim_tpu_torch.io import bam as bamio
from svim_tpu_torch.io import bamstream
from svim_tpu_torch.io.sam import AlignmentHeader, parse_sam_line

BLOBS = {"trunc": (lambda data: data[:len(data) - 30], "truncated or corrupt"),
         "half": (lambda data: data[:len(data) // 2], "truncated or corrupt"),
         "garbage": (lambda data: b"not a bam at all" * 100, "not valid SAM")}


@pytest.fixture()
def dataset(tmp_path, monkeypatch):
    monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")
    header = AlignmentHeader.from_text(
        "@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:100000\n")
    records = [parse_sam_line(
        "r0\t0\tchr1\t100\t60\t500M60D500M\t*\t0\t0\t" + "A" * 1000 + "\t*",
        header)]
    bam_path = str(tmp_path / "ok.bam")
    bamio.write_bam(bam_path, header, records)
    genome = str(tmp_path / "genome.fa")
    with open(genome, "w") as handle:
        handle.write(">chr1\n" + "ACGT" * 25000 + "\n")
    with open(bam_path, "rb") as handle:
        data = handle.read()
    return tmp_path, data, genome


def _run(entry, tmp_path, blob, genome, name, caplog, flags=()):
    path = str(tmp_path / (name + ".bam"))
    with open(path, "wb") as handle:
        handle.write(blob)
    caplog.clear()
    with caplog.at_level(logging.ERROR):
        code = entry(["alignment", str(tmp_path / ("wd_" + name)), path,
                      genome, *flags])
    return code, caplog.text


@pytest.mark.parametrize("flags", [(), ("--stream_input",)],
                         ids=["one_shot", "stream_input"])
@pytest.mark.parametrize("name", sorted(BLOBS))
def test_malformed_input_exits_1_with_a_named_error(dataset, caplog, name,
                                                    flags):
    tmp_path, data, genome = dataset
    damage, message = BLOBS[name]
    code, text = _run(main, tmp_path, damage(data), genome, name, caplog,
                      flags)
    assert code == 1
    assert message in text
    assert "struct.error" not in text.split("Traceback")[0]
    # svim_tpu ends the same input the same way
    jax_code, jax_text = _run(jax_main, tmp_path, damage(data), genome,
                              name + "_jax", caplog, flags)
    assert (jax_code, message in jax_text) == (1, True)


def test_intact_input_still_runs(dataset, caplog):
    tmp_path, data, genome = dataset
    for flags in ((), ("--stream_input",)):
        code, text = _run(main, tmp_path, data, genome,
                          "ok" + "_".join(flags), caplog, flags)
        assert code == 0, text


def _window(data):
    blocks = list(bamstream.scan_bgzf_blocks(data))
    assert blocks
    return blocks


def test_native_build_error_inside_the_window_inflate_reaches_the_caller(
        dataset, monkeypatch):
    _tmp_path, data, _genome = dataset

    def broken():
        raise RuntimeError("g++ failed for svimnative.cpp")

    monkeypatch.setattr(native, "get_library", broken)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        bamstream._decompress_window(data, _window(data))


def test_window_the_native_inflate_declines_goes_to_gzip(dataset,
                                                         monkeypatch):
    _tmp_path, data, _genome = dataset
    blocks = _window(data)
    want = gzip.decompress(bytes(data))
    # the native inflate hands back a buffer of its own, gzip bytes
    assert bytes(bamstream._decompress_window(data, blocks, b"carry")) \
        == b"carry" + want
    monkeypatch.setattr(native, "bgzf_decompress_with_prefix",
                        lambda window, prefix=b"": None)
    assert bamstream._decompress_window(data, blocks, b"carry") \
        == b"carry" + want
