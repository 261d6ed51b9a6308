"""`reads` mode through svim_tpu_torch, on the CPU, against svim_tpu.

No aligner is installed where the tests run, so tiny executable stubs on
PATH stand in (the fixtures of tests/test_reads_mode.py, copied): the
aligner stubs emit a prepared SAM stream and log their argv; the samtools
stub sorts it into a real BGZF BAM with the port's io layer and creates the
.bai marker.  Each case runs the port and svim_tpu over the same stubs and
holds the port's variants.vcf to svim_tpu's, byte for byte (##fileDate
aside): pipeline construction, BAM cache reuse, the --nanopore presets, the
.fn file list (array path and --device_backend host), a missing tool, and a
cached <prefix>.<aligner>.coordsorted.bam with no aligner at all.
"""

import gzip
import logging
import os
import random
import stat
import sys
from unittest import mock

import pytest
import torch

from svim_tpu.cli import main as jax_main
from svim_tpu_torch import align as torch_align
from svim_tpu_torch import cli as torch_cli
from svim_tpu_torch.io import bam as bamio
from svim_tpu_torch.io.sam import AlignmentFile

torch.set_num_threads(1)
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_ALIGNER_STUB = '''#!{python}
import os, sys
with open(os.environ["SVIM_STUB_LOG"], "a") as log:
    log.write("{name} " + " ".join(sys.argv[1:]) + "\\n")
if "--help" in sys.argv:
    sys.exit(0)
if "-q" not in sys.argv and not sys.stdin.isatty():
    # piped-reads invocation (gunzip -c ... | ngmlr): consume stdin like the
    # real aligner, otherwise the upstream stage dies on EPIPE under
    # pipefail when this stub exits first
    sys.stdin.read()
with open(os.environ["SVIM_STUB_SAM"]) as sam:
    sys.stdout.write(sam.read())
'''

_SAMTOOLS_STUB = '''#!{python}
import os, sys
sys.path.insert(0, {repo!r})
with open(os.environ["SVIM_STUB_LOG"], "a") as log:
    log.write("samtools " + " ".join(sys.argv[1:]) + "\\n")
if "--help" in sys.argv:
    sys.exit(0)
mode = sys.argv[1]
if mode == "view":
    sys.stdout.write(sys.stdin.read())       # SAM text passes through
elif mode == "sort":
    out_path = sys.argv[sys.argv.index("-o") + 1]
    from svim_tpu_torch.io.sam import AlignmentHeader, parse_sam_line
    from svim_tpu_torch.io import bam as bamio
    header_lines, records = [], []
    header = None
    for line in sys.stdin:
        if line.startswith("@"):
            header_lines.append(line.rstrip("\\n"))
            continue
        if header is None:
            header = AlignmentHeader.from_text("\\n".join(header_lines))
        if line.strip():
            records.append(parse_sam_line(line, header))
    records.sort(key=lambda r: (r.reference_id, r.reference_start))
    # stamp the coordinate sort order the pipeline dispatches on
    text = "\\n".join(l for l in header_lines if not l.startswith("@HD"))
    header = AlignmentHeader.from_text("@HD\\tVN:1.6\\tSO:coordinate\\n" + text)
    bamio.write_bam(out_path, header, records)
elif mode == "index":
    with open(sys.argv[2] + ".bai", "wb") as handle:
        handle.write(b"BAI\\x01")
'''

_GUNZIP_STUB = '''#!{python}
import sys
if "--help" in sys.argv:
    sys.exit(0)
import gzip
with gzip.open(sys.argv[-1], "rt") as handle:
    sys.stdout.write(handle.read())
'''


def _port_main(arguments):
    """The port's CLI on the CPU, with the run-log tail attached to a
    failure; detaches the log handlers the run added."""
    root = logging.getLogger()
    before = list(root.handlers)
    try:
        code = torch_cli.main(arguments)
    finally:
        for handler in root.handlers[:]:
            if handler not in before:
                root.removeHandler(handler)
                handler.close()
    if code != 0:
        wd = arguments[1]
        logs = sorted(name for name in os.listdir(wd)
                      if name.startswith("SVIM_") and name.endswith(".log"))
        with open(os.path.join(wd, logs[-1])) as handle:
            tail = "".join(handle.readlines()[-30:])
        raise AssertionError("pipeline rc={0}\n--- run log tail ---\n{1}"
                             .format(code, tail))
    return code


def _vcf(working_dir):
    with open(os.path.join(str(working_dir), "variants.vcf")) as handle:
        return [line for line in handle if not line.startswith("##fileDate")]


def _records(working_dir):
    return [line for line in _vcf(working_dir) if not line.startswith("#")]


@pytest.fixture
def stub_env(tmp_path, monkeypatch):
    """PATH with stub ngmlr/minimap2/samtools/gunzip + a SAM they 'produce'."""
    monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    for name, template in (("ngmlr", _ALIGNER_STUB),
                           ("minimap2", _ALIGNER_STUB),
                           ("samtools", _SAMTOOLS_STUB),
                           ("gunzip", _GUNZIP_STUB)):
        path = bin_dir / name
        path.write_text(template.format(python=sys.executable, name=name,
                                        repo=REPO_ROOT))
        path.chmod(path.stat().st_mode | stat.S_IXUSR | stat.S_IXGRP
                   | stat.S_IXOTH)

    rng = random.Random(17)
    genome = "".join(rng.choice("ACGT") for _ in range(60000))
    genome_path = tmp_path / "genome.fa"
    with open(genome_path, "w") as handle:
        handle.write(">chr1\n")
        for i in range(0, len(genome), 70):
            handle.write(genome[i:i + 70] + "\n")

    # one clean DEL locus, deep enough to call and genotype
    lines = ["@HD\tVN:1.6\tSO:unknown", "@SQ\tSN:chr1\tLN:60000"]
    for i in range(8):
        start = 20000 - 900 - i * 37
        left = genome[start:20000]
        right = genome[20300:20300 + 1200]
        lines.append("read{0}\t0\tchr1\t{1}\t60\t{2}M300D{3}M\t*\t0\t0\t{4}\t*"
                     .format(i, start + 1, len(left), len(right),
                             left + right))
    sam_path = tmp_path / "stub_output.sam"
    sam_path.write_text("\n".join(lines) + "\n")

    log_path = tmp_path / "stub_calls.log"
    log_path.write_text("")
    monkeypatch.setenv("PATH", str(bin_dir) + os.pathsep + os.environ["PATH"])
    monkeypatch.setenv("SVIM_STUB_SAM", str(sam_path))
    monkeypatch.setenv("SVIM_STUB_LOG", str(log_path))

    reads_path = tmp_path / "sample.fastq"
    reads_path.write_text("@read0\nACGT\n+\n!!!!\n")
    return tmp_path, str(reads_path), str(genome_path), log_path


def _stub_calls(log_path):
    return [line for line in log_path.read_text().splitlines()
            if "--help" not in line]


def _jax_vcf(tmp_path, name, arguments):
    """svim_tpu's variants.vcf for the same reads-mode arguments."""
    wd = str(tmp_path / name)
    assert jax_main(["reads", wd] + arguments) == 0
    return _vcf(wd)


def test_reads_mode_end_to_end(stub_env):
    tmp_path, reads_path, genome_path, log_path = stub_env
    wd = str(tmp_path / "wd")
    _port_main(["reads", wd, reads_path, genome_path])

    # pipeline construction: aligner ran, view/sort/index ran, BAM cached
    calls = _stub_calls(log_path)
    assert any(call.startswith("ngmlr") for call in calls)
    assert any(call.startswith("samtools sort") for call in calls)
    assert any(call.startswith("samtools index") for call in calls)
    bam_path = os.path.join(wd, "sample.ngmlr.coordsorted.bam")
    assert os.path.exists(bam_path) and os.path.exists(bam_path + ".bai")

    # the DEL came through the whole pipeline
    records = _records(wd)
    assert len(records) == 1 and "SVTYPE=DEL" in records[0]
    assert records[0].split("\t")[1] == "20000" and "SVLEN=-300" in records[0]

    # cache reuse: a second run must not re-run the aligner
    first = _vcf(wd)
    before = len(_stub_calls(log_path))
    _port_main(["reads", wd, reads_path, genome_path])
    assert len(_stub_calls(log_path)) == before
    assert _vcf(wd) == first

    assert first == _jax_vcf(tmp_path, "wd_jax", [reads_path, genome_path])


def test_reads_mode_nanopore_minimap2(stub_env):
    tmp_path, reads_path, genome_path, log_path = stub_env
    wd = str(tmp_path / "wd_ont")
    extra = ["--aligner", "minimap2", "--nanopore", "--cores", "3"]
    _port_main(["reads", wd, reads_path, genome_path] + extra)
    minimap = [call for call in _stub_calls(log_path)
               if call.startswith("minimap2")]
    assert minimap and "-x map-ont" in minimap[0] and "-t 3" in minimap[0]
    assert _vcf(wd) == _jax_vcf(tmp_path, "wd_ont_jax",
                                [reads_path, genome_path] + extra)


def test_reads_mode_ngmlr_nanopore_gzip(stub_env):
    """Gzipped input routes through gunzip | ngmlr with the ont preset."""
    tmp_path, reads_path, genome_path, log_path = stub_env
    gz_path = str(tmp_path / "sample2.fastq.gz")
    with gzip.open(gz_path, "wt") as handle:
        handle.write("@read0\nACGT\n+\n!!!!\n")
    wd = str(tmp_path / "wd_gz")
    _port_main(["reads", wd, gz_path, genome_path, "--nanopore"])
    ngmlr = [call for call in _stub_calls(log_path)
             if call.startswith("ngmlr")]
    assert ngmlr and "-x ont" in ngmlr[0] and "-q" not in ngmlr[0]
    assert _vcf(wd) == _jax_vcf(tmp_path, "wd_gz_jax",
                                [gz_path, genome_path, "--nanopore"])


def test_reads_mode_file_list(stub_env):
    """A .fn list of read files loops run_alignment and concatenates the
    files' signatures (svim:68-82)."""
    tmp_path, reads_path, genome_path, log_path = stub_env
    second = tmp_path / "other.fastq"
    second.write_text("@read1\nACGT\n+\n!!!!\n")
    list_path = tmp_path / "inputs.fq.fn"
    list_path.write_text(reads_path + "\n" + str(second) + "\n")
    wd = str(tmp_path / "wd_list")
    _port_main(["reads", wd, str(list_path), genome_path])
    calls = _stub_calls(log_path)
    assert sum(1 for call in calls if call.startswith("ngmlr")) == 2
    assert os.path.exists(os.path.join(wd, "sample.ngmlr.coordsorted.bam"))
    assert os.path.exists(os.path.join(wd, "other.ngmlr.coordsorted.bam"))
    # both files' signature lists concatenated into one DEL call
    records = _records(wd)
    assert len(records) == 1 and "SVTYPE=DEL" in records[0]

    # the array list path must byte-match the record-based host path
    wd_host = str(tmp_path / "wd_list_host")
    _port_main(["reads", wd_host, str(list_path), genome_path,
                "--device_backend", "host"])
    assert ([line for line in _vcf(wd) if not line.startswith("##")]
            == [line for line in _vcf(wd_host) if not line.startswith("##")])

    assert _vcf(wd) == _jax_vcf(tmp_path, "wd_list_jax",
                                [str(list_path), genome_path])


def test_run_alignment_missing_tool(tmp_path):
    with pytest.raises(torch_align.ToolMissingError):
        torch_align.run_alignment(str(tmp_path), "genome.fa", "reads.fq",
                                  "fastq", 1, "definitely-not-an-aligner",
                                  False)


def test_reads_mode_with_cached_alignment(tmp_path, monkeypatch):
    """reads mode reuses an existing <prefix>.<aligner>.coordsorted.bam
    (reference: SVIM_alignment.py:29,58-60), which lets the full reads-mode
    dispatch run without external aligners."""
    monkeypatch.setenv("SVIM_TORCH_DEVICE", "cpu")
    rng = random.Random(12)
    lines = []
    for i in range(24):
        start = rng.randint(0, 100000)
        lines.append("r{0}\t0\tchr1\t{1}\t60\t500M{2}D500M\t*\t0\t0\t{3}\t*"
                     .format(i, start + 1, rng.randint(50, 200), "A" * 1000))
    lines.sort(key=lambda line: int(line.split("\t")[3]))
    sam_path = tmp_path / "shard.sam"
    sam_path.write_text("@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:1000000\n"
                        + "\n".join(lines) + "\n")
    af = AlignmentFile(str(sam_path))
    records = list(af.fetch(until_eof=True))
    reads_path = tmp_path / "reads.fq"
    reads_path.write_text("@r\nACGT\n+\n!!!!\n")
    genome_path = tmp_path / "g.fa"
    genome_path.write_text(">chr1\n" + "ACGT" * 300000 + "\n")
    arguments = [str(reads_path), str(genome_path), "--skip_genotyping",
                 "--symbolic_alleles"]
    bodies = {}
    for package, patched, run in (
            ("port", "svim_tpu_torch.align.check_prerequisites", _port_main),
            ("jax", "svim_tpu.align.check_prerequisites", jax_main)):
        workdir = tmp_path / ("wd_" + package)
        workdir.mkdir()
        cached_bam = workdir / "reads.ngmlr.coordsorted.bam"
        bamio.write_bam(str(cached_bam), af.header, records)
        (workdir / "reads.ngmlr.coordsorted.bam.bai").write_bytes(b"")
        # the prerequisites probe would fail (no aligners where the tests
        # run); the cache branch must not invoke the aligner itself
        with mock.patch(patched):
            assert run(["reads", str(workdir)] + arguments) == 0
        bodies[package] = _vcf(workdir)
    assert len([line for line in bodies["port"]
                if not line.startswith("#")]) == 24   # one DEL per read
    assert bodies["port"] == bodies["jax"]
