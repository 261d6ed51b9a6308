"""svim_tpu_torch stands on its own: it imports neither jax nor any module
of svim_tpu.  Checked in a fresh interpreter (this test process already
imported both through tests/conftest.py) after three whole golden slices
(its input written by the port's workload generator): one-shot with
--edit_backend wavefront, streaming (--stream_input), and one-shot with
mid-scan incremental clustering at work (the default, with the scan
delivered in chunks so that partitions are reused), so lazy imports on all
three paths count; statically over every source file of the port and
chip_smoke.py; and select_device refuses to carry on without a card unless
the CPU was asked for."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = """
import json, os, sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, os.path.join({repo!r}, "tests"))
import svim_tpu_torch
from svim_tpu_torch.cli import main
from svim_tpu_torch.workloads import chunked_scan, golden_workload
from test_golden_vcf import GOLDEN, _normalize

bam, genome = golden_workload({work!r})
wd = os.path.join({work!r}, "wd")
code = main(["alignment", wd, bam, genome, "--edit_backend", "wavefront"])
same = _normalize(os.path.join(wd, "variants.vcf")) == _normalize(GOLDEN)
streamed = os.path.join({work!r}, "wd_stream")
code_stream = main(["alignment", streamed, bam, genome, "--stream_input",
                    "--batch_reads", "64"])
same_stream = (_normalize(os.path.join(streamed, "variants.vcf"))
               == _normalize(GOLDEN))
incremental = os.path.join({work!r}, "wd_incremental")
with chunked_scan(64):
    code_incremental = main(["alignment", incremental, bam, genome,
                             "--batch_reads", "64"])
same_incremental = (_normalize(os.path.join(incremental, "variants.vcf"))
                    == _normalize(GOLDEN))
reused = 0
for name in os.listdir(incremental):
    if name.startswith("SVIM_") and name.endswith(".log"):
        for line in open(os.path.join(incremental, name)):
            if "Incremental clustering: " in line:
                reused = int(line.split("Incremental clustering: ")[1].split()[0])
def loaded(package):
    return sorted(name for name in sys.modules
                  if name == package or name.startswith(package + "."))
print(json.dumps({{"code": [code, code_stream, code_incremental],
                  "golden": [same, same_stream, same_incremental],
                  "reused": reused > 0,
                  "jax": loaded("jax"), "svim_tpu": loaded("svim_tpu")}}))
"""


def test_port_pipeline_imports_no_jax(tmp_path):
    env = dict(os.environ, SVIM_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    result = subprocess.run(
        [sys.executable, "-c", _SCRIPT.format(repo=REPO, work=str(tmp_path))],
        capture_output=True, text=True, timeout=600, env=env, cwd=tmp_path)
    assert result.returncode == 0, result.stderr[-4000:]
    report = json.loads(result.stdout.strip().splitlines()[-1])
    assert report == {"code": [0, 0, 0], "golden": [True, True, True],
                      "reused": True, "jax": [], "svim_tpu": []}


def _imported_modules(path):
    """Every module name a source file imports, at any depth."""
    with open(path) as handle:
        tree = ast.parse(handle.read(), filename=path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.extend(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def _port_sources():
    sources = sorted(glob.glob(os.path.join(REPO, "svim_tpu_torch", "**",
                                            "*.py"), recursive=True))
    return sources + [os.path.join(REPO, "chip_smoke.py")]


def test_port_sources_import_neither_jax_nor_svim_tpu():
    sources = _port_sources()
    assert len(sources) > 40
    offending = []
    for path in sources:
        for name in _imported_modules(path):
            root = name.split(".")[0]
            if root in ("jax", "jaxlib", "svim_tpu"):
                offending.append((os.path.relpath(path, REPO), name))
    assert offending == []
    assert not os.path.exists(os.path.join(REPO, "svim_tpu_torch",
                                           "native.py"))


@pytest.mark.parametrize("requested, card, expected", [
    ("", False, RuntimeError), ("cuda", False, RuntimeError),
    ("cpu", False, "cpu"), ("cpu", True, "cpu"), ("tpu", False, ValueError)])
def test_select_device_needs_a_card_unless_cpu_is_asked(monkeypatch,
                                                        requested, card,
                                                        expected):
    import torch

    from svim_tpu_torch.utils.device import select_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: card)
    if requested:
        monkeypatch.setenv("SVIM_TORCH_DEVICE", requested)
    else:
        monkeypatch.delenv("SVIM_TORCH_DEVICE", raising=False)
    if isinstance(expected, str):
        assert select_device().type == expected
        return
    with pytest.raises(expected, match="SVIM_TORCH_DEVICE"):
        select_device()


def test_cli_refuses_to_run_without_a_card(tmp_path, monkeypatch):
    """The entry point raises instead of carrying on on the CPU."""
    import torch

    from svim_tpu_torch import cli

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("SVIM_TORCH_DEVICE", raising=False)
    sam = tmp_path / "x.sam"
    sam.write_text("@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:chr1\tLN:1000\n")
    genome = tmp_path / "g.fa"
    genome.write_text(">chr1\n" + "ACGT" * 250 + "\n")
    with pytest.raises(RuntimeError, match="SVIM_TORCH_DEVICE=cpu"):
        cli.main(["alignment", str(tmp_path / "wd"), str(sam), str(genome)])
