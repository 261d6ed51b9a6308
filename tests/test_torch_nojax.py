"""svim_tpu_torch never imports jax, directly or through the svim_tpu host
modules it reuses.  Checked in a fresh interpreter (this test process
already imported jax through tests/conftest.py) after two whole golden
slices (its input written by the port's workload generator): one-shot with
--edit_backend wavefront, and streaming (--stream_input), so lazy imports
on both paths count."""

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SCRIPT = """
import json, os, sys
sys.path.insert(0, {repo!r})
sys.path.insert(0, os.path.join({repo!r}, "tests"))
import svim_tpu_torch
from svim_tpu_torch.cli import main
from svim_tpu_torch.workloads import golden_workload
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
print(json.dumps({{"code": [code, code_stream], "golden": [same, same_stream],
                  "jax": sorted(
    name for name in sys.modules if name == "jax" or name.startswith("jax."))}}))
"""


def test_port_pipeline_imports_no_jax(tmp_path):
    env = dict(os.environ, SVIM_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1")
    env.pop("PYTHONPATH", None)
    result = subprocess.run(
        [sys.executable, "-c", _SCRIPT.format(repo=REPO, work=str(tmp_path))],
        capture_output=True, text=True, timeout=600, env=env, cwd=tmp_path)
    assert result.returncode == 0, result.stderr[-4000:]
    report = json.loads(result.stdout.strip().splitlines()[-1])
    assert report == {"code": [0, 0], "golden": [True, True], "jax": []}
