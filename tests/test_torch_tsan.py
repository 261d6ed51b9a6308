"""ThreadSanitizer gate over the port's native thread pools: the twin of
tests/test_tsan.py for svim_tpu_torch/native (its own copy of
svimnative.cpp and poa.cpp, built by svim_tpu_torch.native).  Builds the
-fsanitize=thread variant of the port's library (SVIM_NATIVE_TSAN=1) and
drives all pools concurrently via scripts/tsan_stress_torch.py.

Marked slow, as its twin is, so the tier-1 run (-m 'not slow') leaves it
out; run it by hand:

    python -m pytest tests/test_torch_tsan.py -m slow

Skips (rather than fails) when the toolchain lacks libtsan.
"""

import os
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STRESS = os.path.join(REPO, "scripts", "tsan_stress_torch.py")


def _libtsan_path():
    try:
        out = subprocess.run(
            ["g++", "-print-file-name=libtsan.so.2"],
            check=True, capture_output=True, text=True).stdout.strip()
    except (OSError, subprocess.CalledProcessError):
        return None
    # g++ echoes the bare name back when the library is not found
    return out if os.path.isabs(out) and os.path.exists(out) else None


def test_native_pools_tsan_clean():
    libtsan = _libtsan_path()
    if libtsan is None:
        pytest.skip("libtsan not available in this toolchain")
    env = dict(os.environ)
    env["SVIM_NATIVE_TSAN"] = "1"
    # libtsan must be loaded before CPython so the runtime can intercept
    # every thread the process creates, not just the library's own.
    env["LD_PRELOAD"] = libtsan
    suppressions = os.path.join(REPO, "scripts", "tsan_suppressions.txt")
    env["TSAN_OPTIONS"] = ("halt_on_error=0 exitcode=66 "
                           "suppressions=" + suppressions)
    env.pop("JAX_PLATFORMS", None)  # stress script never imports jax
    result = subprocess.run(
        [sys.executable, STRESS], env=env, capture_output=True,
        text=True, timeout=600, cwd=REPO)
    warnings = result.stderr.count("WARNING: ThreadSanitizer")
    assert result.returncode == 0 and warnings == 0, (
        "TSAN stress failed (rc={0}, {1} warnings)\n--- stderr tail ---\n{2}"
        .format(result.returncode, warnings, result.stderr[-4000:]))
    assert "TSAN_STRESS_OK" in result.stdout
