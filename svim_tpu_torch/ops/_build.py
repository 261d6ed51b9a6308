"""Build and load the port's hand-written CUDA kernels.

Each `csrc/*.cu` file is compiled by `nvcc` for Hopper (`sm_90a`) into a
shared library with a plain C interface and loaded through `ctypes` — the
same pattern as svim_tpu/native (g++ + ctypes), and seconds to build where
a source including PyTorch's headers takes minutes.  The build happens at
first use, into `svim_tpu_torch/_build/` (git-ignored), keyed by a hash of
the source and the flags, so a fresh checkout builds on its first kernel
call and later processes reuse the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(_PACKAGE_DIR, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# every kernel source of the port: build(KERNEL_SOURCES) compiles them side
# by side (chip_smoke.py does, so that its build costs one nvcc's time)
KERNEL_SOURCES = ("wavefront", "span_distance", "agglomerate", "collect_scan",
                  "classify_segments", "genotype_support", "ins_matrices",
                  "gotoh")

_lock = threading.Lock()
_libraries = {}
BUILD_SECONDS = {}   # source name -> seconds spent in nvcc by this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin); the CUDA "
                       "kernels of svim_tpu_torch build with the CUDA toolkit")


def library_path(name: str) -> str:
    """Path of the built library for `csrc/<name>.cu` (hash-keyed)."""
    source = os.path.join(CSRC_DIR, name + ".cu")
    with open(source, "rb") as handle:
        digest = hashlib.sha256(handle.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "{0}_{1}.so".format(
        name, digest.hexdigest()[:16]))


def build(names) -> None:
    """Compile every `csrc/<name>.cu` of `names` that is not built yet, one
    nvcc process per source, all started together.  Raises when nvcc is
    missing or any compile fails."""
    with _lock:
        missing = [name for name in names
                   if not os.path.exists(library_path(name))]
        if not missing:
            return
        nvcc = _nvcc()
        os.makedirs(BUILD_DIR, exist_ok=True)
        jobs = []
        for name in missing:
            path = library_path(name)
            # compile to a private name, then rename: concurrent builders
            # never load a half-written library
            partial = "{0}.{1}.tmp".format(path, os.getpid())
            command = [nvcc, *NVCC_FLAGS, "-o", partial,
                       os.path.join(CSRC_DIR, name + ".cu")]
            jobs.append((name, path, partial, time.perf_counter(),
                         subprocess.Popen(command, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True)))
        failures = []
        for name, path, partial, started, process in jobs:
            output, _ = process.communicate()
            if process.returncode != 0:
                failures.append("nvcc failed for {0}.cu:\n{1}".format(
                    name, output))
                continue
            os.replace(partial, path)
            BUILD_SECONDS[name] = time.perf_counter() - started
        if failures:
            raise RuntimeError("\n".join(failures))


def load(name: str) -> ctypes.CDLL:
    """Compile `csrc/<name>.cu` on first use and return the loaded library.
    Raises when nvcc is missing or the compile fails."""
    build([name])
    with _lock:
        library = _libraries.get(name)
        if library is None:
            library = ctypes.CDLL(library_path(name))
            _libraries[name] = library
        return library


def check_tensors(tensors, device) -> None:
    """Raises unless every (name, tensor, dtype, shape) is a contiguous
    tensor of that dtype and shape on `device`: what a kernel's wrapper
    checks before it hands pointers to the kernel."""
    for name, tensor, dtype, shape in tensors:
        if tensor.device != device:
            raise ValueError("{0} is on {1}, expected {2}".format(
                name, tensor.device, device))
        if tensor.dtype != dtype or tuple(tensor.shape) != shape:
            raise ValueError("{0} must be a {1} {2} tensor, got {3} {4}"
                             .format(name, shape, dtype,
                                     tuple(tensor.shape), tensor.dtype))
        if not tensor.is_contiguous():
            raise ValueError("{0} must be contiguous".format(name))


def check_launch(kernel: str, code: int) -> None:
    """Raises when a kernel's C entry point returned a CUDA error code (a
    refused launch never runs, and no later synchronisation reports it)."""
    if code != 0:
        raise RuntimeError("{0} kernel launch failed: CUDA error {1}".format(
            kernel, code))


def route(tensor, name: str, plain, kernel):
    """The function a dispatcher calls for `tensor`: `plain` on the CPU,
    `kernel` on a card; raises for any other device (no quiet fallback)."""
    if tensor.device.type == "cpu":
        return plain
    if tensor.device.type == "cuda":
        return kernel
    raise ValueError("no {0} kernel for device {1}".format(name,
                                                          tensor.device))
