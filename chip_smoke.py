#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (svim_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:
  1. environment: a CUDA device is required; prints the card's name and
     power limit (nvidia-smi) and the torch / CUDA versions;
  2. build: compiles csrc/wavefront.cu and csrc/span_distance.cu with nvcc
     (both at once) into svim_tpu_torch/_build, and svim_tpu's native host
     library (scan session, POA) with g++;
  3. kernel vs plain version on the card: banded_distance_cuda against
     banded_distance_torch on seeded inputs (half near-identical pairs, half
     random) at the main path's shapes and the two front layouts; outputs
     must be exactly equal, and 64 resolved entries must equal the O(nm)
     dynamic program below;
  4. golden slice: `alignment --edit_backend wavefront` on the simulated
     workload of tests/test_golden_vcf.py must write a variants.vcf
     byte-equal to tests/golden/variants.golden.vcf (##fileDate aside) and
     resolve its partitions by the same routes as svim_tpu
     (GOLDEN_TELEMETRY);
  5. bench-size slice: the bench.py workload at 8192 reads through the port
     with --edit_backend wavefront and with the default; both variants.vcf
     must be byte-equal and equal to svim_tpu's (BENCH_VCF_SHA256), and the
     clustering telemetry must equal svim_tpu's (BENCH_TELEMETRY); prints
     stage seconds, calls per class, kernel launches and reads/s through
     COLLECT+CLUSTER;
  6. linkage ops on the card: every call the main path made to the plain
     PyTorch agglomeration ops in phases 4-5 is re-run on the CPU and must
     agree; on seeded tie-free partitions the labels built from the card's
     merges must equal exact float64 host linkage;
  7. distance kernel vs plain version on the card: span_position_matrix_cuda
     against span_position_matrix_torch on seeded partitions at P in {32,
     128} and B in {8, 1024, 8192}, with and without the same-read wall,
     plus the case of tests/test_parallel.py; outputs must be bit-equal;
     prints kernel and plain ms per shape (no entry point calls this
     kernel, as in the JAX package);
  8. streaming slice: the bench BAM rewritten as level-0 BGZF (over 96 MiB,
     same records) through `alignment --edit_backend wavefront --profile`
     must stream (io.bamstream.BATCHES), launch the wavefront kernel, match
     BENCH_TELEMETRY["wavefront"] and hash to BENCH_VCF_SHA256; prints stage
     seconds and reads/s through COLLECT+CLUSTER; the golden workload under
     `--stream_input --batch_reads 64` must write the golden VCF (with
     --edit_backend wavefront);
  9. the other inputs: the golden workload as SAM text and as a
     queryname-sorted BAM (SA entries as real supplementary records) with
     --edit_backend wavefront must write VCFs hashing to svim_tpu's
     (SAM_VCF_SHA256, QUERYNAME_VCF_SHA256) and launch the wavefront kernel.
The script imports torch and the port, never jax or the JAX package: the
inputs come from svim_tpu_torch.workloads.
Then one JSON line describing the kernels, the card line, and the last
line {"ok": true, "device": {...}}.  Scratch files go to
svim_tpu_torch/_build/smoke (git-ignored).
"""

import hashlib
import json
import os
import re
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SCRATCH = os.path.join(ROOT, "svim_tpu_torch", "_build", "smoke")
BENCH_READS = 8192
# (B, L, W) of the JSON timing: the main path's costliest launch on the
# 8192-read workload (two launches of ~8k pairs at L=1024, W=1024)
MAIN_SHAPE = (8192, 1024, 1024)
GOLDEN = os.path.join(ROOT, "tests", "golden", "variants.golden.vcf")
# where the clustering stage resolved its device-eligible partitions: the
# counts svim_tpu's own run gives on the CPU (with mid-scan incremental
# clustering off, as the port runs; tests/test_torch_pipeline.py checks the
# golden ones).  On both workloads every partition has exact float64 ties
# (pre_tie) or a resident INS labeling the float32 guard rejects
# (resident_relink), in svim_tpu too; phase 6 covers accepted labelings.
_NO_TELEMETRY = {"device": 0, "pre_tie": 0, "pre_wall": 0, "post_tie": 0,
                 "post_wall": 0, "resident_relink": 0}
GOLDEN_TELEMETRY = dict(_NO_TELEMETRY, pre_tie=11, pre_wall=2,
                        resident_relink=3)
BENCH_TELEMETRY = {"wavefront": dict(_NO_TELEMETRY, pre_tie=96,
                                     resident_relink=96),
                   "auto": dict(_NO_TELEMETRY, pre_tie=192)}
# sha256 of svim_tpu's variants.vcf on the 8192-read workload (##fileDate
# lines left out), from its CPU run with either edit backend
BENCH_VCF_SHA256 = ("99228bd778ac48bd69bb95bc04b0ff5c"
                    "a8cb583bc7200f065cdc2898f1f5fa3e")
# the same for the golden workload as SAM text (equal to the golden
# fixture's) and as a queryname-sorted BAM (workloads.sam_text /
# queryname_bam), from svim_tpu's CPU runs with --edit_backend wavefront
# --incremental_cluster off; tests/test_torch_workloads.py checks both
SAM_VCF_SHA256 = ("a59cd4b5438e42f0b4d728cfa4dff7b0"
                  "3028aca61fd823004605ed1f25446da8")
QUERYNAME_VCF_SHA256 = ("6296cf39aa2176464f1ac4072ac971cc"
                        "6228edbc67482247d37b92dcca95e383")
# (B, P) of the distance kernel's JSON timing: the largest listed shape
DISTANCE_MAIN_SHAPE = (8192, 128)
LINKAGE_OPS = ("span_position_agglomerate_batched", "agglomerate_batched",
               "ins_matrices_from_pairs")


def log(phase, message):
    print("[{0}] {1}".format(phase, message), flush=True)


def phase_environment():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this smoke "
                           "test needs an NVIDIA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log("env", "card: {0}; torch {1}; CUDA {2}; python {3}".format(
        card, torch.__version__, torch.version.cuda, sys.version.split()[0]))
    os.makedirs(SCRATCH, exist_ok=True)
    return card


def phase_build():
    from svim_tpu_torch.native import host_library
    from svim_tpu_torch.ops import _build, distance_kernel, wavefront_kernel

    started = time.perf_counter()
    _build.build(("wavefront", "span_distance"))
    wavefront_kernel._kernel_library()
    distance_kernel._kernel_library()
    log("build", "wavefront.cu and span_distance.cu built (in parallel) and "
        "loaded in {0:.2f}s (nvcc {1})".format(
            time.perf_counter() - started,
            json.dumps({name: round(seconds, 2) for name, seconds
                        in _build.BUILD_SECONDS.items()})))
    started = time.perf_counter()
    host_library()
    log("build", "native host library ready in {0:.2f}s".format(
        time.perf_counter() - started))


def _pairs(rng, batch, length):
    """Half near-identical pairs (0-50 edits), half independent random."""
    import numpy as np

    alphabet = np.frombuffer(b"ACGT", dtype=np.uint8)
    a_codes = np.zeros((batch, length), dtype=np.uint8)
    b_codes = np.zeros((batch, length), dtype=np.uint8)
    a_lens = np.zeros(batch, dtype=np.int32)
    b_lens = np.zeros(batch, dtype=np.int32)
    for row in range(batch):
        a = alphabet[rng.integers(0, 4, size=rng.integers(length // 2,
                                                          length + 1))]
        if row % 2 == 0:
            b = list(a)
            for _ in range(rng.integers(0, 51)):
                position = int(rng.integers(0, max(1, len(b))))
                edit = rng.integers(0, 3)
                if edit == 0 and b:
                    b[position] = alphabet[rng.integers(0, 4)]
                elif edit == 1:
                    b.insert(position, alphabet[rng.integers(0, 4)])
                elif b:
                    del b[position]
            b = np.asarray(b[:length], dtype=np.uint8)
        else:
            b = alphabet[rng.integers(0, 4, size=rng.integers(length // 2,
                                                              length + 1))]
        a_codes[row, :len(a)] = a
        b_codes[row, :len(b)] = b
        a_lens[row] = len(a)
        b_lens[row] = len(b)
    return a_codes, a_lens, b_codes, b_lens


def _edit_distance_dp(a, b):
    """Levenshtein distance by the O(nm) dynamic program."""
    previous = list(range(len(b) + 1))
    for i, char_a in enumerate(a, start=1):
        current = [i] + [0] * len(b)
        for j, char_b in enumerate(b, start=1):
            current[j] = min(previous[j] + 1, current[j - 1] + 1,
                             previous[j - 1] + (char_a != char_b))
        previous = current
    return previous[len(b)]


def _time_ms(function, repeats, warm_up=True):
    import torch

    if warm_up:
        function()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        result = function()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeats, result


def kernel_shapes():
    """(B, L, W): the main path's lengths and pow4 bands at a small and a
    full batch, the full launches of the 8192-read workload, W=4096 (98 KB
    of shared-memory fronts) and W=16384 (fronts in global scratch)."""
    shapes = [(batch, length, band) for length in (512, 1024)
              for band in (64, 128, 256, 1024) for batch in (8, 1024)]
    return shapes + [(8192, 512, 64), (8192, 512, 256), MAIN_SHAPE,
                     (8, 8192, 4096), (8, 16384, 16384)]


def phase_kernels(shapes, dp_samples=64):
    import numpy as np
    import torch

    from svim_tpu_torch.ops import wavefront_kernel as wk

    rng = np.random.default_rng(20261016)
    timings = {}
    max_abs_err = 0
    dp_checked = 0
    for batch, length, band in shapes:
        a_codes, a_lens, b_codes, b_lens = _pairs(rng, batch, length)
        args = [torch.from_numpy(x).cuda() for x in (a_codes, a_lens,
                                                     b_codes, b_lens)]
        tensors = (args[0], args[1], args[2], args[3], band)
        # one run of the plain version: ~2L dependent steps of small
        # launches, seconds at the widest shapes
        plain_ms, plain = _time_ms(lambda: wk.banded_distance_torch(*tensors),
                                   1, warm_up=False)
        kernel_ms, kernel = _time_ms(lambda: wk.banded_distance_cuda(*tensors),
                                     5)
        plain = plain.cpu().numpy()
        kernel = kernel.cpu().numpy()
        max_abs_err = max(max_abs_err, int(np.abs(
            plain.astype(np.int64) - kernel.astype(np.int64)).max()))
        mismatches = int((plain != kernel).sum())
        if mismatches:
            raise AssertionError("kernel != plain at B={0} L={1} W={2}: {3} "
                                 "entries differ".format(batch, length, band,
                                                         mismatches))
        resolved = np.flatnonzero(kernel <= band)
        # 64 resolved entries against the O(nm) reference DP, spread over
        # the L=512 shapes (the DP is pure Python)
        if length == 512 and dp_checked < dp_samples and len(resolved):
            for row in resolved[:16].tolist():
                a = a_codes[row, :a_lens[row]].tobytes().decode()
                b = b_codes[row, :b_lens[row]].tobytes().decode()
                expected = _edit_distance_dp(a, b)
                if expected != int(kernel[row]):
                    raise AssertionError("kernel distance {0} != DP {1} at "
                                         "B={2} L={3} W={4} row {5}".format(
                                             kernel[row], expected, batch,
                                             length, band, row))
                dp_checked += 1
        layout = "shared" if wk.uses_shared_fronts(band) else "global"
        timings[(batch, length, band)] = (kernel_ms, plain_ms)
        log("kernel", "B={0} L={1} W={2} fronts={3}: equal ({4} resolved); "
            "kernel {5:.3f} ms, plain {6:.3f} ms".format(
                batch, length, band, layout, len(resolved), kernel_ms,
                plain_ms))
    if dp_checked < dp_samples:
        raise AssertionError("only {0} resolved entries checked against the "
                             "DP".format(dp_checked))
    log("kernel", "{0} resolved entries equal the reference DP".format(
        dp_checked))
    return timings, max_abs_err


def _normalized_vcf(path):
    with open(path) as handle:
        return [line for line in handle if not line.startswith("##fileDate")]


def _run_port(arguments):
    """cli.main in this process (so the launch counters are readable), its
    console log sent to <working_dir>.console.log and its tail printed when
    the run fails; detaches the log handlers the run added."""
    import contextlib
    import logging

    from svim_tpu_torch import cli

    root = logging.getLogger()
    before = list(root.handlers)
    console_path = arguments[1].rstrip("/") + ".console.log"
    try:
        with open(console_path, "w") as console, \
                contextlib.redirect_stderr(console):
            code = cli.main(arguments)
    finally:
        for handler in root.handlers[:]:
            if handler not in before:
                root.removeHandler(handler)
                handler.close()
    if code != 0:
        with open(console_path) as console:
            sys.stderr.write(console.read()[-6000:])
    return code


def _stage_seconds(working_dir):
    """Unrounded stage timings from the run's SVIM_*.log (--profile)."""
    logs = sorted(name for name in os.listdir(working_dir)
                  if name.startswith("SVIM_") and name.endswith(".log"))
    with open(os.path.join(working_dir, logs[-1])) as handle:
        for line in handle:
            if "Stage seconds: " in line:
                return json.loads(line.split("Stage seconds: ", 1)[1])
    raise AssertionError("no stage timings in the log of " + working_dir)


def _calls_per_class(vcf_path):
    counts = {}
    for line in _normalized_vcf(vcf_path):
        if line.startswith("#"):
            continue
        match = re.search(r"SVTYPE=([A-Z:]+)", line)
        sv_type = match.group(1) if match else "?"
        counts[sv_type] = counts.get(sv_type, 0) + 1
    return counts


class LinkageRecorder:
    """Stands in for the plain PyTorch linkage ops in device_cluster while
    the main path runs, and keeps each call's inputs and outputs on the
    host so phase 6 can re-run them on the CPU."""

    def __init__(self):
        from svim_tpu_torch.cluster import device_cluster

        self.module = device_cluster
        self.originals = {name: getattr(device_cluster, name)
                          for name in LINKAGE_OPS}
        self.calls = []

    def _wrap(self, name):
        original = self.originals[name]

        def recorded(*args, **kwargs):
            outputs = original(*args, **kwargs)
            self.calls.append((name, _to_cpu(args), _to_cpu(kwargs),
                               _to_cpu(outputs), _devices(args)))
            return outputs
        return recorded

    def __enter__(self):
        for name in LINKAGE_OPS:
            setattr(self.module, name, self._wrap(name))
        return self

    def __exit__(self, *exc):
        for name, original in self.originals.items():
            setattr(self.module, name, original)


def _to_cpu(value):
    import torch

    if isinstance(value, torch.Tensor):
        return value.cpu()
    if isinstance(value, (tuple, list)):
        return type(value)(_to_cpu(item) for item in value)
    if isinstance(value, dict):
        return {key: _to_cpu(item) for key, item in value.items()}
    return value


def _devices(args):
    import torch

    return {arg.device.type for arg in args if isinstance(arg, torch.Tensor)}


def _telemetry():
    from svim_tpu_torch.cluster import device_cluster

    counts = device_cluster.TELEMETRY.as_dict()
    return {key: counts[key] for key in _NO_TELEMETRY}


KERNEL_MODULES = {"wavefront_banded_distance": "wavefront_kernel",
                  "span_distance_matrix": "distance_kernel"}
# launch counts of every kernel, per path the smoke drives
PATH_LAUNCHES = {}


def _drive(path, arguments):
    """One run of the port's CLI as a path of the smoke: every kernel's
    launch count is set to 0 just before it and read just after (into
    PATH_LAUNCHES[path]).  Returns the wavefront kernel's count."""
    import importlib

    modules = {name: importlib.import_module("svim_tpu_torch.ops." + module)
               for name, module in KERNEL_MODULES.items()}
    for module in modules.values():
        module.LAUNCHES = 0
    code = _run_port(arguments)
    PATH_LAUNCHES[path] = {name: module.LAUNCHES
                           for name, module in modules.items()}
    if code != 0:
        raise RuntimeError("{0} exited with {1}".format(path, code))
    return PATH_LAUNCHES[path]["wavefront_banded_distance"]


def _vcf_sha256(working_dir):
    return hashlib.sha256("".join(_normalized_vcf(os.path.join(
        working_dir, "variants.vcf"))).encode()).hexdigest()


def phase_golden():
    """Returns the golden workload's (bam, genome)."""
    from svim_tpu_torch import workloads

    directory = os.path.join(SCRATCH, "golden")
    os.makedirs(directory, exist_ok=True)
    bam, genome = workloads.golden_workload(directory)
    working_dir = os.path.join(directory, "wd")
    launches = _drive("golden", ["alignment", working_dir, bam, genome,
                                 "--edit_backend", "wavefront"])
    if _normalized_vcf(os.path.join(working_dir, "variants.vcf")) \
            != _normalized_vcf(GOLDEN):
        raise AssertionError("golden slice: variants.vcf differs from "
                             "tests/golden/variants.golden.vcf")
    if launches <= 0:
        raise AssertionError("golden slice launched no wavefront kernel")
    telemetry = _telemetry()
    if telemetry != GOLDEN_TELEMETRY:
        raise AssertionError("golden slice telemetry {0} != svim_tpu's {1}"
                             .format(telemetry, GOLDEN_TELEMETRY))
    log("golden", "variants.vcf byte-equal to the golden fixture; telemetry "
        "{0} equals svim_tpu's; wavefront kernel launches {1}".format(
            json.dumps(telemetry), launches))
    return bam, genome


def phase_bench(card, recorder):
    """Returns the bench workload's (bam, genome)."""
    from svim_tpu_torch import workloads

    directory = os.path.join(SCRATCH, "bench{0}".format(BENCH_READS))
    bam = os.path.join(directory, "bench.bam")
    genome = os.path.join(directory, "genome.fa")
    if not (os.path.exists(bam) and os.path.exists(genome)):
        os.makedirs(directory, exist_ok=True)
        started = time.perf_counter()
        workloads.bench_workload(directory, BENCH_READS)
        log("bench", "made the {0}-read workload in {1:.1f}s ({2} bytes)"
            .format(BENCH_READS, time.perf_counter() - started,
                    os.path.getsize(bam)))
    results = {}
    for backend in ("wavefront", "auto"):
        working_dir = os.path.join(directory, "wd_" + backend)
        # the timed run goes through the ops themselves; the recorded
        # run that follows feeds phase 6
        started = time.perf_counter()
        launches = _drive("bench_" + backend,
                          ["alignment", working_dir, bam, genome,
                           "--edit_backend", backend, "--profile"])
        wall = time.perf_counter() - started
        seconds = _stage_seconds(working_dir)
        rate = BENCH_READS / (seconds["collect"] + seconds["cluster"])
        telemetry = _telemetry()
        calls = _calls_per_class(os.path.join(working_dir, "variants.vcf"))
        results[backend] = (working_dir, launches)
        log("bench", "{0}: wall {1:.2f}s; stages {2}; calls {3}; telemetry "
            "{4}; wavefront launches {5}; {6:.1f} reads/s through "
            "COLLECT+CLUSTER on {7}".format(
                backend, wall, json.dumps(seconds), json.dumps(calls),
                json.dumps(telemetry), launches, rate, card))
        if telemetry != BENCH_TELEMETRY[backend]:
            raise AssertionError("bench slice ({0}) telemetry {1} != "
                                 "svim_tpu's {2}".format(
                                     backend, telemetry,
                                     BENCH_TELEMETRY[backend]))
    if results["wavefront"][1] <= 0:
        raise AssertionError("bench slice launched no wavefront kernel")
    if _normalized_vcf(os.path.join(results["wavefront"][0], "variants.vcf")) \
            != _normalized_vcf(os.path.join(results["auto"][0],
                                            "variants.vcf")):
        raise AssertionError("bench slice: wavefront and auto variants.vcf "
                             "differ")
    digest = _vcf_sha256(results["wavefront"][0])
    if digest != BENCH_VCF_SHA256:
        raise AssertionError("bench slice: variants.vcf (sha256 {0}) differs "
                             "from svim_tpu's".format(digest))
    log("bench", "wavefront and auto variants.vcf are byte-equal, and equal "
        "to svim_tpu's (sha256)")
    with recorder:
        code = _run_port(["alignment", os.path.join(directory, "wd_recorded"),
                          bam, genome, "--edit_backend", "wavefront"])
    if code != 0:
        raise RuntimeError("recorded bench slice exited with {0}".format(code))
    return bam, genome


def _same_linkage(got, want, where):
    """Agglomeration outputs from the card (`got`) against the CPU's:
    the flag outputs and min_gap on every row; merges and heights on the
    rows the float32 guard accepts (min_gap >= TIE_EPS), the only rows a
    labeling is built from.  Returns those rows and the largest height
    difference on them."""
    import torch

    from svim_tpu_torch.ops.linkage_kernel import TIE_EPS

    for index in range(3, len(want)):
        torch.testing.assert_close(got[index], want[index], rtol=1e-6, atol=0,
                                   msg=lambda m: "{0}, output {1}: {2}".format(
                                       where, index, m))
    accepted = want[3] >= TIE_EPS
    for index in range(2):
        if not torch.equal(got[index][accepted], want[index][accepted]):
            raise AssertionError("{0}: merges differ on accepted rows".format(
                where))
    torch.testing.assert_close(got[2][accepted], want[2][accepted],
                               rtol=1e-6, atol=0, msg=lambda m: "{0}, "
                               "heights: {1}".format(where, m))
    error = float((got[2][accepted].double()
                   - want[2][accepted].double()).abs().max()) \
        if bool(accepted.any()) else 0.0
    return accepted, error


def _synthetic_linkage(rng, device):
    """Seeded tie-free partitions through the three ops on `device`:
    yields (name, args, kwargs) with numpy-made inputs as tensors."""
    import numpy as np
    import torch

    def put(values):
        return torch.from_numpy(np.ascontiguousarray(values)).to(device)

    for pad, most in ((32, 16), (128, 128)):
        batch = 64
        counts = rng.integers(3, most + 1, size=batch)
        valid = np.arange(pad)[None, :] < counts[:, None]
        points = rng.random((batch, pad, pad), dtype=np.float32)
        matrices = np.triu(points, 1) + np.triu(points, 1).transpose(0, 2, 1)
        yield "agglomerate_batched", (put(matrices), put(valid)), {}

        starts = rng.integers(0, 1_000_000, size=(batch, pad)).astype(np.int32)
        ends = starts + rng.integers(50, 5000, size=(batch, pad)).astype(
            np.int32)
        dest = rng.integers(0, 1_000_000, size=(batch, pad)).astype(np.int32)
        reads = rng.integers(0, pad, size=(batch, pad)).astype(np.int32)
        wall = rng.random(batch) < 0.5
        kind = rng.integers(0, 3, size=batch).astype(np.int32)
        yield "span_position_agglomerate_batched", (
            put(starts), put(ends), put(reads), put(valid), 900.0, 0.5,
            put(wall)), {"dest": put(dest), "kind": put(kind)}

        pairs = 4 * batch
        part = rng.integers(0, batch, size=pairs)
        first = rng.integers(0, counts[part])
        second = (first + 1 + rng.integers(0, counts[part] - 1)) % counts[part]
        # each unordered pair once, as the host enumerates them: a repeated
        # pair would be two writes of one cell, in no defined order
        _, unique = np.unique((part * pad + np.minimum(first, second)) * pad
                              + np.maximum(first, second), return_index=True)
        part, first, second = part[unique], first[unique], second[unique]
        pairs = len(unique)
        yield "ins_matrices_from_pairs", (
            put(starts), put(ends - starts), put(part.astype(np.int32)),
            put(first.astype(np.int32)), put(second.astype(np.int32)),
            put(rng.integers(0, 400, size=pairs).astype(np.int32)), 900.0,
            1.0), {}


def _host_labels(matrix, count, threshold):
    """Exact float64 average linkage cut at `threshold` (scipy's rules)."""
    import numpy as np

    from svim_tpu_torch.cluster import device_cluster

    condensed = matrix[:count, :count][np.triu_indices(count, 1)].astype(
        np.float64)
    return device_cluster.fcluster_distance(
        device_cluster.average_linkage(condensed), threshold)


def phase_linkage(recorder):
    import numpy as np
    import torch

    from svim_tpu_torch.cluster import device_cluster
    from svim_tpu_torch.ops import linkage_kernel

    if not recorder.calls:
        raise AssertionError("the main path made no linkage op call")
    seen = set()
    max_error = 0.0
    for number, (name, args, kwargs, got, devices) in enumerate(
            recorder.calls):
        if devices != {"cuda"}:
            raise AssertionError("{0} ran on {1}, not the card".format(
                name, sorted(devices)))
        want = getattr(linkage_kernel, name)(*args, **kwargs)
        where = "main-path call {0} of {1}".format(number, name)
        if name == "ins_matrices_from_pairs":
            torch.testing.assert_close(got, want, rtol=1e-6, atol=0,
                                       msg=lambda m: where + ": " + m)
        else:
            max_error = max(max_error, _same_linkage(got, want, where)[1])
        seen.add(name)
    # partitions resolved on the host at dispatch (telemetry pre_*) never
    # reach an op: on these workloads no fused-route partition does
    log("linkage", "{0} main-path calls ({1}) agree with the CPU; not "
        "called: {2}".format(len(recorder.calls), ", ".join(sorted(seen)),
                             ", ".join(sorted(set(LINKAGE_OPS) - seen))
                             or "none"))

    rng = np.random.default_rng(20261017)
    threshold = 0.5
    accepted_rows = 0
    for name, args, kwargs in _synthetic_linkage(rng, torch.device("cuda")):
        op = getattr(linkage_kernel, name)
        got = _to_cpu(op(*args, **kwargs))
        args, kwargs = _to_cpu(args), _to_cpu(kwargs)
        want = op(*args, **kwargs)
        where = "synthetic {0}, P={1}".format(name, args[0].shape[1])
        if name == "ins_matrices_from_pairs":
            torch.testing.assert_close(got, want, rtol=1e-6, atol=0,
                                       msg=lambda m: where + ": " + m)
            continue
        accepted, error = _same_linkage(got, want, where)
        max_error = max(max_error, error)
        if name != "agglomerate_batched":
            continue
        matrices, valid = args[0].numpy(), args[1].numpy()
        for row in np.flatnonzero(accepted.numpy()):
            count = int(valid[row].sum())
            labels = device_cluster.labels_from_merges(
                got[0][row].numpy(), got[1][row].numpy(),
                got[2][row].numpy(), count, threshold)
            if labels is None:
                continue
            expected = _host_labels(matrices[row], count, threshold)
            if not np.array_equal(labels, expected):
                raise AssertionError("{0}, row {1}: card labels differ from "
                                     "exact host linkage".format(where, row))
            accepted_rows += 1
    if accepted_rows == 0:
        raise AssertionError("no synthetic partition's card labeling passed "
                             "the float32 guard")
    log("linkage", "synthetic partitions agree with the CPU; {0} labelings "
        "from the card's merges pass the float32 guard and equal exact "
        "float64 host linkage; max height difference {1!r}".format(
            accepted_rows, max_error))


def _distance_inputs(rng, batch, pad):
    """Seeded (B, P) partitions: negative starts, zero and negative spans,
    repeated read ids, a ragged number of valid slots per partition."""
    import numpy as np

    starts = rng.integers(-5_000, 2_000_000, size=(batch, pad)).astype(
        np.int32)
    ends = (starts + rng.integers(-50, 5_000, size=(batch, pad))).astype(
        np.int32)
    ends[:, ::7] = starts[:, ::7]
    reads = rng.integers(0, max(2, pad // 3), size=(batch, pad)).astype(
        np.int32)
    counts = rng.integers(1, pad + 1, size=batch)
    valid = np.arange(pad)[None, :] < counts[:, None]
    return starts, ends, reads, valid


def _parallel_case():
    """The inputs of tests/test_parallel.py's Pallas check: read ids % 60,
    the tail of partition 0 invalid."""
    import numpy as np

    rng = np.random.default_rng(11)
    starts = rng.integers(1000, 2000, size=(3, 128)).astype(np.int32)
    ends = starts + rng.integers(50, 500, size=(3, 128)).astype(np.int32)
    reads = np.tile(np.arange(128, dtype=np.int32) % 60, (3, 1))
    valid = np.ones((3, 128), bool)
    valid[0, 100:] = False
    return starts, ends, reads, valid


def phase_distance():
    """Phase 7: the distance kernel against its plain version, bit for bit.
    Returns {(B, P, wall): (kernel ms, plain ms)} and the max abs error."""
    import numpy as np
    import torch

    from svim_tpu_torch.ops import distance_kernel as dk

    rng = np.random.default_rng(20261018)
    cases = [((batch, pad), _distance_inputs(rng, batch, pad))
             for pad in (32, 128) for batch in (8, 1024, 8192)]
    cases.append(((3, 128), _parallel_case()))
    timings = {}
    max_abs_err = 0.0
    for (batch, pad), arrays in cases:
        tensors = [torch.from_numpy(x).cuda() for x in arrays]
        for wall in (True, False):
            plain_ms, plain = _time_ms(
                lambda: dk.span_position_matrix_torch(*tensors, 900.0,
                                                      wall_same_read=wall), 5)
            kernel_ms, kernel = _time_ms(
                lambda: dk.span_position_matrix_cuda(*tensors, 900.0,
                                                     wall_same_read=wall), 20)
            differ = int((plain.view(torch.int32)
                          != kernel.view(torch.int32)).sum())
            if differ:
                raise AssertionError("distance kernel != plain at B={0} P={1}"
                                     " wall={2}: {3} entries differ".format(
                                         batch, pad, wall, differ))
            max_abs_err = max(max_abs_err,
                              float((plain - kernel).abs().max()))
            timings[(batch, pad, wall)] = (kernel_ms, plain_ms)
            log("distance", "B={0} P={1} wall={2}: bit-equal ({3} entries "
                "below BIG); kernel {4:.4f} ms, plain {5:.4f} ms".format(
                    batch, pad, wall, int((kernel < dk.BIG).sum()), kernel_ms,
                    plain_ms))
    return timings, max_abs_err


def phase_streaming(card, bench_bam, genome, golden_bam, golden_genome):
    """Phase 8: the level-0 bench BAM through streaming COLLECT, and the
    golden workload under --stream_input."""
    from svim_tpu_torch import workloads
    from svim_tpu_torch.collect.packed import STREAMING_THRESHOLD_BYTES
    from svim_tpu_torch.io import bamstream

    directory = os.path.dirname(bench_bam)
    stored = os.path.join(directory, "bench_stored.bam")
    started = time.perf_counter()
    workloads.reblock_stored(bench_bam, stored)
    size = os.path.getsize(stored)
    log("stream", "rewrote the bench BAM as level-0 BGZF in {0:.1f}s ({1} "
        "bytes)".format(time.perf_counter() - started, size))
    if size <= STREAMING_THRESHOLD_BYTES:
        raise AssertionError("the level-0 bench BAM is not over the "
                             "streaming threshold")
    working_dir = os.path.join(directory, "wd_stream")
    bamstream.BATCHES = 0
    started = time.perf_counter()
    launches = _drive("stream_bench", ["alignment", working_dir, stored,
                                       genome, "--edit_backend", "wavefront",
                                       "--profile"])
    wall = time.perf_counter() - started
    batches = bamstream.BATCHES
    seconds = _stage_seconds(working_dir)
    telemetry = _telemetry()
    log("stream", "level-0 bench BAM: {0} streamed batches; wall {1:.2f}s; "
        "stages {2}; telemetry {3}; wavefront launches {4}; {5:.1f} reads/s "
        "through COLLECT+CLUSTER on {6}".format(
            batches, wall, json.dumps(seconds), json.dumps(telemetry),
            launches, BENCH_READS / (seconds["collect"] + seconds["cluster"]),
            card))
    if batches <= 0:
        raise AssertionError("the level-0 bench BAM did not stream")
    if launches <= 0:
        raise AssertionError("the streaming slice launched no wavefront "
                             "kernel")
    if telemetry != BENCH_TELEMETRY["wavefront"]:
        raise AssertionError("streaming slice telemetry {0} != svim_tpu's "
                             "{1}".format(telemetry,
                                          BENCH_TELEMETRY["wavefront"]))
    digest = _vcf_sha256(working_dir)
    if digest != BENCH_VCF_SHA256:
        raise AssertionError("streaming slice: variants.vcf (sha256 {0}) "
                             "differs from svim_tpu's".format(digest))

    working_dir = os.path.join(os.path.dirname(golden_bam), "wd_stream")
    bamstream.BATCHES = 0
    launches = _drive("stream_golden", ["alignment", working_dir, golden_bam,
                                        golden_genome, "--stream_input",
                                        "--batch_reads", "64",
                                        "--edit_backend", "wavefront"])
    if bamstream.BATCHES <= 1 or launches <= 0:
        raise AssertionError("golden --stream_input: {0} batches, {1} "
                             "wavefront launches".format(bamstream.BATCHES,
                                                         launches))
    if _normalized_vcf(os.path.join(working_dir, "variants.vcf")) \
            != _normalized_vcf(GOLDEN):
        raise AssertionError("golden --stream_input: variants.vcf differs "
                             "from tests/golden/variants.golden.vcf")
    log("stream", "VCF hashes to svim_tpu's; golden --stream_input "
        "(--batch_reads 64, {0} batches) writes the golden VCF".format(
            bamstream.BATCHES))


def phase_inputs(golden_bam, golden_genome):
    """Phase 9: the golden workload as SAM text and as a queryname-sorted
    BAM."""
    from svim_tpu_torch import workloads

    directory = os.path.dirname(golden_bam)
    for path, writer, name, expected in (
            ("sam_text", workloads.sam_text, "reads.sam", SAM_VCF_SHA256),
            ("queryname", workloads.queryname_bam, "reads.qname.bam",
             QUERYNAME_VCF_SHA256)):
        source = writer(golden_bam, os.path.join(directory, name))
        working_dir = os.path.join(directory, "wd_" + path)
        launches = _drive(path, ["alignment", working_dir, source,
                                 golden_genome, "--edit_backend",
                                 "wavefront"])
        digest = _vcf_sha256(working_dir)
        if digest != expected:
            raise AssertionError("{0}: variants.vcf (sha256 {1}) differs from "
                                 "svim_tpu's".format(path, digest))
        if launches <= 0:
            raise AssertionError("{0} launched no wavefront kernel".format(
                path))
        log("inputs", "{0}: variants.vcf hashes to svim_tpu's; wavefront "
            "launches {1}".format(path, launches))


def main():
    sys.path.insert(0, ROOT)
    card = phase_environment()
    phase_build()
    timings, max_abs_err = phase_kernels(kernel_shapes())
    recorder = LinkageRecorder()
    with recorder:
        golden_bam, golden_genome = phase_golden()
    bench_bam, bench_genome = phase_bench(card, recorder)
    phase_linkage(recorder)
    distance_timings, distance_err = phase_distance()
    phase_streaming(card, bench_bam, bench_genome, golden_bam, golden_genome)
    phase_inputs(golden_bam, golden_genome)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    log("paths", "kernel launches per path: {0}".format(
        json.dumps(PATH_LAUNCHES)))

    import torch

    def by_path(name):
        return {path: counts[name] for path, counts in PATH_LAUNCHES.items()}

    kernel_ms, plain_ms = timings[MAIN_SHAPE]
    distance_ms, distance_plain_ms = distance_timings[
        DISTANCE_MAIN_SHAPE + (True,)]
    print(json.dumps({"kernels": [{
        "name": "wavefront_banded_distance", "route": "cuda",
        "source": "svim_tpu_torch/csrc/wavefront.cu",
        "replaces": "svim_tpu/ops/wavefront_kernel.py:123",
        "launches": PATH_LAUNCHES["bench_wavefront"][
            "wavefront_banded_distance"],
        "launches_by_path": by_path("wavefront_banded_distance"),
        "max_abs_err": max_abs_err, "ms": kernel_ms, "plain_ms": plain_ms,
        "shape": "B={0},L={1},W={2}".format(*MAIN_SHAPE)}, {
        "name": "span_distance_matrix", "route": "cuda",
        "source": "svim_tpu_torch/csrc/span_distance.cu",
        "replaces": "svim_tpu/ops/distance_kernel.py:52",
        "launches": PATH_LAUNCHES["bench_wavefront"]["span_distance_matrix"],
        "launches_by_path": by_path("span_distance_matrix"),
        "on_main_path": False,
        "max_abs_err": distance_err, "ms": distance_ms,
        "plain_ms": distance_plain_ms,
        "shape": "B={0},P={1},wall".format(*DISTANCE_MAIN_SHAPE)}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
