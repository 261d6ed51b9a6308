#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (svim_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:
  1. environment: a CUDA device is required; prints the card's name and
     power limit (nvidia-smi) and the torch / CUDA versions;
  2. build: compiles csrc/wavefront.cu with nvcc into svim_tpu_torch/_build,
     and svim_tpu's native host library (scan session, POA) with g++;
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
     merges must equal exact float64 host linkage.
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
    from svim_tpu_torch.ops import _build, wavefront_kernel

    started = time.perf_counter()
    wavefront_kernel._kernel_library()
    log("build", "wavefront.cu built and loaded in {0:.2f}s (nvcc {1:.2f}s)"
        .format(time.perf_counter() - started,
                _build.BUILD_SECONDS.get("wavefront", 0.0)))
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


def phase_golden():
    from svim_tpu_torch import workloads
    from svim_tpu_torch.ops import wavefront_kernel

    directory = os.path.join(SCRATCH, "golden")
    os.makedirs(directory, exist_ok=True)
    bam, genome = workloads.golden_workload(directory)
    working_dir = os.path.join(directory, "wd")
    wavefront_kernel.LAUNCHES = 0
    code = _run_port(["alignment", working_dir, bam, genome,
                      "--edit_backend", "wavefront"])
    launches = wavefront_kernel.LAUNCHES
    if code != 0:
        raise RuntimeError("golden slice exited with {0}".format(code))
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


def phase_bench(card, recorder):
    from svim_tpu_torch import workloads
    from svim_tpu_torch.ops import wavefront_kernel

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
        wavefront_kernel.LAUNCHES = 0
        started = time.perf_counter()
        code = _run_port(["alignment", working_dir, bam, genome,
                          "--edit_backend", backend, "--profile"])
        wall = time.perf_counter() - started
        launches = wavefront_kernel.LAUNCHES
        if code != 0:
            raise RuntimeError("bench slice ({0}) exited with {1}".format(
                backend, code))
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
    digest = hashlib.sha256("".join(_normalized_vcf(os.path.join(
        results["wavefront"][0], "variants.vcf"))).encode()).hexdigest()
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
    return results["wavefront"][1]


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


def main():
    sys.path.insert(0, ROOT)
    card = phase_environment()
    phase_build()
    timings, max_abs_err = phase_kernels(kernel_shapes())
    recorder = LinkageRecorder()
    with recorder:
        phase_golden()
    launches = phase_bench(card, recorder)
    phase_linkage(recorder)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")

    import torch

    kernel_ms, plain_ms = timings[MAIN_SHAPE]
    print(json.dumps({"kernels": [{
        "name": "wavefront_banded_distance", "route": "cuda",
        "source": "svim_tpu_torch/csrc/wavefront.cu",
        "replaces": "svim_tpu/ops/wavefront_kernel.py:123",
        "launches": launches, "max_abs_err": max_abs_err,
        "ms": kernel_ms, "plain_ms": plain_ms,
        "shape": "B={0},L={1},W={2}".format(*MAIN_SHAPE)}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
