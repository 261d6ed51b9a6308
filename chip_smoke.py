#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (svim_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (non-zero exit) on failure:
  1. environment: a CUDA device is required; prints the card's name and
     power limit (nvidia-smi) and the torch / CUDA versions;
  2. build: compiles csrc/wavefront.cu and csrc/span_distance.cu with nvcc
     (both at once) and, beside them, the port's native host library
     (svim_tpu_torch/native: scan session, POA) with g++, all into
     svim_tpu_torch/_build;
  3. kernel vs plain version on the card: banded_distance_cuda against
     banded_distance_torch on seeded inputs (half near-identical pairs, half
     random) at the main path's shapes and at one case per code path of the
     kernel (warp kernel with a ragged last CTA, CTA kernel with staged and
     unstaged strings, fronts in global scratch, narrow passes that resolve
     and that run on to W, empty and one-character strings); outputs must be
     exactly equal, above the band too, and 64 resolved entries must equal
     the O(nm) dynamic program below;
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
     plus the case of tests/test_parallel.py, P = 64 and 256, P not a
     multiple of 4, B = 1, more partitions than the card holds CTAs, P too
     large to stage in shared memory, each forced path of the kernel once
     and norms in, on the edges of and outside the range of its written-out
     division (distance_cases); outputs must be bit-equal; prints kernel and plain ms per shape (no entry point calls this
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
     (SAM_VCF_SHA256, QUERYNAME_VCF_SHA256) and launch the wavefront kernel;
 10. the default main path, mid-scan incremental clustering
     (--incremental_cluster auto, which phases 4, 5, 8 and 9 switch off
     because their pinned telemetry and launch counts were measured so):
     the bench BAM one-shot with --batch_reads 512 and both edit backends,
     once with the scan delivered in chunks of 512 rows (partitions must be
     reused from the mid-scan memo) and once as the scan comes (reuse is
     whatever the walker's lead allows), and the golden workload in chunks
     of 64; every VCF must hash to the pinned one; prints COLLECT and
     CLUSTER seconds beside phase 5's `off` runs;
 11. the other flags on the golden workload: --device_backend host must
     write the golden VCF with no kernel launch; --profile_trace (with
     --edit_backend wavefront) must write the golden VCF and Chrome traces
     under traces/ whose CLUSTER trace names the wavefront kernel.
 12. `reads` mode: stub ngmlr, minimap2, samtools and gunzip executables on
     PATH (svim_tpu_torch.workloads.stub_aligners; the aligner "produces"
     the golden records as SAM text, the samtools stub sorts them into a
     BGZF BAM with the port's io layer) and `reads <wd> <fastq> <genome>
     --edit_backend wavefront`: the golden VCF, as many wavefront launches
     as phase 4, and a second run that re-uses the cached BAM without a new
     stub call;
 13. --distributed: the bench workload with `--distributed --edit_backend
     wavefront --profile` as 2 and as 3 rank subprocesses sharing the one
     card (3 leaves uneven ranges), and the golden workload as 2; every rank
     must exit 0, name a CUDA device in its log, launch the wavefront
     kernel and hold neither jax nor svim_tpu in its interpreter; rank 0's
     variants.vcf must hash to the pinned one and the ranks' eligible
     partition counts must sum to the single-process count; prints each
     rank's stage seconds and exchange bytes beside phase 5's
     single-process seconds (ranks that share a card and its host's cores:
     a correctness run, no scaling figure);
 14. --num_shards: the bench workload with `--num_shards 8 --edit_backend
     wavefront`: pinned VCF, "8 shards over 1 device(s)" in the log; every
     COLLECT scan and GENOTYPE join the run made is re-run unsharded on its
     recorded inputs and must be equal, as must the two agglomeration ops on
     seeded partitions cut into 8; entry.entry() and
     entry.dryrun_multichip(8) run on the card.
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
# clustering off, as the phases that pin them run the port: partitions
# reused from the mid-scan memo are not counted, and how many are depends on
# the scan's timing; tests/test_torch_pipeline.py checks the golden ones).  On both workloads every partition has exact float64 ties
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
    import threading

    from svim_tpu_torch import native
    from svim_tpu_torch.ops import _build, distance_kernel, wavefront_kernel

    started = time.perf_counter()
    host = {}

    def build_host():
        try:
            native.get_library()
        except BaseException as error:  # re-raised on the main thread below
            host["error"] = error
        host["seconds"] = time.perf_counter() - started

    # g++ compiles the host library while the two nvcc processes run
    thread = threading.Thread(target=build_host)
    thread.start()
    try:
        _build.build(("wavefront", "span_distance"))
        wavefront_kernel._kernel_library()
        distance_kernel._kernel_library()
        log("build", "wavefront.cu and span_distance.cu built (in parallel) "
            "and loaded in {0:.2f}s (nvcc {1}); DPX add-min: {2}".format(
                time.perf_counter() - started,
                json.dumps({name: round(seconds, 2) for name, seconds
                            in _build.BUILD_SECONDS.items()}),
                wavefront_kernel.uses_dpx()))
    finally:
        thread.join()
    if "error" in host:
        raise host["error"]
    for directory in (os.path.dirname(native.library_path()),
                      _build.BUILD_DIR):
        if os.path.dirname(directory) != os.path.join(ROOT, "svim_tpu_torch"):
            raise AssertionError("built outside svim_tpu_torch/_build: "
                                 + directory)
    log("build", "native host library (svim_tpu_torch/native, g++) ready "
        "after {0:.2f}s".format(host["seconds"]))


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
    """(B, L, W, variant): the main path's lengths and pow4 bands at a small
    and a full batch, the full launches of the 8192-read workload, and
    W=4096 and W=16384 (one CTA per pair, fronts in shared memory), each on
    the code path the wrapper picks (variant None); then one case per code
    path of the kernel: the warp kernel with a ragged last CTA (B not a
    multiple of the 4 pairs a CTA) at a narrow and at the widest band, and
    the CTA kernel forced to each of its three layouts at two shapes."""
    shapes = [(batch, length, band, None) for length in (512, 1024)
              for band in (64, 128, 256, 1024) for batch in (8, 1024)]
    shapes += [(8192, 512, 64, None), (8192, 512, 256, None),
               MAIN_SHAPE + (None,), (8, 8192, 4096, None),
               (8, 16384, 16384, None), (2051, 512, 64, None),
               (2051, 1024, 1024, None), (67, 300, 100, None)]
    shapes += [(batch, length, band, variant)
               for variant in ("cta", "cta_unstaged", "global")
               for batch, length, band in ((64, 512, 256), (16, 1024, 1024))]
    return shapes


# int32 operations of one DP cell (a compare, an add, two min, an add-min)
# and the card's int32 rate: 132 SMs x 64 int32 lanes x 1.98 GHz, half the
# 67 TFLOP/s float32 rate counted as one operation a lane and clock
OPS_PER_CELL = 5
INT32_OPS_PER_SECOND = 132 * 64 * 1.98e9
HBM_BYTES_PER_SECOND = 3.35e12
FLOAT32_FLOPS_PER_SECOND = 67e12


def _band_cells(a_lens, b_lens, widths):
    """Cells 1 <= i <= m, 1 <= j <= n with |i - j| <= w, per pair."""
    import numpy as np

    m = a_lens.astype(np.int64)[:, None]
    n = b_lens.astype(np.int64)[:, None]
    w = widths.astype(np.int64)[:, None]
    i = np.arange(1, int(a_lens.max()) + 1, dtype=np.int64)[None, :]
    per_row = np.minimum(n, i + w) - np.maximum(1, i - w) + 1
    return np.where(i <= m, np.maximum(per_row, 0), 0).sum(axis=1)


def wavefront_bound_ms(a_lens, b_lens, values, length, band):
    """The least time the card could take for one launch on these inputs:
    bytes (both code matrices and length vectors read once, the result
    written once) over the memory rate, or the DP cells this data needs
    times OPS_PER_CELL over the int32 rate.  A pair whose distance k is
    within the band needs the cells |i - j| <= k; any other pair within
    reach of the band needs the whole band; a pair with |m - n| > W none.
    Returns (ms, "bytes" or "operations", cells)."""
    import numpy as np

    widths = np.where(values <= band, values,
                      np.minimum(band, np.maximum(a_lens, b_lens)))
    widths = np.where(np.abs(a_lens.astype(np.int64) - b_lens) > band, -1,
                      widths)
    cells = int(_band_cells(a_lens, b_lens, widths).sum())
    batch = len(a_lens)
    bytes_ms = (2 * batch * length + 12 * batch) / HBM_BYTES_PER_SECOND * 1e3
    ops_ms = cells * OPS_PER_CELL / INT32_OPS_PER_SECOND * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations", cells
    return bytes_ms, "bytes", cells


def phase_kernels(shapes, dp_samples=64):
    import numpy as np
    import torch

    from svim_tpu_torch.ops import wavefront_kernel as wk

    rng = np.random.default_rng(20261016)
    timings = {}
    max_abs_err = 0
    dp_checked = 0
    for batch, length, band, variant in shapes:
        a_codes, a_lens, b_codes, b_lens = _pairs(rng, batch, length)
        if variant is None and batch == 67:
            # empty, one-character and far-apart strings beside the rest
            a_lens[:6] = (0, 0, 1, 1, 2, length)
            b_lens[:6] = (0, 1, 0, 1, 1, 3)
        args = [torch.from_numpy(x).cuda() for x in (a_codes, a_lens,
                                                     b_codes, b_lens)]
        tensors = (args[0], args[1], args[2], args[3], band)
        # one run of the plain version: ~2L dependent steps of small
        # launches, seconds at the widest shapes
        plain_ms, plain = _time_ms(lambda: wk.banded_distance_torch(*tensors),
                                   1, warm_up=False)
        kernel_ms, kernel = _time_ms(
            lambda: wk.banded_distance_cuda(*tensors, variant=variant), 5)
        plain = plain.cpu().numpy()
        kernel = kernel.cpu().numpy()
        max_abs_err = max(max_abs_err, int(np.abs(
            plain.astype(np.int64) - kernel.astype(np.int64)).max()))
        mismatches = int((plain != kernel).sum())
        if mismatches:
            raise AssertionError("kernel != plain at B={0} L={1} W={2} "
                                 "variant={3}: {4} entries differ".format(
                                     batch, length, band, variant,
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
        bound_ms, bound_by, cells = wavefront_bound_ms(a_lens, b_lens, kernel,
                                                       length, band)
        path = variant or wk.kernel_variant(length, band)
        # how the in-kernel narrow passes fared: resolved at band 63 or 255
        # (tried where they are below half the pair's band), or run to W
        reach = np.minimum(band, np.maximum(a_lens, b_lens))
        early = int(((kernel <= 63) & (reach > 126)).sum()
                    + ((kernel > 63) & (kernel <= 255) & (reach > 510)).sum())
        if variant is None:
            timings[(batch, length, band)] = (kernel_ms, plain_ms, bound_ms,
                                              bound_by)
        log("kernel", "B={0} L={1} W={2} path={3}{4}: equal ({5} resolved, "
            "{6} by a narrow pass, {7} run to W); kernel {8:.3f} ms, plain "
            "{9:.3f} ms, bound {10:.4f} ms by {11} ({12} cells)".format(
                batch, length, band, path, " (forced)" if variant else "",
                len(resolved), early, batch - early, kernel_ms, plain_ms,
                bound_ms, bound_by, cells))
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


def _drive(path, arguments, chunk=0):
    """One run of the port's CLI as a path of the smoke: every kernel's
    launch count is set to 0 just before it and read just after (into
    PATH_LAUNCHES[path]).  With `chunk` the one-shot scan is delivered in
    claims of that many rows (workloads.chunked_scan).  Returns the
    wavefront kernel's count."""
    import contextlib
    import importlib

    from svim_tpu_torch import workloads

    modules = {name: importlib.import_module("svim_tpu_torch.ops." + module)
               for name, module in KERNEL_MODULES.items()}
    for module in modules.values():
        module.LAUNCHES = 0
    with workloads.chunked_scan(chunk) if chunk else contextlib.nullcontext():
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
                                 "--edit_backend", "wavefront",
                                 "--incremental_cluster", "off"])
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
    """Returns the bench workload's (bam, genome) and the stage seconds of
    its two runs by edit backend."""
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
    off_seconds = {}
    for backend in ("wavefront", "auto"):
        working_dir = os.path.join(directory, "wd_" + backend)
        # the timed run goes through the ops themselves; the recorded
        # run that follows feeds phase 6
        started = time.perf_counter()
        launches = _drive("bench_" + backend,
                          ["alignment", working_dir, bam, genome,
                           "--edit_backend", backend, "--profile",
                           "--incremental_cluster", "off"])
        wall = time.perf_counter() - started
        seconds = _stage_seconds(working_dir)
        off_seconds[backend] = seconds
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
                          bam, genome, "--edit_backend", "wavefront",
                          "--incremental_cluster", "off"])
    if code != 0:
        raise RuntimeError("recorded bench slice exited with {0}".format(code))
    return bam, genome, off_seconds


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


def _distance_inputs(rng, batch, pad, wide=False):
    """Seeded (B, P) partitions: negative starts, zero and negative spans,
    repeated read ids, a ragged number of valid slots per partition; `wide`
    draws the coordinates from all of int32, so that sums and differences
    wrap and |Δ| reaches 2^31."""
    import numpy as np

    low, high, span = (-2**31, 2**31 - 1, 2**30) if wide \
        else (-5_000, 2_000_000, 5_000)
    starts = rng.integers(low, high, size=(batch, pad)).astype(np.int32)
    ends = (starts + rng.integers(-50, span, size=(batch, pad))).astype(
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


# instructions the card issues for one distance cell: 230 in the inner loop
# of the 16-byte-store kernel for its 8 cells, counted from its SASS by
# scripts/distance_kernel_sass.py (beside the differences, absolute values,
# conversions, maximum, sum, comparisons and selects, each IEEE division is
# a reciprocal estimate and three to five fused multiply-adds), and the
# card's issue rate: one instruction a lane and clock on 132 SMs x 128 lanes
# x 1.98 GHz, which is half its float32 rate (a fused multiply-add counts
# as two operations there)
DISTANCE_OPS_PER_CELL = 29
LANE_INSTRUCTIONS_PER_SECOND = FLOAT32_FLOPS_PER_SECOND / 2


def distance_bound_ms_of(batch, pad):
    """The least time the card could take for one (B, P) call: bytes (three
    int32 and one bool (B, P) inputs read once, the (B, P, P) float32 result
    written once) over the memory rate, or DISTANCE_OPS_PER_CELL
    instructions a cell over the issue rate.  Returns (ms, "bytes" or
    "operations")."""
    bytes_ms = (13 * batch * pad + 4 * batch * pad * pad) \
        / HBM_BYTES_PER_SECOND * 1e3
    ops_ms = DISTANCE_OPS_PER_CELL * batch * pad * pad \
        / LANE_INSTRUCTIONS_PER_SECOND * 1e3
    if ops_ms >= bytes_ms:
        return ops_ms, "operations"
    return bytes_ms, "bytes"


def distance_cases(rng):
    """((B, P), inputs, forced launch options) of phase 7.  The wrapper's own
    choice at P in {32, 128} and B in {8, 1024, 8192} and at the case of
    tests/test_parallel.py; P = 64 and 256; P = 30 and 101 (no 16-byte rows:
    scalar stores); P = 100 (a row group of 32 threads of which 25 hold
    columns); B = 1 and 133 (fewer partitions than CTAs the card holds:
    the rows of a partition cut into bands), B = 300 (bands and several
    work items a CTA) and B = 1057, 2113 and 8192 (several partitions a
    CTA through both staging buffers, a ragged last round); P = 6000 and
    5121 (too large to stage in shared memory); each forced path: scalar
    stores at P = 128 and 32, 16-byte stores asked for; then norms (`norm`,
    else 900) below and above the range [2^-40, 2^40] in which the kernel
    divides by its own written-out sequence, on its edges, next to them,
    negative, 1 and 3, each with every slot valid."""
    import numpy as np

    cases = [((batch, pad), {}) for pad in (32, 128)
             for batch in (8, 1024, 8192)]
    cases += [((batch, pad), {}) for batch, pad in (
        (1, 64), (133, 64), (1, 256), (133, 256), (1, 30), (133, 30),
        (7, 101), (9, 100), (1, 128), (133, 128), (1057, 128), (1, 32),
        (2, 600), (1057, 30), (2113, 64), (1, 6000), (2, 5121),
        (300, 256), (300, 30))]
    cases += [((64, 128), {"variant": "scalar"}),
              ((64, 32), {"variant": "scalar"}),
              ((64, 64), {"variant": "vector"}),
              ((64, 128), {"norm": 1e-13}), ((64, 30), {"norm": 1e13}),
              (DISTANCE_MAIN_SHAPE, {"variant": "scalar"})]
    built = [(shape, _distance_inputs(rng, *shape), forced)
             for shape, forced in cases]
    low, high = np.float32(2.0 ** -40), np.float32(2.0 ** 40)
    norms = [1.0, 3.0, -900.0, float(low), float(high), -float(low),
             -float(high)]
    norms += [float(np.nextafter(edge, toward)) for edge, toward in (
        (low, np.float32(0)), (low, np.float32(1)), (high, np.float32(1)),
        (high, np.float32(np.inf)))]
    for index, norm in enumerate(norms):
        shape = ((64, 128), (64, 30))[index % 2]
        starts, ends, reads, valid = _distance_inputs(rng, *shape,
                                                      wide=True)
        built.append((shape, (starts, ends, reads, np.ones_like(valid)),
                      {"norm": norm, "every_slot": "valid"}))
    # the timed shape once more with every slot valid: the other inputs
    # have a ragged number of valid slots, and an invalid row is stored
    # without being computed
    starts, ends, reads, valid = _distance_inputs(rng, *DISTANCE_MAIN_SHAPE)
    built.append((DISTANCE_MAIN_SHAPE, (starts, ends, reads,
                                        np.ones_like(valid)),
                  {"every_slot": "valid"}))
    built.insert(6, ((3, 128), _parallel_case(), {}))
    return built


def phase_distance():
    """Phase 7: the distance kernel against its plain version, bit for
    bit.  Returns
    {(B, P, wall): (kernel ms, plain ms)} of the unforced cases and the max
    abs error."""
    import numpy as np
    import torch

    from svim_tpu_torch.ops import distance_kernel as dk

    rng = np.random.default_rng(20261018)
    timings = {}
    max_abs_err = 0.0
    for (batch, pad), arrays, forced in distance_cases(rng):
        tensors = [torch.from_numpy(x).cuda() for x in arrays]
        options = dict(forced)
        norm = options.pop("norm", 900.0)
        options.pop("every_slot", None)
        for wall in (True, False):
            plain_ms, plain = _time_ms(
                lambda: dk.span_position_matrix_torch(*tensors, norm,
                                                      wall_same_read=wall), 5)
            kernel_ms, kernel = _time_ms(
                lambda: dk.span_position_matrix_cuda(
                    *tensors, norm, wall_same_read=wall, **options), 20)
            differ = int((plain.view(torch.int32)
                          != kernel.view(torch.int32)).sum())
            if differ:
                raise AssertionError("distance kernel != plain at B={0} P={1}"
                                     " wall={2} {3}: {4} entries differ"
                                     .format(batch, pad, wall, forced,
                                             differ))
            max_abs_err = max(max_abs_err,
                              float((plain - kernel).abs().max()))
            if not forced:
                timings[(batch, pad, wall)] = (kernel_ms, plain_ms)
            log("distance", "B={0} P={1} wall={2}{3}: bit-equal ({4} entries "
                "below BIG); kernel {5:.4f} ms, plain {6:.4f} ms".format(
                    batch, pad, wall,
                    " forced " + json.dumps(forced) if forced else "",
                    int((kernel < dk.BIG).sum()), kernel_ms, plain_ms))
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
                                       "--profile", "--incremental_cluster",
                                       "off"])
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
                                        "--edit_backend", "wavefront",
                                        "--incremental_cluster", "off"])
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
                                 "wavefront", "--incremental_cluster",
                                 "off"])
        digest = _vcf_sha256(working_dir)
        if digest != expected:
            raise AssertionError("{0}: variants.vcf (sha256 {1}) differs from "
                                 "svim_tpu's".format(path, digest))
        if launches <= 0:
            raise AssertionError("{0} launched no wavefront kernel".format(
                path))
        log("inputs", "{0}: variants.vcf hashes to svim_tpu's; wavefront "
            "launches {1}".format(path, launches))


def _reused(working_dir):
    """(partitions reused at CLUSTER, partitions clustered mid-scan) from
    the run's SVIM_*.log; (0, 0) when the run logged no reuse."""
    logs = sorted(name for name in os.listdir(working_dir)
                  if name.startswith("SVIM_") and name.endswith(".log"))
    with open(os.path.join(working_dir, logs[-1])) as handle:
        for line in handle:
            if "Incremental clustering: " in line:
                words = line.split("Incremental clustering: ", 1)[1].split()
                return int(words[0]), int(words[2])
    return 0, 0


def phase_default_path(card, bench_bam, genome, off_seconds, golden_bam,
                       golden_genome):
    """Phase 10: --incremental_cluster auto (the default) on the bench and
    golden workloads."""
    directory = os.path.dirname(bench_bam)
    for backend in ("wavefront", "auto"):
        for chunk in (512, 0):
            path = "incremental_{0}{1}".format(backend,
                                               "_chunked" if chunk else "")
            working_dir = os.path.join(directory, "wd_" + path)
            launches = _drive(path, ["alignment", working_dir, bench_bam,
                                     genome, "--edit_backend", backend,
                                     "--profile", "--incremental_cluster",
                                     "auto", "--batch_reads", "512"],
                              chunk=chunk)
            seconds = _stage_seconds(working_dir)
            reused, memoized = _reused(working_dir)
            digest = _vcf_sha256(working_dir)
            log("default", "bench {0}, --incremental_cluster auto "
                "--batch_reads 512, {1}: {2} of {3} mid-scan partitions "
                "reused; collect {4!r} s, cluster {5!r} s (off: {6!r}, {7!r});"
                " wavefront launches {8}; {9:.1f} reads/s through "
                "COLLECT+CLUSTER on {10}".format(
                    backend,
                    "scan in chunks of 512" if chunk else "scan as it comes",
                    reused, memoized, seconds["collect"], seconds["cluster"],
                    off_seconds[backend]["collect"],
                    off_seconds[backend]["cluster"], launches,
                    BENCH_READS / (seconds["collect"] + seconds["cluster"]),
                    card))
            if digest != BENCH_VCF_SHA256:
                raise AssertionError("{0}: variants.vcf (sha256 {1}) differs "
                                     "from svim_tpu's".format(path, digest))
            if chunk and reused <= 0:
                raise AssertionError("{0}: no mid-scan partition was reused"
                                     .format(path))
            if backend == "wavefront" and launches <= 0:
                raise AssertionError("{0} launched no wavefront kernel"
                                     .format(path))
    working_dir = os.path.join(os.path.dirname(golden_bam), "wd_incremental")
    launches = _drive("incremental_golden",
                      ["alignment", working_dir, golden_bam, golden_genome,
                       "--edit_backend", "wavefront", "--batch_reads", "64"],
                      chunk=64)
    reused, memoized = _reused(working_dir)
    if _normalized_vcf(os.path.join(working_dir, "variants.vcf")) \
            != _normalized_vcf(GOLDEN):
        raise AssertionError("golden, incremental: variants.vcf differs from "
                             "tests/golden/variants.golden.vcf")
    if reused <= 0 or launches <= 0:
        raise AssertionError("golden, incremental: {0} partitions reused, {1}"
                             " wavefront launches".format(reused, launches))
    log("default", "golden, default --incremental_cluster, scan in chunks of "
        "64: golden VCF; {0} of {1} mid-scan partitions reused; wavefront "
        "launches {2}".format(reused, memoized, launches))


def phase_flags(golden_bam, golden_genome):
    """Phase 11: --device_backend host and --profile_trace on the golden
    workload."""
    directory = os.path.dirname(golden_bam)
    working_dir = os.path.join(directory, "wd_host")
    _drive("host", ["alignment", working_dir, golden_bam, golden_genome,
                    "--device_backend", "host"])
    if _normalized_vcf(os.path.join(working_dir, "variants.vcf")) \
            != _normalized_vcf(GOLDEN):
        raise AssertionError("--device_backend host: variants.vcf differs "
                             "from tests/golden/variants.golden.vcf")
    if any(PATH_LAUNCHES["host"].values()):
        raise AssertionError("--device_backend host launched a kernel: {0}"
                             .format(PATH_LAUNCHES["host"]))
    log("flags", "--device_backend host: golden VCF, no kernel launch")

    working_dir = os.path.join(directory, "wd_trace")
    launches = _drive("profile_trace",
                      ["alignment", working_dir, golden_bam, golden_genome,
                       "--edit_backend", "wavefront", "--profile_trace"])
    if _normalized_vcf(os.path.join(working_dir, "variants.vcf")) \
            != _normalized_vcf(GOLDEN):
        raise AssertionError("--profile_trace: variants.vcf differs from "
                             "tests/golden/variants.golden.vcf")
    kernels = {}
    for stage in ("collect", "cluster"):
        trace_path = os.path.join(working_dir, "traces", stage + ".json")
        with open(trace_path) as handle:
            events = json.load(handle)["traceEvents"]
        if not events:
            raise AssertionError("--profile_trace: {0} is empty".format(
                trace_path))
        kernels[stage] = sorted({event["name"] for event in events
                                 if event.get("cat") == "kernel"})
        log("flags", "--profile_trace: traces/{0}.json, {1} bytes, {2} events"
            ", {3} CUDA kernels by name".format(
                stage, os.path.getsize(trace_path), len(events),
                len(kernels[stage])))
    if not any("wavefront" in name for name in kernels["cluster"]):
        raise AssertionError("--profile_trace: the CLUSTER trace names no "
                             "wavefront kernel among {0} (launches {1})"
                             .format(kernels["cluster"][:10], launches))
    if not kernels["collect"]:
        raise AssertionError("--profile_trace: the COLLECT trace names no "
                             "CUDA kernel")


def _non_help_calls(log_path):
    with open(log_path) as handle:
        return [line for line in handle if "--help" not in line]


def phase_reads(golden_bam, golden_genome):
    """Phase 12: `reads` mode over stub aligners on the golden records."""
    from svim_tpu_torch import workloads

    directory = os.path.join(os.path.dirname(golden_bam), "reads_mode")
    os.makedirs(directory, exist_ok=True)
    sam = workloads.sam_text(golden_bam, os.path.join(directory,
                                                      "aligned.sam"))
    fastq = os.path.join(directory, "sample.fastq")
    with open(fastq, "w") as handle:
        handle.write("@read0\nACGT\n+\n!!!!\n")
    working_dir = os.path.join(directory, "wd")
    cached = os.path.join(working_dir, "sample.ngmlr.coordsorted.bam")
    for stale in (cached, cached + ".bai"):
        if os.path.exists(stale):
            os.remove(stale)
    arguments = ["reads", working_dir, fastq, golden_genome,
                 "--edit_backend", "wavefront", "--incremental_cluster", "off"]
    with workloads.stub_aligners(directory, sam) as stub_log:
        launches = _drive("reads", arguments)
        calls = _non_help_calls(stub_log)
        for wanted in ("ngmlr", "samtools view", "samtools sort",
                       "samtools index"):
            if not any(call.startswith(wanted) for call in calls):
                raise AssertionError("reads mode: no {0!r} stub call among "
                                     "{1}".format(wanted, calls))
        if _normalized_vcf(os.path.join(working_dir, "variants.vcf")) \
                != _normalized_vcf(GOLDEN):
            raise AssertionError("reads mode: variants.vcf differs from "
                                 "tests/golden/variants.golden.vcf")
        golden_launches = PATH_LAUNCHES["golden"]["wavefront_banded_distance"]
        if launches != golden_launches or launches <= 0:
            raise AssertionError("reads mode: {0} wavefront launches, the "
                                 "golden slice {1}".format(launches,
                                                           golden_launches))
        again = _drive("reads_cached", arguments)
        if len(_non_help_calls(stub_log)) != len(calls):
            raise AssertionError("reads mode: the second run called a stub "
                                 "again instead of re-using " + cached)
        if _normalized_vcf(os.path.join(working_dir, "variants.vcf")) \
                != _normalized_vcf(GOLDEN) or again != launches:
            raise AssertionError("reads mode, cached BAM: other output")
    log("reads", "stub aligners ({0} calls), golden VCF, wavefront launches "
        "{1} (as the golden slice); the second run re-used the cached BAM "
        "with no stub call".format(len(calls), launches))


# a rank of phase 13: the port's CLI, then what its interpreter holds
_RANK_SCRIPT = """
import json, sys
sys.path.insert(0, {root!r})
from svim_tpu_torch.cli import main
code = main(sys.argv[1:])
print("LOADED " + json.dumps(sorted(
    name for name in sys.modules
    if name.split(".")[0] in ("jax", "jaxlib", "svim_tpu"))))
sys.exit(code)
"""
RANK_TIMEOUT = 300   # seconds, each rank subprocess


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _rank_log_values(working_dir, rank):
    """What rank `rank` wrote to its SVIM_*.p<rank>.log: the DEVICE line and
    the JSON lines --profile logs."""
    logs = sorted(name for name in os.listdir(working_dir)
                  if name.endswith(".p{0}.log".format(rank)))
    values = {}
    markers = {"DEVICE: ": "device", "Stage seconds: ": "seconds",
               "Kernel launches: ": "launches",
               "Cluster telemetry: ": "telemetry",
               "Exchange totals: ": "exchange",
               "Distributed collect phases: ": "phases"}
    with open(os.path.join(working_dir, logs[-1])) as handle:
        for line in handle:
            for marker, key in markers.items():
                if marker in line:
                    text = line.split(marker, 1)[1].strip()
                    values[key] = text if key in ("device", "phases") \
                        else json.loads(text)
    missing = sorted(set(markers.values()) - set(values))
    if missing:
        raise AssertionError("rank {0} of {1} logged no {2}".format(
            rank, working_dir, missing))
    return values


def _run_ranks(path, world, working_dir, bam, genome):
    """One --distributed run of `world` rank subprocesses on the one card.
    Returns the per-rank log values; PATH_LAUNCHES[path] gets the launches
    summed over the ranks (each rank counted from 0 in its own process)."""
    import shutil

    if os.path.isdir(working_dir):
        shutil.rmtree(working_dir)
    coordinator = "127.0.0.1:{0}".format(_free_port())
    procs = []
    outputs = []
    try:
        for rank in range(world):
            env = dict(os.environ, SVIM_COORDINATOR=coordinator,
                       SVIM_NUM_PROCESSES=str(world),
                       SVIM_PROCESS_ID=str(rank), GLOO_SOCKET_IFNAME="lo")
            env.pop("SVIM_TORCH_DEVICE", None)
            console = open("{0}.rank{1}.console.log".format(working_dir,
                                                             rank), "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-c", _RANK_SCRIPT.format(root=ROOT),
                 "alignment", working_dir, bam, genome, "--distributed",
                 "--edit_backend", "wavefront", "--profile"],
                env=env, stdout=console, stderr=subprocess.STDOUT),
                console))
        for proc, _console in procs:
            proc.wait(timeout=RANK_TIMEOUT)
    finally:
        for proc, console in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            console.close()
            with open(console.name) as handle:
                outputs.append(handle.read())
    failed = [rank for rank, (proc, _console) in enumerate(procs)
              if proc.returncode != 0]
    if failed:
        for rank, output in enumerate(outputs):
            sys.stderr.write("--- {0}, rank {1} (exit {2}) ---\n{3}\n".format(
                path, rank, procs[rank][0].returncode, output[-3000:]))
        raise RuntimeError("{0}: ranks {1} failed".format(path, failed))
    ranks = []
    for rank, output in enumerate(outputs):
        loaded = [line for line in output.splitlines()
                  if line.startswith("LOADED ")]
        if loaded != ["LOADED []"]:
            raise AssertionError("{0}, rank {1} holds {2}".format(
                path, rank, loaded))
        values = _rank_log_values(working_dir, rank)
        if not values["device"].startswith("cuda"):
            raise AssertionError("{0}, rank {1} ran on {2}".format(
                path, rank, values["device"]))
        if values["launches"]["wavefront_banded_distance"] <= 0:
            raise AssertionError("{0}, rank {1} launched no wavefront "
                                 "kernel".format(path, rank))
        ranks.append(values)
    PATH_LAUNCHES[path] = {
        name: sum(values["launches"][name] for values in ranks)
        for name in KERNEL_MODULES}
    return ranks


def phase_distributed(card, bench_bam, bench_genome, off_seconds, golden_bam,
                      golden_genome):
    """Phase 13: --distributed as rank subprocesses on the one card."""
    runs = [("distributed_bench_w2", 2, bench_bam, bench_genome,
             BENCH_VCF_SHA256, sum(BENCH_TELEMETRY["wavefront"].values())),
            ("distributed_bench_w3", 3, bench_bam, bench_genome,
             BENCH_VCF_SHA256, sum(BENCH_TELEMETRY["wavefront"].values())),
            ("distributed_golden_w2", 2, golden_bam, golden_genome,
             SAM_VCF_SHA256, sum(GOLDEN_TELEMETRY.values()))]
    for path, world, bam, genome, expected, eligible in runs:
        working_dir = os.path.join(os.path.dirname(bam), "wd_" + path)
        started = time.perf_counter()
        ranks = _run_ranks(path, world, working_dir, bam, genome)
        wall = time.perf_counter() - started
        digest = _vcf_sha256(working_dir)
        if digest != expected:
            raise AssertionError("{0}: variants.vcf (sha256 {1}) differs "
                                 "from the pinned one".format(path, digest))
        counted = [values["telemetry"]["eligible"] for values in ranks]
        if sum(counted) != eligible:
            raise AssertionError("{0}: the ranks resolved {1} eligible "
                                 "partitions, one process {2}".format(
                                     path, counted, eligible))
        received = {values["exchange"]["received"] for values in ranks}
        if len(received) != 1 or received.pop() != sum(
                values["exchange"]["sent"] for values in ranks):
            raise AssertionError("{0}: exchange bytes do not add up: {1}"
                                 .format(path, [values["exchange"]
                                                for values in ranks]))
        for rank, values in enumerate(ranks):
            log("distributed", "{0} rank {1}/{2} on {3}: stages {4}; {5}; "
                "exchange {6}; wavefront launches {7}; eligible partitions "
                "{8}".format(path, rank, world, values["device"],
                             json.dumps(values["seconds"]), values["phases"],
                             json.dumps(values["exchange"]),
                             values["launches"]["wavefront_banded_distance"],
                             values["telemetry"]["eligible"]))
        log("distributed", "{0}: {1} ranks sharing {2}, wall {3:.2f}s with "
            "start-up; VCF hashes to the pinned one; eligible partitions {4} "
            "sum to {5}{6}".format(
                path, world, card, wall, counted, eligible,
                "; one process (phase 5, off): collect {0!r} s, cluster {1!r} "
                "s".format(off_seconds["wavefront"]["collect"],
                           off_seconds["wavefront"]["cluster"])
                if "bench" in path else ""))


class ShardedCallRecorder:
    """While active, keeps the inputs and outputs of every row-sharded
    COLLECT scan and every GENOTYPE join the main path runs."""

    def __init__(self):
        from svim_tpu_torch.ops import genotype_kernel
        from svim_tpu_torch.parallel import mesh

        self.mesh = mesh
        self.genotype_kernel = genotype_kernel
        self.scans = []
        self.joins = []

    def __enter__(self):
        self.scan = self.mesh.collect_scan_sharded
        self.join = self.genotype_kernel.genotype_ref_support_device

        def scan(num_shards, device, cigar_words, ref_start, min_sv_size):
            outputs = self.scan(num_shards, device, cigar_words, ref_start,
                                min_sv_size)
            self.scans.append((num_shards, device, cigar_words, ref_start,
                               min_sv_size, outputs))
            return outputs

        def join(jobs, per_tid, device, num_shards=1):
            counts = self.join(jobs, per_tid, device, num_shards)
            self.joins.append((jobs, per_tid, device, num_shards, counts))
            return counts

        self.mesh.collect_scan_sharded = scan
        self.genotype_kernel.genotype_ref_support_device = join
        return self

    def __exit__(self, *exc):
        self.mesh.collect_scan_sharded = self.scan
        self.genotype_kernel.genotype_ref_support_device = self.join


def _sharded_op(op, shards, device, args, kwargs):
    """`op` over `shards` blocks of its tensor arguments' leading axis
    (other arguments pass to every shard), outputs gathered on `device`."""
    import torch

    from svim_tpu_torch.parallel import mesh

    names = sorted(kwargs)
    values = list(args) + [kwargs[name] for name in names]
    cut = [index for index, value in enumerate(values)
           if isinstance(value, torch.Tensor)]
    outputs = []
    for block in mesh.shard_batch(shards, device, *(values[i] for i in cut)):
        local = list(values)
        for index, tensor in zip(cut, block):
            local[index] = tensor
        outputs.append(op(*local[:len(args)],
                          **dict(zip(names, local[len(args):]))))
    return mesh.gather_shards(outputs, device)


def phase_shards(bench_bam, bench_genome):
    """Phase 14: --num_shards 8 on the bench workload."""
    import numpy as np
    import torch

    from svim_tpu_torch import entry
    from svim_tpu_torch.ops import genotype_kernel, linkage_kernel
    from svim_tpu_torch.parallel import mesh

    shards = 8
    working_dir = os.path.join(os.path.dirname(bench_bam), "wd_num_shards")
    with ShardedCallRecorder() as recorder:
        launches = _drive("num_shards", [
            "alignment", working_dir, bench_bam, bench_genome, "--num_shards",
            str(shards), "--edit_backend", "wavefront",
            "--incremental_cluster", "off"])
    digest = _vcf_sha256(working_dir)
    if digest != BENCH_VCF_SHA256:
        raise AssertionError("--num_shards {0}: variants.vcf (sha256 {1}) "
                             "differs from svim_tpu's".format(shards, digest))
    if launches <= 0:
        raise AssertionError("--num_shards launched no wavefront kernel")
    logs = sorted(name for name in os.listdir(working_dir)
                  if name.startswith("SVIM_") and name.endswith(".log"))
    with open(os.path.join(working_dir, logs[-1])) as handle:
        layout = "{0} shards over {1} device(s)".format(
            shards, min(shards, torch.cuda.device_count()))
        if layout not in handle.read():
            raise AssertionError("--num_shards: no {0!r} in the log".format(
                layout))

    cut_scans = 0
    for (num_shards, device, words, ref_start, min_sv_size,
         got) in recorder.scans:
        if device.type != "cuda" or num_shards != shards:
            raise AssertionError("a COLLECT scan ran on {0} over {1} shards"
                                 .format(device, num_shards))
        want = mesh.collect_scan_sharded(1, device, words, ref_start,
                                         min_sv_size)
        if len(got) != len(want) or not all(
                a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
                for a, b in zip(got, want)):
            raise AssertionError("row-sharded COLLECT scan differs from the "
                                 "unsharded one at {0} rows".format(
                                     words.shape[0]))
        cut_scans += words.shape[0] % shards == 0
    if not cut_scans:
        raise AssertionError("no COLLECT scan of the run was cut into shards")

    cut_joins = 0
    original = genotype_kernel.shard_batch
    blocks = []

    def counted(*args):
        result = original(*args)
        blocks.append(len(result))
        return result

    genotype_kernel.shard_batch = counted
    try:
        for jobs, per_tid, device, num_shards, got in recorder.joins:
            if got != genotype_kernel.genotype_ref_support_device(
                    jobs, per_tid, device, 1):
                raise AssertionError("sharded GENOTYPE join differs from the "
                                     "unsharded one at {0} jobs".format(
                                         len(jobs)))
            # a prefix of the jobs whose candidate axis divides: one of 8
            # consecutive lengths does
            for count in range(len(jobs), max(len(jobs) - shards, 0), -1):
                del blocks[:]
                sharded = genotype_kernel.genotype_ref_support_device(
                    jobs[:count], per_tid, device, shards)
                if blocks == [shards]:
                    if sharded != genotype_kernel.genotype_ref_support_device(
                            jobs[:count], per_tid, device, 1):
                        raise AssertionError("GENOTYPE join cut into {0} "
                                             "differs at {1} jobs".format(
                                                 shards, count))
                    cut_joins += 1
                    break
    finally:
        genotype_kernel.shard_batch = original
    if not recorder.joins or not cut_joins:
        raise AssertionError("no GENOTYPE join was cut into shards ({0} "
                             "joins recorded)".format(len(recorder.joins)))

    # the CLUSTER batcher's two agglomeration ops: on this workload every
    # coordinate partition is resolved at dispatch (telemetry pre_tie), so
    # its flushes are empty; seeded partitions stand in
    device = torch.device("cuda")
    rng = np.random.default_rng(20261019)
    checked = []
    for name, args, kwargs in _synthetic_linkage(rng, device):
        if name == "ins_matrices_from_pairs":
            continue
        op = getattr(linkage_kernel, name)
        want = op(*args, **kwargs)
        got = _sharded_op(op, shards, device, args, kwargs)
        if not all(a.dtype == b.dtype and torch.equal(a, b)
                   for a, b in zip(got, want)):
            raise AssertionError("{0} cut into {1} shards differs from the "
                                 "whole batch at P={2}".format(
                                     name, shards, args[0].shape[1]))
        checked.append("{0} P={1}".format(name, args[0].shape[1]))

    function, arguments = entry.entry()
    outputs = function(*arguments)
    torch.cuda.synchronize()
    if any(value.device.type != "cuda" for value in arguments) \
            or int(outputs[10]) != len(outputs[5]) or int(outputs[10]) <= 0:
        raise AssertionError("entry.entry() did not run on the card")
    entry.dryrun_multichip(shards)
    log("shards", "--num_shards {0}: VCF hashes to svim_tpu's; {1!r}; "
        "wavefront launches {2}; {3} COLLECT scans ({4} cut into shards) and "
        "{5} GENOTYPE joins ({6} prefixes cut into shards) equal their "
        "unsharded runs; {7} equal whole-batch runs; entry() found {8} "
        "events on the card; dryrun_multichip({0}) passed".format(
            shards, layout, launches, len(recorder.scans), cut_scans,
            len(recorder.joins), cut_joins, ", ".join(checked),
            int(outputs[10])))


def main():
    sys.path.insert(0, ROOT)
    card = phase_environment()
    phase_build()
    timings, max_abs_err = phase_kernels(kernel_shapes())
    recorder = LinkageRecorder()
    with recorder:
        golden_bam, golden_genome = phase_golden()
    bench_bam, bench_genome, off_seconds = phase_bench(card, recorder)
    phase_linkage(recorder)
    distance_timings, distance_err = phase_distance()
    phase_streaming(card, bench_bam, bench_genome, golden_bam, golden_genome)
    phase_inputs(golden_bam, golden_genome)
    phase_default_path(card, bench_bam, bench_genome, off_seconds,
                       golden_bam, golden_genome)
    phase_flags(golden_bam, golden_genome)
    phase_reads(golden_bam, golden_genome)
    phase_distributed(card, bench_bam, bench_genome, off_seconds, golden_bam,
                      golden_genome)
    phase_shards(bench_bam, bench_genome)
    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    log("paths", "kernel launches per path: {0}".format(
        json.dumps(PATH_LAUNCHES)))

    import torch

    def by_path(name):
        return {path: counts[name] for path, counts in PATH_LAUNCHES.items()}

    kernel_ms, plain_ms, bound_ms, bound_by = timings[MAIN_SHAPE]
    distance_ms, distance_plain_ms = distance_timings[
        DISTANCE_MAIN_SHAPE + (True,)]
    distance_bound_ms, distance_bound_by = distance_bound_ms_of(
        *DISTANCE_MAIN_SHAPE)
    # library_ms is null for both: PyTorch has no call that computes a
    # banded Levenshtein distance, nor one for this pairwise distance with
    # its same-read wall (torch.cdist has neither the two quotients nor the
    # wall)
    print(json.dumps({"kernels": [{
        "name": "wavefront_banded_distance", "route": "cuda",
        "source": "svim_tpu_torch/csrc/wavefront.cu",
        "replaces": "svim_tpu/ops/wavefront_kernel.py:123",
        "launches": PATH_LAUNCHES["bench_wavefront"][
            "wavefront_banded_distance"],
        "launches_by_path": by_path("wavefront_banded_distance"),
        "max_abs_err": max_abs_err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "shape": "B={0},L={1},W={2}".format(*MAIN_SHAPE)}, {
        "name": "span_distance_matrix", "route": "cuda",
        "source": "svim_tpu_torch/csrc/span_distance.cu",
        "replaces": "svim_tpu/ops/distance_kernel.py:52",
        "launches": PATH_LAUNCHES["bench_wavefront"]["span_distance_matrix"],
        "launches_by_path": by_path("span_distance_matrix"),
        "on_main_path": False,
        "max_abs_err": distance_err, "ms": distance_ms,
        "plain_ms": distance_plain_ms, "bound_ms": distance_bound_ms,
        "bound_by": distance_bound_by, "library_ms": None,
        "shape": "B={0},P={1},wall".format(*DISTANCE_MAIN_SHAPE)}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
