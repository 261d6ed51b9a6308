"""Runs one cell of the benchmark once: whole `svim alignment` jobs of the
PyTorch/CUDA port back to back on the cell's made BAM, then the check of
what they wrote against the plain reference.

    python3 svbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration and its traffic mix are looked up by name in
BENCHMARK.json and in svbench/configs/ and svbench/traffic/.  The last line
of standard output is the result, one JSON object; with --trace 0 its
metrics are the cell's end-to-end ones, with --trace 1 its per-layer ones,
each read by svbench/metrics/<name>.py.  Without a card (or with fewer than
the cell asks for) the run fails and prints no result;
`--cpu_rehearsal` runs the same steps on the CPU at the traffic's rehearsal
size, for trying the harness where there is no card, and prints no device
metric.
"""

import time

PROCESS_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import hashlib  # noqa: E402
import importlib.util  # noqa: E402
import inspect  # noqa: E402
import json  # noqa: E402
import logging  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

# the caches of whatever the port compiles, at fixed paths in the checkout
CACHE = os.path.join(HERE, ".cache")
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(CACHE, "torch_extensions"))
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
os.environ["USE_FLAX"] = "0"

FORBIDDEN = ("jax", "jaxlib", "flax", "svim_tpu")
GIB = float(1 << 30)


def log(message):
    print(message, file=sys.stderr, flush=True)


def forbidden_modules():
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def load_cell(name):
    with open(os.path.join(ROOT, "BENCHMARK.json")) as handle:
        bench = json.load(handle)
    cells = {cell["name"]: cell for cell in bench["workloads"]}
    if name not in cells:
        raise SystemExit("no workload {0!r} in BENCHMARK.json".format(name))
    cell = cells[name]
    config_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(ROOT, config_entry["file"])) as handle:
        config = json.load(handle)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as handle:
        traffic = json.load(handle)
    wanted = lambda metric: name in metric.get("workloads", [name])  # noqa: E731
    return (cell, config, traffic,
            [m for m in bench["end_to_end"] if wanted(m)],
            [m for m in bench["per_layer"] if wanted(m)])


def metric_reader(name):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("svbench_metric_" + name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def write_fai(genome):
    """The genome's samtools-style index beside it, as a deployment keeps
    one beside its reference."""
    from svbench.reference.fasta import build_fasta_index

    path = genome + ".fai"
    if not os.path.exists(path):
        with open(path + ".part", "w") as handle:
            for e in build_fasta_index(genome):
                handle.write("{0}\t{1}\t{2}\t{3}\t{4}\n".format(
                    e.name, e.length, e.offset, e.linebases, e.linewidth))
        os.replace(path + ".part", path)


class ResidentPeak:
    """The process's largest resident size over a span of time, sampled
    from /proc/self/statm every INTERVAL seconds by a thread of its own
    (some container runtimes keep no resident high-water mark that a
    process can reset or read)."""

    INTERVAL = 0.02

    def __init__(self):
        self.page = os.sysconf("SC_PAGE_SIZE")
        self.peak = 0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)

    def resident(self):
        with open("/proc/self/statm") as handle:
            return int(handle.read().split()[1]) * self.page

    def _sample(self):
        while not self._stop.is_set():
            self.peak = max(self.peak, self.resident())
            self._stop.wait(self.INTERVAL)

    def __enter__(self):
        self.peak = self.resident()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.peak = max(self.peak, self.resident())


class StageSeconds(logging.Handler):
    """Keeps the program's `Stage seconds: {json}` log line of each job."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.seen = []

    def emit(self, record):
        if record.msg == "Stage seconds: %s":
            self.seen.append(json.loads(record.args[0]))


class Program:
    """The port, imported once, and how a job of it is run."""

    def __init__(self, device_backend):
        from svim_tpu_torch.cli import run_pipeline
        from svim_tpu_torch.config import parse_arguments
        from svim_tpu_torch.utils.device import select_device

        self.run_pipeline = run_pipeline
        self.parse_arguments = parse_arguments
        self.device = select_device(device_backend)
        self.stages = StageSeconds()
        root = logging.getLogger()
        root.addHandler(self.stages)
        root.setLevel(logging.INFO)

    def job(self, workdir, bam, genome, arguments, profile=False):
        """One whole job; returns (exit code, wall seconds)."""
        import torch

        words = ["alignment", workdir, bam, genome] + list(arguments)
        if profile:
            words.append("--profile")
        options = self.parse_arguments(arguments=words)
        started = time.perf_counter()
        code = self.run_pipeline(options, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return code, time.perf_counter() - started


def counters():
    """The program's route counters, as numbers by name."""
    from svim_tpu_torch import genotype as genotype_module
    from svim_tpu_torch.cluster import cluster as cluster_module
    from svim_tpu_torch.cluster.device_cluster import TELEMETRY
    from svim_tpu_torch.collect import packed
    from svim_tpu_torch.io import bamstream
    from svim_tpu_torch.ops import launch_counts, wavefront_kernel

    values = {"launches." + k: v for k, v in launch_counts().items()}
    values.update({"wavefront." + k: v
                   for k, v in wavefront_kernel.VARIANT_LAUNCHES.items()})
    values["collect.reruns"] = len(packed.RERUNS)
    values.update({"cluster.large_partitions." + k: v
                   for k, v in cluster_module.LARGE_PARTITIONS.items()})
    values.update({"genotype.joined." + k: v
                   for k, v in genotype_module.JOINED.items()})
    values["bamstream.windows"] = bamstream.WINDOWS
    values["bamstream.batches"] = bamstream.BATCHES
    values.update({"telemetry." + k: v for k, v in TELEMETRY.as_dict().items()
                   if not k.endswith("fraction")})
    return values


def counter_change(before, after):
    return {key: after[key] - before.get(key, 0) for key in sorted(after)
            if after[key] != before.get(key, 0)}


class CallTimer:
    """CUDA events around each call of the program's entries that a
    per-layer metric's reader names in its TIMED ({module: entry names}),
    installed where the program looks them up, and beside each call what
    the reader's `keep` takes of its arguments and result."""

    def __init__(self, readers):
        self.readers = readers   # {metric name: reader module}
        self.seen = {name: [] for name in readers}
        self.restore = []

    def install(self):
        import torch

        def wrap(metric, reader, entry, original):
            signature = inspect.signature(original)

            def call(*args, **kwargs):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                result = original(*args, **kwargs)
                end.record()
                self.seen[metric].append((start, end, reader.keep(
                    entry, signature.bind(*args, **kwargs).arguments, result)))
                return result
            return call

        for metric, reader in self.readers.items():
            for module_name, entries in getattr(reader, "TIMED", {}).items():
                module = importlib.import_module(module_name)
                for entry in entries:
                    original = getattr(module, entry)
                    self.restore.append((module, entry, original))
                    setattr(module, entry, wrap(metric, reader, entry, original))

    def uninstall(self):
        for module, entry, original in reversed(self.restore):
            setattr(module, entry, original)
        self.restore = []

    def calls(self):
        """{metric: [(device ms, bound ms)]}, the bound the reader's."""
        import torch

        torch.cuda.synchronize()
        return {metric: [(start.elapsed_time(end),
                          self.readers[metric].bound_ms(kept))
                         for start, end, kept in self.seen[metric]]
                for metric in self.readers}


@contextlib.contextmanager
def stage_marks():
    """Each stage of the program's StageTimer also as a profiler range, so
    that the trace can name what the host did in a gap."""
    import torch
    from svim_tpu_torch.utils import timing

    original = timing.StageTimer.stage

    @contextlib.contextmanager
    def stage(self, name, trace=False):
        with torch.profiler.record_function("stage:" + name):
            with original(self, name, trace) as value:
                yield value

    timing.StageTimer.stage = stage
    try:
        yield
    finally:
        timing.StageTimer.stage = original


def profiled_job(program, workdir, bam, genome, arguments, scratch):
    """One whole job under torch.profiler: (busy seconds, wall seconds,
    the breakdown)."""
    from torch.profiler import ProfilerActivity, profile

    from svbench import yardstick

    with stage_marks():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as profiler:
            code, wall = program.job(workdir, bam, genome, arguments)
    if code != 0:
        raise RuntimeError("the profiled job exited {0}".format(code))
    path = os.path.join(scratch, "trace.json")
    profiler.export_chrome_trace(path)
    with open(path) as handle:
        events = json.load(handle)["traceEvents"]
    os.remove(path)
    intervals = yardstick.device_intervals(events)
    busy = yardstick.union_seconds([(s, e) for s, e, _ in intervals])
    by_name = {}
    for start, end, name in intervals:
        by_name[name] = by_name.get(name, 0.0) + (end - start) / 1e6
    top = sorted(by_name.items(), key=lambda item: -item[1])[:10]
    marks = [(event["ts"], event["ts"] + event["dur"], event["name"])
             for event in events
             if event.get("ph") == "X" and event.get("cat") == "user_annotation"
             and str(event.get("name", "")).startswith("stage:")]
    return busy, wall, {"device_ops": [[name, seconds] for name, seconds in top],
                        "idle_gaps": yardstick.idle_gaps(intervals, marks)}


def reads_per_second(reads_per_job, jobs, window_s):
    """All the reads of every job of the window, the last one finished,
    over the window's whole time."""
    return reads_per_job * jobs / window_s


def output_digest(workdir):
    """A hash of what a job wrote: the signature clusters, the candidates
    and variants.vcf without its ##fileDate line."""
    digest = hashlib.sha256()
    for sub in ("signatures", "candidates"):
        folder = os.path.join(workdir, sub)
        for name in sorted(os.listdir(folder)):
            with open(os.path.join(folder, name), "rb") as handle:
                digest.update(name.encode() + handle.read())
    with open(os.path.join(workdir, "variants.vcf"), "rb") as handle:
        for line in handle:
            if not line.startswith(b"##fileDate"):
                digest.update(line)
    return digest.hexdigest()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--cpu_rehearsal", action="store_true",
                        help="run on the CPU at the rehearsal size; no device "
                        "metric, not a measurement")
    args = parser.parse_args(argv)

    cell, config, traffic, end_to_end, per_layer = load_cell(args.workload)
    import torch

    rehearsal = args.cpu_rehearsal
    if not rehearsal and (not torch.cuda.is_available()
                          or torch.cuda.device_count() < cell["chips"]):
        log("no result: the cell needs {0} CUDA card(s) and torch sees {1}".format(
            cell["chips"], torch.cuda.device_count() if torch.cuda.is_available() else 0))
        return 2

    import svim_tpu_torch  # noqa: F401  (the system under test must be there)

    from svbench import inputs

    knobs = traffic["rehearsal"] if rehearsal else traffic["knobs"]
    bam, genome, sample, make_s = inputs.find_or_make(
        traffic["name"], args.seed, knobs)
    write_fai(genome)
    log("make_s {0!r}; reads a job {1}".format(make_s, sample["reads"]))

    scratch = tempfile.mkdtemp(prefix="svbench-")
    try:
        program = Program("cpu" if rehearsal else "auto")
        arguments = config["arguments"]
        # warm-up: one whole job on the same input, which loads every kernel
        # and native library and brings the job's memory in (a first job
        # ran 1-1.8 s slower than the next ones after a warm-up on a small
        # input)
        code, warm_s = program.job(os.path.join(scratch, "warm"), bam,
                                   genome, arguments)
        if code != 0:
            raise RuntimeError("the warm-up job exited {0}".format(code))
        shutil.rmtree(os.path.join(scratch, "warm"))
        log("warm-up job {0!r} s".format(warm_s))

        timer = (CallTimer({m["name"]: metric_reader(m["name"])
                            for m in per_layer})
                 if args.trace and not rehearsal else None)
        if timer:
            timer.install()
        gc.collect()
        if not rehearsal:
            torch.cuda.reset_peak_memory_stats()
        with ResidentPeak() as resident:
            window_start = time.perf_counter()
            # the program's set-up: imports, kernel loads or builds, the
            # warm-up job; the harness's making of the input is apart
            setup_s = window_start - PROCESS_START - make_s
            jobs = []
            while True:
                workdir = os.path.join(scratch, "job{0}".format(len(jobs)))
                before = counters() if args.trace else None
                code, wall = program.job(workdir, bam, genome, arguments,
                                         profile=bool(args.trace))
                jobs.append((workdir, code, wall))
                if args.trace:
                    log("job {0} counters {1}".format(len(jobs) - 1, json.dumps(
                        counter_change(before, counters()))))
                if time.perf_counter() - window_start >= args.seconds:
                    break
            window_s = time.perf_counter() - window_start
        rss = resident.peak
        memory_peak = 0 if rehearsal else torch.cuda.max_memory_allocated()
        if timer:
            timer.uninstall()
        failed = sum(1 for _, code, _ in jobs if code != 0)
        log("jobs {0}; seconds {1}".format(
            len(jobs), json.dumps([wall for _, _, wall in jobs])))

        trace = None
        if args.trace:
            trace = {"stages": program.stages.seen[-len(jobs):]}
            log("stage seconds {0}".format(json.dumps(trace["stages"])))
            if timer:
                trace["calls"] = timer.calls()
                busy, wall, breakdown = profiled_job(
                    program, os.path.join(scratch, "profiled"), bam, genome,
                    arguments, scratch)
                shutil.rmtree(os.path.join(scratch, "profiled"))
                trace.update(busy_s=busy, window_s=wall)
            else:
                trace.update(calls={}, busy_s=0.0, window_s=0.0)

        # the check: every job wrote the same; the last good job's output
        # against the reference, once the program's state is freed
        good = [workdir for workdir, code, _ in jobs if code == 0]
        digests = {output_digest(workdir) for workdir in good}
        checks = {}
        if good:
            with open(os.path.join(good[-1], "variants.vcf"), "rb") as handle:
                log("variants.vcf sha256, ##fileDate left out: {0}".format(
                    hashlib.sha256(b"".join(
                        line for line in handle
                        if not line.startswith(b"##fileDate"))).hexdigest()))
            from svbench import compare

            del program
            gc.collect()
            if not rehearsal:
                torch.cuda.empty_cache()
            check_started = time.perf_counter()
            checks = compare.check(good[-1], bam, genome, arguments,
                                   "cpu" if rehearsal else "cuda", args.seed,
                                   threads=os.cpu_count() or 1)
            log("check seconds {0!r}".format(time.perf_counter() - check_started))
        checks["jobs_differing"] = {"value": max(0, len(digests) - 1) + failed,
                                    "limit": 0}
    finally:
        shutil.rmtree(scratch, ignore_errors=True)

    correct = all(item["value"] <= item["limit"] for item in checks.values())
    if args.trace:
        metrics = {}
        for metric in per_layer:
            value = metric_reader(metric["name"]).read(trace)
            if value is not None and not (rehearsal and metric["source"] == "device_trace"):
                metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    else:
        values = {"reads_per_s": reads_per_second(sample["reads"], len(jobs),
                                                  window_s),
                  "peak_rss_gib": rss / GIB, "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in end_to_end}
    if rehearsal:
        device = {"platform": "cpu", "kind": "cpu", "count": 0,
                  "memory_peak_bytes": 0}
    else:
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                  "count": cell["chips"], "memory_peak_bytes": int(memory_peak)}
        if args.trace:
            device.update(busy_s=trace["busy_s"], window_s=trace["window_s"])
    found = forbidden_modules()
    if found:
        log("no result: modules of JAX or the JAX package are loaded: "
            "{0}".format(", ".join(found)))
        return 3
    for name, item in checks.items():
        log("check {0} {1} limit {2}".format(name, item["value"], item["limit"]))
    result = {"correct": correct, "attempted": len(jobs), "failed": failed,
              "metrics": metrics, "device": device}
    if trace is not None and not rehearsal:
        result["breakdown"] = breakdown
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
