#!/usr/bin/env python3
"""Stage seconds and device busy time of the PyTorch/CUDA port on the
bench or the tie-free workload, on one NVIDIA card.

    python3 scripts/profile_port.py [--root DIR] [--work DIR] [--reads 8192]
        [--workload bench|tiefree] [--edit_backend wavefront]
        [--incremental_cluster auto|off] [--batch_reads 4096] [--runs 3]
        [--label NAME] [--host_top N]

Runs `svim_tpu_torch alignment --profile` on a workload of
svim_tpu_torch/workloads.py (`bench`: every partition resolved on the host;
`tiefree`: most partitions labelled by the device; made once under --work
by this script's own checkout, reused by later calls): one warm-up run, `--runs` untraced runs whose stage seconds are
host wall clock, then one run under torch.profiler.  Of that run only the
device's own events count (kernels, copies and memsets: rows of
key_averages() whose device type is CUDA and that are no user annotation,
the rule of PyTorch's own table; the CPU-op rows also carry the time of the
kernels they launched and would count each twice): device busy is the
union of their intervals, so that a copy running beside a kernel counts
once, beside their plain sum and their sums by name.  The run's Chrome
trace is written under --work and the union of its kernel, gpu_memcpy and
gpu_memset events is reported beside device busy as a check; so is the
sum over every row that the script took before (`all_rows_s`).  The trace
also says whether COLLECT's device passes (the kernels of
csrc/collect_scan.cu and csrc/classify_segments.cu) ran while the host did
other work: of their device time (`collect_pass_s`), the part during which
a host thread sat in a CUDA runtime call that waits for the device
(`collect_pass_waited_s`), and how many kernels each pass launched in
the traced run beside the calls of its wrapper (`collect_kernels`: one a
call since the scan's second design).  Each untraced run also reports the
launches of GENOTYPE's join kernel and of the INS matrix kernel, and the
traced run their device seconds (`genotype_kernel_s`,
`ins_matrices_kernel_s`; 0 for a --root whose port ran them as plain
PyTorch ops).  The traced run's stage seconds
are inflated by the tracing and are not reported.  With --host_top N one
more run goes under cProfile and the N
functions with the largest cumulative host time are reported (inflated by
the profiling; for shares, not for seconds).  --incremental_cluster and
--batch_reads are passed to the port (its defaults: auto, 4096); each
untraced run reports how many partitions clustered mid-scan were reused at
CLUSTER, which depends on how far the scan's threads were ahead.  Prints
the card's name and power limit, then one JSON object.

--root is the checkout whose svim_tpu_torch is measured (default: the one
this script lies in), so two checkouts can be compared within one call on
one card by running the script once per --root with the same --work.  The
workload is always written by this script's checkout (in a process of its
own), so a --root from before a workload existed can be timed on it.
"""

import argparse
import json
import os
import subprocess
import sys
import time


def _stage_seconds(working_dir):
    logs = sorted(name for name in os.listdir(working_dir)
                  if name.startswith("SVIM_") and name.endswith(".log"))
    with open(os.path.join(working_dir, logs[-1])) as handle:
        for line in handle:
            if "Stage seconds: " in line:
                return json.loads(line.split("Stage seconds: ", 1)[1])
    raise RuntimeError("no stage timings in the log of " + working_dir)


def _reused(working_dir):
    """[partitions reused at CLUSTER, partitions clustered mid-scan] from
    the run's log; [0, 0] when it logged no reuse."""
    logs = sorted(name for name in os.listdir(working_dir)
                  if name.startswith("SVIM_") and name.endswith(".log"))
    with open(os.path.join(working_dir, logs[-1])) as handle:
        for line in handle:
            if "Incremental clustering: " in line:
                words = line.split("Incremental clustering: ", 1)[1].split()
                return [int(words[0]), int(words[2])]
    return [0, 0]


# the categories of a torch.profiler Chrome trace that occupy the card
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _self_device_us(event):
    micros = getattr(event, "self_device_time_total", None)
    return event.self_cuda_time_total if micros is None else micros


def _on_device(event):
    """A kernel, copy or memset row: run on the card, no user annotation."""
    from torch.autograd import DeviceType

    return (event.device_type == DeviceType.CUDA
            and not getattr(event, "is_user_annotation", False))


def _union_seconds(intervals):
    """Length of the union of (start, end) intervals in microseconds, in
    seconds."""
    total = 0.0
    reach = None
    for start, end in sorted(intervals):
        if reach is None or start > reach:
            total += end - start
            reach = end
        elif end > reach:
            total += end - reach
            reach = end
    return total / 1e6


# kernel names of the COLLECT passes: csrc/collect_scan.cu's one kernel
# (scan_and_compact) and csrc/classify_segments.cu's two routes
# (classify_groups, classify_groups_warp); then the three kernels of the
# scan's first design (commit e292760), so that a --root that old reads too
SCAN_KERNELS = ("scan_and_compact", "scan_rows", "scan_offsets",
                "write_events")
CLASSIFY_KERNELS = ("classify_groups",)
COLLECT_KERNELS = SCAN_KERNELS + CLASSIFY_KERNELS
# CUDA runtime calls in which the host waits for the device
WAITING_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                 "cudaEventSynchronize", "cudaMemcpy")


def _covered_seconds(intervals, cover):
    """Seconds of `intervals` ((start, end) in microseconds) that lie within
    the union of `cover`."""
    merged = []
    for start, end in sorted(cover):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    total = 0.0
    for start, end in intervals:
        for low, high in merged:
            total += max(0.0, min(end, high) - max(start, low))
    return total / 1e6


def collect_pass_overlap(chrome_trace):
    """(device seconds of the COLLECT kernels, the part of them during which
    the host waited in a runtime call) from a Chrome trace of torch.profiler;
    the rest ran beside host work (the emit of an earlier batch, parsing)."""
    with open(chrome_trace) as handle:
        events = [event for event in json.load(handle)["traceEvents"]
                  if event.get("ph") == "X"]
    kernels = [(event["ts"], event["ts"] + event["dur"]) for event in events
               if event.get("cat") == "kernel"
               and any(name in event.get("name", "")
                       for name in COLLECT_KERNELS)]
    waits = [(event["ts"], event["ts"] + event["dur"]) for event in events
             if event.get("cat") != "kernel"
             and event.get("name") in WAITING_CALLS]
    return (sum(end - start for start, end in kernels) / 1e6,
            _covered_seconds(kernels, waits))


def collect_kernel_counts(chrome_trace):
    """{"scan": kernel events of the COLLECT scan, "classify": of the
    classify pass} in a Chrome trace of torch.profiler."""
    with open(chrome_trace) as handle:
        names = [event.get("name", "") for event in
                 json.load(handle)["traceEvents"]
                 if event.get("ph") == "X" and event.get("cat") == "kernel"]
    return {part: sum(any(kernel in name for kernel in kernels)
                      for name in names)
            for part, kernels in (("scan", SCAN_KERNELS),
                                  ("classify", CLASSIFY_KERNELS))}


def device_intervals(chrome_trace):
    """(start, end) in microseconds of every kernel, copy and memset event
    of a Chrome trace that torch.profiler wrote."""
    with open(chrome_trace) as handle:
        events = json.load(handle)["traceEvents"]
    return [(event["ts"], event["ts"] + event["dur"]) for event in events
            if event.get("ph") == "X"
            and event.get("cat") in DEVICE_CATEGORIES]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parser.add_argument("--root", default=here)
    parser.add_argument("--work", default=os.path.join(
        here, "svim_tpu_torch", "_build", "profile"))
    parser.add_argument("--reads", type=int, default=8192)
    parser.add_argument("--workload", default="bench",
                        choices=("bench", "tiefree"))
    parser.add_argument("--edit_backend", default="wavefront")
    parser.add_argument("--incremental_cluster", default="auto",
                        choices=("auto", "off"))
    parser.add_argument("--batch_reads", type=int, default=4096)
    parser.add_argument("--runs", type=int, default=3)
    parser.add_argument("--label", default="")
    parser.add_argument("--host_top", type=int, default=0)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise RuntimeError("this measurement needs an NVIDIA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)

    from svim_tpu_torch import cli
    from svim_tpu_torch.ops import (
        cigar_kernel,
        genotype_kernel,
        linkage_kernel,
        segments_kernel,
        wavefront_kernel,
    )

    directory = os.path.join(args.work, "{0}{1}".format(args.workload,
                                                        args.reads))
    bam = os.path.join(directory, args.workload + ".bam")
    genome = os.path.join(directory, "genome.fa")
    if not (os.path.exists(bam) and os.path.exists(genome)):
        os.makedirs(directory, exist_ok=True)
        subprocess.run(
            [sys.executable, "-c",
             "import sys; sys.path.insert(0, sys.argv[1]); "
             "from svim_tpu_torch import workloads; "
             "getattr(workloads, sys.argv[2] + '_workload')(sys.argv[3], "
             "int(sys.argv[4]))", here, args.workload, directory,
             str(args.reads)], check=True)

    def run(tag):
        working_dir = os.path.join(directory, "wd_{0}_{1}".format(
            args.label or "run", tag))
        # a --root from before the COLLECT kernels has no count there
        for module in (wavefront_kernel, linkage_kernel, cigar_kernel,
                       segments_kernel, genotype_kernel):
            for counter in ("LAUNCHES", "INS_LAUNCHES"):
                if hasattr(module, counter):
                    setattr(module, counter, 0)
        started = time.perf_counter()
        code = cli.main(["alignment", working_dir, bam, genome,
                         "--edit_backend", args.edit_backend, "--profile",
                         "--incremental_cluster", args.incremental_cluster,
                         "--batch_reads", str(args.batch_reads)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - started
        if code != 0:
            raise RuntimeError("the port exited with {0}".format(code))
        return working_dir, wall

    run("warm")
    untraced = []
    for number in range(args.runs):
        working_dir, wall = run(str(number))
        seconds = _stage_seconds(working_dir)
        untraced.append({"wall": wall, "stages": seconds,
                         "reads_per_s": args.reads / (seconds["collect"]
                                                      + seconds["cluster"]),
                         "wavefront_launches": wavefront_kernel.LAUNCHES,
                         "agglomerate_launches": linkage_kernel.LAUNCHES,
                         "collect_scan_launches": getattr(
                             cigar_kernel, "LAUNCHES", None),
                         "classify_launches": getattr(
                             segments_kernel, "LAUNCHES", None),
                         "genotype_launches": getattr(
                             genotype_kernel, "LAUNCHES", None),
                         "ins_matrices_launches": getattr(
                             linkage_kernel, "INS_LAUNCHES", None),
                         "reused_of_memoized": _reused(working_dir)})

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as trace:
        working_dir, traced_wall = run("traced")
    chrome_trace = os.path.join(working_dir, "profile_trace.json")
    trace.export_chrome_trace(chrome_trace)
    rows = trace.key_averages()
    by_name = {}
    for event in rows:
        if _on_device(event):
            by_name[event.key] = (by_name.get(event.key, 0.0)
                                  + _self_device_us(event) / 1e6)
    busy = _union_seconds([(event.time_range.start, event.time_range.end)
                           for event in trace.events()
                           if _on_device(event)])
    if busy <= 0:
        raise RuntimeError("the profiler recorded no device time")
    trace_busy = _union_seconds(device_intervals(chrome_trace))
    collect_pass_s, collect_pass_waited_s = collect_pass_overlap(chrome_trace)
    # device kernels of COLLECT in the traced run beside the wrappers'
    # calls, held to each wrapper's KERNELS_PER_CALL where it has one
    collect_kernels = collect_kernel_counts(chrome_trace)
    for part, module in (("scan", cigar_kernel),
                         ("classify", segments_kernel)):
        calls = getattr(module, "LAUNCHES", None)
        collect_kernels[part + "_calls"] = calls
        expected = getattr(module, "KERNELS_PER_CALL", None)
        if expected is not None and collect_kernels[part] != expected * calls:
            raise RuntimeError("{0}: {1} kernels in the trace for {2} calls "
                               "of {3} a call".format(
                                   part, collect_kernels[part], calls,
                                   expected))
    all_rows = sum(max(_self_device_us(event), 0) for event in rows) / 1e6
    top = sorted(by_name.items(), key=lambda item: -item[1])[:8]
    host_top = []
    if args.host_top:
        import cProfile
        import pstats

        profiler = cProfile.Profile()
        profiler.enable()
        run("cprofile")
        profiler.disable()
        stats = pstats.Stats(profiler).stats
        ranked = sorted(stats.items(), key=lambda item: -item[1][3])
        host_top = [{"function": "{0}:{1}:{2}".format(
            os.path.relpath(key[0], os.path.abspath(args.root))
            if os.path.isabs(key[0]) else key[0], key[1], key[2]),
            "calls": value[1], "own_s": value[2], "cumulative_s": value[3]}
            for key, value in ranked[:args.host_top]]
    print(json.dumps({
        "label": args.label, "card": card, "workload": args.workload,
        "reads": args.reads,
        "edit_backend": args.edit_backend,
        "incremental_cluster": args.incremental_cluster,
        "batch_reads": args.batch_reads, "untraced_runs": untraced,
        "traced_wall_s": traced_wall, "device_busy_s": busy,
        "device_sum_s": sum(by_name.values()), "trace_busy_s": trace_busy,
        "busy_over_trace": busy / trace_busy if trace_busy else None,
        "all_rows_s": all_rows, "chrome_trace": chrome_trace,
        "wavefront_kernel_s": sum(seconds for name, seconds in by_name.items()
                                  if "wavefront" in name),
        "agglomerate_kernel_s": sum(seconds for name, seconds
                                    in by_name.items()
                                    if "agglomerate" in name),
        "genotype_kernel_s": sum(seconds for name, seconds
                                 in by_name.items()
                                 if "genotype_support" in name),
        "ins_matrices_kernel_s": sum(
            seconds for name, seconds in by_name.items()
            # one kernel since the one-launch design; two for a --root before it
            if any(kernel in name for kernel in (
                "ins_matrices_kernel", "ins_cells_kernel",
                "ins_pairs_kernel"))),
        "collect_pass_s": collect_pass_s,
        "collect_pass_waited_s": collect_pass_waited_s,
        "collect_kernels": collect_kernels,
        "device_seconds_by_name": dict(top), "host_top": host_top}),
        flush=True)


if __name__ == "__main__":
    main()
