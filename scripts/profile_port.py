#!/usr/bin/env python3
"""Stage seconds and device busy time of the PyTorch/CUDA port on the
bench workload, on one NVIDIA card.

    python3 scripts/profile_port.py [--root DIR] [--work DIR] [--reads 8192]
        [--edit_backend wavefront] [--runs 3] [--label NAME] [--host_top N]

Runs `svim_tpu_torch alignment --profile` on the bench workload of
svim_tpu_torch/workloads.py (made once under --work, reused by later
calls): one warm-up run, `--runs` untraced runs whose stage seconds are
host wall clock, then one run under torch.profiler whose device times are
summed by kernel name (device busy = every kernel and copy on the card;
the traced run's stage seconds are inflated by the tracing and are not
reported).  With --host_top N one more run goes under cProfile and the N
functions with the largest cumulative host time are reported (inflated by
the profiling; for shares, not for seconds).  Prints the card's name and
power limit, then one JSON object.

--root is the checkout whose svim_tpu_torch is measured (default: the one
this script lies in), so two checkouts can be compared within one call on
one card by running the script once per --root with the same --work.
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    parser.add_argument("--root", default=here)
    parser.add_argument("--work", default=os.path.join(
        here, "svim_tpu_torch", "_build", "profile"))
    parser.add_argument("--reads", type=int, default=8192)
    parser.add_argument("--edit_backend", default="wavefront")
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

    from svim_tpu_torch import cli, workloads
    from svim_tpu_torch.ops import wavefront_kernel

    directory = os.path.join(args.work, "bench{0}".format(args.reads))
    bam = os.path.join(directory, "bench.bam")
    genome = os.path.join(directory, "genome.fa")
    if not (os.path.exists(bam) and os.path.exists(genome)):
        os.makedirs(directory, exist_ok=True)
        workloads.bench_workload(directory, args.reads)

    def run(tag):
        working_dir = os.path.join(directory, "wd_{0}_{1}".format(
            args.label or "run", tag))
        wavefront_kernel.LAUNCHES = 0
        started = time.perf_counter()
        code = cli.main(["alignment", working_dir, bam, genome,
                         "--edit_backend", args.edit_backend, "--profile"])
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
                         "wavefront_launches": wavefront_kernel.LAUNCHES})

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as trace:
        _, traced_wall = run("traced")
    by_name = {}
    for event in trace.key_averages():
        micros = getattr(event, "self_device_time_total", None)
        if micros is None:
            micros = event.self_cuda_time_total
        if micros > 0:
            by_name[event.key] = by_name.get(event.key, 0.0) + micros / 1e6
    busy = sum(by_name.values())
    if busy <= 0:
        raise RuntimeError("the profiler recorded no device time")
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
        "label": args.label, "card": card, "reads": args.reads,
        "edit_backend": args.edit_backend, "untraced_runs": untraced,
        "traced_wall_s": traced_wall, "device_busy_s": busy,
        "wavefront_kernel_s": sum(seconds for name, seconds in by_name.items()
                                  if "wavefront" in name),
        "device_seconds_by_name": dict(top), "host_top": host_top}),
        flush=True)


if __name__ == "__main__":
    main()
