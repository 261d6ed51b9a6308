"""A seed sweep of one benchmark cell: whole jobs of the PyTorch/CUDA port
on the cell's made input for each of several seeds, the seeds visited in
turn and the turns repeated, so that a job time that follows the seed can
be told apart from one that follows the time of the run.

    python3 scripts/seed_sweep.py --workload wavefront-longtail30x \\
        --seeds 1 2 3 4 5 6 7 8 --passes 2 --jobs 2 \\
        --out sweep.jsonl

Each seed's input is made once by the benchmark's frozen maker
(svbench/inputs.py) into a cache directory of its own under `--inputs`,
so the passes reuse it.  One process loads the port, runs one warm-up
job, then for each pass and seed `--jobs` jobs with --profile, and writes
a line a (pass, seed) to `--out`: each job's wall seconds, its `Stage
seconds:` record (stages, spans, counts), the change of the route
counters that svbench/run.py prints, the CPU seconds the job cost the
host, its output's digest, and what the sweep times itself around the
program's entries: each consensus cluster of COMBINE's pool (its place in
the queue, its size and its seconds) and each wavefront launch (pairs,
padded length, band, host seconds).  The comparison that decides
`correct` is svbench/run.py's, and is not run here.  Needs a card unless
--cpu_rehearsal (the traffic's rehearsal size, on the CPU).
"""

import argparse
import concurrent.futures
import json
import multiprocessing
import os
import resource
import shutil
import statistics
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _make(arguments):
    """Make (or find) one seed's input in a cache directory of its own."""
    directory, traffic, seed, knobs = arguments
    from svbench import inputs

    inputs.ROOT = directory
    bam, genome, sample, made_s = inputs.find_or_make(traffic, seed, knobs)
    return seed, bam, genome, sample["reads"], made_s


class Probe:
    """Times the program's consensus clusters and wavefront launches of
    the running job, by wrapping the entries where the program looks them
    up."""

    def __init__(self):
        self.clusters = []
        self.launches = []
        self.lock = threading.Lock()
        self.started = time.perf_counter()

    def install(self):
        from svim_tpu_torch.combine import consensus
        from svim_tpu_torch.ops import wavefront_kernel

        original_consensus = consensus.consensus_from_inputs
        original_launch = wavefront_kernel.banded_distance

        def timed_consensus(inputs, *args, **kwargs):
            haplotypes = inputs[0]
            start = time.perf_counter()
            result = original_consensus(inputs, *args, **kwargs)
            end = time.perf_counter()
            with self.lock:
                self.clusters.append({
                    "start": start - self.started, "end": end - self.started,
                    "members": len(haplotypes),
                    "bases": sum(map(len, haplotypes))})
            return result

        def timed_launch(a_codes, a_lens, b_codes, b_lens, band):
            start = time.perf_counter()
            result = original_launch(a_codes, a_lens, b_codes, b_lens, band)
            self.launches.append((len(a_lens), int(a_codes.shape[1]), band,
                                  time.perf_counter() - start))
            return result

        consensus.consensus_from_inputs = timed_consensus
        wavefront_kernel.banded_distance = timed_launch

    def reset(self):
        self.clusters = []
        self.launches = []
        self.started = time.perf_counter()

    def summary(self, workers=8):
        """The pool's timeline and the launches of the job, summed."""
        clusters = sorted(self.clusters, key=lambda c: c["start"])
        out = {"clusters": len(clusters)}
        if clusters:
            first = clusters[0]["start"]
            last = max(c["end"] for c in clusters)
            seconds = [c["end"] - c["start"] for c in clusters]
            longest = max(range(len(clusters)), key=lambda i: seconds[i])
            out.update(
                pool_wall=last - first, pool_busy=sum(seconds),
                longest_s=seconds[longest],
                longest_rank=longest, longest_bases=clusters[longest]["bases"],
                longest_members=clusters[longest]["members"],
                # the wall from the longest cluster's start to the pool's end
                tail_after_longest=last - clusters[longest]["start"],
                # seconds the last thread ran alone at the end
                alone_s=last - sorted(c["end"] for c in clusters)[-2]
                if len(clusters) > 1 else 0.0,
                lpt_s=_makespan(sorted(seconds, reverse=True), workers),
                queue_s=_makespan(seconds, workers),
                top=[[round(seconds[i], 3), i, clusters[i]["bases"],
                      clusters[i]["members"]]
                     for i in sorted(range(len(clusters)),
                                     key=lambda i: -seconds[i])[:5]])
        groups = {}
        for pairs, length, band, seconds in self.launches:
            key = "{0}x{1}".format(length, band)
            entry = groups.setdefault(key, [0, 0, 0.0])
            entry[0] += 1
            entry[1] += pairs
            entry[2] += seconds
        out["launches"] = groups
        out["launch_host_s"] = sum(s for *_, s in self.launches)
        return out


def host_usage():
    """The process's CPU seconds, for the change over a job."""
    usage = resource.getrusage(resource.RUSAGE_SELF)
    return {"cpu_s": usage.ru_utime + usage.ru_stime}


def _makespan(seconds, workers):
    """When a pool of `workers` threads that takes the tasks in this order
    ends."""
    free = [0.0] * workers
    for duration in seconds:
        index = min(range(workers), key=free.__getitem__)
        free[index] += duration
    return max(free)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--passes", type=int, default=2)
    parser.add_argument("--jobs", type=int, default=2)
    parser.add_argument("--makers", type=int, default=2,
                        help="inputs made at once")
    parser.add_argument("--inputs", default=os.path.join(ROOT, "svbench",
                                                         ".inputs", "sweep"))
    parser.add_argument("--out", required=True)
    parser.add_argument("--cpu_rehearsal", action="store_true")
    args = parser.parse_args(argv)

    from svbench import run

    _, config, traffic, _, _ = run.load_cell(args.workload)
    knobs = traffic["rehearsal"] if args.cpu_rehearsal else traffic["knobs"]
    jobs = [(os.path.join(args.inputs, "seed{0}".format(seed)),
             traffic["name"], seed, knobs) for seed in args.seeds]
    started = time.perf_counter()
    # the makers' own children need workers that are not daemons
    with concurrent.futures.ProcessPoolExecutor(
            args.makers, mp_context=multiprocessing.get_context("spawn")) as pool:
        made = {seed: (bam, genome, reads, made_s)
                for seed, bam, genome, reads, made_s in pool.map(_make, jobs)}
    run.log("inputs ready in {0:.1f} s: {1}".format(
        time.perf_counter() - started,
        {seed: round(entry[3], 1) for seed, entry in made.items()}))
    for _, genome, _, _ in made.values():
        run.write_fai(genome)

    import torch

    program = run.Program("cpu" if args.cpu_rehearsal else "auto")
    arguments = config["arguments"]
    scratch = os.path.join(args.inputs, "work")
    first = made[args.seeds[0]]
    code, warm_s = program.job(os.path.join(scratch, "warm"), first[0],
                               first[1], arguments)
    if code != 0:
        raise RuntimeError("the warm-up job exited {0}".format(code))
    run.log("warm-up job {0:.2f} s".format(warm_s))
    probe = Probe()
    probe.install()
    device = ("cpu" if args.cpu_rehearsal
              else torch.cuda.get_device_name(0))
    rows = []
    with open(args.out, "a") as out:
        for turn in range(args.passes):
            for seed in args.seeds:
                bam, genome, reads, _ = made[seed]
                line = {"workload": args.workload, "seed": seed, "pass": turn,
                        "device": device, "reads": reads, "jobs": []}
                for number in range(args.jobs):
                    before = run.counters()
                    usage = host_usage()
                    probe.reset()
                    workdir = os.path.join(scratch, "s{0}p{1}j{2}".format(
                        seed, turn, number))
                    code, wall = program.job(workdir, bam, genome, arguments,
                                             profile=True)
                    line["jobs"].append({
                        "code": code, "wall": wall,
                        "record": program.stages.seen[-1],
                        "counters": run.counter_change(before, run.counters()),
                        "probe": probe.summary(),
                        "host": {key: value - usage[key] for key, value
                                 in host_usage().items()},
                        "digest": run.output_digest(workdir)})
                    shutil.rmtree(workdir, ignore_errors=True)
                walls = [job["wall"] for job in line["jobs"]]
                line["reads_per_s"] = reads * len(walls) / sum(walls)
                rows.append(line)
                out.write(json.dumps(line) + "\n")
                out.flush()
                stages = line["jobs"][-1]["record"]
                run.log("pass {0} seed {1}: {2:.1f} reads/s, jobs {3}, "
                        "stages {4}".format(
                            turn, seed, line["reads_per_s"],
                            [round(w, 2) for w in walls],
                            {k: round(v, 2) for k, v in stages.items()
                             if isinstance(v, float)}))
    rates = [row["reads_per_s"] for row in rows]
    median = statistics.median(rates)
    print(json.dumps({"workload": args.workload, "device": device,
                      "runs": len(rates), "median": median,
                      "max_minus_min_share": (max(rates) - min(rates)) / median,
                      "by_seed": {seed: [round(row["reads_per_s"], 1)
                                         for row in rows if row["seed"] == seed]
                                  for seed in args.seeds}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
