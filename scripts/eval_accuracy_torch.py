#!/usr/bin/env python3
"""Accuracy evaluation of the PyTorch/CUDA port (svim_tpu_torch): simulate
all six SV classes, run the port's pipeline, report per-class
precision/recall/F1 against the simulated truth.  The counterpart of
scripts/eval_accuracy.py, with the same usage and the same JSON lines.

Usage: python scripts/eval_accuracy_torch.py [seed] [--big | --independent]

--big runs the large-scale stress harness (svim_tpu_torch.workloads.
stress_workload: 54 Mb over five contigs, 15% of each contig under repeat
arrays, 12% per-base read noise, ~215 SV loci across all six classes
including cut&paste DUP:INT); --independent the donor-genome projection
(workloads.independent_workload: reads from both strands and both
haplotypes); neither the default simulation.

The pipeline runs on the CUDA card; without one the script raises before
simulating anything, unless SVIM_TORCH_DEVICE=cpu asks for the CPU.
Imports torch and svim_tpu_torch only.
"""

import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    import logging

    from svim_tpu_torch.cli import main as run_cli
    from svim_tpu_torch.sim import SimConfig, evaluate_vcf, f1, simulate
    from svim_tpu_torch.utils.device import select_device
    from svim_tpu_torch.workloads import (
        STRESS_SIM,
        independent_workload,
        stress_workload,
    )

    select_device()   # the card, or the CPU where SVIM_TORCH_DEVICE asks
    logging.disable(logging.INFO)
    args = [a for a in sys.argv[1:] if not a.startswith("--")]
    big = "--big" in sys.argv[1:]
    independent = "--independent" in sys.argv[1:]
    seed = int(args[0]) if args else 1
    out_dir = tempfile.mkdtemp(prefix="svim_torch_eval_")
    workdir = os.path.join(out_dir, "wd")
    start = time.time()
    if independent:
        genome_path, bam_path, truth = independent_workload(out_dir, seed)
    elif big:
        genome_path, bam_path, truth = stress_workload(out_dir, seed)
    else:
        genome_path, bam_path, truth = simulate(out_dir, SimConfig(seed=seed))
    sim_seconds = time.time() - start
    start = time.time()
    if run_cli(["alignment", workdir, bam_path, genome_path]) != 0:
        raise RuntimeError("the pipeline failed; see " + workdir)
    pipeline_seconds = round(time.time() - start, 1)
    if independent:
        print(json.dumps({"harness": "independent (donor-genome projection)",
                          "truth_records": len(truth),
                          "sim_s": round(sim_seconds, 1),
                          "pipeline_s": pipeline_seconds}))
    elif big:
        print(json.dumps({
            "harness": "big",
            "genome_mb": (STRESS_SIM["genome_length"]
                          + STRESS_SIM["second_contig_length"]
                          + sum(STRESS_SIM["extra_contigs"])) / 1e6,
            "contigs": 2 + len(STRESS_SIM["extra_contigs"]),
            "truth_records": len(truth),
            "error_rate": STRESS_SIM["error_rate"],
            "repeat_fraction": STRESS_SIM["repeat_fraction"],
            "sim_s": round(sim_seconds, 1),
            "pipeline_s": pipeline_seconds}))
    results = evaluate_vcf(os.path.join(workdir, "variants.vcf"), truth)
    for svtype, (tp, fp, fn) in sorted(results.items()):
        print(json.dumps({"svtype": svtype, "tp": tp, "fp": fp, "fn": fn,
                          "f1": round(f1(tp, fp, fn), 3)}))


if __name__ == "__main__":
    main()
