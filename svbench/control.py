"""The control of the comparison that decides `correct`, and the readings
that its limits were set from.

    python3 svbench/control.py --workload <cell> --seeds 11 12 13 [--cpu_rehearsal]

For each seed, in one process: the cell's input is made, one job of the
program runs on it as in a measured run, and the comparison reads

- the program's job against the reference (a sound run: the lower
  readings), and
- the control in the program's place (the upper readings): the reference
  itself, with the guarantee that the configuration states for insertions
  broken as a later change would be tempted to break it, the POA consensus
  skipped (SVIM's --skip_consensus): every insertion at its cluster's
  place, with no sequence.

One JSON line a seed.  The benchmark's own runs never run this.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))

from svbench import compare, inputs, run  # noqa: E402


def readings(bam, genome, arguments, workdir, device, seed):
    """{"program": numbers, "control": numbers} for the job in `workdir`."""
    signatures, insertions, records = compare.program_output(workdir)
    analysis = compare.reference_analysis(bam, genome, arguments, device)
    reference = compare.reference_output(analysis, insertions, records,
                                         seed=seed)
    control = compare.reference_output(analysis, insertions, records,
                                       skip_consensus=True)
    control_lines, control_records, _, _, _, control_bed, _ = control
    judge = compare.reference_output(analysis, control_bed, control_records,
                                     seed=seed)
    return {"program": compare.numbers((signatures, records), reference),
            "control": compare.numbers((control_lines, control_records),
                                       judge)}


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--cpu_rehearsal", action="store_true")
    args = parser.parse_args(argv)
    cell, config, traffic, _, _ = run.load_cell(args.workload)
    import torch

    if not args.cpu_rehearsal and not torch.cuda.is_available():
        run.log("the control runs on the card")
        return 2
    device = "cpu" if args.cpu_rehearsal else "cuda"
    program = run.Program("cpu" if args.cpu_rehearsal else "auto")
    knobs = traffic["rehearsal"] if args.cpu_rehearsal else traffic["knobs"]
    arguments = config["arguments"]
    for seed in args.seeds:
        bam, genome, _, _ = inputs.find_or_make(traffic["name"], seed, knobs)
        run.write_fai(genome)
        scratch = tempfile.mkdtemp(prefix="svbench-control-")
        try:
            workdir = os.path.join(scratch, "job")
            code, _ = program.job(workdir, bam, genome, arguments)
            if code != 0:
                raise RuntimeError("the job exited {0}".format(code))
            result = readings(bam, genome, arguments, workdir, device, seed)
        finally:
            shutil.rmtree(scratch, ignore_errors=True)
        print(json.dumps(dict(workload=cell["name"], seed=seed, **result)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
