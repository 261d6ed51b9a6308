#!/usr/bin/env python3
"""Instructions a cell of the span-distance kernel, counted from its SASS.

    python3 scripts/distance_kernel_sass.py [--out DIR]

Compiles svim_tpu_torch/csrc/span_distance.cu for sm_90a with the port's
flags plus `-Xptxas -v` (registers, shared memory and spills of every
kernel), disassembles it with cuobjdump, and for each kernel finds the
loops (a branch back to a lower address) that store to global memory.  For
the innermost such loop it prints the number of instructions, the cells an
iteration stores (16 bytes are four cells), their quotient and the opcode
counts: that quotient is the figure chip_smoke.py's DISTANCE_OPS_PER_CELL
and PERF.md state.  The slow path of an IEEE division is a subroutine
outside the loop and is not counted (it runs for denormal or huge
quotients only).  Needs the CUDA toolkit (nvcc, cuobjdump); the listing and
ptxas' report go to --out (default svim_tpu_torch/_build/sass, which git
ignores).  Prints one JSON object.
"""

import argparse
import collections
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def loops_of(lines):
    """[(first index, last index)] of the backward branches of one kernel's
    instruction lines [(address, opcode, text)]."""
    index_of = {address: index for index, (address, _, _) in enumerate(lines)}
    found = []
    for index, (address, opcode, text) in enumerate(lines):
        if not opcode.startswith("BRA"):
            continue
        target = re.search(r"0x([0-9a-f]+)\s*;?\s*$", text)
        if target and int(target.group(1), 16) <= address \
                and int(target.group(1), 16) in index_of:
            found.append((index_of[int(target.group(1), 16)], index))
    return found


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join(
        ROOT, "svim_tpu_torch", "_build", "sass"))
    args = parser.parse_args()
    sys.path.insert(0, ROOT)
    from svim_tpu_torch.ops import _build

    os.makedirs(args.out, exist_ok=True)
    nvcc = _build._nvcc()
    cubin = os.path.join(args.out, "span_distance.cubin")
    flags = [flag for flag in _build.NVCC_FLAGS
             if flag not in ("-shared", "-Xcompiler", "-fPIC")]
    report = subprocess.run(
        [nvcc, *flags, "-Xptxas", "-v", "-cubin", "-o", cubin,
         os.path.join(_build.CSRC_DIR, "span_distance.cu")],
        capture_output=True, text=True, check=True).stderr
    with open(os.path.join(args.out, "span_distance.ptxas.txt"), "w") as handle:
        handle.write(report)
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", cubin], capture_output=True,
                          text=True, check=True).stdout
    with open(os.path.join(args.out, "span_distance.sass"), "w") as handle:
        handle.write(sass)

    print(json.dumps(summarise(sass, report)))


def summarise(sass, report):
    """Per kernel of the cuobjdump listing `sass`: instructions, registers
    (from ptxas' `report`) and the loops that store, shortest first."""
    kernels = {}
    name = None
    for line in sass.splitlines():
        function = re.search(r"Function : (\S+)", line)
        if function:
            name = function.group(1)
            kernels[name] = []
            continue
        instruction = re.match(
            r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\d+\s+)?([A-Z][A-Z0-9_.]*)"
            r"(.*?);", line)
        if instruction and name:
            kernels[name].append((int(instruction.group(1), 16),
                                  instruction.group(2),
                                  instruction.group(3)))
    resources = dict(zip(
        re.findall(r"Compiling entry function '(\S+)'", report),
        re.findall(r"Used (\d+) registers", report)))
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                        report)
    result = {"spills": sorted(set(spills)), "kernels": {}}
    for name, lines in kernels.items():
        storing = []
        for first, last in loops_of(lines):
            opcodes = [opcode for _, opcode, _ in lines[first:last + 1]]
            cells = sum(4 if ".128" in opcode else 1 for opcode in opcodes
                        if opcode.startswith("STG"))
            if cells:
                storing.append((last - first + 1, cells, opcodes))
        entry = {"instructions": len(lines),
                 "registers": int(resources.get(name, 0)), "store_loops": []}
        for length, cells, opcodes in sorted(storing):
            families = collections.Counter(opcode.split(".")[0]
                                           for opcode in opcodes)
            entry["store_loops"].append({
                "instructions": length, "cells": cells,
                "instructions_per_cell": length / cells,
                "opcodes": dict(families.most_common())})
        result["kernels"][name] = entry
    return result


if __name__ == "__main__":
    main()
