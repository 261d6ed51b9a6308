#!/usr/bin/env python3
"""Where the agglomeration kernel's time goes, on one NVIDIA card.

    python3 scripts/agglomerate_steps.py

1. Device ms of both entries of csrc/agglomerate.cu at P = 32 and 128 for a
   few valid counts n, one partition (B = 1: the chain of n - 1 dependent
   steps alone, as on the main path, where a call holds a few partitions)
   and B = 1024 full partitions, beside the design of
   chip_smoke.RESCAN_DESIGN_COMMIT on the same inputs (when its source can
   be had; chip_smoke.rescan_design_library).
2. Cycles by phase of a step: a copy of the source with clock64() marks in
   the step loop (thread 0 of partition 0 adds the cycles since the last
   mark to a counter a phase: exchange, rows lo and hi, the barrier after
   them, the writes, the rescans; and the setup before the loop), built
   into the smoke's scratch directory, run once a shape at B = 1 with every
   slot valid.  The marks cost cycles themselves, so the phases add up to
   more than the plain kernel takes; they are for shares, not for totals.

Prints the card's name and power limit, then one line a measurement.
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

PHASES = ("setup", "exchange", "rows_lo_hi", "barrier", "writes", "rescans",
          "total")
_MARK = ("    if (threadIdx.x == 0 && blockIdx.x == 0) {{ const long long t = "
         "clock64(); atomicAdd(reinterpret_cast<unsigned long long*>("
         "&g_phase[{0}]), static_cast<unsigned long long>(t - mark)); "
         "mark = t; }}\n")
# (anchor in the step loop, phase index, mark before the anchor)
_ANCHORS = (
    ("  for (int step = 0;; ++step) {\n", 0, False),
    ("    if (step == steps) break;\n", 1, True),
    ("    group.sync();   // rows lo and hi, (lo, hi) and the sizes are "
     "read\n", 2, True),
    ("    group.sync();   // rows lo and hi, (lo, hi) and the sizes are "
     "read\n", 3, False),
    ("    __syncwarp();\n    warp_rescan(d, s, p, k - lane, rescan, "
     "&row_value, &row_column);\n", 4, True),
    ("    last_lo = lo;\n", 5, True),
)


def _inputs(name, batch, pad, count, rng):
    import numpy as np

    counts = np.full(batch, count)
    if name == "agglomerate_batched":
        return cs._matrix_inputs(rng, batch, pad, counts)
    arguments = list(cs._fused_inputs(rng, batch, pad, 0, True,
                                      counts=counts))
    # distinct read ids: no slot is dropped, every step is a merge
    arguments[2] = np.tile(np.arange(pad, dtype=np.int32), (batch, 1))
    return tuple(arguments)


def instrumented_library():
    """csrc/agglomerate.cu with the phase marks, built and bound."""
    from svim_tpu_torch.ops import _build, linkage_kernel

    with open(os.path.join(_build.CSRC_DIR, "agglomerate.cu")) as handle:
        source = handle.read()
    start = "  const int s = stride_of(p);\n  const int k = group.rank();"
    for anchor in (start, "namespace {\n", "  if (k == 0) *min_gap_out = "
                   "min_gap;\n"):
        if source.count(anchor) != 1:
            raise RuntimeError("the step loop changed: no single {0!r}"
                               .format(anchor))
    source = source.replace("namespace {\n", "namespace {\n__device__ long "
                            "long g_phase[8];\n", 1)
    source = source.replace(start, "  long long mark = clock64();\n  const "
                            "long long begin = mark;\n" + start, 1)
    for anchor, phase, before in _ANCHORS:
        if source.count(anchor) != 1:
            raise RuntimeError("the step loop changed: no single {0!r}"
                               .format(anchor))
        mark = _MARK.format(phase)
        source = source.replace(anchor, mark + anchor if before
                                else anchor + mark, 1)
    end = "  if (k == 0) *min_gap_out = min_gap;\n"
    source = source.replace(end, _MARK.replace("t - mark", "t - begin")
                            .format(6) + end, 1)
    source += ('\nextern "C" int phase_cycles(void* host) {\n'
               '  cudaDeviceSynchronize();\n'
               '  return static_cast<int>(cudaMemcpyFromSymbol(host, '
               'g_phase, sizeof(g_phase)));\n}\n'
               'extern "C" int phase_clear() {\n'
               '  long long zero[8] = {0};\n'
               '  return static_cast<int>(cudaMemcpyToSymbol(g_phase, zero, '
               'sizeof(zero)));\n}\n')
    directory = os.path.join(cs.SCRATCH, "agglomerate_steps")
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, "agglomerate_phases.cu")
    with open(path, "w") as handle:
        handle.write(source)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                    path[:-3] + ".so", path], check=True,
                   capture_output=True)
    library = ctypes.CDLL(path[:-3] + ".so")
    present = linkage_kernel._kernel_library()
    for name in ("agglomerate_max_slots", "agglomerate_matrix",
                 "agglomerate_fused"):
        getattr(library, name).argtypes = getattr(present, name).argtypes
        getattr(library, name).restype = getattr(present, name).restype
    return library


def main():
    import json

    import numpy as np

    from svim_tpu_torch.ops import linkage_kernel

    card = cs.phase_environment()
    print(card, flush=True)
    cs.phase_build()
    rescan_design = cs.rescan_design_library()
    rng = np.random.default_rng(1)
    names = ("agglomerate_batched", "span_position_agglomerate_batched")
    for pad, counts in ((32, (2, 8, 32)), (128, (2, 32, 128))):
        for count in counts:
            for batch in (1, 1024) if count == pad else (1,):
                for name in names:
                    tensors = cs._on_card(_inputs(name, batch, pad, count,
                                                  rng))
                    ms, rescan_ms = cs._time_against(name, tensors,
                                                     rescan_design, 20)
                    print(json.dumps({
                        "entry": "matrix" if name == names[0] else "fused",
                        "P": pad, "n": count, "B": batch, "ms": ms,
                        "rescan_design_ms": rescan_ms}), flush=True)
    library = instrumented_library()
    for pad in (32, 128):
        for name in names:
            tensors = cs._on_card(_inputs(name, 1, pad, pad, rng))
            kernel = getattr(linkage_kernel, name + "_cuda")
            cs._through(library, lambda: kernel(*tensors))
            library.phase_clear()
            cs._through(library, lambda: kernel(*tensors))
            cycles = (ctypes.c_longlong * 8)()
            library.phase_cycles(cycles)
            print(json.dumps({
                "entry": "matrix" if name == names[0] else "fused",
                "P": pad, "n": pad, "B": 1, "steps": pad - 1,
                "cycles": dict(zip(PHASES, list(cycles)[:len(PHASES)]))}),
                flush=True)


if __name__ == "__main__":
    main()
