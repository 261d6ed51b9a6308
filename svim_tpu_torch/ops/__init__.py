"""The port's device ops: a hand-written CUDA kernel each (csrc/), with its
plain PyTorch version for the CPU.

Each wrapper adds one to its module's launch counter where it launches its
kernel; KERNEL_COUNTERS names them, launch_counts() reads them all and
reset_launch_counts() sets them to 0."""

import importlib

# kernel name -> (module of svim_tpu_torch.ops, counter attribute)
KERNEL_COUNTERS = {
    "wavefront_banded_distance": ("wavefront_kernel", "LAUNCHES"),
    "span_distance_matrix": ("distance_kernel", "LAUNCHES"),
    "agglomerate": ("linkage_kernel", "LAUNCHES"),
    "collect_scan": ("cigar_kernel", "LAUNCHES"),
    "classify_segments": ("segments_kernel", "LAUNCHES"),
    "genotype_support": ("genotype_kernel", "LAUNCHES"),
    "ins_matrices": ("linkage_kernel", "INS_LAUNCHES"),
    "gotoh_align": ("gotoh_kernel", "LAUNCHES")}


def _counters():
    return {name: (importlib.import_module(__name__ + "." + module), attribute)
            for name, (module, attribute) in KERNEL_COUNTERS.items()}


def launch_counts():
    """{kernel name: launches counted since the last reset}."""
    return {name: getattr(module, attribute)
            for name, (module, attribute) in _counters().items()}


def reset_launch_counts():
    for module, attribute in _counters().values():
        setattr(module, attribute, 0)
