"""svim_tpu_torch: the PyTorch / CUDA port of svim-tpu.

A second package beside `svim_tpu` (the JAX reference, unchanged).  It runs
the `alignment` pipeline (COLLECT -> CLUSTER -> COMBINE -> GENOTYPE) with
PyTorch tensors on one device chosen by `utils.device.select_device`, and
its wavefront edit-distance kernel is hand-written CUDA for Hopper
(csrc/wavefront.cu).  The framework-free host modules of `svim_tpu`
(config, signatures, sigtable, candidates, io, native, consensus, merging,
output, plots, partitioning, exact linkage) are imported, not copied: the
byte-parity contract lives there.  This package never imports `jax`.
"""

from svim_tpu import __version__

__all__ = ["__version__"]
