"""svim_tpu_torch: the PyTorch / CUDA port of svim-tpu.

A second package beside `svim_tpu` (the JAX reference, unchanged).  It runs
the `alignment` pipeline (COLLECT -> CLUSTER -> COMBINE -> GENOTYPE) with
PyTorch tensors on one device chosen by `utils.device.select_device`, and
its kernels are hand-written CUDA for Hopper (csrc/wavefront.cu,
csrc/span_distance.cu).  It stands on its own: every host module it needs
(config, signatures, sigtable, candidates, io, native, consensus, merging,
output, plots, partitioning, exact linkage, the simulator) is a copy of
`svim_tpu`'s under the same relative name, with the byte-parity contract
intact.  This package imports neither `jax` nor anything of `svim_tpu`.
"""

__version__ = "2.0.0"
__all__ = ["__version__"]
