"""Batched exact edit distances for INS clustering (port routing).

Counterpart of svim_tpu/cluster/edit_distance.py::batch_edit_distances:
"wavefront" runs the port's wavefront driver (CUDA kernel on a card, plain
PyTorch on the CPU); "auto" and "python" are host routes that svim_tpu
already implements without any framework, so they are imported.
"""

from __future__ import annotations

from svim_tpu.cluster.edit_distance import (
    batch_edit_distances as host_batch_edit_distances,
)


def batch_edit_distances(pairs, device, backend: str = "auto",
                         band_hints=None):
    """Exact edit distances for many (a, b) pairs; `device` is where the
    wavefront route runs."""
    if backend == "wavefront":
        from svim_tpu_torch.ops.wavefront_kernel import batched_edit_distance
        return batched_edit_distance(pairs, device, initial_band=128,
                                     band_hints=band_hints)
    return host_batch_edit_distances(pairs, backend, band_hints=band_hints)
