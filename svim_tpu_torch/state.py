"""State that crosses between svim_tpu and the port, and device fetches.

The system has no weights.  What crosses from the JAX package into the port
is the packed alignment batch (numpy columns of svim_tpu.io.packing.
PackedAlignments) and the genotype table; `packed_to_torch` turns the
former into the port's tensors, so a test can feed both packages the same
batch.  `to_host` is the port's counterpart of jax.device_get: one walk
over an output tree that brings every tensor back as numpy, and where the
CLI's paths wait on the card for results.
"""

from __future__ import annotations

import numpy as np
import torch

from svim_tpu_torch.utils import timing


def packed_to_torch(packed, device):
    """{cigar_words (N, K) int32, ref_id, ref_start (N,) int32, is_reverse
    (N,) bool} tensors on `device` from a PackedAlignments batch."""
    def column(values, dtype):
        return torch.from_numpy(np.ascontiguousarray(values, dtype=dtype)).to(
            device)

    return {"cigar_words": column(packed.cigar_words, np.int32),
            "ref_id": column(packed.ref_id, np.int32),
            "ref_start": column(packed.ref_start, np.int32),
            "is_reverse": column(packed.is_reverse, np.bool_)}


def to_host(tree):
    """Tensors -> numpy arrays through tuples, lists and dicts (None and
    other leaves pass through).  Each call is a `fetch` span of the running
    stage and adds to the job's counts `fetches` and `fetch_bytes`."""
    with timing.span("fetch"):
        host = _to_host(tree)
    if timing.counting():
        timing.count("fetches")
        timing.count("fetch_bytes", _nbytes(tree))
    return host


def _to_host(tree):
    if torch.is_tensor(tree):
        return tree.cpu().numpy()
    if isinstance(tree, tuple):
        return tuple(_to_host(item) for item in tree)
    if isinstance(tree, list):
        return [_to_host(item) for item in tree]
    if isinstance(tree, dict):
        return {key: _to_host(value) for key, value in tree.items()}
    return tree


def _nbytes(tree):
    """Bytes of the tensors of an output tree."""
    if torch.is_tensor(tree):
        return tree.nbytes
    if isinstance(tree, (tuple, list)):
        return sum(_nbytes(item) for item in tree)
    if isinstance(tree, dict):
        return sum(_nbytes(value) for value in tree.values())
    return 0
