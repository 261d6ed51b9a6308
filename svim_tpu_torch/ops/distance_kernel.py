"""Batched span-position distance matrices.

Counterpart of svim_tpu/ops/distance_kernel.py: per partition, the (P, P)
float32 matrix |Δcenter|/norm + |Δspan|/max(span, 1), with center =
(start+end)//2 and span = end−start; same-read off-diagonal pairs (when
`wall_same_read`) and pairs with an invalid slot get BIG.

Three layers, on the pattern of ops/wavefront_kernel.py:
  * `span_position_matrix_torch` — the plain PyTorch version, a
    line-for-line port of the jnp `span_position_matrix`; runs on any
    device and equals the jnp twin bit for bit on the CPU.
  * `span_position_matrix_cuda` — the wrapper of the hand-written CUDA
    kernel (csrc/span_distance.cu: a persistent grid, a partition staged
    once in shared memory, four columns a thread in registers, 16-byte
    streaming stores), bit-identical to the plain version, counted in
    `LAUNCHES`.
  * `span_position_matrix` — the dispatcher: a CPU tensor takes the plain
    version, a CUDA tensor the kernel.

No entry point calls it: as in the JAX package, the production CLUSTER
stage builds its matrices inside span_position_agglomerate_batched
(ops/linkage_kernel.py), and this kernel is the standalone distance
contract that a hand kernel of that op can build on.
"""

from __future__ import annotations

import ctypes

import torch

from svim_tpu_torch.ops._build import check_launch

BIG = 99999.0

LAUNCHES = 0   # kernel launches by span_position_matrix_cuda


def span_position_matrix_torch(starts, ends, read_ids, valid,
                               position_distance_normalizer,
                               wall_same_read: bool = True):
    """(B, P) int32 starts/ends/read_ids and bool valid -> (B, P, P)
    float32 distances on the inputs' device.

    The normalizer is divided as a float32 tensor of one element, never as
    a scalar: PyTorch's CUDA division multiplies by the reciprocal of a
    scalar divisor, which rounds differently from the jnp twin's division."""
    device = starts.device
    starts = starts.to(torch.int32)
    ends = ends.to(torch.int32)
    centers = torch.div(starts + ends, 2, rounding_mode="floor")
    spans = ends - starts
    delta_center = (centers[:, :, None] - centers[:, None, :]).abs()
    delta_span = (spans[:, :, None] - spans[:, None, :]).abs()
    max_span = torch.maximum(spans[:, :, None], spans[:, None, :])
    norm = torch.full((1, 1, 1), float(position_distance_normalizer),
                      dtype=torch.float32, device=device)
    distance = (delta_center.to(torch.float32) / norm
                + delta_span.to(torch.float32)
                / max_span.clamp_min(1).to(torch.float32))
    pair_valid = valid[:, :, None] & valid[:, None, :]
    big = torch.tensor(BIG, dtype=torch.float32, device=device)
    if wall_same_read:
        same_read = read_ids[:, :, None] == read_ids[:, None, :]
        eye = torch.eye(starts.shape[1], dtype=torch.bool, device=device)[None]
        distance = torch.where(same_read & ~eye, big, distance)
    return torch.where(pair_valid, distance, big)


VARIANTS = {None: 0, "vector": 1, "scalar": 2}


_library = None


def _kernel_library():
    global _library
    if _library is None:
        from svim_tpu_torch.ops._build import load

        library = load("span_distance")
        library.span_distance_matrix.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        library.span_distance_matrix.restype = ctypes.c_int
        _library = library
    return _library


def span_position_matrix_cuda(starts, ends, read_ids, valid,
                              position_distance_normalizer,
                              wall_same_read: bool = True, variant=None):
    """span_position_matrix on the card through csrc/span_distance.cu.

    starts, ends, read_ids: (B, P) int32 contiguous CUDA tensors; valid:
    (B, P) bool on the same device.  Returns (B, P, P) float32 on that
    device, equal to span_position_matrix_torch entry for entry.  The
    kernel takes 16-byte stores when P is a multiple of 4 and scalar stores
    otherwise; `variant` "vector" insists on the former (refused for another
    P) and "scalar" forces the latter, for the tests."""
    global LAUNCHES
    if variant not in VARIANTS:
        raise ValueError("variant must be one of {0}".format(
            sorted(key for key in VARIANTS if key)))
    if variant == "vector" and starts.shape[-1] % 4:
        raise ValueError("16-byte stores need P to be a multiple of 4, got "
                         "P={0}".format(starts.shape[-1]))
    device = starts.device
    if device.type != "cuda":
        raise ValueError("span_position_matrix_cuda needs CUDA tensors")
    for name, tensor, dtype in (("starts", starts, torch.int32),
                                ("ends", ends, torch.int32),
                                ("read_ids", read_ids, torch.int32),
                                ("valid", valid, torch.bool)):
        if tensor.device != device:
            raise ValueError("{0} is on {1}, expected {2}".format(
                name, tensor.device, device))
        if tensor.dtype != dtype or tensor.shape != starts.shape \
                or tensor.dim() != 2:
            raise ValueError("{0} must be a (B, P) {1} tensor like starts "
                             "{2}, got {3} {4}".format(
                                 name, dtype, tuple(starts.shape),
                                 tuple(tensor.shape), tensor.dtype))
        if not tensor.is_contiguous():
            raise ValueError("{0} must be contiguous".format(name))
    batch, p = starts.shape
    out = torch.empty((batch, p, p), dtype=torch.float32, device=device)
    if batch == 0 or p == 0:
        return out
    with torch.cuda.device(device):
        code = _kernel_library().span_distance_matrix(
            starts.data_ptr(), ends.data_ptr(), read_ids.data_ptr(),
            valid.data_ptr(), out.data_ptr(), batch, p,
            float(position_distance_normalizer), int(bool(wall_same_read)),
            VARIANTS[variant], torch.cuda.current_stream(device).cuda_stream)
    check_launch("span distance", code)
    LAUNCHES += 1
    return out


def span_position_matrix(starts, ends, read_ids, valid,
                         position_distance_normalizer,
                         wall_same_read: bool = True):
    """Dispatcher: CPU tensors -> plain version, CUDA tensors -> kernel."""
    if starts.device.type == "cpu":
        return span_position_matrix_torch(starts, ends, read_ids, valid,
                                          position_distance_normalizer,
                                          wall_same_read)
    if starts.device.type == "cuda":
        return span_position_matrix_cuda(starts, ends, read_ids, valid,
                                         position_distance_normalizer,
                                         wall_same_read)
    raise ValueError("no span distance kernel for device {0}".format(
        starts.device))
