"""Device selection for the port.

The device is picked ONCE (by the CLI) and passed down explicitly to every
stage and op.  The port runs on the card: without a visible CUDA device
`select_device` raises unless the caller asked for the CPU, with
`--device_backend cpu` or with `SVIM_TORCH_DEVICE=cpu` (the port's
counterpart of JAX_PLATFORMS), as the tests do.  It never falls back on
its own.
"""

from __future__ import annotations

import os

import torch


def select_device(device_backend: str = "auto",
                  distributed: bool = False) -> torch.device:
    """The device for --device_backend `device_backend`: the current CUDA
    device (with `distributed`, the rank's card, made current) under "auto"
    and "host" (which only moves COLLECT and GENOTYPE to the record-based
    host paths); the CPU under "cpu" or when SVIM_TORCH_DEVICE=cpu asks for
    it.  "tpu" is refused: the port has no
    TPU backend.  Raises RuntimeError when no card is visible and the CPU
    was not asked for."""
    if device_backend == "tpu":
        raise ValueError("--device_backend tpu: svim_tpu_torch has no TPU "
                         "backend; use --device_backend auto (the CUDA card) "
                         "or cpu, or run the svim_tpu package")
    if device_backend not in ("auto", "cpu", "host"):
        raise ValueError("unknown --device_backend {0!r}".format(
            device_backend))
    requested = os.environ.get("SVIM_TORCH_DEVICE", "").strip().lower()
    if requested not in ("", "cuda", "cpu"):
        raise ValueError("SVIM_TORCH_DEVICE must be 'cuda' or 'cpu', got "
                         "{0!r}".format(requested))
    if requested == "cpu" or device_backend == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA device; svim_tpu_torch runs on "
                           "the card unless --device_backend cpu or "
                           "SVIM_TORCH_DEVICE=cpu asks for the CPU")
    if distributed:
        rank = int(os.environ.get("SVIM_PROCESS_ID", "0"))
        torch.cuda.set_device(rank % torch.cuda.device_count())
    return torch.device("cuda", torch.cuda.current_device())


def describe(device: torch.device) -> str:
    if device.type == "cuda":
        return "{0} ({1})".format(device, torch.cuda.get_device_name(device))
    return str(device)
