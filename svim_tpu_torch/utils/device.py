"""Device selection for the port.

The device is picked ONCE (by the CLI) and passed down explicitly to every
stage and op.  The port runs on the card: without a visible CUDA device
`select_device` raises unless the caller asked for the CPU with
`SVIM_TORCH_DEVICE=cpu` (the port's counterpart of JAX_PLATFORMS), as the
tests do.  It never falls back on its own.
"""

from __future__ import annotations

import os

import torch


def select_device() -> torch.device:
    """The current CUDA device; `cpu` only when SVIM_TORCH_DEVICE=cpu asks
    for it.  Raises RuntimeError when no card is visible and the CPU was
    not asked for."""
    requested = os.environ.get("SVIM_TORCH_DEVICE", "").strip().lower()
    if requested not in ("", "cuda", "cpu"):
        raise ValueError("SVIM_TORCH_DEVICE must be 'cuda' or 'cpu', got "
                         "{0!r}".format(requested))
    if requested == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("torch sees no CUDA device; svim_tpu_torch runs on "
                           "the card unless SVIM_TORCH_DEVICE=cpu asks for "
                           "the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def describe(device: torch.device) -> str:
    if device.type == "cuda":
        return "{0} ({1})".format(device, torch.cuda.get_device_name(device))
    return str(device)
