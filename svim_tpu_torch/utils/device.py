"""Device selection for the port.

The device is picked ONCE (by the CLI) and passed down explicitly to every
stage and op.  `SVIM_TORCH_DEVICE=cuda|cpu` overrides the choice — the
port's counterpart of JAX_PLATFORMS; asking for `cuda` where there is no
card raises instead of falling back.
"""

from __future__ import annotations

import os

import torch


def select_device() -> torch.device:
    """`cuda` when a card is visible, else `cpu`; SVIM_TORCH_DEVICE
    overrides."""
    requested = os.environ.get("SVIM_TORCH_DEVICE", "").strip().lower()
    if requested not in ("", "cuda", "cpu"):
        raise ValueError("SVIM_TORCH_DEVICE must be 'cuda' or 'cpu', got "
                         "{0!r}".format(requested))
    if requested == "cpu":
        return torch.device("cpu")
    if requested == "cuda" or torch.cuda.is_available():
        if not torch.cuda.is_available():
            raise RuntimeError("SVIM_TORCH_DEVICE=cuda but torch sees no "
                               "CUDA device")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def describe(device: torch.device) -> str:
    if device.type == "cuda":
        return "{0} ({1})".format(device, torch.cuda.get_device_name(device))
    return str(device)
