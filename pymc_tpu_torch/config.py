"""Default float type per device, and device resolution.

Counterpart of `pymc_tpu/config.py`. The JAX package picks float64 through
JAX's x64 mode; here the float type follows the device: float64 on the CPU
(the parity tests compare against the JAX package in x64), float32 on the
card, where the samplers run.
"""

from __future__ import annotations

import torch

__all__ = ["floatX", "resolve_device"]


def floatX(device=None) -> torch.dtype:
    """Default float type for `device`: float32 on CUDA, float64 elsewhere."""
    return torch.float32 if resolve_device(device).type == "cuda" else torch.float64


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device (default: the CPU).

    Asking for `cuda` where no card is visible raises instead of falling back
    to the CPU. On the card, float32 matrix products are pinned to full
    float32 precision (TF32 off), so the card's numbers are comparable with
    the CPU's at float32 tolerances.
    """
    device = torch.device("cpu" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() "
                "is False"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
