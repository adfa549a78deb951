"""Default float type per device, and device resolution.

Counterpart of `pymc_tpu/config.py`. The JAX package picks float64 through
JAX's x64 mode; here the float type follows the device: float64 on the CPU
(the parity tests compare against the JAX package in x64), float32 on the
card, where the samplers run. The default device is the card: a caller that
means the CPU says `device="cpu"`. The integer type of discrete values,
`intX()`, is int64 on every device, as the JAX package's is in x64 mode.
"""

from __future__ import annotations

import torch

__all__ = ["floatX", "intX", "resolve_device", "config"]


class _Config:
    """Global switches (pymc_tpu/config.py). check_bounds: the
    distributions' parameter checks (-inf, or NaN for a quantile, where a
    parameter is invalid); `Model(check_bounds=False)` turns them off while
    its densities are evaluated."""

    def __init__(self):
        self.check_bounds = True

    def __repr__(self):
        return f"Config(check_bounds={self.check_bounds})"


config = _Config()


def floatX(device=None) -> torch.dtype:
    """Default float type for `device` (default: the card): float32 on CUDA,
    float64 elsewhere."""
    return torch.float32 if resolve_device(device).type == "cuda" else torch.float64


def intX() -> torch.dtype:
    """Integer type of discrete values: int64 on every device."""
    return torch.int64


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device (default: `cuda`, the card).

    Asking for `cuda`, or for nothing, where no card is visible raises; there
    is no fallback to the CPU. On the card, float32 matrix products are
    pinned to full float32 precision (TF32 off), so the card's numbers are
    comparable with the CPU's at float32 tolerances.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() "
                "is False"
            )
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return device
