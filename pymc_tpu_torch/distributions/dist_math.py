"""Numeric helpers shared by distribution log-densities.

Counterpart of `pymc_tpu/distributions/dist_math.py`, cut to what Normal and
HalfCauchy use. Everything is a tensor operation with no host branch on a
value, so `torch.func.vmap` runs through it.
"""

from __future__ import annotations

import torch

__all__ = ["check_parameters", "log_normal"]

_LOG_SQRT_2PI = 0.9189385332046727  # log(sqrt(2*pi))


def check_parameters(logp, *conditions):
    """Return -inf where any parameter condition fails (the reference raises
    ParameterValueError, dist_math.py:50; -inf is sampler-safe)."""
    ok = conditions[0]
    for c in conditions[1:]:
        ok = ok & c
    return torch.where(ok, logp, -torch.inf)


def log_normal(x, mean, std):
    """log N(x | mean, std^2)."""
    return -0.5 * ((x - mean) / std) ** 2 - torch.log(std) - _LOG_SQRT_2PI
