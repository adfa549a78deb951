"""Numeric helpers shared by distribution log-densities.

Counterpart of `pymc_tpu/distributions/dist_math.py`, cut to what the ported
distributions use. Everything is a tensor operation with no host branch on a
value, so `torch.func.vmap` runs through it.
"""

from __future__ import annotations

import torch

__all__ = ["check_parameters", "log_normal", "logpow", "safe_log", "softplus"]

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


def safe_log(x):
    """log x, -inf where x <= 0, with a NaN-free gradient there (reference
    dist_math.py:72)."""
    safe = torch.where(x > 0, x, 1.0)
    return torch.where(x > 0, torch.log(safe), -torch.inf)


def softplus(x):
    """log(1 + e^x) as logaddexp(x, 0), the JAX package's `jax.nn.softplus`
    (torch's own returns x itself above x = 20, 2e-9 off there)."""
    return torch.logaddexp(x, x.new_zeros(()))


def logpow(x, m):
    """m * log(x) with the convention 0**0 = 1 (reference dist_math.py:92).
    x == 0 with m > 0 gives -inf; the double where keeps the gradient
    NaN-free."""
    is_zero = x == 0
    log_x = torch.where(is_zero, -torch.inf, torch.log(torch.where(is_zero, 1.0, x)))
    return torch.where(m == 0, 0.0, m * log_x)
