"""Numeric helpers shared by distribution log-densities.

Counterpart of `pymc_tpu/distributions/dist_math.py`, cut to what the ported
distributions use. Everything is a tensor operation with no host branch on a
value, so `torch.func.vmap` runs through it.
"""

from __future__ import annotations

import torch

__all__ = ["check_parameters", "gammainc", "log_normal", "logpow", "safe_log", "softplus"]

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


def _sum_to(grad, shape):
    """Sum a broadcast gradient back to an operand's shape."""
    while grad.ndim > len(shape):
        grad = grad.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and grad.shape[i] != 1:
            grad = grad.sum(i, keepdim=True)
    return grad


_GAMMAINC_TERMS = 400


class _GammaInc(torch.autograd.Function):
    """The regularized lower incomplete gamma P(a, x) with gradients in both
    arguments (torch's has none in a). d/da from the series P = x^a e^-x
    sum_n x^n / Gamma(a + n + 1): sum_n term_n (log x - digamma(a + n + 1)),
    whose terms fall geometrically once n > x, in float64."""

    @staticmethod
    def forward(ctx, a, x):
        ctx.save_for_backward(a, x)
        return torch.special.gammainc(a, x)

    @staticmethod
    def backward(ctx, g):
        a, x = ctx.saved_tensors
        a_b, x_b = torch.broadcast_tensors(a, x)
        a64, x64 = a_b.double(), torch.clamp(x_b.double(), min=1e-300)
        log_x = torch.log(x64)
        d_x = torch.exp((a64 - 1.0) * log_x - x64 - torch.lgamma(a64))
        n = torch.arange(_GAMMAINC_TERMS, dtype=torch.float64, device=a.device)
        an = a64[..., None] + n + 1.0
        log_term = (a64[..., None] + n) * log_x[..., None] - x64[..., None] - torch.lgamma(an)
        d_a = torch.sum(torch.exp(log_term) * (log_x[..., None] - torch.digamma(an)), dim=-1)
        d_a = torch.where(x_b > 0, d_a, 0.0)
        d_x = torch.where(x_b > 0, d_x, 0.0)
        return (_sum_to((g * d_a).to(a.dtype), a.shape),
                _sum_to((g * d_x).to(x.dtype), x.shape))


def gammainc(a, x):
    """P(a, x), differentiable in a and x (series for d/da: x up to about
    a hundred)."""
    return _GammaInc.apply(a, x)
