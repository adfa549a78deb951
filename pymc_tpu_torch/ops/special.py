"""Modified Bessel functions of real order, in plain PyTorch.

Counterpart of `pymc_tpu/ops/special.py` (:32-106), which the JAX package
computes outside any Pallas kernel: `pm.math.iv`/`kv` reach them. The
algorithm is the JAX package's:

- I_v: for x below a cut (25 in float64, 12 in float32) the power series
  (x/2)^v sum_k (x^2/4)^k / (k! Gamma(v+k+1)) by its term recurrence, 40
  terms; above it the 12-term asymptotic expansion
  e^x / sqrt(2 pi x) sum_k (-1)^k a_k(v) / (8x)^k. Negative orders by the
  reflection I_{-v} = I_v + (2/pi) sin(pi v) K_v (DLMF 10.27.2).
- K_v: the integral K_v(x) = int_0^inf e^{-x cosh t} cosh(v t) dt by the
  trapezoid rule on 250 nodes of step min(0.08, 0.5 / sqrt(max(x, 1))),
  e^{-x} factored out. log cosh(v t) is taken as |v t| + log1p(e^{-2|v t|})
  - log 2, which is the same number where cosh does not overflow and stays
  finite where it would (float32 past v t = 89).

Everything is elementwise tensor code with no host branch on a value, so
gradients in x come from autograd and `torch.func.vmap` runs through it.
torch.special's i0/i1 are not used for orders 0 and 1: the same series
serves every order, as in the JAX package.
"""

from __future__ import annotations

import functools
import math

import torch

__all__ = ["bessel_iv", "bessel_kv"]

_N_SERIES = 40
_N_ASYM = 12
_N_NODES = 250


def _as_float_pair(v, x):
    """v and x as broadcast tensors of one float type: the tensors' (the
    wider of two), float64 for numbers and arrays."""
    floats = [a.dtype for a in (v, x) if isinstance(a, torch.Tensor) and a.is_floating_point()]
    dtype = functools.reduce(torch.promote_types, floats) if floats else torch.float64
    device = next((a.device for a in (v, x) if isinstance(a, torch.Tensor)), None)
    return torch.broadcast_tensors(torch.as_tensor(v, dtype=dtype, device=device),
                                   torch.as_tensor(x, dtype=dtype, device=device))


def _iv_series(v, x):
    """The power series by its term recurrence t_k = t_{k-1} q / (k (v+k)),
    for v > -1 and x below the asymptotic cut."""
    q = 0.25 * x * x
    t = torch.exp(-torch.lgamma(v + 1.0))
    s = t
    for k in range(1, _N_SERIES):
        t = t * q / (k * (v + k))
        s = s + t
    # (x/2)^v with the v = 0, x = 0 corner defined (I_0(0) = 1)
    pref = torch.where((v == 0) & (x == 0), 1.0, torch.exp(v * torch.log(0.5 * x)))
    return pref * s


def _iv_asymptotic(v, x):
    """I_v(x) ~ e^x / sqrt(2 pi x) sum_k (-1)^k a_k(v) / (8x)^k."""
    mu = 4.0 * v * v
    t = torch.ones_like(x)
    s = t
    for k in range(1, _N_ASYM):
        t = -t * (mu - (2.0 * k - 1.0) ** 2) / (k * 8.0 * x)
        s = s + t
    return torch.exp(x) / torch.sqrt(2.0 * math.pi * x) * s


def _iv_nonneg(v, x):
    cut = 25.0 if x.dtype == torch.float64 else 12.0
    return torch.where(
        x < cut,
        _iv_series(v, torch.clamp(x, max=cut)),
        _iv_asymptotic(v, torch.clamp(x, min=cut)),
    )


def _log_cosh(y):
    a = torch.abs(y)
    return a + torch.log1p(torch.exp(-2.0 * a)) - math.log(2.0)


def _kv(v, x):
    v = torch.abs(v)  # K_{-v} = K_v
    # the step shrinks with x: for large x the integrand is a Gaussian of
    # width ~1/sqrt(x) around t = 0
    h = torch.clamp(0.5 / torch.sqrt(torch.clamp(x, min=1.0)), max=0.08)
    nodes = torch.arange(_N_NODES, dtype=x.dtype, device=x.device)
    t = nodes * h[..., None]
    w = torch.where(nodes == 0, 0.5, 1.0) * h[..., None]
    expo = -x[..., None] * (torch.cosh(t) - 1.0) + _log_cosh(v[..., None] * t)
    s = torch.sum(w * torch.exp(expo), dim=-1)
    return torch.where(x > 0, torch.exp(-x) * s, torch.inf)


def bessel_iv(v, x):
    """Modified Bessel function of the first kind I_v(x), real order v."""
    v, x = _as_float_pair(v, x)
    av = torch.abs(v)
    pos = _iv_nonneg(av, x)
    refl = pos + (2.0 / math.pi) * torch.sin(math.pi * av) * _kv(av, x)
    return torch.where(v >= 0, pos, refl)


def bessel_kv(v, x):
    """Modified Bessel function of the second kind K_v(x), real order v."""
    v, x = _as_float_pair(v, x)
    return _kv(v, x)
