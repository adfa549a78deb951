"""Utility functions.

Counterpart of `pymc_tpu/func_utils.py` (reference pymc/func_utils.py:31,
find_constrained_prior: fit a distribution's parameters so that a given
probability mass lies within bounds). The optimizer is scipy's on the
host, as in the JAX package; the loss and its gradient are torch's, in
float64 on the CPU (a few scalars: nothing here is worth the card). It
needs the distribution's `logcdf` (ported for Normal, HalfNormal and
Gamma).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

__all__ = ["find_constrained_prior"]

_log = logging.getLogger("pymc_tpu_torch")


def find_constrained_prior(distribution, lower, upper, init_guess, mass=0.95, fixed_params=None,
                           mass_below_lower=None):
    """{param name: value} for the free parameters (`init_guess`'s keys,
    starting there) that put `mass` of `distribution` between `lower` and
    `upper`, `mass_below_lower` of it below `lower` (default: half the
    rest). `fixed_params` are held fixed."""
    from scipy import optimize

    fixed_params = dict(fixed_params or {})
    names = list(init_guess.keys())
    if mass_below_lower is None:
        mass_below_lower = (1.0 - mass) / 2.0
    target_lower = mass_below_lower
    target_upper = mass_below_lower + mass
    bounds = torch.tensor([lower, upper], dtype=torch.float64)

    def loss_fn(vals):
        d = distribution.dist(**fixed_params, **dict(zip(names, vals)))
        cdf = torch.exp(d.logcdf(bounds))
        return (cdf[0] - target_lower) ** 2 + (cdf[1] - target_upper) ** 2

    def f(v):
        v = torch.tensor(v, dtype=torch.float64, requires_grad=True)
        val = loss_fn(list(v))
        (g,) = torch.autograd.grad(val, v)
        return float(val.detach()), g.numpy()

    x0 = np.asarray([init_guess[n] for n in names], dtype=np.float64)
    res = optimize.minimize(f, x0, jac=True, method="L-BFGS-B")
    if res.fun > 1e-6:
        # L-BFGS-B's unit-norm first trial can land on a degenerate boundary
        # (e.g. sigma = 0) and stall at x0; Nelder-Mead is robust for the
        # few parameters here
        res_nm = optimize.minimize(lambda v: f(v)[0], x0, method="Nelder-Mead",
                                   options={"xatol": 1e-10, "fatol": 1e-12, "maxiter": 5000})
        if res_nm.fun < res.fun:
            res = res_nm
    if res.fun > 1e-5:
        _log.warning(f"find_constrained_prior converged to loss {res.fun:.2g}; the requested "
                     "mass may not be achievable with this distribution.")
    return {n: float(v) for n, v in zip(names, res.x)}
