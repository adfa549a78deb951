"""Initial points for samplers.

Counterpart of `pymc_tpu/initial_point.py` (reference pymc/initial_point.py):
each free RV starts at its initval where the model has one, else at its
distribution's support point, mapped to the unconstrained space, and every
chain adds U(-1, 1) noise there.
The retry of the reference's _init_jitter (sampling/mcmc.py:1695) is
vectorised: every chain draws 10 candidates at once and keeps the first
with a finite logp.
"""

from __future__ import annotations

import numpy as np
import torch

from .blocking import ravel_point
from .config import floatX, resolve_device

__all__ = ["support_point_values", "make_initial_points_per_chain"]


def support_point_values(model):
    """{value_name: unconstrained initial value} in registration order, on
    the CPU in float64: each free RV's initval (given in the constrained
    space, pymc_tpu initial_point.py:26-28) or else its support point."""
    env = {}
    values = {}
    memo = {}
    for rv in model.free_RVs:
        if rv.name in model.rvs_to_initial_values:
            x = torch.broadcast_to(
                torch.as_tensor(np.asarray(model.rvs_to_initial_values[rv.name])), rv.shape
            )
        else:
            x = rv.dist.support_point(env, memo)
        x = x.to(torch.float64)
        env[rv.name] = x
        values[rv.value_name] = rv.transform.forward(x, env) if rv.transform else x
    return values


_RETRIES = 10


def make_initial_points_per_chain(model, logp_fn, chains, generator, device=None,
                                  dtype=None):
    """(chains, D) flat starting points on `device` (default: the card) in
    `dtype` (default: `floatX(device)`): the support point plus U(-1, 1)
    jitter, the first of `_RETRIES` candidates per chain with a finite logp
    (the support point itself if none is). logp_fn maps a (N, D) batch of
    flat points to (N,) logps."""
    device = resolve_device(device)
    dtype = dtype or floatX(device)
    info = model.raveled_info()
    base = ravel_point(support_point_values(model), info).to(device=device, dtype=dtype)
    R = _RETRIES
    u = torch.rand(
        (chains * R, base.shape[0]), generator=generator, device=device, dtype=dtype
    )
    cands = base + (2.0 * u - 1.0)
    finite = torch.isfinite(logp_fn(cands)).reshape(chains, R)
    first = torch.argmax(finite.to(torch.int8), dim=1)
    picked = cands.reshape(chains, R, -1)[torch.arange(chains, device=device), first]
    return torch.where(finite.any(dim=1)[:, None], picked, base)
