"""Initial points for samplers.

Counterpart of `pymc_tpu/initial_point.py` (reference pymc/initial_point.py):
each free RV starts at its initval where the model has one (or where the
call overrides it), else at its distribution's support point, mapped to the
unconstrained space, and every chain adds U(-jitter, jitter) noise there.
The retry of the reference's _init_jitter (sampling/mcmc.py:1695) is
vectorised: every chain draws `jitter_max_retries` candidates at once and
keeps the first with a finite logp.
"""

from __future__ import annotations

import numpy as np
import torch

from .blocking import ravel_point
from .config import floatX, resolve_device
from .graph import FreeRV, Node, ObservedRV, ancestors, evaluate

__all__ = ["support_point_values", "make_initial_points_per_chain"]


def _strategy_value(rv, strategy, env, memo, generator):
    """The constrained initial value of `rv` under `strategy`: a value, a
    Node with no random ancestor, "support_point" (or its old name
    "moment") or "prior" (a draw from `generator`, a CPU generator)."""
    if isinstance(strategy, str):
        if strategy in ("support_point", "moment"):
            return rv.dist.support_point(env, memo)
        if strategy == "prior":
            if generator is None:
                raise ValueError(f"initval 'prior' for {rv.name!r} needs a generator")
            return rv.dist.sample(generator, (), env, memo)
        raise ValueError(f"Unknown initval strategy {strategy!r} for {rv.name!r}")
    if isinstance(strategy, Node):
        if any(isinstance(n, (FreeRV, ObservedRV)) for n in ancestors([strategy])):
            raise ValueError(
                f"Initial value of {rv.name} depends on other random variables; that is "
                "not supported (reference initial_point contract)."
            )
        strategy = evaluate(strategy)
    return torch.broadcast_to(torch.as_tensor(np.asarray(strategy)), rv.shape)


def support_point_values(model, overrides=None, generator=None):
    """{value_name: unconstrained initial value} in registration order, on
    the CPU in float64: each free RV's initval (given in the constrained
    space, pymc_tpu initial_point.py:26-28; `overrides`, keyed by rv or
    value name, win over the model's) or else its support point."""
    strategies = dict(model.rvs_to_initial_values)
    strategies.update(overrides or {})
    env = {}
    values = {}
    memo = {}
    for rv in model.free_RVs:
        strategy = strategies.get(rv.name, strategies.get(rv.value_name, "support_point"))
        x = _strategy_value(rv, strategy, env, memo, generator).to(torch.float64)
        env[rv.name] = x
        values[rv.value_name] = rv.transform.forward(x, env, memo) if rv.transform else x
    return values


def make_initial_points_per_chain(model, logp_fn, chains, generator, device=None,
                                  dtype=None, jitter=1.0, overrides=None,
                                  jitter_max_retries=10):
    """(chains, D) flat starting points on `device` (default: the card) in
    `dtype` (default: `floatX(device)`): the initial point plus U(-jitter,
    jitter) noise on the continuous entries (a discrete free RV keeps its
    initial value, pymc_tpu/initial_point.py:106), the first of
    `jitter_max_retries` candidates per chain with a finite logp (the
    initial point itself if none is). jitter=0 (the
    adapt_diag and adapt_full inits) gives every chain the initial point.
    `overrides` are initvals, as `support_point_values` takes them. logp_fn
    maps a (N, D) batch of flat points to (N,) logps."""
    device = resolve_device(device)
    dtype = dtype or floatX(device)
    info = model.raveled_info()
    cpu_gen = None
    if any(v == "prior" for v in {**model.rvs_to_initial_values, **(overrides or {})}.values()
           if isinstance(v, str)):
        seed = torch.randint(2**62, (1,), generator=generator, device=device)
        cpu_gen = torch.Generator().manual_seed(int(seed))
    base = ravel_point(support_point_values(model, overrides, cpu_gen), info).to(
        device=device, dtype=dtype)
    if not jitter:
        return base.expand(chains, -1).clone()
    R = int(jitter_max_retries)
    u = torch.rand(
        (chains * R, base.shape[0]), generator=generator, device=device, dtype=dtype
    )
    continuous = torch.cat([
        torch.full((size,), not rv.dist.is_discrete, device=device)
        for rv, size in zip(model.free_RVs, info.sizes)
    ])
    cands = base + torch.where(continuous, jitter * (2.0 * u - 1.0), 0.0)
    finite = torch.isfinite(logp_fn(cands)).reshape(chains, R)
    first = torch.argmax(finite.to(torch.int8), dim=1)
    picked = cands.reshape(chains, R, -1)[torch.arange(chains, device=device), first]
    return torch.where(finite.any(dim=1)[:, None], picked, base)
