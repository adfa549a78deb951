"""Functional density and sampling API.

Counterpart of `pymc_tpu/functions.py` (:47-117; reference
pymc/logprob/basic.py:105,206,307,372 pm.logp, pm.logcdf, pm.logccdf,
pm.icdf, and pymc/sampling/forward.py:397 pm.draw): each dispatches on a
Distribution, a random-variable node or a random expression, whose
distribution the logprob engine derives (`distributions/transformed.py`:
an invertible elementwise chain over one random variable, a fold of one,
or a structural form: censoring, rounding, a join, an index or switch
mixture, a matmul, ...; random variables named in `env` are conditioned
on). `draw` of an expression (a Deterministic) draws its random ancestors
and evaluates it.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import floatX, resolve_device
from .distributions.distribution import Distribution
from .distributions.transformed import conditioned_on, dist_from_expression
from .graph import FreeRV, Node, ObservedRV, ancestors, evaluate, place_constants

__all__ = ["logp", "logcdf", "logccdf", "icdf", "draw"]


def _dist_of(rv, env=None):
    if isinstance(rv, Distribution):
        return rv
    if isinstance(rv, (FreeRV, ObservedRV)):
        return rv.dist
    if isinstance(rv, Node):
        # the random variables named in env are constants of this density,
        # as the reference's conditional_logp treats every other valued
        # variable (logprob/basic.py:206)
        with conditioned_on(env.keys() if isinstance(env, dict) else ()):
            return dist_from_expression(rv)
    raise TypeError(
        f"Expected a Distribution or random-variable node, got {type(rv).__name__}."
    )


def _memo(dist, value, memo):
    """`memo`, or the distribution's constants placed on the value's device
    in its float type (float64 for a value that is not a float tensor)."""
    if memo is not None:
        return memo
    v = value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
    dtype = v.dtype if v.is_floating_point() else torch.float64
    return place_constants(dist.inputs(), v.device, dtype)


def logp(rv, value, env=None, memo=None):
    """Elementwise log-density of `rv` at `value`."""
    dist = _dist_of(rv, env)
    return dist.logp(value, env, _memo(dist, value, memo))


def logcdf(rv, value, env=None, memo=None):
    """Elementwise log of the cdf of `rv` at `value`."""
    dist = _dist_of(rv, env)
    return dist.logcdf(value, env, _memo(dist, value, memo))


def logccdf(rv, value, env=None, memo=None):
    """Elementwise log of the survival function of `rv` at `value`."""
    dist = _dist_of(rv, env)
    return dist.logccdf(value, env, _memo(dist, value, memo))


def icdf(rv, q, env=None, memo=None):
    """The quantile function of `rv` at `q`; NaN for q outside [0, 1]."""
    dist = _dist_of(rv, env)
    return dist.icdf(q, env, _memo(dist, q, memo))


def draw(rv, draws=1, random_seed=None, device=None):
    """`draws` draws of a distribution, a random variable or an expression
    of random variables (a Deterministic), from a torch.Generator on
    `device` (default: the card) seeded by `random_seed`; shape (draws,
    *shape), or the shape itself for draws=1. A list of variables gives a
    list, each drawn in turn from the same generator."""
    device = resolve_device(device)
    seed = (int(np.random.default_rng().integers(2**30)) if random_seed is None
            else int(random_seed))
    gen = torch.Generator(device=device).manual_seed(seed)
    return _draw(rv, draws, gen, device)


def _random_ancestors(node):
    return [a for a in ancestors([node]) if isinstance(a, (FreeRV, ObservedRV))]


def _draw(rv, draws, gen, device):
    if isinstance(rv, (list, tuple)):
        return [_draw(r, draws, gen, device) for r in rv]
    if isinstance(rv, Node) and not (isinstance(rv, (FreeRV, ObservedRV))
                                     and len(_random_ancestors(rv)) == 1):
        return _draw_expression(rv, draws, gen, device)
    dist = _dist_of(rv)
    memo = place_constants(dist.inputs(), device, floatX(device))
    return dist.sample(gen, () if draws == 1 else (draws,), {}, memo)


def _draw_expression(node, draws, gen, device):
    """Draw the random ancestors of `node` in dependency order and evaluate
    it, once a draw (vmapped with its own random numbers a draw); an
    observed variable is drawn at its data's shape. `pymc_tpu`'s draw
    raises for a random variable with random parents; the port draws it
    with them (reference forward.py:397)."""
    from .sampling.forward import draw_rv, rv_order

    order = rv_order(_random_ancestors(node))
    placed = place_constants([node], device, floatX(device))

    def one(_):
        env, memo = {}, dict(placed)
        for rv in order:
            env[rv.name] = memo[id(rv)] = draw_rv(rv, gen, env, memo)
        return evaluate(node, env, memo)

    if draws == 1:
        return one(None)
    return torch.func.vmap(one, randomness="different")(torch.empty(draws, device=device))
