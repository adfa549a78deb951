"""Functional density and sampling API.

Counterpart of `pymc_tpu/functions.py` (:47-117; reference
pymc/logprob/basic.py:105,206,307,372 pm.logp, pm.logcdf, pm.logccdf,
pm.icdf, and pymc/sampling/forward.py:397 pm.draw): each dispatches on a
Distribution or a random-variable node.

Left out against the JAX package, raising NotImplementedError with the
ROADMAP item it waits for: the density, cdf or quantile of a derived
expression, an invertible elementwise transform of one random variable
(the item on the logprob engine, `distributions/transformed.py`). `draw`
of an expression (a Deterministic) works: its random ancestors are drawn
and it is evaluated.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import floatX, resolve_device
from .distributions.distribution import Distribution
from .graph import FreeRV, Node, ObservedRV, ancestors, evaluate, place_constants

__all__ = ["logp", "logcdf", "logccdf", "icdf", "draw"]


def _dist_of(rv):
    if isinstance(rv, Distribution):
        return rv
    if isinstance(rv, (FreeRV, ObservedRV)):
        return rv.dist
    if isinstance(rv, Node):
        raise NotImplementedError(
            "The density of a derived expression is not ported to pymc_tpu_torch yet: it "
            "waits for the logprob engine (distributions/transformed.py, the ROADMAP item on "
            "the logprob engine)"
        )
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
    dist = _dist_of(rv)
    return dist.logp(value, env, _memo(dist, value, memo))


def logcdf(rv, value, env=None, memo=None):
    """Elementwise log of the cdf of `rv` at `value`."""
    dist = _dist_of(rv)
    return dist.logcdf(value, env, _memo(dist, value, memo))


def logccdf(rv, value, env=None, memo=None):
    """Elementwise log of the survival function of `rv` at `value`."""
    dist = _dist_of(rv)
    return dist.logccdf(value, env, _memo(dist, value, memo))


def icdf(rv, q, env=None, memo=None):
    """The quantile function of `rv` at `q`; NaN for q outside [0, 1]."""
    dist = _dist_of(rv)
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
    if isinstance(rv, Node) and _random_ancestors(rv) != [rv]:
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
