"""Optimizers for VI, as plain functions on dicts of tensors.

Counterpart of `pymc_tpu/variational/updates.py` (reference
pymc/variational/updates.py: sgd:187, momentum:287, nesterov_momentum:400,
adagrad:465, adagrad_window:542 — the PyMC default, rmsprop:588,
adadelta:669, adam:773, adamax:860, norm_constraint:944,
total_norm_constraint:1019). The JAX package builds them from optax; each
one here is written out with optax's formulas, which are not
`torch.optim`'s: optax's rmsprop puts eps inside the square root, its
adagrad starts the accumulator at 0.1, adamax adds eps to |g| before the
max, and `clip_by_block_rms` is optax's own.

An optimizer is a `GradientTransformation(init, update)`:
`init(params) -> state`, `update(grads, state, params) -> (updates,
state)`, with params, grads and updates nested dicts of tensors; the new
parameters are `apply_updates(params, updates)`. Every update stays on the
parameters' device.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = [
    "GradientTransformation", "chain", "identity", "apply_updates", "tree_map",
    "tree_leaves", "sgd", "momentum", "nesterov_momentum", "adagrad", "adagrad_window",
    "rmsprop", "adadelta", "adam", "adamax", "get_optimizer", "norm_constraint",
    "total_norm_constraint", "clip_by_global_norm", "apply_momentum",
    "apply_nesterov_momentum",
]


class GradientTransformation(NamedTuple):
    init: Callable
    update: Callable


def tree_map(fn, tree, *rest):
    """fn over the leaves of nested dicts of tensors, in key order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves in sorted key order (jax.tree.leaves' order for dicts)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def apply_updates(params, updates):
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)


def identity():
    return GradientTransformation(lambda params: (), lambda g, state, params=None: (g, state))


def chain(*transforms):
    """Apply `transforms` in order; the state is the tuple of theirs."""

    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new_state = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new_state.append(s)
        return grads, tuple(new_state)

    return GradientTransformation(init, update)


def _scale(step):
    return GradientTransformation(
        lambda params: (), lambda g, state, params=None: (tree_map(lambda x: step * x, g), state)
    )


def _zeros(params):
    return tree_map(torch.zeros_like, params)


def _trace(decay, nesterov=False):
    """optax.trace: t' = g + decay t; the update is t', or with nesterov
    g + decay t'."""

    def update(g, state, params=None):
        new = tree_map(lambda x, t: x + decay * t, g, state)
        out = tree_map(lambda x, t: x + decay * t, g, new) if nesterov else new
        return out, new

    return GradientTransformation(_zeros, update)


def _bias_correction(moment, decay, count):
    return tree_map(lambda t: t / (1 - decay**count), moment)


def sgd(learning_rate=1e-3, **kwargs):
    return _scale(-learning_rate)


def momentum(learning_rate=1e-3, momentum=0.9, **kwargs):
    return chain(_trace(momentum), _scale(-learning_rate))


def nesterov_momentum(learning_rate=1e-3, momentum=0.9, **kwargs):
    return chain(_trace(momentum, nesterov=True), _scale(-learning_rate))


def adagrad(learning_rate=1.0, epsilon=1e-6, **kwargs):
    """optax.adagrad: the sum of squares starts at 0.1; g / sqrt(s + eps)."""

    def update(g, state, params=None):
        s = tree_map(lambda x, t: x * x + t, g, state)
        out = tree_map(
            lambda x, t: torch.where(t > 0, torch.rsqrt(t + epsilon), 0.0) * x, g, s
        )
        return out, s

    def init(params):
        return tree_map(lambda p: torch.full_like(p, 0.1), params)

    return chain(GradientTransformation(init, update), _scale(-learning_rate))


class _AdagradWindowState(NamedTuple):
    buffer: dict
    step: int


def adagrad_window(learning_rate=1e-3, epsilon=0.1, n_win=10, **kwargs):
    """PyMC's default VI optimizer (reference updates.py:542): adagrad over
    a sliding window of the last n_win squared gradients."""

    def init(params):
        buf = tree_map(lambda p: p.new_zeros((n_win,) + tuple(p.shape)), params)
        return _AdagradWindowState(buffer=buf, step=0)

    def update(grads, state, params=None):
        slot = state.step % n_win

        def put(b, g):
            b = b.clone()
            b[slot] = g**2
            return b

        buf = tree_map(put, state.buffer, grads)
        updates = tree_map(
            lambda g, b: -learning_rate * g / (torch.sqrt(torch.sum(b, dim=0)) + epsilon),
            grads, buf,
        )
        return updates, _AdagradWindowState(buffer=buf, step=state.step + 1)

    return GradientTransformation(init, update)


def rmsprop(learning_rate=1e-3, rho=0.9, epsilon=1e-6, **kwargs):
    """optax.rmsprop: nu' = (1 - rho) g^2 + rho nu; g / sqrt(nu' + eps)."""

    def update(g, state, params=None):
        nu = tree_map(lambda x, n: (1 - rho) * x**2 + rho * n, g, state)
        return tree_map(lambda x, n: torch.rsqrt(n + epsilon) * x, g, nu), nu

    return chain(GradientTransformation(_zeros, update), _scale(-learning_rate))


def adadelta(learning_rate=1.0, rho=0.95, epsilon=1e-6, **kwargs):
    """optax.adadelta (weight decay 0): e_g' = (1 - rho) g^2 + rho e_g;
    u = sqrt(e_x + eps) / sqrt(e_g' + eps) g; e_x' = (1 - rho) u^2 + rho e_x."""

    def update(g, state, params=None):
        e_g, e_x = state
        # optax.add_decayed_weights with weight decay 0 comes first: g + 0 p
        g = tree_map(lambda x, p: x + 0.0 * p, g, params)
        e_g = tree_map(lambda x, t: (1 - rho) * x**2 + rho * t, g, e_g)
        u = tree_map(
            lambda x, cur, prev: torch.sqrt(prev + epsilon) / torch.sqrt(cur + epsilon) * x,
            g, e_g, e_x,
        )
        e_x = tree_map(lambda x, t: (1 - rho) * x**2 + rho * t, u, e_x)
        return u, (e_g, e_x)

    return chain(
        GradientTransformation(lambda params: (_zeros(params), _zeros(params)), update),
        _scale(-learning_rate),
    )


def adam(learning_rate=1e-3, beta1=0.9, beta2=0.999, epsilon=1e-8, **kwargs):
    """optax.adam: bias-corrected m / (sqrt(v) + eps)."""

    def update(g, state, params=None):
        count, mu, nu = state
        mu = tree_map(lambda x, t: (1 - beta1) * x + beta1 * t, g, mu)
        nu = tree_map(lambda x, t: (1 - beta2) * x**2 + beta2 * t, g, nu)
        count += 1
        mu_hat, nu_hat = _bias_correction(mu, beta1, count), _bias_correction(nu, beta2, count)
        out = tree_map(lambda m, v: m / (torch.sqrt(v) + epsilon), mu_hat, nu_hat)
        return out, (count, mu, nu)

    return chain(
        GradientTransformation(lambda params: (0, _zeros(params), _zeros(params)), update),
        _scale(-learning_rate),
    )


def adamax(learning_rate=2e-3, beta1=0.9, beta2=0.999, epsilon=1e-8, **kwargs):
    """optax.adamax: u = max(|g| + eps, beta2 u); bias-corrected m / u."""

    def update(g, state, params=None):
        count, mu, nu = state
        count += 1
        mu = tree_map(lambda x, t: (1 - beta1) * x + beta1 * t, g, mu)
        nu = tree_map(lambda x, t: torch.maximum(torch.abs(x) + epsilon, beta2 * t), g, nu)
        mu_hat = _bias_correction(mu, beta1, count)
        return tree_map(lambda m, v: m / v, mu_hat, nu), (count, mu, nu)

    return chain(
        GradientTransformation(lambda params: (0, _zeros(params), _zeros(params)), update),
        _scale(-learning_rate),
    )


def norm_constraint(max_norm):
    """optax.clip_by_block_rms: each leaf u / max(1, rms(u) / max_norm)."""

    def update(g, state, params=None):
        return tree_map(
            lambda u: u / torch.clamp(torch.sqrt(torch.mean(u * u)) / max_norm, min=1.0), g
        ), state

    return GradientTransformation(lambda params: (), update)


def clip_by_global_norm(max_norm):
    """optax.clip_by_global_norm: every leaf scaled by max_norm / ||g||
    where the norm over all leaves is at least max_norm."""

    def update(g, state, params=None):
        norm = torch.sqrt(sum(torch.sum(x * x) for x in tree_leaves(g)))
        trigger = norm < max_norm
        return tree_map(lambda t: torch.where(trigger, t, t / norm * max_norm), g), state

    return GradientTransformation(lambda params: (), update)


def total_norm_constraint(max_norm):
    return clip_by_global_norm(max_norm)


_REGISTRY = {
    "sgd": sgd,
    "momentum": momentum,
    "nesterov_momentum": nesterov_momentum,
    "adagrad": adagrad,
    "adagrad_window": adagrad_window,
    "rmsprop": rmsprop,
    "adadelta": adadelta,
    "adam": adam,
    "adamax": adamax,
}


def get_optimizer(obj_optimizer=None, default="adagrad_window", default_lr=None):
    if obj_optimizer is None:
        kwargs = {"learning_rate": default_lr} if default_lr else {}
        return _REGISTRY[default](**kwargs)
    if isinstance(obj_optimizer, str):
        return _REGISTRY[obj_optimizer]()
    if isinstance(obj_optimizer, GradientTransformation):
        return obj_optimizer
    if callable(obj_optimizer):
        return obj_optimizer()
    raise TypeError(f"Cannot interpret optimizer {obj_optimizer}")


def apply_momentum(updates=None, params=None, momentum=0.9, **kwargs):
    """Classical momentum on top of a transformation (reference
    updates.py:apply_momentum; it composes transformations, as the JAX
    package's does, rather than mutating an update dict)."""
    return chain(updates if updates is not None else identity(), _trace(momentum))


def apply_nesterov_momentum(updates=None, params=None, momentum=0.9, **kwargs):
    """The Nesterov variant of apply_momentum."""
    return chain(updates if updates is not None else identity(), _trace(momentum, True))
