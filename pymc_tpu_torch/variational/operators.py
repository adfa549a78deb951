"""Variational operators.

Counterpart of `pymc_tpu/variational/operators.py` (reference
pymc/variational/operators.py: KL:33, KSD:104; opvi.py: Operator:455,
ObjectiveFunction:188, TestFunction:558; stein.py:27). The fit loops of
inference.py compute the same objectives in their own steps; these classes
expose them for code that composes operators explicitly.

Randomness is an input: an objective takes the approximation's noise
(`Approximation.noise`), so it can be fed the JAX package's normals.
"""

from __future__ import annotations

import math

import torch

__all__ = ["Operator", "ObjectiveFunction", "TestFunction", "KL", "KSD", "rbf", "Stein"]


class Operator:
    """Base operator over an approximation (reference opvi.py:455)."""

    def __init__(self, approx):
        self.approx = approx

    def apply(self, f=None):
        raise NotImplementedError

    def __call__(self, f=None):
        return ObjectiveFunction(self, f)


class ObjectiveFunction:
    """An (operator, test function) pair; __call__(params, noise) is the
    stochastic objective at the draws `noise` (reference opvi.py:188)."""

    def __init__(self, op, tf=None):
        self.op = op
        self.tf = tf

    def __call__(self, params, noise=None):
        return self.op.apply_value(params, noise)


class TestFunction:
    """A kernel or test function for operator VI (reference opvi.py:558)."""

    def __call__(self, X):
        raise NotImplementedError


def _median(x):
    """The median of every element, the mean of the two middle values for
    an even count, as `jnp.median` (torch.median returns the lower one)."""
    v = torch.sort(x.reshape(-1)).values
    n = v.numel()
    return (v[(n - 1) // 2] + v[n // 2]) * 0.5


class rbf(TestFunction):
    """The RBF kernel with the median heuristic (reference
    test_functions.py:rbf): (K (P, P), the kernel's gradient summed over
    the particles (P, D))."""

    def __call__(self, X):
        diff = X[:, None, :] - X[None, :, :]
        sq = torch.sum(diff**2, dim=-1)
        h = torch.sqrt(0.5 * _median(sq) / math.log(X.shape[0] + 1.0)) + 1e-6
        K = torch.exp(-sq / (2.0 * h**2))
        dK = -diff / h**2 * K[..., None]
        return K, torch.sum(dK, dim=0)


class Stein:
    """The Stein update (reference stein.py:27): phi(X) = (K grad logp(X) +
    the kernel's repulsion) / P. `logp_grad_b` maps the (P, D) particles to
    their (P, D) gradients of logp."""

    def __init__(self, logp_grad_b, kernel=None):
        self.logp_grad = logp_grad_b
        self.kernel = kernel or rbf()

    def phi(self, X):
        K, repulse = self.kernel(X)
        return (K @ self.logp_grad(X) + repulse) / X.shape[0]


def _model_logp_grad(approx):
    return approx.model.logp_dlogp_fn(device=approx.device, dtype=approx.dtype)


class KL(Operator):
    """The ELBO operator E_q[log q - log p] (reference operators.py:33),
    estimated at the points the draws `noise` give."""

    def apply_value(self, params, noise):
        cls = type(self.approx)
        z = cls.sample_q(params, noise)
        logp, _ = _model_logp_grad(self.approx)(z)
        return torch.mean(cls.logq(params, z) - logp)


class KSD(Operator):
    """The kernelized Stein discrepancy operator (reference
    operators.py:104), which powers SVGD: apply_value is the mean squared
    Stein update of the particles (a diagnostic; SVGD uses phi itself)."""

    def apply_value(self, params, noise=None):
        X = params["particles"] if isinstance(params, dict) else params
        logp_grad = _model_logp_grad(self.approx)
        return torch.mean(Stein(lambda x: logp_grad(x)[1]).phi(X) ** 2)
