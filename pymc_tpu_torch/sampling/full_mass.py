"""A full (dense) mass matrix, run through the diagonal kernels by whitening.

The JAX package's full-mass route (`pymc_tpu/sampling/nuts.py:257-262,
411-433,595-612`, `chees.py:84-127`) draws p = L^-T xi with Sigma = L L^T
and moves q by Sigma p. Here the samplers run instead in the coordinates
x = L^-1 q with a unit mass: the gradient there is L^T grad, the momentum
is xi itself, and the kinetic energy and the U-turn dots p_x . p_x and
p_x . rho_x equal p^T Sigma p and (Sigma p) . rho. So the trajectory is the
JAX package's in exact arithmetic, and the leapfrog kernels and the fused
NUTS leaf run unchanged with inv_mass = 1. L comes from the port's
Cholesky kernel (`ops/linalg.py::cholesky_batched`, one launch), made once
per mass: the sampler factors Sigma only when it changes.
"""

from __future__ import annotations

import torch

from ..ops.linalg import cholesky_batched

__all__ = ["DenseMass"]


class DenseMass:
    """Sigma (D, D), the inverse mass shared by every chain, and its lower
    factor L. Rows are chains: q, x, grad, p are (C, D)."""

    def __init__(self, cov):
        self.cov = cov
        self.L = cholesky_batched(cov[None])[0]

    def to_x(self, q):
        """x = L^-1 q."""
        return torch.linalg.solve_triangular(self.L, q.mT, upper=False).mT

    def to_q(self, x):
        """q = L x."""
        return x @ self.L.mT

    def grad_to_x(self, grad):
        """The gradient in x: L^T grad."""
        return grad @ self.L

    def to_q_momentum(self, p_x):
        """p = L^-T p_x (also the gradient back from x to q)."""
        return torch.linalg.solve_triangular(self.L.mT, p_x.mT, upper=True).mT

    def whitened(self, logp_grad_b):
        """logp_grad_b over x: (C, D) -> (logp (C,), grad in x (C, D))."""

        def fn(x):
            logp, grad = logp_grad_b(self.to_q(x))
            return logp, self.grad_to_x(grad)

        return fn

    def unit(self, chains):
        """The unit diagonal inverse mass the kernels run with in x."""
        return torch.ones((chains, self.L.shape[0]), dtype=self.L.dtype, device=self.L.device)
