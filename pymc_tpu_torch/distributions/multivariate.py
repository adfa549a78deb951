"""Multivariate distributions: MvNormal, MvStudentT, Dirichlet and
KroneckerNormal.

Counterpart of `pymc_tpu/distributions/multivariate.py` (MvNormal :41-110,
MvStudentT :113-155, Dirichlet :158-193, KroneckerNormal :774-846;
reference pymc/distributions/multivariate.py MvNormal:188,
PrecisionMvNormal:310 via `tau`, MvStudentT:417, Dirichlet:515,
KroneckerNormal:1919). A covariance, scale or precision parameter is
factored by `ops.linalg.cholesky_batched`, the hand-written kernel on the
card; KroneckerNormal takes one eigendecomposition a factor, as the JAX
package does.
"""

from __future__ import annotations

import math

import torch

from ..graph import apply
from ..ops.linalg import cholesky_batched
from .continuous import standard_gamma
from .dist_math import check_parameters, logpow
from .distribution import Continuous, as_param, standard_normal

__all__ = ["MvNormal", "MvStudentT", "Dirichlet", "KroneckerNormal"]

_LOG_2PI = math.log(2.0 * math.pi)


def _solve_chol_params(mu=None, cov=None, tau=None, chol=None, lower=True):
    """Canonicalize MvNormal-style parametrization to its lower Cholesky
    factor."""
    n_given = sum(p is not None for p in (cov, tau, chol))
    if n_given != 1:
        raise ValueError("Provide exactly one of cov, tau, chol")
    if chol is not None:
        chol = as_param(chol)
        if not lower:
            chol = apply(lambda c: c.transpose(-1, -2), chol)
        return chol
    if cov is not None:
        return apply(cholesky_batched, as_param(cov))
    # tau: Sigma = inv(tau)
    return apply(lambda t: cholesky_batched(torch.linalg.inv(t)), as_param(tau))


def _tri_solve(chol, vec):
    """Batched lower-triangular solve with full broadcasting of the operands."""
    batch = torch.broadcast_shapes(vec.shape[:-1], chol.shape[:-2])
    chol_b = chol.expand(batch + chol.shape[-2:])
    vec_b = vec.expand(batch + vec.shape[-1:])
    return torch.linalg.solve_triangular(chol_b, vec_b[..., None], upper=False)[..., 0]


def _diag(m):
    return torch.diagonal(m, dim1=-2, dim2=-1)


def _mvn_logp(value, mu, chol):
    """log N(value | mu, L L^T); -inf where the factor's diagonal is not
    finite and positive (a covariance that was not positive definite)."""
    d = value.shape[-1]
    z = _tri_solve(chol, value - mu)
    quad = torch.sum(z**2, dim=-1)
    diag = _diag(chol)
    logdet = torch.sum(torch.log(torch.abs(diag)), dim=-1)
    res = -0.5 * (d * _LOG_2PI + quad) - logdet
    ok = torch.all(torch.isfinite(diag), dim=-1) & torch.all(diag > 0, dim=-1)
    return torch.where(ok, res, -torch.inf)


class MvNormal(Continuous):
    """Reference multivariate.py:188 (covers PrecisionMvNormal:310 via tau)."""

    param_names = ("mu", "chol")
    param_event_ndims = (1, 2)
    event_ndim = 1

    def __dist_init__(self, mu=0.0, cov=None, tau=None, chol=None, lower=True):
        self.chol = _solve_chol_params(mu, cov, tau, chol, lower)
        self.mu = as_param(mu)

    def _event_shape(self, mu_shape, chol_shape):
        return (chol_shape[-1],)

    def _logp(self, value, mu, chol):
        return _mvn_logp(value, mu, chol)

    def _sample(self, generator, shape, mu, chol):
        z = standard_normal(generator, shape, chol)
        return mu + torch.einsum("...ij,...j->...i", chol, z)

    def _support_point(self, mu, chol):
        return torch.broadcast_to(mu, torch.broadcast_shapes(mu.shape, chol.shape[:-1]))


class MvStudentT(Continuous):
    """Reference multivariate.py:417; `scale` (or `cov`), `tau` or `chol`."""

    param_names = ("nu", "mu", "chol")
    param_event_ndims = (0, 1, 2)
    event_ndim = 1

    def __dist_init__(self, nu, mu=0.0, scale=None, tau=None, chol=None, cov=None, lower=True):
        scale = scale if scale is not None else cov
        self.chol = _solve_chol_params(mu, scale, tau, chol, lower)
        self.nu = as_param(nu)
        self.mu = as_param(mu)

    def _event_shape(self, nu_shape, mu_shape, chol_shape):
        return (chol_shape[-1],)

    def _logp(self, value, nu, mu, chol):
        d = value.shape[-1]
        quad = torch.sum(_tri_solve(chol, value - mu) ** 2, dim=-1)
        logdet = torch.sum(torch.log(torch.abs(_diag(chol))), dim=-1)
        res = (
            torch.lgamma((nu + d) / 2.0)
            - torch.lgamma(nu / 2.0)
            - 0.5 * d * torch.log(nu * math.pi)
            - logdet
            - 0.5 * (nu + d) * torch.log1p(quad / nu)
        )
        return check_parameters(res, nu > 0)

    def _sample(self, generator, shape, nu, mu, chol):
        z = standard_normal(generator, shape, chol)
        g = standard_gamma(generator, (nu / 2.0).expand(shape[:-1]))
        w = torch.sqrt(nu / (2.0 * g))[..., None]
        return mu + w * torch.einsum("...ij,...j->...i", chol, z)

    def _support_point(self, nu, mu, chol):
        return torch.broadcast_to(mu, torch.broadcast_shapes(mu.shape, chol.shape[:-1]))


class Dirichlet(Continuous):
    """Reference multivariate.py:515; its values live on the simplex, and a
    value off it (a negative entry, or a sum more than 1e-6 from 1) has
    logp -inf."""

    param_names = ("a",)
    param_event_ndims = (1,)
    event_ndim = 1
    support = "simplex"

    def __dist_init__(self, a):
        self.a = as_param(a)

    def _event_shape(self, a_shape):
        return (a_shape[-1],)

    def _logp(self, value, a):
        res = (
            torch.sum(logpow(value, a - 1.0), dim=-1)
            + torch.lgamma(torch.sum(a, dim=-1))
            - torch.sum(torch.lgamma(a), dim=-1)
        )
        in_simplex = torch.all(value >= 0, dim=-1) & (
            torch.abs(torch.sum(value, dim=-1) - 1.0) < 1e-6
        )
        res = torch.where(in_simplex, res, -torch.inf)
        return check_parameters(res, torch.all(a > 0, dim=-1))

    def _sample(self, generator, shape, a):
        g = standard_gamma(generator, a.expand(shape))
        return g / torch.sum(g, dim=-1, keepdim=True)

    def _support_point(self, a):
        return a / torch.sum(a, dim=-1, keepdim=True)


def _kron_diag(*diags):
    """Diagonal of a Kronecker product from its factors' diagonals."""
    out = diags[0]
    for d in diags[1:]:
        out = (out[:, None] * d[None, :]).reshape(-1)
    return out


def _kron_rotate(x, vecs, transpose):
    """(V_1 (x) V_2 (x) ...)^T x (transpose) or (V_1 (x) ...) x over x's
    last axis, one factor at a time in the JAX package's order of axes."""
    batch = x.shape[:-1]
    for V in vecs:
        x = x.reshape(batch + (V.shape[-1], -1))
        x = torch.einsum("ji,...jk->...ik" if transpose else "ij,...jk->...ik", V, x)
        x = x.transpose(-1, -2).reshape(batch + (-1,))
    return x


class KroneckerNormal(Continuous):
    """Reference multivariate.py:1919: N(mu, K_1 (x) K_2 (x) ... + sigma^2 I),
    through one eigendecomposition a factor (O(sum n_i^3))."""

    event_ndim = 1

    def __dist_init__(self, mu=0.0, covs=None, sigma=None):
        if covs is None:
            raise ValueError("KroneckerNormal requires covs=[K1, K2, ...]")
        self.covs = [as_param(c) for c in covs]
        for i, c in enumerate(self.covs):
            setattr(self, f"_cov{i}", c)
        self.sigma = as_param(sigma if sigma is not None else 0.0)
        self.mu = as_param(mu)
        self.param_event_ndims = (1, 0) + (2,) * len(self.covs)
        self.param_names = ("mu", "sigma") + tuple(f"_cov{i}" for i in range(len(self.covs)))
        self._N = int(math.prod(c.shape[-1] for c in self.covs))

    def _event_shape(self, *shapes):
        return (self._N,)

    @staticmethod
    def _eigh_all(covs):
        eigs, vecs = zip(*(torch.linalg.eigh(K) for K in covs))
        return eigs, vecs

    def _logp(self, value, mu, sigma, *covs):
        eigs, vecs = self._eigh_all(covs)
        lam = _kron_diag(*eigs) + sigma**2
        x = _kron_rotate(value - mu, vecs, transpose=True)
        quad = torch.sum(x**2 / lam, dim=-1)
        return -0.5 * (self._N * _LOG_2PI + torch.sum(torch.log(lam)) + quad)

    def _sample(self, generator, shape, mu, sigma, *covs):
        eigs, vecs = self._eigh_all(covs)
        lam = _kron_diag(*eigs) + sigma**2
        z = standard_normal(generator, shape, lam) * torch.sqrt(lam)
        return mu + _kron_rotate(z, vecs, transpose=False)

    def _support_point(self, mu, sigma, *covs):
        return torch.broadcast_to(mu, torch.broadcast_shapes(mu.shape, (self._N,)))
