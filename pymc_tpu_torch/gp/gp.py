"""GP model classes: Latent (prior) and Marginal (marginal likelihood).

Counterpart of `pymc_tpu/gp/gp.py` (reference pymc/gp/gp.py), cut to the
paths that need no forward sampling: `Latent.prior` and
`Marginal.marginal_likelihood`. Both factor their covariance with
`ops.linalg.cholesky_batched`, the hand-written kernel on the card.
`conditional`, `predict`, TP, MarginalApprox and the Kron classes are not
ported.
"""

from __future__ import annotations

import torch

from ..graph import Node, apply, as_tensor
from ..ops.linalg import cholesky_batched
from . import cov as gp_cov
from . import mean as gp_mean
from .util import JITTER_DEFAULT

__all__ = ["Latent", "Marginal"]


def _stabilize(K, jitter=None):
    """Diagonal jitter for Cholesky safety (reference gp/util.py:77).

    The default is dtype-aware: the reference's 1e-6 assumes float64; in
    float32 kernel matrices with near-duplicate inputs are indefinite at that
    level, so the float32 default is 1e-4, raised to 3e-4 times the mean of
    the diagonal when the kernel's amplitude is large."""

    def _f(k):
        j = _resolve_jitter(jitter, k.dtype)
        if jitter is None and k.dtype != torch.float64:
            diag_mean = torch.mean(torch.diagonal(k, dim1=-2, dim2=-1))
            j = torch.clamp_min(3e-4 * diag_mean, j)
        return k + j * torch.eye(k.shape[-1], dtype=k.dtype, device=k.device)

    return apply(_f, K)


def _resolve_jitter(jitter, dtype):
    if jitter is not None:
        return jitter
    return JITTER_DEFAULT if dtype == torch.float64 else 1e-4


def _as_input(X):
    return X if isinstance(X, Node) else as_tensor(X)


class Base:
    def __init__(self, mean_func=None, cov_func=None):
        self.mean_func = mean_func if mean_func is not None else gp_mean.Zero()
        if cov_func is None:
            raise ValueError("A covariance function is required")
        self.cov_func = cov_func

    def __add__(self, other):
        if type(self) is not type(other):
            raise TypeError("Cannot add different GP types")
        return type(self)(
            mean_func=self.mean_func + other.mean_func,
            cov_func=self.cov_func + other.cov_func,
        )


class Latent(Base):
    """Latent (noise-free) GP prior (reference gp.py Latent)."""

    def __init__(self, mean_func=None, cov_func=None):
        super().__init__(mean_func, cov_func)
        self.X = None
        self.f = None

    def prior(self, name, X, reparameterize=True, jitter=None, **kwargs):
        """f = mu + L v with v ~ N(0, I) (reparameterize=True), or
        f ~ MvNormal(mu, chol=L)."""
        from ..distributions import MvNormal, Normal
        from ..model.core import Deterministic

        X = _as_input(X)
        n = X.shape[0]
        mu = self.mean_func(X)
        chol = apply(cholesky_batched, _stabilize(self.cov_func(X), jitter))
        if reparameterize:
            v = Normal(f"{name}_rotated_", 0.0, 1.0, shape=(n,), **kwargs)
            f = Deterministic(name, apply(lambda m, L, vv: m + L @ vv, mu, chol, v))
        else:
            f = MvNormal(name, mu=mu, chol=chol, **kwargs)
        self.X, self.f, self._jitter = X, f, jitter
        return f


class Marginal(Base):
    """GP with Gaussian observation noise marginalized analytically
    (reference gp.py Marginal)."""

    def __init__(self, mean_func=None, cov_func=None):
        super().__init__(mean_func, cov_func)
        self.X = None
        self.y = None
        self.sigma = None

    @staticmethod
    def _as_noise_func(sigma):
        """A scalar sigma becomes WhiteNoise(sigma); a Covariance is used
        directly as the noise kernel (reference gp.py:522-527)."""
        if isinstance(sigma, gp_cov.Covariance):
            return sigma
        return gp_cov.WhiteNoise(sigma)

    def marginal_likelihood(self, name, X, y, sigma=None, noise=None,
                            jitter=None, is_observed=True, **kwargs):
        """y ~ MvNormal(mean(X), K(X) + noise(X) + 1e-6 I), observed."""
        from ..distributions import MvNormal

        if sigma is None:
            sigma = noise
        if sigma is None:
            raise ValueError("Marginal requires sigma (noise level)")
        X = _as_input(X)
        noise_func = self._as_noise_func(sigma)
        mu = self.mean_func(X)
        cov = apply(
            lambda k, kn: k + kn + JITTER_DEFAULT * torch.eye(
                k.shape[-1], dtype=k.dtype, device=k.device
            ),
            self.cov_func(X), noise_func(X),
        )
        self.X, self.y, self.sigma, self._jitter = X, y, noise_func, jitter
        return MvNormal(name, mu=mu, cov=cov, observed=y, **kwargs)
