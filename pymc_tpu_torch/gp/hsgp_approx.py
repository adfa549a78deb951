"""Hilbert-space GP approximation: HSGP and HSGPPeriodic.

Counterpart of `pymc_tpu/gp/hsgp_approx.py` (reference
pymc/gp/hsgp_approx.py; Solin & Särkkä 2020). On the box [-L, L]^d the
Laplacian's eigenfunctions are products of sines, and the GP becomes
f ~ phi(x) @ (beta * sqrt(S(sqrt(lambda)))): one (n, m) matmul a logp and
no Cholesky. The basis of concrete inputs is computed once, when the model
is built, in float64 from numpy, as in the JAX package.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from ..graph import Node, apply, as_tensor
from .gp import Base

__all__ = ["HSGP", "HSGPPeriodic", "set_boundary", "approx_hsgp_hyperparams"]


def set_boundary(X, c):
    """(L, center): half-widths L = c * max|X - center| per dim, the center
    midway between X's extremes (reference hsgp_approx.py set_boundary)."""
    X = np.asarray(X)
    if X.ndim == 1:
        X = X[:, None]
    center = (X.max(0) + X.min(0)) / 2
    return np.asarray(c) * np.max(np.abs(X - center), axis=0), center


def approx_hsgp_hyperparams(x_range, lengthscale_range, cov_func="expquad"):
    """Heuristic (m, c) recommendation (reference hsgp_approx.py
    approx_hsgp_hyperparams)."""
    S = (x_range[1] - x_range[0]) / 2
    ell = np.asarray(lengthscale_range) / S
    if cov_func.lower() in ("expquad", "se"):
        c = max(3.2 * ell[0] ** -0.5 * 0 + 1.75 * ell[1], 1.2)
        m = int(np.ceil(1.75 * c / ell[0]))
    elif "52" in cov_func:
        c = max(4.1 * ell[1], 1.2)
        m = int(np.ceil(2.65 * c / ell[0]))
    else:
        c = max(4.5 * ell[1], 1.2)
        m = int(np.ceil(3.42 * c / ell[0]))
    return m, c


def _eigendata(L, m_list):
    """(M, D) square roots of the eigenvalues, the index grid in
    itertools.product order (the last dimension's index varies fastest)."""
    grids = list(itertools.product(*[range(1, m + 1) for m in m_list]))
    J = np.asarray(grids, dtype=np.float64)
    return torch.as_tensor(J * np.pi / (2.0 * np.asarray(L)))


def _phi(x, L, center, sqrt_eig):
    """(n, M) basis: prod_d L_d^{-1/2} sin(sqrt_eig_d (x_d - center_d + L_d))."""
    x = torch.atleast_2d(as_tensor(x))
    x = x if x.is_floating_point() else x.double()
    L = torch.as_tensor(L, dtype=x.dtype, device=x.device)
    Xs = x - torch.as_tensor(center, dtype=x.dtype, device=x.device) + L
    args = Xs[:, None, :] * sqrt_eig.to(x)[None, :, :]
    return torch.prod(torch.sin(args) / torch.sqrt(L), dim=-1)


def _sqrt_psd(s):
    return torch.sqrt(torch.clamp_min(s, 1e-30))


class HSGP(Base):
    """Reference hsgp_approx.py HSGP."""

    def __init__(self, m, c=None, L=None, drop_first=False, parametrization="noncentered",
                 mean_func=None, cov_func=None):
        if isinstance(m, int):
            m = [m]
        self.m = list(m)
        if L is None and c is None:
            raise ValueError("Provide L or c")
        self.c = c
        self.L = L
        self.drop_first = drop_first
        self.parametrization = parametrization
        super().__init__(mean_func, cov_func)
        self._beta = None

    def _basis(self, X):
        """(phi, sqrt_psd) at X with the stored boundary, drop_first applied."""
        phi = apply(lambda x: _phi(x, self._L, self._center, self._sqrt_eig), X)
        sqrt_psd = apply(_sqrt_psd, self.cov_func.power_spectral_density(self._sqrt_eig))
        if self.drop_first:
            phi = apply(lambda p: p[:, 1:], phi)
            sqrt_psd = apply(lambda s: s[1:], sqrt_psd)
        return phi, sqrt_psd

    def prior_linearized(self, X):
        """(phi, sqrt_psd): f = mean + phi @ (beta * sqrt_psd) (reference
        HSGP.prior_linearized)."""
        if self.L is None:
            if isinstance(X, Node):
                raise ValueError("HSGP with c= needs concrete inputs to set its boundary")
            self._L, self._center = set_boundary(as_tensor(X).numpy(), self.c)
        else:
            self._L = np.atleast_1d(np.asarray(self.L))
            self._center = np.zeros(len(self._L))
        self._sqrt_eig = _eigendata(self._L, self.m)
        return self._basis(X)

    @property
    def n_basis(self):
        M = int(np.prod(self.m))
        return M - 1 if self.drop_first else M

    def _f(self, phi, sqrt_psd):
        if self.parametrization == "noncentered":
            return apply(lambda p, s, b: p @ (s * b), phi, sqrt_psd, self._beta)
        return apply(lambda p, b: p @ b, phi, self._beta)

    def prior(self, name, X, dims=None, **kwargs):
        from ..distributions import Normal
        from ..model.core import Deterministic

        phi, sqrt_psd = self.prior_linearized(X)
        scale = 1.0 if self.parametrization == "noncentered" else sqrt_psd
        self._beta = Normal(f"{name}_hsgp_coeffs_", 0.0, scale, shape=(self.n_basis,))
        f = Deterministic(name, apply(torch.add, self.mean_func(X), self._f(phi, sqrt_psd)),
                          dims=dims)
        self.X, self.f = X, f
        return f

    def conditional(self, name, Xnew, dims=None):
        """f at Xnew from the prior's coefficients."""
        from ..model.core import Deterministic

        phi, sqrt_psd = self._basis(Xnew)
        return Deterministic(
            name, apply(torch.add, self.mean_func(Xnew), self._f(phi, sqrt_psd)), dims=dims
        )


class HSGPPeriodic(Base):
    """Periodic-kernel HSGP through the cosine/sine expansion (reference
    hsgp_approx.py HSGPPeriodic)."""

    def __init__(self, m, scale=1.0, mean_func=None, cov_func=None):
        from .cov import Periodic

        if not isinstance(cov_func, Periodic):
            raise ValueError("HSGPPeriodic requires a Periodic covariance")
        self.m = int(m)
        self.scale = scale
        super().__init__(mean_func, cov_func)

    def prior_linearized(self, X):
        """((phi_cos, phi_sin), sqrt_psd)."""
        J = self.m
        coeffs = self.cov_func.power_spectral_density_approx(J)
        w0 = apply(lambda p: 2.0 * math.pi / p, self.cov_func.period)

        def basis(x, w, part):
            x1 = torch.ravel(as_tensor(x))
            x1 = x1 if x1.is_floating_point() else x1.double()
            js = torch.arange(J, dtype=x1.dtype, device=x1.device)
            ang = x1[:, None] * w * js[None, :]
            return torch.cos(ang) if part == "cos" else torch.sin(ang)

        phi_cos = apply(lambda x, w: basis(x, w, "cos"), X, w0)
        phi_sin = apply(lambda x, w: basis(x, w, "sin"), X, w0)
        sqrt_psd = apply(lambda c, s: s * _sqrt_psd(c), coeffs, self.scale)
        return (phi_cos, phi_sin), sqrt_psd

    def _f(self, X):
        (phi_cos, phi_sin), sqrt_psd = self.prior_linearized(X)
        beta_cos, beta_sin = self._beta
        f = apply(
            lambda pc, ps, s, bc, bs: pc @ (s * bc) + ps @ (s * bs),
            phi_cos, phi_sin, sqrt_psd, beta_cos, beta_sin,
        )
        return apply(torch.add, self.mean_func(X), f)

    def prior(self, name, X, dims=None):
        from ..distributions import Normal
        from ..model.core import Deterministic

        self._beta = (
            Normal(f"{name}_hsgp_cos_", 0.0, 1.0, shape=(self.m,)),
            Normal(f"{name}_hsgp_sin_", 0.0, 1.0, shape=(self.m,)),
        )
        return Deterministic(name, self._f(X), dims=dims)

    def conditional(self, name, Xnew, dims=None):
        from ..model.core import Deterministic

        return Deterministic(name, self._f(Xnew), dims=dims)
