"""Multivariate distributions.

Counterpart of `pymc_tpu/distributions/multivariate.py` (reference
pymc/distributions/multivariate.py: MvNormal:188, PrecisionMvNormal:310 via
`tau`, MvStudentT:417, Dirichlet:515, Multinomial:587,
DirichletMultinomial:716, OrderedMultinomial:820, Wishart:983,
LKJCholeskyCov:1313, LKJCorr:1578, MatrixNormal:1703, KroneckerNormal:1919,
CAR:2160, ICAR:2315, StickBreakingWeights:2501, ZeroSumNormal:2654). A
covariance, scale or precision parameter, a correlation matrix (LKJCorr and
its transform) and a Wishart value and scale are factored by
`ops.linalg.cholesky_batched`, the hand-written kernel on the card;
KroneckerNormal takes one eigendecomposition a factor, as the JAX package
does. CAR's eigenvalues of a constant adjacency matrix are computed once,
when the model is built; a symbolic W takes them on every call.

Where the JAX package differs from PyMC, the port keeps PyMC's semantics:
a Wishart value that is not positive definite has logp -inf (the JAX
package tests only the sign of its determinant, so a symmetric value with
two negative eigenvalues gets a finite logp there).
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from ..graph import Node, apply
from ..ops.linalg import cholesky_batched
from . import transforms as tr
from .continuous import _beta_draws, standard_gamma
from .dist_math import check_parameters, factln, logpow
from .distribution import Continuous, Discrete, as_param, standard_normal
from .transforms import packed_diag, tril_pack, tril_unpack

__all__ = [
    "MvNormal", "MvStudentT", "Dirichlet", "Multinomial", "DirichletMultinomial",
    "OrderedMultinomial", "Wishart", "WishartBartlett", "LKJCholeskyCov", "LKJCorr",
    "MatrixNormal", "KroneckerNormal", "CAR", "ICAR", "StickBreakingWeights", "ZeroSumNormal",
]

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


class Multinomial(Discrete):
    """Reference multivariate.py:587. A constant `p` with a negative entry
    raises; one that does not sum to 1 warns and is rescaled. A symbolic
    `p` off the simplex gives -inf."""

    param_names = ("n", "p")
    param_event_ndims = (0, 1)
    event_ndim = 1

    def __dist_init__(self, n, p):
        self.n = as_param(n)
        if not isinstance(p, Node):
            p_ = np.asarray(p, dtype=float)
            if np.any(p_ < 0):
                raise ValueError("Negative `p` parameters are not valid")
            p_sum = np.sum(p_, axis=-1)
            if not np.all(np.isclose(p_sum, 1.0)):
                warnings.warn(
                    f"`p` parameters sum to {p_sum}, instead of 1.0. "
                    "They will be automatically rescaled.",
                    UserWarning,
                )
                p = p_ / np.sum(p_, axis=-1, keepdims=True)
        self.p = as_param(p)

    def _event_shape(self, n_shape, p_shape):
        return (p_shape[-1],)

    def _logp(self, value, n, p):
        vf = value.to(p.dtype)
        p_norm = p / torch.sum(p, dim=-1, keepdim=True)
        res = factln(n) + torch.sum(logpow(p_norm, vf) - factln(vf), dim=-1)
        ok = (torch.sum(vf, dim=-1) == n) & torch.all(vf >= 0, dim=-1)
        res = torch.where(ok, res, -torch.inf)
        return check_parameters(
            res,
            torch.all(p >= 0, dim=-1),
            torch.all(p <= 1, dim=-1),
            torch.abs(torch.sum(p, dim=-1) - 1.0) <= 1e-8 + 1e-5,  # jnp.isclose(sum, 1)
            n >= 0,
        )

    def _sample(self, generator, shape, n, p):
        # one binomial a category, of what the earlier ones left
        p = p.expand(shape)
        n_rem = n.expand(shape[:-1])
        p_rem = torch.ones_like(n_rem)
        outs = []
        for i in range(shape[-1] - 1):
            frac = torch.clamp(p[..., i] / torch.clamp(p_rem, min=1e-30), 0.0, 1.0)
            draw = torch.binomial(n_rem.contiguous(), frac.contiguous(), generator=generator)
            outs.append(draw)
            n_rem = n_rem - draw
            p_rem = p_rem - p[..., i]
        outs.append(n_rem)
        return torch.stack(outs, dim=-1)

    def _support_point(self, n, p):
        mode = torch.floor(n[..., None] * p)
        rem = n - torch.sum(mode, dim=-1)
        return torch.cat([mode[..., :1] + rem[..., None], mode[..., 1:]], dim=-1)


class DirichletMultinomial(Discrete):
    """Reference multivariate.py:716."""

    param_names = ("n", "a")
    param_event_ndims = (0, 1)
    event_ndim = 1

    def __dist_init__(self, n, a):
        self.n = as_param(n)
        self.a = as_param(a)

    def _event_shape(self, n_shape, a_shape):
        return (a_shape[-1],)

    def _logp(self, value, n, a):
        vf = value.to(a.dtype)
        sum_a = torch.sum(a, dim=-1)
        res = (
            factln(n)
            + torch.lgamma(sum_a)
            - torch.lgamma(n + sum_a)
            + torch.sum(torch.lgamma(vf + a) - factln(vf) - torch.lgamma(a), dim=-1)
        )
        ok = (torch.sum(vf, dim=-1) == n) & torch.all(vf >= 0, dim=-1)
        res = torch.where(ok, res, -torch.inf)
        return check_parameters(res, torch.all(a > 0, dim=-1))

    def _sample(self, generator, shape, n, a):
        g = standard_gamma(generator, a.expand(shape))
        p = g / torch.sum(g, dim=-1, keepdim=True)
        return Multinomial._sample(self, generator, shape, n, p)

    def _support_point(self, n, a):
        return Multinomial._support_point(self, n, a / torch.sum(a, dim=-1, keepdim=True))


class OrderedMultinomial(Discrete):
    """Reference multivariate.py:820: a multinomial over the ordinal
    categories' probabilities that cutpoints and a latent eta induce."""

    param_names = ("eta", "cutpoints", "n")
    param_event_ndims = (0, 1, 0)
    event_ndim = 1

    def __dist_init__(self, eta, cutpoints, n):
        self.eta = as_param(eta)
        self.cutpoints = as_param(cutpoints)
        self.n = as_param(n)

    def _event_shape(self, eta_shape, cut_shape, n_shape):
        return (cut_shape[-1] + 1,)

    @staticmethod
    def _probs(eta, cutpoints):
        cdf = torch.sigmoid(cutpoints - eta[..., None])
        lo = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)
        hi = torch.cat([cdf, torch.ones_like(cdf[..., :1])], dim=-1)
        return hi - lo

    def _logp(self, value, eta, cutpoints, n):
        return Multinomial._logp(self, value, n, self._probs(eta, cutpoints))

    def _sample(self, generator, shape, eta, cutpoints, n):
        return Multinomial._sample(self, generator, shape, n, self._probs(eta, cutpoints))

    def _support_point(self, eta, cutpoints, n):
        return Multinomial._support_point(self, n, self._probs(eta, cutpoints))


def _lkj_cholesky_corr_logp(W, eta, n):
    """The normalised log density of a correlation matrix's Cholesky factor
    W under LKJ(eta): sum_k (n - k + 2 eta - 2) log W_kk - sum_k log Z_k
    over the rows k = 2..n, with log Z_k = (k - 1)/2 log pi +
    lgamma((n - k)/2 + eta) - lgamma((n - 1)/2 + eta) (pymc_tpu
    multivariate.py:346-367)."""
    k = torch.arange(2, n + 1, dtype=W.dtype, device=W.device)
    eta = eta[..., None]
    log_diag = torch.log(torch.clamp(torch.diagonal(W, dim1=-2, dim2=-1)[..., 1:], min=1e-30))
    res = torch.sum((n - k + 2.0 * eta - 2.0) * log_diag, dim=-1)
    lognorm = torch.sum(
        0.5 * (k - 1.0) * math.log(math.pi)
        + torch.lgamma((n - k) / 2.0 + eta)
        - torch.lgamma((n - 1.0) / 2.0 + eta),
        dim=-1,
    )
    return res - lognorm


def _packed_to_chol_corr(packed, n):
    """Packed strictly-lower entries -> the full factor, its diagonal set
    from the unit row norms."""
    W = tril_unpack(packed, n, -1)
    diag = torch.sqrt(torch.clamp(1.0 - torch.sum(W**2, dim=-1), min=1e-30))
    return W + diag[..., None] * torch.eye(n, dtype=packed.dtype, device=packed.device)


def _sample_lkj_chol(generator, batch, n, eta):
    """Onion-method draws of LKJ(eta) Cholesky factors of shape batch + (n,
    n): row k (k = 2..n) has W_kk^2 ~ Beta((n - k)/2 + eta, (k - 1)/2) and
    a direction uniform on the (k - 1)-sphere (pymc_tpu
    multivariate.py:380-400)."""
    def zeros(m):
        return torch.zeros(batch + (m,), dtype=eta.dtype, device=eta.device)

    rows = [torch.cat([zeros(1) + 1.0, zeros(n - 1)], dim=-1)]
    for k in range(2, n + 1):
        b = _beta_draws(generator, batch, (n - k) / 2.0 + eta, eta.new_full((), (k - 1) / 2.0))
        z = standard_normal(generator, batch + (k - 1,), eta)
        z = z / torch.linalg.vector_norm(z, dim=-1, keepdim=True)
        r = torch.sqrt(torch.clamp(1.0 - b, 0.0, 1.0))[..., None]
        rows.append(torch.cat([r * z, torch.sqrt(b)[..., None], zeros(n - k)], dim=-1))
    return torch.stack(rows, dim=-2)


class _LKJCholeskyCov(Continuous):
    """The packed Cholesky factor L (row-major, n (n + 1)/2 entries; cov =
    L L^T) of a covariance matrix with an LKJ(eta) prior on its correlation
    and `sd_dist` on its standard deviations (reference
    multivariate.py:1223, pymc_tpu multivariate.py:403). The density is
    taken through the factorisation L = diag(sd) W, with the Jacobian
    prod_i sd_i^(i - 1) / W_ii. sd_dist's parameters are this
    distribution's too, after eta, so they are evaluated, and placed on the
    device, with the model's."""

    event_ndim = 1

    def __dist_init__(self, eta, n, sd_dist):
        self.eta = as_param(eta)
        self.n = int(n)
        self.sd_dist = sd_dist
        sd_names = tuple(f"_sd_{name}" for name in sd_dist.param_names)
        for name, p in zip(sd_names, sd_dist.param_values()):
            setattr(self, name, p)
        self.param_names = ("eta",) + sd_names
        # the sd parameters' own shapes are no batch shape of the factor
        self.param_event_ndims = (0,) + tuple(
            0 if p is None else len(p.shape) for p in sd_dist.param_values())

    def _event_shape(self, *param_shapes):
        return (self.n * (self.n + 1) // 2,)

    def default_transform(self):
        return tr.CholeskyCovPackedTransform(self.n)

    def _logp(self, value, eta, *sd_params):
        n = self.n
        L = tril_unpack(value, n)
        sd = torch.sqrt(torch.clamp(torch.sum(L**2, dim=-1), min=1e-30))
        W = L / sd[..., None]
        lkj = _lkj_cholesky_corr_logp(W, eta, n)
        sd_logp = torch.sum(self.sd_dist._logp(sd, *sd_params), dim=-1)
        i = torch.arange(n, dtype=value.dtype, device=value.device)
        log_jac = torch.sum(i * torch.log(sd), dim=-1) - torch.sum(
            torch.log(torch.clamp(torch.diagonal(W, dim1=-2, dim2=-1), min=1e-30)), dim=-1)
        res = torch.where(torch.all(packed_diag(value, n) > 0, dim=-1),
                          lkj + sd_logp - log_jac, -torch.inf)
        return check_parameters(res, eta > 0)

    def _sample(self, generator, shape, eta, *sd_params):
        batch = tuple(shape[:-1])
        W = _sample_lkj_chol(generator, batch, self.n, eta)
        sd = self.sd_dist._sample(generator, batch + (self.n,), *sd_params)
        return tril_pack(W * sd[..., None])

    def _support_point(self, eta, *sd_params):
        n = self.n
        sd = torch.broadcast_to(self.sd_dist._support_point(*sd_params), (n,)).to(eta.dtype)
        return tril_pack(torch.eye(n, dtype=eta.dtype, device=eta.device) * sd[..., None])


def LKJCholeskyCov(name, eta, n, sd_dist, *, compute_corr=True, store_in_trace=True, **kwargs):
    """Reference multivariate.py:1313: registers the packed factor `name`
    and, with compute_corr, returns (chol, corr, stds), stored as the
    deterministics `{name}_chol`, `{name}_corr` and `{name}_stds` unless
    store_in_trace=False."""
    from ..model.core import Deterministic

    packed = _LKJCholeskyCov(name, eta, n, sd_dist, **kwargs)
    if not compute_corr:
        return packed
    n = int(n)
    chol = apply(lambda v: tril_unpack(v, n), packed)
    stds = apply(lambda L: torch.sqrt(torch.sum(L**2, dim=-1)), chol)
    corr = apply(lambda L, s: (L @ L.transpose(-1, -2)) / (s[..., None] * s[..., None, :]),
                 chol, stds)
    if store_in_trace:
        chol = Deterministic(f"{name}_chol", chol)
        corr = Deterministic(f"{name}_corr", corr)
        stds = Deterministic(f"{name}_stds", stds)
    return chol, corr, stds


class LKJCorr(Continuous):
    """The LKJ distribution over correlation matrices (reference
    multivariate.py:1578): the value is the packed strictly-lower entries
    of C (n (n - 1)/2), or the whole matrix with return_matrix=True, which
    has no default transform. The density is taken through C's Cholesky
    factor, the kernel's on the card; a matrix that is not positive
    definite gives -inf."""

    param_names = ("eta",)
    event_ndim = 1

    def __dist_init__(self, n, eta, return_matrix=False):
        self.n = int(n)
        self.eta = as_param(eta)
        self.return_matrix = bool(return_matrix)
        self.event_ndim = 2 if self.return_matrix else 1

    def _event_shape(self, eta_shape):
        if self.return_matrix:
            return (self.n, self.n)
        return (self.n * (self.n - 1) // 2,)

    def default_transform(self):
        return None if self.return_matrix else CorrPackedTransform(self.n)

    def _to_matrix(self, value):
        if self.return_matrix:
            return value
        C = tril_unpack(value, self.n, -1)
        return C + C.transpose(-1, -2) + torch.eye(self.n, dtype=value.dtype,
                                                   device=value.device)

    def _logp(self, value, eta):
        """logp of chol(C) minus log|d packed(C) / d free(W)| = sum_j (n - j)
        log W_jj."""
        n = self.n
        W = cholesky_batched(self._to_matrix(value))
        diag = torch.clamp(torch.diagonal(W, dim1=-2, dim2=-1), min=1e-30)
        j = torch.arange(1, n + 1, dtype=value.dtype, device=value.device)
        res = _lkj_cholesky_corr_logp(W, eta, n) - torch.sum((n - j) * torch.log(diag), dim=-1)
        ok = torch.all(torch.isfinite(W).flatten(-2), dim=-1)
        return check_parameters(torch.where(ok, res, -torch.inf), eta > 0)

    def _sample(self, generator, shape, eta):
        batch = tuple(shape[: len(shape) - self.event_ndim])
        W = _sample_lkj_chol(generator, batch, self.n, eta)
        C = W @ W.transpose(-1, -2)
        return C if self.return_matrix else tril_pack(C, -1)

    def _support_point(self, eta):
        if self.return_matrix:
            return torch.eye(self.n, dtype=eta.dtype, device=eta.device)
        return eta.new_zeros((self.n * (self.n - 1) // 2,))


class CorrPackedTransform(tr.Transform):
    """R^{n(n-1)/2} <-> the packed strictly-lower entries of a correlation
    matrix C = W W^T (LKJCorr's values; pymc_tpu multivariate.py:572): the
    canonical partial-correlation map to W, then C; the log-Jacobian adds
    sum_j (n - j) log W_jj for W -> packed(C). `forward` factors C with the
    Cholesky kernel."""

    name = "corr-packed"
    event_ndim = 1

    def __init__(self, n):
        self.n = int(n)
        self._chol_t = tr.CholeskyCorrTransform(n)

    def backward(self, v, env=None, memo=None):
        W = _packed_to_chol_corr(self._chol_t.backward(v), self.n)
        return tril_pack(W @ W.transpose(-1, -2), -1)

    def forward(self, x, env=None, memo=None):
        C = tril_unpack(x, self.n, -1)
        C = C + C.transpose(-1, -2) + torch.eye(self.n, dtype=x.dtype, device=x.device)
        return self._chol_t.forward(tril_pack(cholesky_batched(C), -1))

    def log_jac_det(self, v, env=None, memo=None):
        W = _packed_to_chol_corr(self._chol_t.backward(v), self.n)
        j = torch.arange(1, self.n + 1, dtype=v.dtype, device=v.device)
        diag = torch.clamp(torch.diagonal(W, dim1=-2, dim2=-1), min=1e-30)
        return self._chol_t.log_jac_det(v) + torch.sum((self.n - j) * torch.log(diag), dim=-1)

    def __repr__(self):
        return f"CorrPackedTransform(n={self.n})"


def _logdet_of_chol(L):
    """log det(L L^T) from a Cholesky factor."""
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


class Wishart(Continuous):
    """Reference multivariate.py:983: a (p, p) positive-definite value, its
    scale `V` or the scale's factor `scale_chol`. The default transform is
    CholeskyCovTransform, so gradient samplers take it directly. Both the
    value and V are factored by the Cholesky kernel: the log-determinants
    are the factors' and tr(V^-1 X) = ||L_V^-1 L_X||^2; a value whose
    factor is not finite (not positive definite) gives -inf, as PyMC's
    matrix_pos_def check does."""

    param_names = ("nu", "V")
    param_event_ndims = (0, 2)
    event_ndim = 2

    def __dist_init__(self, nu, V=None, scale_chol=None):
        self.nu = as_param(nu)
        if V is None:
            if scale_chol is None:
                raise ValueError("Wishart requires V or scale_chol")
            if isinstance(scale_chol, Node):
                V = apply(lambda L: L @ L.transpose(-1, -2), scale_chol)
            else:
                L = np.asarray(scale_chol, dtype=np.float64)
                V = L @ np.swapaxes(L, -1, -2)
        self.V = as_param(V)

    def default_transform(self):
        return tr.CholeskyCovTransform(int(self.V.shape[-1]))

    def _event_shape(self, nu_shape, V_shape):
        return tuple(V_shape[-2:])

    def _logp(self, value, nu, V):
        p = value.shape[-1]
        L_V = cholesky_batched(V)
        L_X = cholesky_batched(value)
        batch = torch.broadcast_shapes(L_X.shape[:-2], L_V.shape[:-2])
        A = torch.linalg.solve_triangular(L_V.expand(batch + L_V.shape[-2:]),
                                          L_X.expand(batch + L_X.shape[-2:]), upper=False)
        trace = torch.sum(A**2, dim=(-2, -1))
        j = torch.arange(1, p + 1, dtype=value.dtype, device=value.device)
        multigammaln = 0.25 * p * (p - 1) * math.log(math.pi) + torch.sum(
            torch.lgamma((nu[..., None] + 1.0 - j) / 2.0), dim=-1)
        res = (
            0.5 * (nu - p - 1.0) * _logdet_of_chol(L_X)
            - 0.5 * trace
            - 0.5 * nu * p * math.log(2.0)
            - 0.5 * nu * _logdet_of_chol(L_V)
            - multigammaln
        )
        ok = torch.all(torch.isfinite(L_X).flatten(-2), dim=-1)
        return check_parameters(torch.where(ok, res, -torch.inf), nu > p - 1)

    def _sample(self, generator, shape, nu, V):
        # the Bartlett decomposition
        p = V.shape[-1]
        batch = tuple(shape[:-2])
        L_V = cholesky_batched(V)
        normals = standard_normal(generator, batch + (p * (p - 1) // 2,), V)
        j = torch.arange(p, dtype=V.dtype, device=V.device)
        chi = standard_gamma(generator, ((nu[..., None] - j) / 2.0).expand(batch + (p,)))
        A = tril_unpack(normals, p, -1) + torch.diag_embed(torch.sqrt(2.0 * chi))
        LA = L_V @ A
        return LA @ LA.transpose(-1, -2)

    def _support_point(self, nu, V):
        return nu[..., None, None] * V


def WishartBartlett(name, S, nu, is_cholesky=False, return_cholesky=False, initval=None):
    """The Bartlett-decomposed Wishart prior, kept for backward
    compatibility (reference multivariate.py:1091; pymc_tpu
    multivariate.py:692): Wishart itself samples directly, so this warns and
    delegates to it; is_cholesky=True takes S as `scale_chol`, and
    return_cholesky=True returns the Cholesky factor of the draw as the
    deterministic `name` (of the Wishart `_{name}_wishart`)."""
    warnings.warn(
        "WishartBartlett is deprecated; use pm.Wishart directly "
        "(scale_chol= for a Cholesky-parameterized scale).",
        FutureWarning,
        stacklevel=2,
    )
    if initval is not None:
        raise NotImplementedError(
            "initval is not supported by the WishartBartlett shim; pass an "
            "SPD initval to pm.Wishart directly."
        )
    kw = {"scale_chol": S} if is_cholesky else {"V": S}
    if return_cholesky:
        from ..model.core import Deterministic

        w = Wishart(f"_{name}_wishart", nu=nu, **kw)
        return Deterministic(name, apply(cholesky_batched, w))
    return Wishart(name, nu=nu, **kw)


class MatrixNormal(Continuous):
    """Reference multivariate.py:1703: an (n, p) value with row covariance
    (rowcov, or its factor rowchol) and column covariance (colcov or
    colchol); each covariance is factored by the Cholesky kernel."""

    param_names = ("mu", "rowchol", "colchol")
    param_event_ndims = (2, 2, 2)
    event_ndim = 2

    def __dist_init__(self, mu=0.0, rowcov=None, rowchol=None, colcov=None, colchol=None):
        self.rowchol = _solve_chol_params(None, rowcov, None, rowchol)
        self.colchol = _solve_chol_params(None, colcov, None, colchol)
        self.mu = as_param(mu)

    def _event_shape(self, mu_shape, rowchol_shape, colchol_shape):
        return (rowchol_shape[-1], colchol_shape[-1])

    def _logp(self, value, mu, rowchol, colchol):
        n, p = value.shape[-2], value.shape[-1]
        diff = value - mu
        batch = torch.broadcast_shapes(diff.shape[:-2], rowchol.shape[:-2], colchol.shape[:-2])
        rc = rowchol.expand(batch + rowchol.shape[-2:])
        cc = colchol.expand(batch + colchol.shape[-2:])
        # L_r Z = diff, then Z L_c^-T: two triangular solves
        z = torch.linalg.solve_triangular(rc, diff.expand(batch + diff.shape[-2:]), upper=False)
        z = torch.linalg.solve_triangular(cc, z.transpose(-1, -2), upper=False)
        quad = torch.sum(z**2, dim=(-2, -1))
        logdet_r = torch.sum(torch.log(torch.abs(_diag(rowchol))), dim=-1)
        logdet_c = torch.sum(torch.log(torch.abs(_diag(colchol))), dim=-1)
        return -0.5 * (n * p * _LOG_2PI + quad) - p * logdet_r - n * logdet_c

    def _sample(self, generator, shape, mu, rowchol, colchol):
        z = standard_normal(generator, shape, rowchol)
        return mu + rowchol @ z @ colchol.transpose(-1, -2)

    def _support_point(self, mu, rowchol, colchol):
        return torch.broadcast_to(mu, torch.broadcast_shapes(
            mu.shape, rowchol.shape[:-2] + (rowchol.shape[-1], colchol.shape[-1])))


def _car_eigvals(W):
    """The eigenvalues of D^-1/2 W D^-1/2 (D = diag of W's row sums) of a
    constant adjacency matrix, in float64."""
    W = np.asarray(W, dtype=np.float64)
    d_inv_sqrt = 1.0 / np.sqrt(np.sum(W, axis=-1))
    return np.linalg.eigvalsh(W * d_inv_sqrt[..., :, None] * d_inv_sqrt[..., None, :])


class CAR(Continuous):
    """The conditional autoregressive prior (reference
    multivariate.py:2160): mu, adjacency W, alpha, tau. Its log-determinant
    takes the eigenvalues of D^-1/2 W D^-1/2; a constant W's are computed
    once here (`W_eigvals`, a constant of the graph, placed on the device
    with the others), so the density has no eigendecomposition, which would
    wait for the host on the card; a symbolic W's are taken on each call.
    A W that is not symmetric gives -inf."""

    param_names = ("mu", "W", "alpha", "tau")
    aux_param_names = ("W_eigvals",)
    param_event_ndims = (1, 2, 0, 0)
    event_ndim = 1

    def __dist_init__(self, mu, W, alpha, tau):
        self.mu = as_param(mu)
        if not isinstance(W, Node) and np.ndim(W) != 2:
            raise TypeError("W must be a matrix")
        self.W = as_param(W)
        self.W_eigvals = None if isinstance(W, Node) else as_param(_car_eigvals(W))
        self.alpha = as_param(alpha)
        self.tau = as_param(tau)

    def _event_shape(self, mu_shape, W_shape, a_shape, t_shape):
        return (W_shape[-1],)

    def _logp(self, value, mu, W, alpha, tau, W_eigvals=None):
        n = value.shape[-1]
        d = torch.sum(W, dim=-1)
        diff = value - mu
        if W_eigvals is None:
            d_inv_sqrt = 1.0 / torch.sqrt(d)
            W_eigvals = torch.linalg.eigvalsh(
                W * d_inv_sqrt[..., :, None] * d_inv_sqrt[..., None, :])
        logdet = torch.sum(torch.log1p(-alpha[..., None] * W_eigvals), dim=-1) + torch.sum(
            torch.log(d), dim=-1)
        Wx = torch.einsum("...ij,...j->...i", W, diff)
        quad = tau * (torch.sum(d * diff**2, dim=-1) - alpha * torch.sum(diff * Wx, dim=-1))
        res = 0.5 * (n * torch.log(tau) + logdet - quad - n * _LOG_2PI)
        w_sym = torch.all(torch.isclose(W, W.transpose(-1, -2)).flatten(-2), dim=-1)
        return check_parameters(res, tau > 0, torch.abs(alpha) < 1, w_sym)

    def _sample(self, generator, shape, mu, W, alpha, tau, W_eigvals=None):
        d = torch.sum(W, dim=-1)
        prec = tau[..., None, None] * (torch.diag_embed(d) - alpha[..., None, None] * W)
        L = cholesky_batched(torch.linalg.inv(prec))
        z = standard_normal(generator, shape, L)
        return mu + torch.einsum("...ij,...j->...i", L, z)

    def _support_point(self, mu, W, alpha, tau):
        return torch.broadcast_to(mu, torch.broadcast_shapes(mu.shape, W.shape[:-1]))


def _laplacian(W):
    return torch.diag_embed(torch.sum(W, dim=-1)) - W


class ICAR(Continuous):
    """The intrinsic CAR prior (reference multivariate.py:2315), improper:
    the pairwise-difference energy at scale sigma plus a soft zero-sum
    Normal on the raw value with sd zero_sum_stdev * n. A constant W must
    be a square symmetric 0/1 matrix. It cannot be drawn from."""

    param_names = ("W", "sigma")
    param_event_ndims = (2, 0)
    event_ndim = 1

    def __dist_init__(self, W, sigma=1.0, zero_sum_stdev=0.001):
        if not isinstance(W, Node):
            W_ = np.asarray(W)
            if W_.ndim != 2:
                raise ValueError("W must be matrix with ndim=2")
            if W_.shape[0] != W_.shape[1]:
                raise ValueError("W must be a square matrix")
            if not np.allclose(W_.T, W_):
                raise ValueError("W must be a symmetric matrix")
            if np.any((W_ != 0) & (W_ != 1)):
                raise ValueError("W must be composed of only 1s and 0s")
        self.W = as_param(W)
        self.sigma = as_param(sigma)
        self.zero_sum_stdev = float(zero_sum_stdev)

    def _event_shape(self, W_shape, s_shape):
        return (W_shape[-1],)

    def _logp(self, value, W, sigma):
        n = value.shape[-1]
        phi = value / sigma
        pairwise = -0.5 * torch.einsum("...i,...ij,...j->...", phi, _laplacian(W), phi)
        zero_sum_sd = self.zero_sum_stdev * n
        soft = (-0.5 * (torch.sum(value, dim=-1) / zero_sum_sd) ** 2
                - math.log(zero_sum_sd) - 0.5 * _LOG_2PI)
        return check_parameters(pairwise + soft, sigma > 0)

    def _sample(self, generator, shape, W, sigma):
        raise NotImplementedError("Cannot sample from ICAR prior")

    def _support_point(self, W, sigma):
        return W.new_zeros(W.shape[:-1])


class StickBreakingWeights(Continuous):
    """Reference multivariate.py:2501: K + 1 simplex weights from K
    Beta(1, alpha) sticks. p(w) = alpha^K w_{K+1}^(alpha - 1) /
    prod_{k=1}^{K-1} R_k, R_k = 1 - sum_{j<=k} w_j."""

    param_names = ("alpha",)
    event_ndim = 1
    support = "simplex"

    def __dist_init__(self, alpha, K):
        self.alpha = as_param(alpha)
        self.K = int(K)

    def _event_shape(self, alpha_shape):
        return (self.K + 1,)

    def _logp(self, value, alpha):
        K = self.K
        safe = torch.clamp(value, 1e-30, 1.0)
        remainders = torch.flip(torch.cumsum(torch.flip(value, dims=(-1,)), dim=-1), dims=(-1,))
        res = (
            K * torch.log(alpha)
            + (alpha - 1.0) * torch.log(safe[..., -1])
            - torch.sum(torch.log(torch.clamp(remainders[..., 1:-1], min=1e-30)), dim=-1)
        )
        in_simplex = torch.all(value >= 0, dim=-1) & (
            torch.abs(torch.sum(value, dim=-1) - 1.0) < 1e-6)
        return check_parameters(torch.where(in_simplex, res, -torch.inf), alpha > 0)

    def _sample(self, generator, shape, alpha):
        sticks_shape = tuple(shape[:-1]) + (self.K,)
        betas = _beta_draws(generator, sticks_shape, alpha.new_ones(()), alpha[..., None])
        left = torch.cat([torch.ones_like(betas[..., :1]), torch.cumprod(1.0 - betas, dim=-1)],
                         dim=-1)
        return torch.cat([betas, torch.ones_like(betas[..., :1])], dim=-1) * left

    def _support_point(self, alpha):
        # the expected weights: (1/(1+a)) (a/(1+a))^(k-1), the tail (a/(1+a))^K
        K = self.K
        a = alpha[..., None]
        ks = torch.arange(K + 1, dtype=alpha.dtype, device=alpha.device)
        w = (1.0 / (1.0 + a)) * (a / (1.0 + a)) ** ks
        return torch.cat([w[..., :-1], (a / (1.0 + a)) ** K], dim=-1)


class ZeroSumNormal(Continuous):
    """A Normal constrained to sum to zero over its last `n_zerosum_axes`
    axes (reference multivariate.py:2654), sigma the scale of the
    unconstrained fluctuation. Its shape comes from `shape=` or
    `support_shape=`. A value whose sums along any of those axes reach
    1e-6 sqrt(n) (n the product of their lengths) gives -inf."""

    param_names = ("sigma",)
    support = "zerosum"

    def __dist_init__(self, sigma=1.0, n_zerosum_axes=1, support_shape=None):
        self.sigma = as_param(sigma)
        self.n_zerosum_axes = int(n_zerosum_axes)
        self.event_ndim = self.n_zerosum_axes
        self._support_shape = support_shape

    def _resolve_shapes(self, shape):
        self._explicit_shape = shape
        super()._resolve_shapes(shape)

    def _event_shape(self, sigma_shape):
        if self._explicit_shape is not None:
            return tuple(self._explicit_shape[-self.n_zerosum_axes:])
        if self._support_shape is not None:
            ss = self._support_shape
            return tuple(ss) if np.ndim(ss) else (int(ss),)
        raise ValueError("ZeroSumNormal requires shape= or support_shape=")

    def default_transform(self):
        return tr.ZeroSumTransform(self.n_zerosum_axes)

    def _logp(self, value, sigma):
        nza = self.n_zerosum_axes
        axes = tuple(range(-nza, 0))
        n_full = math.prod(value.shape[ax] for ax in axes)
        n_free = float(math.prod(value.shape[ax] - 1 for ax in axes))
        quad = torch.sum((value / sigma) ** 2, dim=axes)
        # every slice along each zerosum axis sums to zero, not only the total
        ok = None
        for ax in axes:
            small = torch.abs(torch.sum(value, dim=ax)) < 1e-6 * math.sqrt(n_full)
            if nza > 1:
                small = torch.all(small.flatten(-(nza - 1)), dim=-1)
            ok = small if ok is None else ok & small
        res = -0.5 * quad - n_free * (torch.log(sigma) + 0.5 * _LOG_2PI)
        return check_parameters(torch.where(ok, res, -torch.inf), sigma > 0)

    def _sample(self, generator, shape, sigma):
        z = sigma * standard_normal(generator, shape, sigma)
        for i in range(self.n_zerosum_axes):
            z = z - torch.mean(z, dim=-(i + 1), keepdim=True)
        return z

    def _support_point(self, sigma):
        return sigma.new_zeros(self.event_shape)
