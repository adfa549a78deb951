"""GP model classes: Latent, Marginal, TP, MarginalApprox (FITC, VFE, DTC),
LatentKron and MarginalKron, with `conditional` and `Marginal.predict`.

Counterpart of `pymc_tpu/gp/gp.py` (reference pymc/gp/gp.py). Every
Cholesky factor goes through `ops.linalg.cholesky_batched`, the
hand-written kernel on the card; triangular solves and products are
library calls, as the JAX package leaves them to XLA. Each GP object keeps
(X, f or y, sigma) from `prior`/`marginal_likelihood`, and `conditional`
registers the closed-form predictive distribution. Its pieces (the factor,
the solves, the mean, the covariance) are separate graph nodes, so one
evaluation factors each matrix once.

The diagonal jitter follows the JAX package's values in float64. In
float32 the default is the port's dtype-aware rule: at least 1e-4 and a
fraction of the mean of the matrix's diagonal, 3e-5 for a prior's factored
covariance (`_stabilize`) and 3e-4 for a conditional covariance
(`_cond_jitter`), whose difference of two matrices loses more digits.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..graph import Node, apply, as_tensor, evaluate, place_constants
from ..ops.linalg import cholesky_batched
from . import cov as gp_cov
from . import mean as gp_mean
from .util import JITTER_DEFAULT

__all__ = [
    "Latent", "Marginal", "TP", "MarginalApprox", "MarginalSparse", "LatentKron",
    "MarginalKron",
]


def _eye(k):
    return torch.eye(k.shape[-1], dtype=k.dtype, device=k.device)


# The float32 default jitter of a prior's covariance is at least 1e-4 and
# F32_PRIOR_JITTER times the mean of its diagonal. The jitter is iid variance
# added to f, which a Gaussian likelihood takes out of sigma^2: for the
# latent GP of benchmarks/suite.py::case_gp the exact posterior mean of
# sigma is 0.30587 at float64's 1e-6, 0.30276 at 3e-4 (the JAX package's
# factor) and 0.30556 at 3e-5. LAPACK's float32 Cholesky of that model's
# kernel stays finite down to 1e-5, with a backward error of a third of the
# jitter there and a ninth at 3e-5 (scripts/gp_latent_jitter_posterior.py)
F32_PRIOR_JITTER = 3e-5
F32_COND_JITTER = 3e-4


def _jitter_f32(k, jitter, rel):
    """The float32 jitter of `k`: `jitter` if given, else at least 1e-4 and
    `rel` times the mean of k's diagonal."""
    j = _resolve_jitter(jitter, k.dtype)
    if jitter is None:
        j = torch.clamp_min(rel * torch.mean(torch.diagonal(k, dim1=-2, dim2=-1)), j)
    return j


def _stabilize(K, jitter=None):
    """Diagonal jitter for Cholesky safety (reference gp/util.py:77).

    The default is dtype-aware: the reference's 1e-6 assumes float64; in
    float32 kernel matrices with near-duplicate inputs are indefinite at that
    level, so the float32 default is 1e-4, raised to F32_PRIOR_JITTER times
    the mean of the diagonal when the kernel's amplitude is large."""

    def _f(k):
        if k.dtype == torch.float64:
            j = _resolve_jitter(jitter, k.dtype)
        else:
            j = _jitter_f32(k, jitter, F32_PRIOR_JITTER)
        return k + j * _eye(k)

    return apply(_f, K)


def _resolve_jitter(jitter, dtype):
    if jitter is not None:
        return jitter
    return JITTER_DEFAULT if dtype == torch.float64 else 1e-4


def _cond_jitter(cov, jitter, f64_value):
    """cov + jitter I for a conditional covariance: `f64_value` (the JAX
    package's) in float64, the float32 rule otherwise."""
    j = f64_value if cov.dtype == torch.float64 else _jitter_f32(cov, jitter, F32_COND_JITTER)
    return cov + j * _eye(cov)


def _as_input(X):
    return X if isinstance(X, Node) else as_tensor(X)


def _solve_lower(L, B):
    """L^{-1} B for a lower-triangular L and a matrix or vector B."""
    if B.ndim == 1:
        return torch.linalg.solve_triangular(L, B[:, None], upper=False)[:, 0]
    return torch.linalg.solve_triangular(L, B, upper=False)


def _solve_upper(U, b):
    return torch.linalg.solve_triangular(U, b[:, None], upper=True)[:, 0]


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


def _totals(gp, given):
    """(cov, mean) of the additive total named by given["gp"], else gp's own
    (reference gp.py:201-214)."""
    if "gp" in given:
        return given["gp"].cov_func, given["gp"].mean_func
    return gp.cov_func, gp.mean_func


def _posterior_mean_and_factor(L, Kxs, resid):
    """Nodes (A, v) = (L^-1 Kxs, L^-1 resid): the mean is mu_s + A^T v and
    the covariance Kss - A^T A."""
    A = apply(_solve_lower, L, Kxs)
    v = apply(_solve_lower, L, resid)
    return A, v


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
        self.X, self.f = X, f
        return f

    def _get_given_vals(self, given):
        """`given` may name the additive total gp and its (X, f), so that a
        component is conditioned on the sum's values (reference
        gp.py:201-214)."""
        given = given or {}
        cov_total, mean_total = _totals(self, given)
        if all(val in given for val in ("X", "f")):
            X, f = given["X"], given["f"]
        else:
            X, f = self.X, self.f
        return X, f, cov_total, mean_total

    def _build_conditional(self, Xnew, jitter, X, f, cov_total, mean_total):
        """(mean, covariance) nodes at Xnew: Kxx and the residual from the
        total process, the cross and new covariances from this component's
        kernel (reference gp.py:216-229)."""
        L = apply(cholesky_batched, _stabilize(cov_total(X), jitter))
        resid = apply(torch.sub, _as_input(f), mean_total(X))
        A, v = _posterior_mean_and_factor(L, self.cov_func(X, Xnew), resid)
        mu = apply(lambda ms, a, vv: ms + a.T @ vv, self.mean_func(Xnew), A, v)
        cov = apply(
            lambda kss, a: _cond_jitter(kss - a.T @ a, jitter, JITTER_DEFAULT),
            self.cov_func(Xnew), A,
        )
        return mu, cov

    def conditional(self, name, Xnew, given=None, jitter=None, **kwargs):
        """f* ~ MvNormal at Xnew, given the prior's f (or `given`)."""
        from ..distributions import MvNormal

        mu, cov = self._build_conditional(_as_input(Xnew), jitter, *self._get_given_vals(given))
        return MvNormal(name, mu=mu, cov=cov, **kwargs)


class TP(Latent):
    """Student-t process (reference gp.py TP)."""

    def __init__(self, mean_func=None, scale_func=None, cov_func=None, nu=None):
        if nu is None:
            raise ValueError("Student's T process requires a degrees of freedom parameter, 'nu'")
        super().__init__(mean_func, scale_func if scale_func is not None else cov_func)
        self.nu = nu

    def __add__(self, other):
        # reference gp.py:316-318
        raise TypeError("Student's T processes aren't additive")

    def prior(self, name, X, reparameterize=True, jitter=None, **kwargs):
        """f = mu + sqrt(nu / chi2) L v with chi2 ~ ChiSquared(nu) and v ~
        N(0, I) (reparameterize=True), or f ~ MvStudentT(nu, mu, chol=L)."""
        from ..distributions import ChiSquared, MvStudentT, Normal
        from ..model.core import Deterministic

        X = _as_input(X)
        n = X.shape[0]
        mu = self.mean_func(X)
        chol = apply(cholesky_batched, _stabilize(self.cov_func(X), jitter))
        if reparameterize:
            chi2 = ChiSquared(f"{name}_chi2_", self.nu)
            v = Normal(f"{name}_rotated_", 0.0, 1.0, shape=(n,), **kwargs)
            f = Deterministic(name, apply(
                lambda m, L, vv, c2, nu: m + torch.sqrt(nu / c2) * (L @ vv),
                mu, chol, v, chi2, self.nu,
            ))
        else:
            f = MvStudentT(name, nu=self.nu, mu=mu, chol=chol, **kwargs)
        self.X, self.f = X, f
        return f

    def conditional(self, name, Xnew, jitter=None, **kwargs):
        """TP conditional: the degrees of freedom grow by n and the
        covariance carries the Mahalanobis correction (reference
        gp.py:360-380)."""
        from ..distributions import MvStudentT

        X, f = self.X, self.f
        n = X.shape[0]
        L = apply(cholesky_batched, _stabilize(self.cov_func(X), jitter))
        resid = apply(torch.sub, f, self.mean_func(X))
        A, v = _posterior_mean_and_factor(L, self.cov_func(X, _as_input(Xnew)), resid)
        mu = apply(lambda ms, a, vv: ms + a.T @ vv, self.mean_func(Xnew), A, v)

        def cov_fn(kss, a, vv, nu):
            scale = (nu + torch.sum(vv**2) - 2.0) / (nu + n - 2.0)
            return _cond_jitter(scale * (kss - a.T @ a), jitter, JITTER_DEFAULT)

        cov = apply(cov_fn, self.cov_func(Xnew), A, v, self.nu)
        nu_new = apply(lambda nu: nu + n, self.nu)
        return MvStudentT(name, nu=nu_new, mu=mu, cov=cov, **kwargs)


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
            lambda k, kn: k + kn + JITTER_DEFAULT * _eye(k), self.cov_func(X), noise_func(X)
        )
        self.X, self.y, self.sigma = X, y, noise_func
        return MvNormal(name, mu=mu, cov=cov, observed=y, **kwargs)

    def _get_given_vals(self, given):
        """`given` may carry the additive total gp and its (X, y, sigma)
        (reference gp.py:512-528)."""
        given = given or {}
        cov_total, mean_total = _totals(self, given)
        if all(val in given for val in ("X", "y", "sigma")):
            X, y = given["X"], given["y"]
            noise_func = self._as_noise_func(given["sigma"])
        else:
            X, y, noise_func = self.X, self.y, self.sigma
        return X, y, noise_func, cov_total, mean_total

    def _build_conditional(self, Xnew, pred_noise, diag, jitter,
                           X, y, noise_func, cov_total, mean_total):
        """(mean, covariance or variance) nodes at Xnew (reference
        gp.py:283-321)."""

        def factor(kxx, knx):
            return cholesky_batched(kxx + knx + _resolve_jitter(jitter, kxx.dtype) * _eye(kxx))

        L = apply(factor, cov_total(X), noise_func(X))
        resid = apply(torch.sub, _as_input(y), mean_total(X))
        A, v = _posterior_mean_and_factor(L, self.cov_func(X, Xnew), resid)
        mu = apply(lambda ms, a, vv: ms + a.T @ vv, self.mean_func(Xnew), A, v)
        Kss = self.cov_func(Xnew, diag=diag)
        noise = (noise_func(Xnew, diag=diag),) if pred_noise else ()
        if diag:
            var = apply(lambda kss, a, *kns: kss - torch.sum(a**2, dim=0) + sum(kns), Kss, A,
                        *noise)
            return mu, var

        def cov_fn(kss, a, *kns):
            cov = kss - a.T @ a + sum(kns)
            return _cond_jitter(cov, jitter, _resolve_jitter(jitter, torch.float64))

        return mu, apply(cov_fn, Kss, A, *noise)

    def conditional(self, name, Xnew, pred_noise=False, given=None, jitter=None, **kwargs):
        """f* (or y* with pred_noise=True) ~ MvNormal at Xnew, given the
        observed y (or `given`)."""
        from ..distributions import MvNormal

        mu, cov = self._build_conditional(
            _as_input(Xnew), pred_noise, False, jitter, *self._get_given_vals(given)
        )
        return MvNormal(name, mu=mu, cov=cov, **kwargs)

    def predict_fn(self, Xnew, diag=False, pred_noise=False, given=None, jitter=None,
                   device=None, dtype=None):
        """fn(point) -> (mean, covariance or variance) as tensors on
        `device` (default: the card) in `dtype` (default: floatX(device)),
        where point maps the model's variable names to their constrained
        values there. torch.func.vmap maps it over a batch of points."""
        from ..config import floatX, resolve_device

        device = resolve_device(device)
        dtype = dtype or floatX(device)
        mu, cov = self._build_conditional(
            as_tensor(Xnew), pred_noise, diag, jitter, *self._get_given_vals(given)
        )
        placed = place_constants([mu, cov], device, dtype)

        def fn(point):
            memo = dict(placed)
            return evaluate(mu, point, memo), evaluate(cov, point, memo)

        return fn

    def predict(self, Xnew, point=None, diag=False, pred_noise=False, given=None,
                jitter=None, model=None, device=None):
        """Closed-form predictive moments at a point, as numpy arrays
        (reference Marginal.predict); evaluated on `device` (default: the
        card) in its float type."""
        from ..config import floatX, resolve_device

        device = resolve_device(device)
        dtype = floatX(device)
        fn = self.predict_fn(Xnew, diag, pred_noise, given, jitter, device, dtype)
        env = {
            k: torch.as_tensor(np.asarray(v), device=device).to(dtype)
            for k, v in (point or {}).items()
        }
        mu, cov = fn(env)
        return mu.cpu().numpy(), cov.cpu().numpy()


class MarginalApprox(Marginal):
    """Sparse approximations FITC, VFE and DTC with inducing points Xu
    (reference gp.py MarginalApprox). The approximate marginal likelihood
    is added as a Potential; each evaluation factors the (m, m) Kuu and the
    (m, m) B = I + A Lambda^-1 A^T, two Cholesky launches."""

    _available_approx = ("FITC", "VFE", "DTC")

    def __init__(self, approx="VFE", mean_func=None, cov_func=None):
        if approx not in self._available_approx:
            raise NotImplementedError(f"approx must be one of {self._available_approx}")
        self.approx = approx
        super().__init__(mean_func, cov_func)

    def __add__(self, other):
        # reference gp.py MarginalApprox.__add__: only same approximations add
        new_gp = super().__add__(other)
        if not self.approx == other.approx:
            raise TypeError("Cannot add GPs with different approximations")
        new_gp.approx = self.approx
        return new_gp

    def _factors(self, Kuu, Kuf, Kffd, sigma, jitter):
        """Nodes (Luu, A = Luu^-1 Kuf, Lambda's diagonal, L_B)."""
        approx = self.approx

        def luu(kuu):
            return cholesky_batched(kuu + _resolve_jitter(jitter, kuu.dtype) * _eye(kuu))

        Luu = apply(luu, Kuu)
        A = apply(_solve_lower, Luu, Kuf)

        def lamd(a, kffd, s):
            n = a.shape[1]
            if approx == "FITC":
                return torch.clamp_min(kffd - torch.sum(a**2, dim=0), 0.0) + s**2
            return s**2 * torch.ones(n, dtype=a.dtype, device=a.device)

        Lamd = apply(lamd, A, Kffd, sigma)

        def lb(a, lam):
            B = (a / lam) @ a.T
            return cholesky_batched(_eye(B) + B)

        return Luu, A, Lamd, apply(lb, A, Lamd)

    def marginal_likelihood(self, name, X, Xu, y, sigma=None, noise=None,
                            jitter=None, is_observed=True, **kwargs):
        """Potential(name, approximate log marginal likelihood of y)."""
        from ..model.core import Potential

        if sigma is None:
            sigma = noise
        if sigma is None:
            raise ValueError("MarginalApprox requires sigma")
        X, Xu = _as_input(X), _as_input(Xu)
        self.X, self.Xu, self.y, self.sigma = X, Xu, y, sigma
        approx = self.approx
        _, A, Lamd, L_B = self._factors(
            self.cov_func(Xu), self.cov_func(Xu, X), self.cov_func(X, diag=True), sigma, jitter
        )

        def logp(a, lam, lb, kffd, mx, yv, s):
            n = a.shape[1]
            trace = 0.0
            if approx == "VFE":
                trace = -0.5 * torch.sum(torch.clamp_min(kffd - torch.sum(a**2, dim=0), 0.0)) / s**2
            r = yv - mx
            r_l = r / lam
            c = _solve_lower(lb, a @ r_l)
            constant = 0.5 * n * np.log(2.0 * np.pi)
            logdet = torch.sum(torch.log(torch.diagonal(lb))) + 0.5 * torch.sum(torch.log(lam))
            quad = 0.5 * (torch.sum(r * r_l) - torch.sum(c * c))
            return -constant - logdet - quad + trace

        pot = apply(logp, A, Lamd, L_B, self.cov_func(X, diag=True), self.mean_func(X),
                    _as_input(y), sigma)
        return Potential(name, pot)

    def _get_given_vals(self, given):
        """Reference MarginalApprox._get_given_vals: (X, Xu, y, sigma)."""
        given = given or {}
        cov_total, mean_total = _totals(self, given)
        if all(val in given for val in ("X", "Xu", "y", "sigma")):
            X, Xu, y, sigma = given["X"], given["Xu"], given["y"], given["sigma"]
        else:
            X, Xu, y, sigma = self.X, self.Xu, self.y, self.sigma
        return X, Xu, y, sigma, cov_total, mean_total

    def _build_conditional(self, Xnew, pred_noise, diag, jitter,
                           X, Xu, y, sigma, cov_total, mean_total):
        """Kuu, Kuf and Kff's diagonal from the total kernel; the cross and
        new covariances from this component's (reference
        MarginalApprox._build_conditional)."""
        Luu, A, Lamd, L_B = self._factors(
            cov_total(Xu), cov_total(Xu, X), cov_total(X, diag=True), sigma, jitter
        )
        c = apply(lambda a, lam, lb, yv, mx: _solve_lower(lb, a @ ((yv - mx) / lam)),
                  A, Lamd, L_B, _as_input(y), mean_total(X))
        As = apply(_solve_lower, Luu, self.cov_func(Xu, Xnew))
        mu = apply(lambda ms, a_s, lb, cc: ms + a_s.T @ _solve_upper(lb.T, cc),
                   self.mean_func(Xnew), As, L_B, c)
        Cm = apply(_solve_lower, L_B, As)
        Kss = self.cov_func(Xnew, diag=diag)
        if diag:
            def var_fn(kss, a_s, cm, s):
                var = kss - torch.sum(a_s**2, dim=0) + torch.sum(cm**2, dim=0)
                return var + s**2 if pred_noise else var

            return mu, apply(var_fn, Kss, As, Cm, sigma)

        def cov_fn(kss, a_s, cm, s):
            cov = kss - a_s.T @ a_s + cm.T @ cm
            if pred_noise:
                cov = cov + s**2 * _eye(cov)
            return _cond_jitter(cov, jitter, _resolve_jitter(jitter, torch.float64))

        return mu, apply(cov_fn, Kss, As, Cm, sigma)


class MarginalSparse(MarginalApprox):
    """Deprecated alias of MarginalApprox (reference gp/gp.py MarginalSparse)."""

    def __init__(self, *args, **kwargs):
        warnings.warn("gp.MarginalSparse has been renamed to gp.MarginalApprox.", FutureWarning)
        super().__init__(*args, **kwargs)


def kron_matvec(v, *Ls):
    """(L_1 (x) L_2 (x) ...) v without the Kronecker product: one matmul a
    factor, in the JAX package's order of axes (gp.py:526-532)."""
    x = v
    for L in Ls:
        x = (L @ x.reshape(L.shape[-1], -1)).T.reshape(-1)
    return x


class LatentKron(Base):
    """Latent GP over a Kronecker-structured input grid (reference gp.py
    LatentKron): chol(K1 (x) K2) = chol(K1) (x) chol(K2), one Cholesky a
    factor, applied by `kron_matvec`."""

    def __init__(self, mean_func=None, cov_funcs=None):
        self.cov_funcs = list(cov_funcs)
        super().__init__(mean_func, self.cov_funcs[0])

    def prior(self, name, Xs, jitter=None, **kwargs):
        from ..distributions import Normal
        from ..model.core import Deterministic

        self.Xs = [as_tensor(X) for X in Xs]
        N = int(np.prod([X.shape[0] for X in self.Xs]))
        chols = [
            apply(lambda k: cholesky_batched(k + _resolve_jitter(jitter, k.dtype) * _eye(k)),
                  cf(X))
            for cf, X in zip(self.cov_funcs, self.Xs)
        ]
        v = Normal(f"{name}_rotated_", 0.0, 1.0, shape=(N,), **kwargs)
        self.f = Deterministic(name, apply(kron_matvec, v, *chols))
        return self.f


class MarginalKron(Base):
    """Marginal GP on a Kronecker grid with iid noise, through the
    KroneckerNormal distribution (reference gp.py MarginalKron): one
    eigendecomposition a factor, no Cholesky."""

    def __init__(self, mean_func=None, cov_funcs=None):
        self.cov_funcs = list(cov_funcs)
        super().__init__(mean_func, self.cov_funcs[0])

    def marginal_likelihood(self, name, Xs, y, sigma, **kwargs):
        from ..distributions import KroneckerNormal

        self.Xs = [as_tensor(X) for X in Xs]
        covs = [cf(X) for cf, X in zip(self.cov_funcs, self.Xs)]
        N = int(np.prod([X.shape[0] for X in self.Xs]))
        return KroneckerNormal(name, mu=np.zeros(N), covs=covs, sigma=sigma, observed=y,
                               **kwargs)
