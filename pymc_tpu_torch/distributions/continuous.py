"""Continuous univariate distributions.

Counterpart of `pymc_tpu/distributions/continuous.py` (Uniform :68 through
PolyaGamma :1488; reference pymc/distributions/continuous.py). Densities
and log-cdfs are elementwise tensor expressions in the JAX package's forms:
an invalid parameter gives -inf and never raises, a value outside the
support gives -inf, and the masked branch of every `torch.where` is fed a
safe value first (clamp, then where), so its gradient stays finite. Draws
(`_sample`) come from an explicit `torch.Generator`: gamma-based ones
(Gamma, Beta, StudentT, InverseGamma, ...) through `torch._standard_gamma`,
which takes the generator, the rest from standard normals, uniforms and
exponentials. `_icdf` is not ported yet (`Distribution.icdf` raises).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..graph import apply
from .dist_math import (
    betainc, betaln, check_parameters, gammainc, gammaincc, log1mexp, log_i0, log_normal,
    logpow, normal_lcdf, normal_lccdf, safe_log, softplus,
)
from .distribution import Continuous, as_param, standard_normal, standard_uniform

__all__ = [
    "Uniform", "Flat", "HalfFlat", "Normal", "TruncatedNormal", "HalfNormal",
    "Wald", "Beta", "Kumaraswamy", "Exponential", "Laplace",
    "AsymmetricLaplace", "LogNormal", "Lognormal", "StudentT", "HalfStudentT",
    "Pareto", "Cauchy", "HalfCauchy", "Gamma", "InverseGamma", "ChiSquared",
    "Weibull", "ExGaussian", "VonMises", "SkewNormal", "Triangular", "Gumbel",
    "Logistic", "LogitNormal", "Rice", "Moyal", "Interpolated",
    "SkewStudentT", "PolyaGamma",
]

_LOG_2_OVER_PI = math.log(2.0 / math.pi)
_SQRT_2 = math.sqrt(2.0)
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
_LOG_2PI = math.log(2.0 * math.pi)
_EULER = 0.5772156649015329


def standard_gamma(generator, alpha):
    """Gamma(alpha, 1) draws of alpha's shape; `torch.distributions.Gamma`
    would not take the generator."""
    return torch._standard_gamma(alpha.contiguous(), generator=generator)


def standard_exponential(generator, shape, like):
    """Exp(1) draws of `shape` in `like`'s float type, on its device, as
    -log(1 - U): out of place, so that `torch.func.vmap(...,
    randomness="different")` (the forward samplers) draws anew for each
    point, which an in-place `exponential_` cannot."""
    return -torch.log1p(-standard_uniform(generator, shape, like))


def _beta_draws(generator, shape, alpha, beta):
    """Beta(alpha, beta) draws of `shape` from two gamma draws."""
    ga = standard_gamma(generator, alpha.expand(shape))
    gb = standard_gamma(generator, beta.expand(shape))
    return ga / (ga + gb)


def _student_t_draws(generator, shape, nu):
    """Standard Student-t draws of `shape`: z / sqrt(chi2_nu / nu)."""
    z = standard_normal(generator, shape, nu)
    g = standard_gamma(generator, (nu / 2.0).expand(shape))
    return z * torch.rsqrt(g / (nu / 2.0))


def _broadcast(*xs):
    return torch.broadcast_shapes(*[x.shape for x in xs])


def _sigma_tau(sigma, tau):
    """Resolve the (sigma, tau) alternative parametrization (reference
    continuous.py get_tau_sigma)."""
    if sigma is not None and tau is not None:
        raise ValueError("Can't pass both tau and sigma")
    if sigma is None and tau is None:
        return as_param(1.0)
    if tau is not None:
        return apply(lambda t: 1.0 / torch.sqrt(t), as_param(tau))
    return as_param(sigma)


def _lam_sigma(sigma, lam):
    """Resolve the (sigma, lam) alternative parametrization of the
    Student-t family (lam is the precision)."""
    if sigma is not None and lam is not None:
        raise ValueError("Can't pass both lam and sigma")
    if sigma is None and lam is None:
        return as_param(1.0)
    if lam is not None:
        return apply(lambda l: 1.0 / torch.sqrt(l), as_param(lam))
    return as_param(sigma)


class Uniform(Continuous):
    """Reference continuous.py:249."""

    param_names = ("lower", "upper")
    support = "interval"

    def __dist_init__(self, lower=0.0, upper=1.0):
        self.lower = as_param(lower)
        self.upper = as_param(upper)

    def _interval_bounds(self):
        return self.lower, self.upper

    def _logp(self, value, lower, upper):
        res = -torch.log(upper - lower)
        res = torch.where((value >= lower) & (value <= upper), res, -torch.inf)
        return check_parameters(res, lower < upper)

    def _logcdf(self, value, lower, upper):
        frac = torch.clamp((value - lower) / (upper - lower), 0.0, 1.0)
        return check_parameters(safe_log(frac), lower < upper)

    def _sample(self, generator, shape, lower, upper):
        return lower + (upper - lower) * standard_uniform(generator, shape, lower)

    def _support_point(self, lower, upper):
        return (lower + upper) / 2.0


class Flat(Continuous):
    """Improper flat prior on R (reference continuous.py:364); no draws."""

    param_names = ()
    support = "real"

    def __dist_init__(self):
        pass

    def _logp(self, value):
        return torch.zeros_like(value)

    def _logcdf(self, value):
        # log(1/2) at any finite value (reference continuous.py:380-383)
        res = torch.where(value == torch.inf, 0.0, torch.full_like(value, math.log(0.5)))
        return torch.where(value == -torch.inf, -torch.inf, res)

    def _sample(self, generator, shape):
        raise NotImplementedError("Cannot sample from Flat distribution")

    def _support_point(self):
        return torch.zeros((), dtype=torch.float64)


class HalfFlat(Continuous):
    """Improper flat prior on R+ (reference continuous.py:400); no draws."""

    param_names = ()
    support = "positive"

    def __dist_init__(self):
        pass

    def _logp(self, value):
        return torch.where(value > 0, 0.0, -torch.inf).to(value.dtype)

    def _sample(self, generator, shape):
        raise NotImplementedError("Cannot sample from HalfFlat distribution")

    def _support_point(self):
        return torch.ones((), dtype=torch.float64)


class Normal(Continuous):
    """Reference continuous.py:445."""

    param_names = ("mu", "sigma")
    support = "real"

    def __dist_init__(self, mu=0.0, sigma=None, tau=None):
        self.mu = as_param(mu)
        self.sigma = _sigma_tau(sigma, tau)

    def _logp(self, value, mu, sigma):
        return check_parameters(log_normal(value, mu, sigma), sigma > 0)

    def _logcdf(self, value, mu, sigma):
        return check_parameters(normal_lcdf(mu, sigma, value), sigma > 0)

    def _logccdf(self, value, mu, sigma):
        return check_parameters(normal_lccdf(mu, sigma, value), sigma > 0)

    def _sample(self, generator, shape, mu, sigma):
        return mu + sigma * standard_normal(generator, shape, mu)

    def _support_point(self, mu, sigma):
        return torch.broadcast_to(mu, _broadcast(mu, sigma))


class TruncatedNormal(Continuous):
    """Reference continuous.py:596; either bound may be None."""

    param_names = ("mu", "sigma", "lower", "upper")
    support = "interval"

    def __dist_init__(self, mu=0.0, sigma=None, lower=None, upper=None, tau=None):
        if lower is None and upper is None:
            raise ValueError("TruncatedNormal requires at least one bound")
        self.mu = as_param(mu)
        self.sigma = _sigma_tau(sigma, tau)
        self.lower = as_param(lower) if lower is not None else None
        self.upper = as_param(upper) if upper is not None else None

    def _interval_bounds(self):
        return self.lower, self.upper

    @staticmethod
    def _log_z(mu, sigma, lower, upper):
        if lower is not None and upper is not None:
            a = normal_lcdf(mu, sigma, upper)
            b = normal_lcdf(mu, sigma, lower)
            return a + torch.log1p(-torch.exp(torch.clamp(b - a, max=-1e-15)))
        if lower is not None:
            return normal_lccdf(mu, sigma, lower)
        return normal_lcdf(mu, sigma, upper)

    def _logp(self, value, mu, sigma, lower, upper):
        res = log_normal(value, mu, sigma) - self._log_z(mu, sigma, lower, upper)
        in_sup = torch.ones_like(value, dtype=torch.bool)
        if lower is not None:
            in_sup = value >= lower
        if upper is not None:
            in_sup = in_sup & (value <= upper)
        res = torch.where(in_sup, res, -torch.inf)
        return check_parameters(res, sigma > 0)

    def _logcdf(self, value, mu, sigma, lower, upper):
        logz = self._log_z(mu, sigma, lower, upper)
        hi = normal_lcdf(mu, sigma, value)
        if lower is not None:
            lo = normal_lcdf(mu, sigma, lower)
            num = hi + torch.log1p(-torch.exp(torch.clamp(lo - hi, max=-1e-15)))
        else:
            num = hi
        res = torch.clamp(num - logz, max=0.0)
        if lower is not None:
            res = torch.where(value < lower, -torch.inf, res)
        if upper is not None:
            res = torch.where(value >= upper, 0.0, res)
        return check_parameters(res, sigma > 0)

    def _sample(self, generator, shape, mu, sigma, lower, upper):
        # the inverse cdf in the Phi domain: exact, no rejection loop
        lo_u = torch.special.ndtr((lower - mu) / sigma) if lower is not None else 0.0
        hi_u = torch.special.ndtr((upper - mu) / sigma) if upper is not None else 1.0
        u = lo_u + (hi_u - lo_u) * standard_uniform(generator, shape, mu)
        fi = torch.finfo(mu.dtype)
        return mu + sigma * torch.special.ndtri(torch.clamp(u, fi.tiny, 1.0 - fi.eps / 2))

    def _support_point(self, mu, sigma, lower, upper):
        pt = mu
        if lower is not None and upper is not None:
            pt = torch.where((mu >= lower) & (mu <= upper), mu, (lower + upper) / 2)
        elif lower is not None:
            pt = torch.maximum(mu, lower + sigma)
        else:
            pt = torch.minimum(mu, upper - sigma)
        return pt + 0.0 * sigma


class HalfNormal(Continuous):
    """Reference continuous.py:822."""

    param_names = ("sigma",)
    support = "positive"

    def __dist_init__(self, sigma=None, tau=None):
        self.sigma = _sigma_tau(sigma, tau)

    def _logp(self, value, sigma):
        res = 0.5 * _LOG_2_OVER_PI - torch.log(sigma) - 0.5 * (value / sigma) ** 2
        res = torch.where(value >= 0, res, -torch.inf)
        return check_parameters(res, sigma > 0)

    def _logcdf(self, value, sigma):
        z = value / (sigma * _SQRT_2)
        res = torch.log(torch.special.erf(torch.clamp(z, min=0.0)))
        res = torch.where(value >= 0, res, -torch.inf)
        return check_parameters(res, sigma > 0)

    def _sample(self, generator, shape, sigma):
        return sigma * torch.abs(standard_normal(generator, shape, sigma))

    def _support_point(self, sigma):
        return sigma * _SQRT_2_OVER_PI


class Wald(Continuous):
    """Inverse Gaussian (reference continuous.py:952): two of (mu, lam,
    phi), shifted by alpha."""

    param_names = ("mu", "lam", "alpha")
    support = "positive"

    def __dist_init__(self, mu=None, lam=None, phi=None, alpha=0.0):
        mu, lam = self._get_mu_lam(mu, lam, phi)
        self.mu = as_param(mu)
        self.lam = as_param(lam)
        self.alpha = as_param(alpha)

    @staticmethod
    def _get_mu_lam(mu, lam, phi):
        # reference continuous.py Wald.get_mu_lam_phi
        if mu is None:
            if lam is not None and phi is not None:
                return apply(torch.div, as_param(lam), as_param(phi)), lam
        else:
            if lam is None:
                if phi is None:
                    return mu, 1.0
                return mu, apply(torch.mul, as_param(mu), as_param(phi))
            if phi is None:
                return mu, lam
        raise ValueError("Wald requires two of (mu, lam, phi)")

    def _logp(self, value, mu, lam, alpha):
        v = value - alpha
        safe_v = torch.where(v > 0, v, 1.0)
        res = (
            0.5 * torch.log(lam / (2.0 * math.pi))
            - 1.5 * torch.log(safe_v)
            - lam * (safe_v - mu) ** 2 / (2.0 * mu**2 * safe_v)
        )
        res = torch.where(v > 0, res, -torch.inf)
        # alpha >= 0 is a parameter constraint, not only a shift
        return check_parameters(res, mu > 0, lam > 0, alpha >= 0)

    def _logcdf(self, value, mu, lam, alpha):
        v = value - alpha
        safe_v = torch.where((v > 0) & (v < torch.inf), v, 1.0)
        l = torch.sqrt(lam / safe_v)  # noqa: E741
        a = normal_lcdf(0.0, 1.0, l * (safe_v / mu - 1.0))
        b = 2.0 * lam / mu + normal_lcdf(0.0, 1.0, -l * (safe_v / mu + 1.0))
        res = a + torch.log1p(torch.exp(b - a))
        res = torch.where(v > 0, res, -torch.inf)
        # the cdf is exactly 1 at +inf (reference Wald.logcdf)
        res = torch.where(v == torch.inf, 0.0, res)
        return check_parameters(torch.clamp(res, max=0.0), mu > 0, lam > 0, alpha >= 0)

    def _sample(self, generator, shape, mu, lam, alpha):
        # Michael-Schucany-Haas transform
        y = standard_normal(generator, shape, mu) ** 2
        x = mu + mu**2 * y / (2.0 * lam) - mu / (2.0 * lam) * torch.sqrt(
            4.0 * mu * lam * y + mu**2 * y**2
        )
        u = standard_uniform(generator, shape, mu)
        return alpha + torch.where(u <= mu / (mu + x), x, mu**2 / x)

    def _support_point(self, mu, lam, alpha):
        return mu + alpha + 0.0 * lam


class Beta(Continuous):
    """Reference continuous.py:1131; (alpha, beta), (mu, sigma) or (mu, nu)."""

    param_names = ("alpha", "beta")
    support = "unit_interval"

    def __dist_init__(self, alpha=None, beta=None, mu=None, sigma=None, nu=None):
        alpha, beta = self._get_alpha_beta(alpha, beta, mu, sigma, nu)
        self.alpha = as_param(alpha)
        self.beta = as_param(beta)

    @staticmethod
    def _get_alpha_beta(alpha, beta, mu, sigma, nu):
        if alpha is not None and beta is not None:
            return alpha, beta
        if mu is not None and sigma is not None:
            mu, sigma = as_param(mu), as_param(sigma)

            def kappa(m, s):
                return m * (1 - m) / s**2 - 1

            return (apply(lambda m, s: m * kappa(m, s), mu, sigma),
                    apply(lambda m, s: (1 - m) * kappa(m, s), mu, sigma))
        if mu is not None and nu is not None:
            mu, nu = as_param(mu), as_param(nu)
            return apply(torch.mul, mu, nu), apply(lambda m, n: (1 - m) * n, mu, nu)
        raise ValueError("Beta requires (alpha, beta), (mu, sigma) or (mu, nu)")

    def _logp(self, value, alpha, beta):
        safe = torch.clamp(value, 0.0, 1.0)
        res = logpow(safe, alpha - 1.0) + logpow(1.0 - safe, beta - 1.0) - betaln(alpha, beta)
        res = torch.where((value >= 0) & (value <= 1), res, -torch.inf)
        return check_parameters(res, alpha > 0, beta > 0)

    def _logcdf(self, value, alpha, beta):
        safe = torch.clamp(value, 0.0, 1.0)
        res = safe_log(betainc(alpha, beta, safe))
        res = torch.where(value < 0, -torch.inf, torch.where(value >= 1, 0.0, res))
        return check_parameters(res, alpha > 0, beta > 0)

    def _sample(self, generator, shape, alpha, beta):
        return _beta_draws(generator, shape, alpha, beta)

    def _support_point(self, alpha, beta):
        return alpha / (alpha + beta)


class Kumaraswamy(Continuous):
    """Reference continuous.py:1317."""

    param_names = ("a", "b")
    support = "unit_interval"

    def __dist_init__(self, a, b):
        self.a = as_param(a)
        self.b = as_param(b)

    def _logp(self, value, a, b):
        safe = torch.clamp(value, 0.0, 1.0)
        res = torch.log(a) + torch.log(b) + logpow(safe, a - 1.0) + logpow(1.0 - safe**a, b - 1.0)
        res = torch.where((value >= 0) & (value <= 1), res, -torch.inf)
        return check_parameters(res, a > 0, b > 0)

    def _logcdf(self, value, a, b):
        safe = torch.clamp(value, 0.0, 1.0)
        res = log1mexp(b * torch.log1p(-(safe**a)))
        res = torch.where(value < 0, -torch.inf, torch.where(value >= 1, 0.0, res))
        return check_parameters(res, a > 0, b > 0)

    def _sample(self, generator, shape, a, b):
        u = standard_uniform(generator, shape, a)
        return (1.0 - (1.0 - u) ** (1.0 / b)) ** (1.0 / a)

    def _support_point(self, a, b):
        # the mean b B(1 + 1/a, b)
        return torch.exp(torch.log(b) + betaln(1.0 + 1.0 / a, b))


class Exponential(Continuous):
    """Reference continuous.py:1417; `lam` or `scale` = 1 / lam."""

    param_names = ("lam",)
    support = "positive"

    def __dist_init__(self, lam=None, scale=None):
        if lam is None and scale is None:
            raise ValueError("Exponential requires lam or scale")
        if scale is not None:
            lam = apply(lambda s: 1.0 / s, as_param(scale))
        self.lam = as_param(lam)

    def _logp(self, value, lam):
        res = torch.log(lam) - lam * value
        res = torch.where(value >= 0, res, -torch.inf)
        return check_parameters(res, lam > 0)

    def _logcdf(self, value, lam):
        res = log1mexp(-lam * torch.clamp(value, min=0.0))
        res = torch.where(value >= 0, res, -torch.inf)
        return check_parameters(res, lam > 0)

    def _logccdf(self, value, lam):
        return check_parameters(-lam * torch.clamp(value, min=0.0), lam > 0)

    def _sample(self, generator, shape, lam):
        return standard_exponential(generator, shape, lam) / lam

    def _support_point(self, lam):
        return 1.0 / lam


class Laplace(Continuous):
    """Reference continuous.py:1511."""

    param_names = ("mu", "b")
    support = "real"

    def __dist_init__(self, mu=0.0, b=1.0):
        self.mu = as_param(mu)
        self.b = as_param(b)

    def _logp(self, value, mu, b):
        res = -torch.log(2.0 * b) - torch.abs(value - mu) / b
        return check_parameters(res, b > 0)

    def _logcdf(self, value, mu, b):
        z = (value - mu) / b
        res = torch.where(
            z <= 0, math.log(0.5) + z, torch.log1p(-0.5 * torch.exp(-torch.clamp(z, min=0.0)))
        )
        return check_parameters(res, b > 0)

    def _sample(self, generator, shape, mu, b):
        e = standard_exponential(generator, shape, mu) - standard_exponential(generator, shape, mu)
        return mu + b * e

    def _support_point(self, mu, b):
        return mu + 0.0 * b


class AsymmetricLaplace(Continuous):
    """Reference continuous.py:1633; `kappa` or the quantile `q`."""

    param_names = ("b", "kappa", "mu")
    support = "real"

    def __dist_init__(self, kappa=None, mu=0.0, b=1.0, q=None):
        if q is not None and kappa is not None:
            raise ValueError("Specify kappa or q, not both")
        if q is not None:
            kappa = apply(lambda qq: torch.sqrt(qq / (1.0 - qq)), as_param(q))
        if kappa is None:
            kappa = 1.0
        self.b = as_param(b)
        self.kappa = as_param(kappa)
        self.mu = as_param(mu)

    def _logp(self, value, b, kappa, mu):
        z = value - mu
        s = torch.sign(z)
        res = torch.log(b / (kappa + 1.0 / kappa)) - z * b * s * torch.pow(kappa, s)
        return check_parameters(res, b > 0, kappa > 0)

    def _sample(self, generator, shape, b, kappa, mu):
        u = standard_uniform(generator, shape, b)
        switch = kappa**2 / (1.0 + kappa**2)
        non_positive = mu + kappa / b * torch.log(u * (1.0 / switch))
        positive = mu - 1.0 / (kappa * b) * torch.log((1.0 - u) * (1.0 + kappa**2))
        return torch.where(u > switch, positive, non_positive)

    def _support_point(self, b, kappa, mu):
        return mu - (kappa - 1.0 / kappa) / b


class LogNormal(Continuous):
    """Reference continuous.py:1723; `sigma` or `tau`."""

    param_names = ("mu", "sigma")
    support = "positive"

    def __dist_init__(self, mu=0.0, sigma=None, tau=None):
        self.mu = as_param(mu)
        self.sigma = _sigma_tau(sigma, tau)

    def _logp(self, value, mu, sigma):
        safe = torch.where(value > 0, value, 1.0)
        res = log_normal(torch.log(safe), mu, sigma) - torch.log(safe)
        res = torch.where(value > 0, res, -torch.inf)
        return check_parameters(res, sigma > 0)

    def _logcdf(self, value, mu, sigma):
        safe = torch.where(value > 0, value, 1.0)
        res = normal_lcdf(mu, sigma, torch.log(safe))
        res = torch.where(value > 0, res, -torch.inf)
        return check_parameters(res, sigma > 0)

    def _sample(self, generator, shape, mu, sigma):
        return torch.exp(mu + sigma * standard_normal(generator, shape, mu))

    def _support_point(self, mu, sigma):
        return torch.exp(mu + sigma**2 / 2.0)


Lognormal = LogNormal


def _log_t_tail_survival(nu, abs_t):
    """log I_x(nu/2, 1/2) with x = nu / (nu + t^2): the Student-t two-tail
    survival P(|T| > t). Deep tails (log x < -23) take the leading
    asymptotic x^a / (a B(a, 1/2)), as the JAX package does."""
    a = nu / 2.0
    tiny = torch.finfo(abs_t.dtype).tiny
    log_t = torch.log(torch.clamp(abs_t, min=tiny))
    log_x = torch.log(nu) - torch.logaddexp(torch.log(nu), 2.0 * log_t)
    x = nu / (nu + abs_t**2)
    ib = betainc(a, torch.full_like(a, 0.5), torch.clamp(x, 0.0, 1.0))
    log_beta_ab = betaln(a, torch.full_like(a, 0.5))
    log_asym = a * log_x - torch.log(a) - log_beta_ab
    return torch.where(log_x < -23.0, log_asym, safe_log(ib))


class StudentT(Continuous):
    """Reference continuous.py:1855; `sigma` or the precision `lam`."""

    param_names = ("nu", "mu", "sigma")
    support = "real"

    def __dist_init__(self, nu, mu=0.0, sigma=None, lam=None):
        self.nu = as_param(nu)
        self.mu = as_param(mu)
        self.sigma = _lam_sigma(sigma, lam)

    def _logp(self, value, nu, mu, sigma):
        z = (value - mu) / sigma
        res = (
            torch.lgamma((nu + 1.0) / 2.0)
            - torch.lgamma(nu / 2.0)
            - 0.5 * torch.log(nu * math.pi)
            - torch.log(sigma)
            - (nu + 1.0) / 2.0 * torch.log1p(z**2 / nu)
        )
        return check_parameters(res, nu > 0, sigma > 0)

    def _logcdf(self, value, nu, mu, sigma):
        t = (value - mu) / sigma
        nu = torch.broadcast_to(nu, _broadcast(nu, t))
        log_ib = _log_t_tail_survival(nu, torch.abs(t))
        res = torch.where(
            t >= 0, torch.log1p(-0.5 * torch.exp(log_ib)), math.log(0.5) + log_ib
        )
        return check_parameters(res, nu > 0, sigma > 0)

    def _sample(self, generator, shape, nu, mu, sigma):
        return mu + sigma * _student_t_draws(generator, shape, nu)

    def _support_point(self, nu, mu, sigma):
        return torch.broadcast_to(mu, _broadcast(nu, mu, sigma))


class HalfStudentT(Continuous):
    """Reference continuous.py:2862; `sigma` or the precision `lam`."""

    param_names = ("nu", "sigma")
    support = "positive"

    def __dist_init__(self, nu=1.0, sigma=None, lam=None):
        self.nu = as_param(nu)
        self.sigma = _lam_sigma(sigma, lam)

    def _logp(self, value, nu, sigma):
        z = value / sigma
        res = (
            math.log(2.0)
            + torch.lgamma((nu + 1.0) / 2.0)
            - torch.lgamma(nu / 2.0)
            - 0.5 * torch.log(nu * math.pi)
            - torch.log(sigma)
            - (nu + 1.0) / 2.0 * torch.log1p(z**2 / nu)
        )
        res = torch.where(value >= 0, res, -torch.inf)
        return check_parameters(res, nu > 0, sigma > 0)

    def _logcdf(self, value, nu, sigma):
        # P(|T| <= z) = 1 - I_{nu/(nu+z^2)}(nu/2, 1/2)
        z = torch.clamp(value, min=0.0) / sigma
        nu = torch.broadcast_to(nu, _broadcast(nu, z))
        res = torch.log1p(-torch.exp(_log_t_tail_survival(nu, z)))
        res = torch.where(value >= 0, res, -torch.inf)
        res = torch.where(value == torch.inf, 0.0, res)
        return check_parameters(res, nu > 0, sigma > 0)

    def _sample(self, generator, shape, nu, sigma):
        return torch.abs(sigma * _student_t_draws(generator, shape, nu))

    def _support_point(self, nu, sigma):
        return sigma + 0.0 * nu


class Pareto(Continuous):
    """Reference continuous.py:2116; support [m, inf)."""

    param_names = ("alpha", "m")
    support = "interval"

    def __dist_init__(self, alpha, m):
        self.alpha = as_param(alpha)
        self.m = as_param(m)

    def _interval_bounds(self):
        return self.m, None

    def _logp(self, value, alpha, m):
        safe = torch.where(value > 0, value, 1.0)
        res = torch.log(alpha) + alpha * torch.log(m) - (alpha + 1.0) * torch.log(safe)
        res = torch.where(value >= m, res, -torch.inf)
        return check_parameters(res, alpha > 0, m > 0)

    def _logcdf(self, value, alpha, m):
        safe = torch.where(value > 0, value, 1.0)
        res = log1mexp(alpha * (torch.log(m) - torch.log(safe)))
        res = torch.where(value >= m, res, -torch.inf)
        return check_parameters(res, alpha > 0, m > 0)

    def _sample(self, generator, shape, alpha, m):
        return m * torch.exp(standard_exponential(generator, shape, alpha) / alpha)

    def _support_point(self, alpha, m):
        az = torch.where(alpha > 1, alpha, 2.0)
        return az * m / (az - 1.0)


class Cauchy(Continuous):
    """Reference continuous.py:2225."""

    param_names = ("alpha", "beta")
    support = "real"

    def __dist_init__(self, alpha=0.0, beta=1.0):
        self.alpha = as_param(alpha)
        self.beta = as_param(beta)

    def _logp(self, value, alpha, beta):
        z = (value - alpha) / beta
        res = -math.log(math.pi) - torch.log(beta) - torch.log1p(z**2)
        return check_parameters(res, beta > 0)

    def _logcdf(self, value, alpha, beta):
        z = (value - alpha) / beta
        return check_parameters(torch.log(0.5 + torch.atan(z) / math.pi), beta > 0)

    def _sample(self, generator, shape, alpha, beta):
        u = standard_uniform(generator, shape, alpha)
        return alpha + beta * torch.tan(math.pi * (u - 0.5))

    def _support_point(self, alpha, beta):
        return alpha + 0.0 * beta


class HalfCauchy(Continuous):
    """Reference continuous.py:2330."""

    param_names = ("beta",)
    support = "positive"

    def __dist_init__(self, beta):
        self.beta = as_param(beta)

    def _logp(self, value, beta):
        z = value / beta
        res = _LOG_2_OVER_PI - torch.log(beta) - torch.log1p(z**2)
        res = torch.where(value >= 0, res, -torch.inf)
        return check_parameters(res, beta > 0)

    def _logcdf(self, value, beta):
        z = torch.clamp(value, min=0.0) / beta
        res = torch.log(2.0 * torch.atan(z) / math.pi)
        res = torch.where(value >= 0, res, -torch.inf)
        return check_parameters(res, beta > 0)

    def _sample(self, generator, shape, beta):
        cauchy = torch.tan(math.pi * (standard_uniform(generator, shape, beta) - 0.5))
        return torch.abs(beta * cauchy)

    def _support_point(self, beta):
        return beta


class Gamma(Continuous):
    """Reference continuous.py:2415; (alpha, beta) or (mu, sigma)."""

    param_names = ("alpha", "beta")
    support = "positive"

    def __dist_init__(self, alpha=None, beta=None, mu=None, sigma=None):
        alpha, beta = self._get_alpha_beta(alpha, beta, mu, sigma)
        self.alpha = as_param(alpha)
        self.beta = as_param(beta)

    @staticmethod
    def _get_alpha_beta(alpha, beta, mu, sigma):
        if alpha is not None and beta is not None:
            return alpha, beta
        if mu is not None and sigma is not None:
            mu, sigma = as_param(mu), as_param(sigma)
            return (
                apply(lambda m, s: m**2 / s**2, mu, sigma),
                apply(lambda m, s: m / s**2, mu, sigma),
            )
        raise ValueError("Gamma requires (alpha, beta) or (mu, sigma)")

    def _logp(self, value, alpha, beta):
        safe = torch.where(value > 0, value, 1.0)
        res = (
            alpha * torch.log(beta)
            + logpow(safe, alpha - 1.0)
            - beta * safe
            - torch.lgamma(alpha)
        )
        res = torch.where(value >= 0, res, -torch.inf)
        return check_parameters(res, alpha > 0, beta > 0)

    def _logcdf(self, value, alpha, beta):
        res = safe_log(gammainc(alpha, beta * torch.clamp(value, min=0.0)))
        res = torch.where(value >= 0, res, -torch.inf)
        return check_parameters(res, alpha > 0, beta > 0)

    def _sample(self, generator, shape, alpha, beta):
        return standard_gamma(generator, alpha.expand(shape)) / beta

    def _support_point(self, alpha, beta):
        return alpha / beta


class InverseGamma(Continuous):
    """Reference continuous.py:2543; alpha (beta 1 by default) or (mu,
    sigma)."""

    param_names = ("alpha", "beta")
    support = "positive"

    def __dist_init__(self, alpha=None, beta=None, mu=None, sigma=None):
        alpha, beta = self._get_alpha_beta(alpha, beta, mu, sigma)
        self.alpha = as_param(alpha)
        self.beta = as_param(beta)

    @staticmethod
    def _get_alpha_beta(alpha, beta, mu, sigma):
        if alpha is not None:
            return alpha, beta if beta is not None else 1.0
        if mu is not None and sigma is not None:
            mu, sigma = as_param(mu), as_param(sigma)
            return (
                apply(lambda m, s: (m / s) ** 2 + 2.0, mu, sigma),
                apply(lambda m, s: m * ((m / s) ** 2 + 1.0), mu, sigma),
            )
        raise ValueError("InverseGamma requires alpha(+beta) or (mu, sigma)")

    def _logp(self, value, alpha, beta):
        safe = torch.where(value > 0, value, 1.0)
        res = (
            alpha * torch.log(beta)
            - (alpha + 1.0) * torch.log(safe)
            - beta / safe
            - torch.lgamma(alpha)
        )
        res = torch.where(value > 0, res, -torch.inf)
        return check_parameters(res, alpha > 0, beta > 0)

    def _logcdf(self, value, alpha, beta):
        safe = torch.where(value > 0, value, 1.0)
        res = safe_log(gammaincc(alpha, beta / safe))
        res = torch.where(value > 0, res, -torch.inf)
        return check_parameters(res, alpha > 0, beta > 0)

    def _sample(self, generator, shape, alpha, beta):
        return beta / standard_gamma(generator, alpha.expand(shape))

    def _support_point(self, alpha, beta):
        # the mean where alpha > 1, else beta / alpha
        return torch.where(alpha > 1, beta / (alpha - 1.0), beta / alpha)


class ChiSquared(Continuous):
    """Reference continuous.py:2659: Gamma(nu / 2, 1 / 2)."""

    param_names = ("nu",)
    support = "positive"

    def __dist_init__(self, nu):
        self.nu = as_param(nu)

    def _logp(self, value, nu):
        return Gamma._logp(self, value, nu / 2.0, torch.full_like(nu, 0.5))

    def _logcdf(self, value, nu):
        return Gamma._logcdf(self, value, nu / 2.0, torch.full_like(nu, 0.5))

    def _sample(self, generator, shape, nu):
        return 2.0 * standard_gamma(generator, (nu / 2.0).expand(shape))

    def _support_point(self, nu):
        return nu


class Weibull(Continuous):
    """Reference continuous.py:2740 (alpha the shape, beta the scale)."""

    param_names = ("alpha", "beta")
    support = "positive"

    def __dist_init__(self, alpha, beta):
        self.alpha = as_param(alpha)
        self.beta = as_param(beta)

    def _logp(self, value, alpha, beta):
        safe = torch.where(value > 0, value, 1.0)
        z = safe / beta
        res = torch.log(alpha) - torch.log(beta) + (alpha - 1.0) * torch.log(z) - z**alpha
        res = torch.where(value >= 0, res, -torch.inf)
        return check_parameters(res, alpha > 0, beta > 0)

    def _logcdf(self, value, alpha, beta):
        z = torch.clamp(value, min=0.0) / beta
        res = log1mexp(-(z**alpha))
        res = torch.where(value >= 0, res, -torch.inf)
        return check_parameters(res, alpha > 0, beta > 0)

    def _logccdf(self, value, alpha, beta):
        z = torch.clamp(value, min=0.0) / beta
        return check_parameters(-(z**alpha), alpha > 0, beta > 0)

    def _sample(self, generator, shape, alpha, beta):
        return beta * standard_exponential(generator, shape, alpha) ** (1.0 / alpha)

    def _support_point(self, alpha, beta):
        return beta * torch.exp(torch.lgamma(1.0 + 1.0 / alpha))


class ExGaussian(Continuous):
    """Exponentially modified Gaussian (reference continuous.py:2994)."""

    param_names = ("mu", "sigma", "nu")
    support = "real"

    def __dist_init__(self, mu=0.0, sigma=None, nu=None):
        self.mu = as_param(mu)
        self.sigma = as_param(sigma if sigma is not None else 1.0)
        self.nu = as_param(nu if nu is not None else 1.0)

    def _logp(self, value, mu, sigma, nu):
        # the normal density where nu is negligible beside sigma
        std = (
            -torch.log(nu)
            + (mu - value) / nu
            + 0.5 * (sigma / nu) ** 2
            + normal_lcdf(mu + sigma**2 / nu, sigma, value)
        )
        res = torch.where(nu > 0.05 * sigma, std, log_normal(value, mu, sigma))
        return check_parameters(res, sigma > 0, nu > 0)

    def _logcdf(self, value, mu, sigma, nu):
        lp1 = normal_lcdf(mu, sigma, value)
        lp2 = (
            (mu - value) / nu
            + 0.5 * (sigma / nu) ** 2
            + normal_lcdf(mu + sigma**2 / nu, sigma, value)
        )
        res = lp1 + log1mexp(torch.clamp(lp2 - lp1, max=-1e-15))
        res = torch.where(nu > 0.05 * sigma, res, normal_lcdf(mu, sigma, value))
        # the cdf is exactly 0 at -inf, where lp2 is (+inf) + (-inf)
        res = torch.where(value == -torch.inf, -torch.inf, res)
        return check_parameters(res, sigma > 0, nu > 0)

    def _sample(self, generator, shape, mu, sigma, nu):
        n = mu + sigma * standard_normal(generator, shape, mu)
        return n + nu * standard_exponential(generator, shape, mu)

    def _support_point(self, mu, sigma, nu):
        return mu + nu + 0.0 * sigma


class VonMises(Continuous):
    """Reference continuous.py:3117; values on [-pi, pi]."""

    param_names = ("mu", "kappa")
    support = "circular"

    def __dist_init__(self, mu=0.0, kappa=None):
        self.mu = as_param(mu)
        self.kappa = as_param(kappa if kappa is not None else 1.0)

    def _logp(self, value, mu, kappa):
        res = kappa * torch.cos(value - mu) - _LOG_2PI - log_i0(kappa)
        res = torch.where((value >= -math.pi) & (value <= math.pi), res, -torch.inf)
        return check_parameters(res, kappa >= 0)

    def _sample(self, generator, shape, mu, kappa):
        # Best-Fisher (1979) rejection in 32 masked rounds, every element
        # alike (acceptance about 0.65 or more a round)
        kappa_b = torch.broadcast_to(kappa, shape)
        tau = 1.0 + torch.sqrt(1.0 + 4.0 * kappa_b**2)
        rho = (tau - torch.sqrt(2.0 * tau)) / (2.0 * kappa_b)
        r = (1.0 + rho**2) / (2.0 * rho)
        accepted = torch.zeros(shape, dtype=torch.bool, device=kappa.device)
        out = torch.zeros(shape, dtype=kappa.dtype, device=kappa.device)
        for _ in range(32):
            u1 = standard_uniform(generator, shape, kappa)
            u2 = standard_uniform(generator, shape, kappa)
            u3 = standard_uniform(generator, shape, kappa)
            z = torch.cos(math.pi * u1)
            f = (1.0 + r * z) / (r + z)
            c = kappa_b * (r - f)
            accept = (c * (2.0 - c) - u2 > 0) | (torch.log(c / u2) + 1.0 - c >= 0)
            theta = torch.sign(u3 - 0.5) * torch.acos(torch.clamp(f, -1.0, 1.0))
            out = torch.where(accept & ~accepted, theta, out)
            accepted = accepted | accept
        ang = out + mu
        return torch.atan2(torch.sin(ang), torch.cos(ang))

    def _support_point(self, mu, kappa):
        return torch.atan2(torch.sin(mu), torch.cos(mu)) + 0.0 * kappa


class SkewNormal(Continuous):
    """Reference continuous.py:3203; `sigma` or `tau`."""

    param_names = ("mu", "sigma", "alpha")
    support = "real"

    def __dist_init__(self, mu=0.0, sigma=None, alpha=1.0, tau=None):
        self.mu = as_param(mu)
        self.sigma = _sigma_tau(sigma, tau)
        self.alpha = as_param(alpha)

    def _logp(self, value, mu, sigma, alpha):
        z = (value - mu) / sigma
        res = math.log(2.0) + log_normal(value, mu, sigma) + normal_lcdf(0.0, 1.0, alpha * z)
        return check_parameters(res, sigma > 0)

    def _sample(self, generator, shape, mu, sigma, alpha):
        delta = alpha / torch.sqrt(1.0 + alpha**2)
        u0 = standard_normal(generator, shape, mu)
        v = standard_normal(generator, shape, mu)
        return mu + sigma * (delta * torch.abs(u0) + torch.sqrt(1.0 - delta**2) * v)

    def _support_point(self, mu, sigma, alpha):
        delta = alpha / torch.sqrt(1.0 + alpha**2)
        return mu + sigma * delta * _SQRT_2_OVER_PI


class Triangular(Continuous):
    """Reference continuous.py:3298."""

    param_names = ("lower", "c", "upper")
    support = "interval"

    def __dist_init__(self, lower=0.0, upper=1.0, c=0.5):
        self.lower = as_param(lower)
        self.c = as_param(c)
        self.upper = as_param(upper)

    def _interval_bounds(self):
        return self.lower, self.upper

    def _logp(self, value, lower, c, upper):
        left = safe_log(2.0 * (value - lower) / ((upper - lower) * (c - lower)))
        right = safe_log(2.0 * (upper - value) / ((upper - lower) * (upper - c)))
        peak = math.log(2.0) - torch.log(upper - lower)
        res = torch.where(value < c, left, torch.where(value > c, right, peak))
        res = torch.where((value >= lower) & (value <= upper), res, -torch.inf)
        return check_parameters(res, lower <= c, c <= upper, lower < upper)

    def _logcdf(self, value, lower, c, upper):
        left = safe_log((value - lower) ** 2 / ((upper - lower) * (c - lower)))
        right = torch.log1p(-((upper - value) ** 2) / ((upper - lower) * (upper - c)))
        res = torch.where(value <= c, left, right)
        res = torch.where(value < lower, -torch.inf, torch.where(value >= upper, 0.0, res))
        return check_parameters(res, lower <= c, c <= upper, lower < upper)

    def _sample(self, generator, shape, lower, c, upper):
        q = standard_uniform(generator, shape, lower)
        fc = (c - lower) / (upper - lower)
        left = lower + torch.sqrt(q * (upper - lower) * (c - lower))
        right = upper - torch.sqrt((1.0 - q) * (upper - lower) * (upper - c))
        return torch.where(q < fc, left, right)

    def _support_point(self, lower, c, upper):
        return (lower + c + upper) / 3.0


class Gumbel(Continuous):
    """Reference continuous.py:3427."""

    param_names = ("mu", "beta")
    support = "real"

    def __dist_init__(self, mu=0.0, beta=1.0):
        self.mu = as_param(mu)
        self.beta = as_param(beta)

    def _logp(self, value, mu, beta):
        z = (value - mu) / beta
        return check_parameters(-z - torch.exp(-z) - torch.log(beta), beta > 0)

    def _logcdf(self, value, mu, beta):
        return check_parameters(-torch.exp(-(value - mu) / beta), beta > 0)

    def _sample(self, generator, shape, mu, beta):
        return mu - beta * torch.log(standard_exponential(generator, shape, mu))

    def _support_point(self, mu, beta):
        return mu + beta * _EULER


class Logistic(Continuous):
    """Reference continuous.py:3654."""

    param_names = ("mu", "s")
    support = "real"

    def __dist_init__(self, mu=0.0, s=1.0):
        self.mu = as_param(mu)
        self.s = as_param(s)

    def _logp(self, value, mu, s):
        z = (value - mu) / s
        return check_parameters(-z - torch.log(s) - 2.0 * softplus(-z), s > 0)

    def _logcdf(self, value, mu, s):
        return check_parameters(-softplus(-(value - mu) / s), s > 0)

    def _sample(self, generator, shape, mu, s):
        u = standard_uniform(generator, shape, mu)
        return mu + s * (torch.log(u) - torch.log1p(-u))

    def _support_point(self, mu, s):
        return mu + 0.0 * s


class LogitNormal(Continuous):
    """Reference continuous.py:3741; `sigma` or `tau`."""

    param_names = ("mu", "sigma")
    support = "unit_interval"

    def __dist_init__(self, mu=0.0, sigma=None, tau=None):
        self.mu = as_param(mu)
        self.sigma = _sigma_tau(sigma, tau)

    def _logp(self, value, mu, sigma):
        inside = (value > 0) & (value < 1)
        safe = torch.where(inside, value, 0.5)
        res = log_normal(torch.logit(safe), mu, sigma) - torch.log(safe) - torch.log1p(-safe)
        res = torch.where(inside, res, -torch.inf)
        return check_parameters(res, sigma > 0)

    def _logcdf(self, value, mu, sigma):
        inside = (value > 0) & (value < 1)
        safe = torch.where(inside, value, 0.5)
        res = normal_lcdf(mu, sigma, torch.logit(safe))
        res = torch.where(value <= 0, -torch.inf, torch.where(value >= 1, 0.0, res))
        return check_parameters(res, sigma > 0)

    def _sample(self, generator, shape, mu, sigma):
        return torch.sigmoid(mu + sigma * standard_normal(generator, shape, mu))

    def _support_point(self, mu, sigma):
        return torch.sigmoid(mu) + 0.0 * sigma


class Rice(Continuous):
    """Reference continuous.py:3538; (nu, sigma) or b = nu / sigma."""

    param_names = ("nu", "sigma")
    support = "positive"

    def __dist_init__(self, nu=None, sigma=None, b=None):
        sigma = as_param(sigma if sigma is not None else 1.0)
        if nu is None and b is not None:
            nu = apply(torch.mul, as_param(b), sigma)
        self.nu = as_param(nu if nu is not None else 1.0)
        self.sigma = sigma

    def _logp(self, value, nu, sigma):
        safe = torch.where(value > 0, value, 1.0)
        res = (
            torch.log(safe / sigma**2)
            - (safe**2 + nu**2) / (2.0 * sigma**2)
            + log_i0(safe * nu / sigma**2)
        )
        res = torch.where(value > 0, res, -torch.inf)
        return check_parameters(res, nu >= 0, sigma > 0)

    def _sample(self, generator, shape, nu, sigma):
        x = nu + sigma * standard_normal(generator, shape, nu)
        y = sigma * standard_normal(generator, shape, nu)
        return torch.sqrt(x**2 + y**2)

    def _support_point(self, nu, sigma):
        # a finite point in the support, as the JAX package takes it
        return torch.sqrt(nu**2 + 2.0 * sigma**2)


class Moyal(Continuous):
    """Reference continuous.py:3982."""

    param_names = ("mu", "sigma")
    support = "real"

    def __dist_init__(self, mu=0.0, sigma=1.0):
        self.mu = as_param(mu)
        self.sigma = as_param(sigma)

    def _logp(self, value, mu, sigma):
        z = (value - mu) / sigma
        res = -0.5 * (z + torch.exp(-z)) - torch.log(sigma) - 0.5 * _LOG_2PI
        return check_parameters(res, sigma > 0)

    def _logcdf(self, value, mu, sigma):
        z = (value - mu) / sigma
        return check_parameters(torch.log(torch.special.erfc(torch.exp(-0.5 * z) / _SQRT_2)),
                                sigma > 0)

    def _sample(self, generator, shape, mu, sigma):
        # the inverse cdf at U(tiny, 1)
        u = torch.clamp(standard_uniform(generator, shape, mu), min=torch.finfo(mu.dtype).tiny)
        return mu + sigma * (-2.0 * torch.log(_SQRT_2 * torch.special.erfinv(1.0 - u)))

    def _support_point(self, mu, sigma):
        return mu + sigma * (_EULER + math.log(2.0))


def interp(x, xp, fp):
    """Piecewise-linear interpolation of (xp, fp) at x, fp[0] left of xp and
    fp[-1] right of it (numpy's and JAX's `interp`), with `searchsorted` on
    the tensors' device: no host read."""
    shape, n = x.shape, xp.shape[-1]
    x = x.reshape(-1)  # a 1-D index: a 0-d one would be read as a host int under vmap
    i = torch.clamp(torch.searchsorted(xp, x.contiguous(), right=True), 1, n - 1)
    x0, x1 = xp[i - 1], xp[i]
    f0, f1 = fp[i - 1], fp[i]
    dx = x1 - x0
    f = torch.where(dx == 0, f1, f0 + (x - x0) / torch.where(dx == 0, 1.0, dx) * (f1 - f0))
    f = torch.where(x < xp[0], fp[0], f)
    return torch.where(x > xp[-1], fp[-1], f).reshape(shape)


class Interpolated(Continuous):
    """Piecewise-linear pdf from tabulated points (reference continuous.py:
    3856). The tables are made once, in numpy, at construction, and are the
    distribution's parameters: graph constants that the model places on the
    device with the rest."""

    param_names = ("x_points", "pdf_points", "cdf_points")
    param_event_ndims = (1, 1, 1)
    support = "interval"

    def __dist_init__(self, x_points, pdf_points):
        x = np.asarray(x_points, dtype=np.float64)
        p = np.asarray(pdf_points, dtype=np.float64)
        if x.ndim != 1 or p.shape != x.shape:
            raise ValueError("x_points and pdf_points must be 1-D equal-length")
        p = p / np.sum((p[1:] + p[:-1]) / 2.0 * np.diff(x))  # the trapezoid rule
        cdf = np.concatenate([[0.0], np.cumsum((p[1:] + p[:-1]) / 2.0 * np.diff(x))])
        self.x_points = as_param(x)
        self.pdf_points = as_param(p)
        self.cdf_points = as_param(cdf / cdf[-1])
        self._lower = float(x[0])
        self._upper = float(x[-1])
        self._bounds = (as_param(x[0]), as_param(x[-1]))

    def inputs(self):
        return super().inputs() + list(self._bounds)

    def _interval_bounds(self):
        return self._bounds

    def _logp(self, value, x, pdf, cdf):
        res = safe_log(interp(value, x, pdf))
        return torch.where((value >= self._lower) & (value <= self._upper), res, -torch.inf)

    def _logcdf(self, value, x, pdf, cdf):
        return safe_log(interp(value, x, cdf))

    def _sample(self, generator, shape, x, pdf, cdf):
        return interp(standard_uniform(generator, shape, x), cdf, x)

    def _support_point(self, x, pdf, cdf):
        # the density-weighted mean
        mids = (x[1:] + x[:-1]) / 2.0
        w = (pdf[1:] + pdf[:-1]) / 2.0 * torch.diff(x)
        return torch.sum(mids * w) / torch.sum(w)


class SkewStudentT(Continuous):
    """Jones-Faddy skew Student-t (reference continuous.py:2001): a, b the
    tails, mu and sigma (or the precision lam) the location and scale."""

    param_names = ("a", "b", "mu", "sigma")
    support = "real"

    def __dist_init__(self, a, b, mu=0.0, sigma=None, lam=None):
        self.a = as_param(a)
        self.b = as_param(b)
        self.mu = as_param(mu)
        self.sigma = _lam_sigma(sigma, lam)

    def _logp(self, value, a, b, mu, sigma):
        t = (value - mu) / sigma
        denom = torch.sqrt(a + b + t**2)
        res = (
            (a + 0.5) * torch.log1p(t / denom)
            + (b + 0.5) * torch.log1p(-t / denom)
            - ((a + b - 1.0) * math.log(2.0) + betaln(a, b) + 0.5 * torch.log(a + b))
            - torch.log(sigma)
        )
        return check_parameters(res, a > 0, b > 0, sigma > 0)

    def _logcdf(self, value, a, b, mu, sigma):
        # (1 + t / sqrt(a + b + t^2)) / 2 ~ Beta(a, b)
        t = (value - mu) / sigma
        z = 0.5 * (1.0 + t / torch.sqrt(a + b + t**2))
        res = safe_log(betainc(a, b, torch.clamp(z, 0.0, 1.0)))
        return check_parameters(res, a > 0, b > 0, sigma > 0)

    def _sample(self, generator, shape, a, b, mu, sigma):
        eps = torch.finfo(a.dtype).eps
        u = torch.clamp(_beta_draws(generator, shape, a, b), eps, 1.0 - eps)
        t = (2.0 * u - 1.0) * torch.sqrt(a + b) / (2.0 * torch.sqrt(u * (1.0 - u)))
        return mu + sigma * t

    def _support_point(self, a, b, mu, sigma):
        um = a / (a + b)
        t = (2.0 * um - 1.0) * torch.sqrt(a + b) / (2.0 * torch.sqrt(um * (1.0 - um)))
        return mu + sigma * t


class PolyaGamma(Continuous):
    """Polya-Gamma PG(h, z) (reference continuous.py:4140): the density by
    the alternating series truncated at 40 terms, draws by the
    convolution-of-gammas form truncated at 200 terms with a moment-matched
    tail (Windle et al. 2014), as the JAX package does."""

    param_names = ("h", "z")
    support = "positive"

    def __dist_init__(self, h=1.0, z=0.0):
        self.h = as_param(h)
        self.z = as_param(z)

    def _logp(self, value, h, z):
        safe = torch.where(value > 0, value, 1.0)
        h, safe = torch.broadcast_tensors(h, safe)
        ns = torch.arange(40, dtype=value.dtype, device=value.device)
        hn = h[..., None]
        coef = torch.lgamma(ns + hn) - torch.lgamma(ns + 1.0) + torch.log(2.0 * ns + hn)
        expo = -((2.0 * ns + hn) ** 2) / (8.0 * safe[..., None])
        sign = 1.0 - 2.0 * torch.remainder(ns, 2.0)
        alt = torch.sum(torch.exp(coef + expo) * sign, dim=-1)
        log_f0 = (
            (h - 1.0) * math.log(2.0)
            - torch.lgamma(h)
            - 0.5 * torch.log(2.0 * math.pi * safe**3)
            + torch.log(torch.clamp(alt, min=1e-300))
        )
        # the tilt: f(x | h, z) = cosh^h(z/2) exp(-x z^2 / 2) f(x | h, 0)
        res = h * torch.log(torch.cosh(z / 2.0)) - safe * z**2 / 2.0 + log_f0
        res = torch.where(value > 0, res, -torch.inf)
        return check_parameters(res, h > 0)

    def _sample(self, generator, shape, h, z):
        K = 200
        ks = torch.arange(1, K + 1, dtype=h.dtype, device=h.device)
        denom = (ks - 0.5) ** 2 + (z[..., None] / (2.0 * math.pi)) ** 2
        g = standard_gamma(generator, h[..., None].expand(tuple(shape) + (K,)))
        x = torch.sum(g / denom, dim=-1) / (2.0 * math.pi**2)
        # sum_{k >= 1} 1 / ((k - 1/2)^2 + c^2) = pi^2 tanh(z/2) / z, c = z / (2 pi)
        zb = torch.broadcast_to(z, x.shape)
        small = torch.abs(zb) < 1e-6
        safe_z = torch.where(small, 1.0, zb)
        s_inf = torch.where(small, math.pi**2 / 2.0, math.pi**2 * torch.tanh(safe_z / 2.0) / safe_z)
        tail_mean = h / (2.0 * math.pi**2) * (s_inf - torch.sum(1.0 / denom, dim=-1))
        return x + torch.clamp(tail_mean, min=0.0)

    def _support_point(self, h, z):
        # E[PG(h, z)] = h / (2z) tanh(z / 2), h / 4 at z = 0
        small = torch.abs(z) < 1e-6
        safe_z = torch.where(small, 1.0, z)
        return torch.where(small, h / 4.0, h / (2.0 * safe_z) * torch.tanh(safe_z / 2.0))
