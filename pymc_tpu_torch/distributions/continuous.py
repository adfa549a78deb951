"""Continuous univariate distributions: Normal, HalfNormal, HalfCauchy,
Gamma and ChiSquared.

Counterpart of `pymc_tpu/distributions/continuous.py` (Normal :149,
HalfNormal :250, HalfCauchy :799, Gamma :830, ChiSquared :945; reference
pymc/distributions/continuous.py:445, :822, :2330, :2415, :2659).
Densities (and the logcdf of Normal, HalfNormal and Gamma, which
`find_constrained_prior` needs) are elementwise tensor expressions; an invalid parameter gives
-inf and never raises, and a value outside the support gives -inf. Draws
(`_sample`) follow the JAX package's: Normal and HalfNormal from standard
normals, HalfCauchy as |beta tan(pi (u - 1/2))|, Gamma from
`torch._standard_gamma`, which takes the generator.
"""

from __future__ import annotations

import math

import torch

from ..graph import apply
from .dist_math import check_parameters, gammainc, log_normal, logpow, safe_log
from .distribution import Continuous, as_param, standard_normal, standard_uniform

__all__ = ["Normal", "HalfNormal", "HalfCauchy", "Gamma", "ChiSquared"]

_LOG_2_OVER_PI = math.log(2.0 / math.pi)
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def standard_gamma(generator, alpha):
    """Gamma(alpha, 1) draws of alpha's shape; `torch.distributions.Gamma`
    would not take the generator."""
    return torch._standard_gamma(alpha.contiguous(), generator=generator)


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
        return check_parameters(torch.special.log_ndtr((value - mu) / sigma), sigma > 0)

    def _sample(self, generator, shape, mu, sigma):
        return mu + sigma * standard_normal(generator, shape, mu)

    def _support_point(self, mu, sigma):
        return torch.broadcast_to(mu, torch.broadcast_shapes(mu.shape, sigma.shape))


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
        z = value / (sigma * math.sqrt(2.0))
        res = torch.log(torch.special.erf(torch.clamp(z, min=0.0)))
        res = torch.where(value >= 0, res, -torch.inf)
        return check_parameters(res, sigma > 0)

    def _sample(self, generator, shape, sigma):
        return sigma * torch.abs(standard_normal(generator, shape, sigma))

    def _support_point(self, sigma):
        return sigma * _SQRT_2_OVER_PI


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


class ChiSquared(Continuous):
    """Reference continuous.py:2659: Gamma(nu / 2, 1 / 2)."""

    param_names = ("nu",)
    support = "positive"

    def __dist_init__(self, nu):
        self.nu = as_param(nu)

    def _logp(self, value, nu):
        return Gamma._logp(self, value, nu / 2.0, torch.full_like(nu, 0.5))

    def _sample(self, generator, shape, nu):
        return 2.0 * standard_gamma(generator, (nu / 2.0).expand(shape))

    def _support_point(self, nu):
        return nu
