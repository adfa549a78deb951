"""Continuous univariate distributions: Normal and HalfCauchy.

Counterpart of `pymc_tpu/distributions/continuous.py` (Normal :149,
HalfCauchy :799; reference pymc/distributions/continuous.py:445, :2330).
Densities are elementwise tensor expressions; an invalid parameter gives
-inf and never raises, and a value outside the support gives -inf.
"""

from __future__ import annotations

import math

import torch

from .dist_math import check_parameters, log_normal
from .distribution import Continuous, as_param

__all__ = ["Normal", "HalfCauchy"]

_LOG_2_OVER_PI = math.log(2.0 / math.pi)


class Normal(Continuous):
    """Reference continuous.py:445."""

    param_names = ("mu", "sigma")
    support = "real"

    def __dist_init__(self, mu=0.0, sigma=1.0):
        self.mu = as_param(mu)
        self.sigma = as_param(sigma)

    def _logp(self, value, mu, sigma):
        return check_parameters(log_normal(value, mu, sigma), sigma > 0)

    def _support_point(self, mu, sigma):
        return torch.broadcast_to(mu, torch.broadcast_shapes(mu.shape, sigma.shape))


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

    def _support_point(self, beta):
        return beta
