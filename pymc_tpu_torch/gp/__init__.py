"""Gaussian process module (reference pymc/gp/__init__.py)."""

from . import cov, mean, util
from .gp import TP, Latent, LatentKron, Marginal, MarginalApprox, MarginalKron, MarginalSparse
from .hsgp_approx import HSGP, HSGPPeriodic, approx_hsgp_hyperparams, set_boundary

__all__ = [
    "util", "cov", "mean", "Latent", "Marginal", "MarginalApprox", "MarginalSparse",
    "MarginalKron", "LatentKron", "TP", "HSGP", "HSGPPeriodic", "set_boundary",
    "approx_hsgp_hyperparams",
]
