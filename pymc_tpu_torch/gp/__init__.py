"""Gaussian process module (reference pymc/gp/__init__.py), cut to the
marginal and latent GP paths."""

from . import cov, mean, util
from .gp import Latent, Marginal

__all__ = ["util", "cov", "mean", "Latent", "Marginal"]
