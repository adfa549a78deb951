"""Distributions of the PyTorch port."""

from .continuous import Gamma, HalfCauchy, HalfNormal, Normal
from .distribution import Continuous, Distribution
from .multivariate import MvNormal

__all__ = [
    "Distribution", "Continuous", "Normal", "HalfNormal", "HalfCauchy", "Gamma", "MvNormal",
]
