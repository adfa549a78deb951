"""Distributions of the PyTorch port."""

from .continuous import Gamma, HalfCauchy, HalfNormal, Normal
from .discrete import Bernoulli
from .distribution import Continuous, Discrete, Distribution
from .multivariate import MvNormal

__all__ = [
    "Distribution", "Continuous", "Discrete", "Bernoulli", "Normal", "HalfNormal", "HalfCauchy",
    "Gamma", "MvNormal",
]
