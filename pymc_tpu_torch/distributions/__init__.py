"""Distributions of the PyTorch port."""

from . import transforms
from .continuous import Gamma, HalfCauchy, HalfNormal, Normal
from .discrete import Bernoulli
from .distribution import Continuous, Discrete, Distribution
from .mixture import Mixture, NormalMixture
from .multivariate import Dirichlet, MvNormal

__all__ = [
    "Distribution", "Continuous", "Discrete", "Bernoulli", "Normal", "HalfNormal", "HalfCauchy",
    "Gamma", "MvNormal", "Dirichlet", "Mixture", "NormalMixture", "transforms",
]
