"""Distributions of the PyTorch port."""

from . import transforms
from .continuous import ChiSquared, Gamma, HalfCauchy, HalfNormal, Normal
from .discrete import Bernoulli
from .distribution import Continuous, Discrete, Distribution
from .mixture import Mixture, NormalMixture
from .multivariate import Dirichlet, KroneckerNormal, MvNormal, MvStudentT

__all__ = [
    "Distribution", "Continuous", "Discrete", "Bernoulli", "Normal", "HalfNormal", "HalfCauchy",
    "Gamma", "ChiSquared", "MvNormal", "MvStudentT", "KroneckerNormal", "Dirichlet", "Mixture",
    "NormalMixture", "transforms",
]
