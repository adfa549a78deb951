"""Distributions of the PyTorch port (Normal and HalfCauchy so far)."""

from .continuous import HalfCauchy, Normal
from .distribution import Continuous, Distribution

__all__ = ["Distribution", "Continuous", "Normal", "HalfCauchy"]
