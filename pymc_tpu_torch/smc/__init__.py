"""Tempered SMC (counterpart of `pymc_tpu/smc/`)."""

from .kernels import IMH, MH
from .sampling import sample_smc

__all__ = ["sample_smc", "IMH", "MH"]
