"""Convergence diagnostics, pointwise log densities, summaries and model
comparison (the names of `pymc_tpu/stats/__init__.py`)."""

from .convergence import ess, mcse_mean, mcse_sd, rhat, run_convergence_checks
from .log_density import compute_log_likelihood, compute_log_prior
from .model_comparison import ELPDData, compare, loo, waic
from .summary import hdi, summary

__all__ = [
    "ess", "rhat", "mcse_mean", "mcse_sd", "run_convergence_checks",
    "compute_log_likelihood", "compute_log_prior", "summary", "hdi",
    "loo", "waic", "compare", "ELPDData",
]
