"""Warnings and errors of the port (counterpart of the part of
`pymc_tpu/exceptions.py` that the ported modules raise)."""

__all__ = ["ImplicitFreezeWarning", "ImputationWarning", "UndefinedMomentException"]


class ImplicitFreezeWarning(UserWarning):
    """A trace variable was kept at its trace values although one of its
    inputs is resampled (reference exceptions.py)."""


class ImputationWarning(UserWarning):
    """Observed data with missing values is imputed (reference
    exceptions.py)."""


class UndefinedMomentException(Exception):
    """No support point / moment exists for a distribution
    (reference exceptions.py)."""
