"""Warnings and errors of the port (counterpart of the part of
`pymc_tpu/exceptions.py` that the ported modules raise)."""

__all__ = ["ImplicitFreezeWarning"]


class ImplicitFreezeWarning(UserWarning):
    """A trace variable was kept at its trace values although one of its
    inputs is resampled (reference exceptions.py)."""
