"""Stein machinery (reference pymc/variational/stein.py): a shim that
re-exports the names of operators.py."""

from .operators import Stein, rbf

__all__ = ["Stein", "rbf"]
