"""Test functions for operator VI (reference
pymc/variational/test_functions.py): a shim that re-exports the names of
operators.py."""

from .operators import TestFunction, rbf

__all__ = ["TestFunction", "rbf"]
