from .scaling import trace_cov
from .starting import find_MAP, find_hessian, guess_scaling

__all__ = ["find_MAP", "find_hessian", "guess_scaling", "trace_cov"]
