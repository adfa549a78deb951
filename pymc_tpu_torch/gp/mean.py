"""GP mean functions (reference pymc/gp/mean.py: Zero, Constant, Linear).

Counterpart of `pymc_tpu/gp/mean.py`. A mean evaluated on a concrete X is a
concrete float64 tensor; on a graph Node it is a Node whose value follows
X's float type and device.
"""

from __future__ import annotations

import torch

from ..graph import apply

__all__ = ["Mean", "Zero", "Constant", "Linear", "Add", "Prod"]


def _float_like(x):
    """(dtype, device) of the values a mean of `x` produces."""
    x = torch.as_tensor(x)
    return (x.dtype if x.is_floating_point() else torch.float64), x.device


def _rows(x):
    return torch.atleast_2d(torch.as_tensor(x)).shape[0]


class Mean:
    def __call__(self, X):
        raise NotImplementedError

    def __add__(self, other):
        return _MeanAdd(self, other)

    def __mul__(self, other):
        return _MeanProd(self, other)


class _MeanAdd(Mean):
    def __init__(self, a, b):
        self.a, self.b = a, b

    def __call__(self, X):
        return apply(torch.add, self.a(X), self.b(X))


class _MeanProd(Mean):
    def __init__(self, a, b):
        self.a, self.b = a, b

    def __call__(self, X):
        return apply(torch.mul, self.a(X), self.b(X))


class Zero(Mean):
    def __call__(self, X):
        def zero(x):
            dtype, device = _float_like(x)
            return torch.zeros((_rows(x),), dtype=dtype, device=device)

        return apply(zero, X)


class Constant(Mean):
    def __init__(self, c=0.0):
        self.c = c

    def __call__(self, X):
        def const(x, c):
            dtype, device = _float_like(x)
            if not isinstance(c, torch.Tensor):
                # a fill, not a copy from the host
                return torch.full((_rows(x),), float(c), dtype=dtype, device=device)
            return c.to(dtype=dtype, device=device).expand(_rows(x))

        return apply(const, X, self.c)


class Linear(Mean):
    def __init__(self, coeffs, intercept=0.0):
        self.coeffs = coeffs
        self.intercept = intercept

    def __call__(self, X):
        def linear(x, b, a):
            x = torch.atleast_2d(torch.as_tensor(x))
            b = torch.atleast_1d(torch.as_tensor(b, dtype=x.dtype, device=x.device))
            return x @ b + a

        return apply(linear, X, self.coeffs, self.intercept)


# public aliases matching reference gp/mean.py class names
Add = _MeanAdd
Prod = _MeanProd
