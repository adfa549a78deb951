"""Value-space transforms (bijectors).

Counterpart of `pymc_tpu/distributions/transforms.py`: the log, log-odds,
interval, log-expm1 (softplus), circular, simplex (stick-breaking), ordered
and chained transforms. Same convention as the reference: `forward` maps
constrained -> unconstrained, `backward` maps unconstrained -> constrained,
and `log_jac_det(v)` is log|det d backward(v) / dv| at the unconstrained
value `v`. Every method takes the evaluation env and memo as optional last
arguments, which a chained transform passes through to its parts: the
interval transform's bounds are graph nodes, evaluated there (the memo
holds the constants placed on the device). The sum-to-1, zero-sum and
Cholesky transforms are not ported yet.
"""

from __future__ import annotations

import math

import torch

from ..graph import evaluate
from .dist_math import softplus

__all__ = [
    "Transform", "LogTransform", "LogOddsTransform", "IntervalTransform", "LogExpM1Transform",
    "CircularTransform", "SimplexTransform", "OrderedTransform", "ChainedTransform", "Chain",
    "Interval", "log", "logodds", "log_exp_m1", "circular", "simplex", "ordered",
]


class Transform:
    name: str = "transform"
    #: trailing constrained-space dims the transform treats as one block (0 =
    #: elementwise); `Model.register_rv` refuses one smaller than the
    #: distribution's event_ndim
    event_ndim: int = 0

    def forward(self, x, env=None, memo=None):
        raise NotImplementedError

    def backward(self, v, env=None, memo=None):
        raise NotImplementedError

    def log_jac_det(self, v, env=None, memo=None):
        raise NotImplementedError

    def value_shape(self, shape):
        """Shape of the unconstrained value for a constrained var of `shape`."""
        return tuple(shape)

    def constrained_shape(self, value_shape):
        return tuple(value_shape)

    def __repr__(self):
        return f"{type(self).__name__}()"


class LogTransform(Transform):
    name = "log"

    def forward(self, x, env=None, memo=None):
        return torch.log(x)

    def backward(self, v, env=None, memo=None):
        return torch.exp(v)

    def log_jac_det(self, v, env=None, memo=None):
        return v


class LogOddsTransform(Transform):
    """(0, 1) -> R, x = sigmoid(v)."""

    name = "logodds"

    def forward(self, x, env=None, memo=None):
        return torch.log(x) - torch.log1p(-x)

    def backward(self, v, env=None, memo=None):
        return torch.sigmoid(v)

    def log_jac_det(self, v, env=None, memo=None):
        return -softplus(-v) - softplus(v)


class IntervalTransform(Transform):
    """(lower, upper) -> R; either bound may be None (half-open). A bound
    is a number or a graph node (pymc_tpu transforms.py:108): a
    distribution's default transform takes its parameters' nodes."""

    name = "interval"

    def __init__(self, lower=None, upper=None):
        if lower is None and upper is None:
            raise ValueError("Lower and upper interval bounds cannot both be None")
        self.lower = lower
        self.upper = upper

    def _bounds(self, env, memo):
        lo = None if self.lower is None else evaluate(self.lower, env, memo)
        hi = None if self.upper is None else evaluate(self.upper, env, memo)
        return lo, hi

    def forward(self, x, env=None, memo=None):
        lo, hi = self._bounds(env, memo)
        if lo is not None and hi is not None:
            return torch.log(x - lo) - torch.log(hi - x)
        if lo is not None:
            return torch.log(x - lo)
        return torch.log(hi - x)

    def backward(self, v, env=None, memo=None):
        lo, hi = self._bounds(env, memo)
        if lo is not None and hi is not None:
            # the convex combination rounds to the bound itself when the
            # sigmoid saturates, where lo + (hi - lo) s would overshoot it
            s = torch.sigmoid(v)
            return s * hi + (1.0 - s) * lo
        if lo is not None:
            return lo + torch.exp(v)
        return hi - torch.exp(v)

    def log_jac_det(self, v, env=None, memo=None):
        lo, hi = self._bounds(env, memo)
        if lo is not None and hi is not None:
            width = hi - lo
            log_width = torch.log(width) if isinstance(width, torch.Tensor) else math.log(width)
            return log_width - softplus(-v) - softplus(v)
        return v


class LogExpM1Transform(Transform):
    """(0, inf) -> R, x = softplus(v)."""

    name = "log_exp_m1"

    def forward(self, x, env=None, memo=None):
        return x + torch.log1p(-torch.exp(-x))

    def backward(self, v, env=None, memo=None):
        return softplus(v)

    def log_jac_det(self, v, env=None, memo=None):
        return -softplus(-v)


class CircularTransform(Transform):
    """An angle wrapped to (-pi, pi] both ways, with a zero log-Jacobian."""

    name = "circular"

    def forward(self, x, env=None, memo=None):
        return torch.atan2(torch.sin(x), torch.cos(x))

    def backward(self, v, env=None, memo=None):
        return torch.atan2(torch.sin(v), torch.cos(v))

    def log_jac_det(self, v, env=None, memo=None):
        return torch.zeros_like(v)


def _stick_offsets(v):
    """log(K - 1 - k) for k = 0 .. K-2, K = v.shape[-1] + 1: the shift that
    centres the stick-breaking fractions at the uniform simplex."""
    K = v.shape[-1] + 1
    ks = torch.arange(K - 1, dtype=v.dtype, device=v.device)
    return torch.log(K - 1.0 - ks)


class SimplexTransform(Transform):
    """Stick-breaking: a simplex of K -> R^{K-1} (pymc_tpu
    transforms.py:166)."""

    name = "simplex"
    event_ndim = 1

    def forward(self, x, env=None, memo=None):
        x0 = x[..., :-1]
        rem = 1.0 - torch.cumsum(x0, dim=-1)
        rem = torch.cat([torch.ones_like(x[..., :1]), rem[..., :-1]], dim=-1)
        z = x0 / rem
        return torch.log(z) - torch.log1p(-z) + _stick_offsets(x0)

    def backward(self, v, env=None, memo=None):
        z = torch.sigmoid(v - _stick_offsets(v))
        zl = torch.cat([z, torch.ones_like(v[..., :1])], dim=-1)
        lower = torch.cat([torch.ones_like(v[..., :1]), torch.cumprod(1.0 - z, dim=-1)], dim=-1)
        return zl * lower

    def log_jac_det(self, v, env=None, memo=None):
        adj = v - _stick_offsets(v)
        z = torch.sigmoid(adj)
        one_minus = torch.cumprod(1.0 - z, dim=-1)
        lower = torch.cat([torch.ones_like(v[..., :1]), one_minus[..., :-1]], dim=-1)
        # d x_k / d v_k = lower_k * z_k * (1 - z_k)
        return torch.sum(torch.log(lower) - softplus(-adj) - softplus(adj), dim=-1)

    def value_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] - 1,)

    def constrained_shape(self, value_shape):
        return tuple(value_shape[:-1]) + (value_shape[-1] + 1,)


class OrderedTransform(Transform):
    """Monotone vector (pymc_tpu transforms.py:221): x_0 = v_0 (exp(v_0)
    with `positive`), x_k = x_{k-1} + exp(v_k); reversed when not
    `ascending`."""

    name = "ordered"
    event_ndim = 1

    def __init__(self, positive=False, ascending=True):
        self.positive = positive
        self.ascending = ascending

    def forward(self, x, env=None, memo=None):
        if not self.ascending:
            x = torch.flip(x, dims=(-1,))
        y0 = torch.log(x[..., :1]) if self.positive else x[..., :1]
        return torch.cat([y0, torch.log(torch.diff(x, dim=-1))], dim=-1)

    def backward(self, v, env=None, memo=None):
        x0 = torch.exp(v[..., :1]) if self.positive else v[..., :1]
        x = torch.cumsum(torch.cat([x0, torch.exp(v[..., 1:])], dim=-1), dim=-1)
        if not self.ascending:
            x = torch.flip(x, dims=(-1,))
        return x

    def log_jac_det(self, v, env=None, memo=None):
        if self.positive:
            return torch.sum(v, dim=-1)
        return torch.sum(v[..., 1:], dim=-1)


class ChainedTransform(Transform):
    """Composition (pymc_tpu transforms.py:530): `forward` applies the
    transforms in order, `backward` in reverse."""

    def __init__(self, transforms):
        self.transforms = list(transforms)
        self.name = "chain_" + "_".join(t.name for t in self.transforms)
        self.event_ndim = max((t.event_ndim for t in self.transforms), default=0)

    def forward(self, x, env=None, memo=None):
        for t in self.transforms:
            x = t.forward(x, env, memo)
        return x

    def backward(self, v, env=None, memo=None):
        for t in reversed(self.transforms):
            v = t.backward(v, env, memo)
        return v

    def log_jac_det(self, v, env=None, memo=None):
        # each part's term is reduced to the smallest ndim among them (a
        # vector part collapses the core axis); batch axes stay
        dets = []
        for t in reversed(self.transforms):
            dets.append(torch.as_tensor(t.log_jac_det(v, env, memo)))
            v = t.backward(v, env, memo)
        ndim0 = min(d.ndim for d in dets)
        total = 0.0
        for d in dets:
            while d.ndim > ndim0:
                d = torch.sum(d, dim=-1)
            total = total + d
        return total

    def value_shape(self, shape):
        for t in self.transforms:
            shape = t.value_shape(shape)
        return tuple(shape)

    def constrained_shape(self, value_shape):
        for t in reversed(self.transforms):
            value_shape = t.constrained_shape(value_shape)
        return tuple(value_shape)

    def __repr__(self):
        return f"ChainedTransform({self.transforms!r})"


log = LogTransform()
logodds = LogOddsTransform()
log_exp_m1 = LogExpM1Transform()
circular = CircularTransform()
simplex = SimplexTransform()
ordered = OrderedTransform()

# the reference's names
Chain = ChainedTransform
Interval = IntervalTransform
