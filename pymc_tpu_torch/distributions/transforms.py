"""Value-space transforms (bijectors).

Counterpart of `pymc_tpu/distributions/transforms.py`, cut to the log,
simplex (stick-breaking), ordered and chained transforms. Same convention as
the reference: `forward` maps constrained -> unconstrained, `backward` maps
unconstrained -> constrained, and `log_jac_det(v)` is
log|det d backward(v) / dv| at the unconstrained value `v`. Every method
takes the evaluation env as an optional last argument, which a chained
transform passes through to its parts (the JAX package's parametrised
transforms read their bounds from it; none of the ported ones does).
"""

from __future__ import annotations

import torch

from .dist_math import softplus

__all__ = [
    "Transform", "LogTransform", "SimplexTransform", "OrderedTransform", "ChainedTransform",
    "log", "simplex", "ordered",
]


class Transform:
    name: str = "transform"
    #: trailing constrained-space dims the transform treats as one block (0 =
    #: elementwise); `Model.register_rv` refuses one smaller than the
    #: distribution's event_ndim
    event_ndim: int = 0

    def forward(self, x, env=None):
        raise NotImplementedError

    def backward(self, v, env=None):
        raise NotImplementedError

    def log_jac_det(self, v, env=None):
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

    def forward(self, x, env=None):
        return torch.log(x)

    def backward(self, v, env=None):
        return torch.exp(v)

    def log_jac_det(self, v, env=None):
        return v


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

    def forward(self, x, env=None):
        x0 = x[..., :-1]
        rem = 1.0 - torch.cumsum(x0, dim=-1)
        rem = torch.cat([torch.ones_like(x[..., :1]), rem[..., :-1]], dim=-1)
        z = x0 / rem
        return torch.log(z) - torch.log1p(-z) + _stick_offsets(x0)

    def backward(self, v, env=None):
        z = torch.sigmoid(v - _stick_offsets(v))
        zl = torch.cat([z, torch.ones_like(v[..., :1])], dim=-1)
        lower = torch.cat([torch.ones_like(v[..., :1]), torch.cumprod(1.0 - z, dim=-1)], dim=-1)
        return zl * lower

    def log_jac_det(self, v, env=None):
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

    def forward(self, x, env=None):
        if not self.ascending:
            x = torch.flip(x, dims=(-1,))
        y0 = torch.log(x[..., :1]) if self.positive else x[..., :1]
        return torch.cat([y0, torch.log(torch.diff(x, dim=-1))], dim=-1)

    def backward(self, v, env=None):
        x0 = torch.exp(v[..., :1]) if self.positive else v[..., :1]
        x = torch.cumsum(torch.cat([x0, torch.exp(v[..., 1:])], dim=-1), dim=-1)
        if not self.ascending:
            x = torch.flip(x, dims=(-1,))
        return x

    def log_jac_det(self, v, env=None):
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

    def forward(self, x, env=None):
        for t in self.transforms:
            x = t.forward(x, env)
        return x

    def backward(self, v, env=None):
        for t in reversed(self.transforms):
            v = t.backward(v, env)
        return v

    def log_jac_det(self, v, env=None):
        # each part's term is reduced to the smallest ndim among them (a
        # vector part collapses the core axis); batch axes stay
        dets = []
        for t in reversed(self.transforms):
            dets.append(torch.as_tensor(t.log_jac_det(v, env)))
            v = t.backward(v, env)
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
simplex = SimplexTransform()
ordered = OrderedTransform()
