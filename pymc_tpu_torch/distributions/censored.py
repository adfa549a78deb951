"""Censored distribution combinator.

Counterpart of `pymc_tpu/distributions/censored.py:22-156` (reference
pymc/distributions/censored.py:79, with the logp of pymc/logprob/
censoring.py:86): a value at a bound carries the cdf mass beyond it, so a
censored observation's term is log F(lower) or log(1 - F(upper^-)) and an
exact one the base's density. A value is compared with the bounds in its
own float type: on the card the data and the bounds are both float32, and
a float64 bound beside float32 data is rounded to the data's type first,
so a bound that float32 cannot hold still matches the data censored at it.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import intX
from ..graph import evaluate
from .dist_math import log1mexp
from .distribution import Distribution, _gather_batch_param, as_param

__all__ = ["Censored"]


def _bound(x, like):
    """A bound in `like`'s float type (a float value) or as it is."""
    return x.to(like.dtype) if like.is_floating_point() else x


def _clip(x, lo, hi):
    """clip(x, lo, hi) with either bound None; NaN stays NaN."""
    if lo is not None:
        x = torch.maximum(x, lo.to(x.dtype) if x.is_floating_point() else lo)
    if hi is not None:
        x = torch.minimum(x, hi.to(x.dtype) if x.is_floating_point() else hi)
    return x


class Bounded(Distribution):
    """A univariate base distribution `base` and bounds `lower`, `upper`
    (either may be None): what Censored and Truncated share (their shapes,
    their inputs, the rebuild for imputation)."""

    param_names = ("lower", "upper")
    _kind = "Bounding"

    def __dist_init__(self, dist, lower=None, upper=None):
        if not isinstance(dist, Distribution):
            raise ValueError(f"{type(self).__name__}(dist=...) requires a .dist() instance")
        if dist.event_ndim != 0:
            raise NotImplementedError(f"{self._kind} supports univariate base dists")
        self.base = dist
        self.lower = as_param(lower) if lower is not None else None
        self.upper = as_param(upper) if upper is not None else None
        self.is_discrete = dist.is_discrete

    @property
    def dtype(self):
        return self.base.dtype

    def inputs(self):
        return [p for p in (self.lower, self.upper) if p is not None] + self.base.inputs()

    def _interval_bounds(self):
        return self.lower, self.upper

    def _resolve_shapes(self, shape):
        nat = tuple(np.broadcast_shapes(
            self.base.shape, *[tuple(p.shape) for p in (self.lower, self.upper) if p is not None]
        ))
        self.batch_shape = tuple(shape) if shape is not None else nat
        self.event_shape = ()
        self.shape = self.batch_shape

    def _gathered(self, shape, idx, batch_shape, extra_event=()):
        base = self.base._gathered(shape, idx, batch_shape)
        kwargs = {n: _gather_batch_param(p, batch_shape, idx)
                  for n, p in (("lower", self.lower), ("upper", self.upper)) if p is not None}
        return type(self).dist(base, shape=shape, **kwargs)

    def _bounds(self, env, memo):
        return tuple(None if p is None else evaluate(p, env, memo)
                     for p in (self.lower, self.upper))

    def _value(self, value, env, memo):
        """`value` as a tensor, a float one for a continuous base (the JAX
        package's `_cast_value`), in the bounds' float type if it was not
        a float."""
        value = torch.as_tensor(value)
        if not self.is_discrete and not value.is_floating_point():
            bounds = [b for b in self._bounds(env, memo) if b is not None]
            value = value.to(bounds[0].dtype if bounds else torch.float64)
        return value

    def logccdf(self, value, env=None, memo=None):
        return log1mexp(self.logcdf(value, env, memo))


class Censored(Bounded):
    """clip(base, lower, upper): P(X = lower) = F(lower), P(X = upper) =
    1 - F(upper^-). No default transform: the point masses at the bounds
    are part of the density, and an interval transform could not reach
    them (`pymc_tpu/distributions/censored.py:38-45`)."""

    _kind = "Censoring"

    @property
    def support(self):
        return "real"

    def logp(self, value, env=None, memo=None):
        memo = {} if memo is None else memo
        value = self._value(value, env, memo)
        res = self.base.logp(value, env, memo)
        if self.lower is not None:
            lower = evaluate(self.lower, env, memo)
            lo_mass = self.base.logcdf(lower, env, memo)
            lower = _bound(lower, value)
            res = torch.where(value == lower, lo_mass, res)
            res = torch.where(value < lower, -torch.inf, res)
        if self.upper is not None:
            upper = evaluate(self.upper, env, memo)
            if self.is_discrete:
                # P(X >= upper) = 1 - F(upper - 1)
                hi_mass = log1mexp(torch.clamp(self.base.logcdf(upper - 1, env, memo),
                                               max=-1e-15))
            else:
                hi_mass = self.base.logccdf(upper, env, memo)
            upper = _bound(upper, value)
            res = torch.where(value == upper, hi_mass, res)
            res = torch.where(value > upper, -torch.inf, res)
        return res

    def logcdf(self, value, env=None, memo=None):
        memo = {} if memo is None else memo
        value = self._value(value, env, memo)
        res = self.base.logcdf(value, env, memo)
        if self.lower is not None:
            res = torch.where(value < _bound(evaluate(self.lower, env, memo), value),
                              -torch.inf, res)
        if self.upper is not None:
            res = torch.where(value >= _bound(evaluate(self.upper, env, memo), value), 0.0, res)
        return res

    def icdf(self, q, env=None, memo=None):
        """The point masses absorb the tail quantiles: clip(base.icdf(q),
        lower, upper); NaN outside [0, 1] stays NaN through the clip."""
        memo = {} if memo is None else memo
        return _clip(self.base.icdf(q, env, memo), *self._bounds(env, memo))

    def sample(self, generator, sample_shape=(), env=None, memo=None):
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        memo = {} if memo is None else memo
        full = tuple(sample_shape) + self.shape
        base_shape = self.base.shape
        extra = full[: len(full) - len(base_shape)] if base_shape else full
        draw = self.base.sample(generator, extra, env, memo)
        clipped = _clip(draw.to(torch.float64) if not draw.is_floating_point() else draw,
                        *self._bounds(env, memo))
        return torch.broadcast_to(clipped.to(draw.dtype), full)

    def support_point(self, env=None, memo=None):
        memo = {} if memo is None else memo
        pt = self.base.support_point(env, memo)
        lo, hi = self._bounds(env, memo)
        pt = _clip(pt if pt.is_floating_point() else pt.to(torch.float64), lo, hi)
        if self.is_discrete:
            pt = pt.to(intX())
        return torch.broadcast_to(pt, self.shape)
