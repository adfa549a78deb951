"""Derived-density combinators: discretization, order statistics,
cumulative sums and comparisons of random variables.

Counterpart of `pymc_tpu/distributions/derived.py`, whose densities are
closed forms of a base distribution's logp, logcdf and logccdf (reference
pymc/logprob/censoring.py:299-420, order.py:70-172, cumsum.py:53-75,
binary.py:92-122):

- Discretized: round/floor/ceil/trunc of a continuous base; the mass of a
  value is the base's cdf difference over its cell (above the base's
  median, its survival difference, which float32 resolves in the tail).
- OrderStatistic, Max, Min: the k-th smallest of n iid draws; the closed
  form for a continuous base, the cdf-power difference for a discrete one
  (max and min only).
- CumSum: the cumulative sum of a base of independent components; the map
  has a unit Jacobian, so the density is the base's at the differences.
- Compared: the boolean X > c (>=, <, <=), a Bernoulli with the cdf and
  survival masses, with the boundary corrections of a discrete base.

Each base is an unnamed `.dist`; `inputs` lists its inputs, so the graph
finds the random variables it reads and the constants to place on the
device. The log-cdf differences clamp with the smallest normal number of
the value's own float type (float32 on the card), not of float64.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import intX
from ..graph import Node, as_node, evaluate
from .dist_math import log1mexp
from .distribution import Continuous, Discrete, Distribution, as_param

__all__ = ["Discretized", "OrderStatistic", "Max", "Min", "CumSum", "Compared"]


def _below_zero(x):
    """x clamped below -tiny of its float type."""
    return torch.clamp(x, max=-torch.finfo(x.dtype).tiny)


def _logdiffexp(a, b):
    """log(exp(a) - exp(b)) for a >= b, stable."""
    return a + log1mexp(_below_zero(b - a))


def _base_float(base, env, memo):
    """The float type of the base's parameters as evaluated (float32 on the
    card), float64 where it has none."""
    floats = [p for p in base.resolve_params(env, memo) if p is not None and p.is_floating_point()]
    return floats[0].dtype if floats else torch.float64


class Discretized(Discrete):
    """Distribution of ``method(X)`` for a continuous base X, method one of
    round, floor, ceil, trunc:

    P(round(X) = k) = F(k + 1/2) - F(k - 1/2)
    P(floor(X) = k) = F(k + 1)   - F(k)
    P(ceil(X)  = k) = F(k)       - F(k - 1)
    P(trunc(X) = k) = the floor cell for k > 0, the ceil cell for k < 0,
                      and the pooled (-1, 1) cell at k = 0.
    """

    param_names = ()
    _methods = ("round", "floor", "ceil", "trunc")

    def __dist_init__(self, dist, method="round"):
        if not isinstance(dist, Distribution):
            raise ValueError("Discretized(dist=...) requires a .dist() instance")
        if dist.is_discrete:
            raise ValueError(
                "Discretized requires a continuous base distribution; "
                f"{type(dist).__name__} is already discrete"
            )
        if dist.event_ndim != 0:
            raise NotImplementedError("Discretized supports univariate base distributions")
        if method not in self._methods:
            raise ValueError(f"method must be one of {self._methods}")
        self.base = dist
        self.method = method

    def inputs(self):
        return self.base.inputs()

    def _resolve_shapes(self, shape):
        self.batch_shape = tuple(self.base.shape) if shape is None else tuple(shape)
        self.event_shape = ()
        self.shape = self.batch_shape

    def _cell_bounds(self, v):
        """(snapped value, lower edge, upper edge) of the cell of float `v`."""
        if self.method == "round":
            v = torch.round(v)
            return v, v - 0.5, v + 0.5
        if self.method == "floor":
            v = torch.floor(v)
            return v, v, v + 1.0
        if self.method == "ceil":
            v = torch.ceil(v)
            return v, v - 1.0, v
        # trunc: [k, k+1) for k >= 0, (k-1, k] for k < 0, (-1, 1) pooled at 0
        v = torch.trunc(v)
        return v, v - (v <= 0).to(v.dtype), v + (v >= 0).to(v.dtype)

    def _float_value(self, value, env, memo):
        return torch.as_tensor(value).to(_base_float(self.base, env, memo))

    def logp(self, value, env=None, memo=None):
        """log(F(hi) - F(lo)) over the value's cell; above the base's
        median, where F(lo) > 1/2, as log(S(lo) - S(hi)), which float32
        resolves in the upper tail where F rounds to 1."""
        memo = {} if memo is None else memo
        _, lo, hi = self._cell_bounds(self._float_value(value, env, memo))
        F_lo = self.base.logcdf(lo, env, memo)
        lower = _logdiffexp(self.base.logcdf(hi, env, memo), F_lo)
        upper = _logdiffexp(self.base.logccdf(lo, env, memo), self.base.logccdf(hi, env, memo))
        return torch.where(F_lo > -math.log(2.0), upper, lower)

    def logcdf(self, value, env=None, memo=None):
        memo = {} if memo is None else memo
        v, _, hi = self._cell_bounds(self._float_value(value, env, memo))
        if self.method == "trunc":
            # trunc(X) <= k  <=>  X < k+1 for k >= 0, X <= k for k < 0
            hi = v + (v >= 0).to(v.dtype)
        return self.base.logcdf(hi, env, memo)

    def sample(self, generator, sample_shape=(), env=None, memo=None):
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        full = tuple(sample_shape) + self.shape
        extra = full[: len(full) - len(self.base.shape)]
        draw = self.base.sample(generator, extra, env, memo)
        fn = {"round": torch.round, "floor": torch.floor,
              "ceil": torch.ceil, "trunc": torch.trunc}[self.method]
        return torch.broadcast_to(fn(draw), full).to(intX())

    def support_point(self, env=None, memo=None):
        pt, _, _ = self._cell_bounds(self.base.support_point(env, memo))
        return torch.broadcast_to(pt, self.shape).to(intX())


class OrderStatistic(Distribution):
    """Distribution of the k-th smallest of ``n`` iid draws from ``dist``
    (rank k from 1, the minimum, to n, the maximum). Continuous:

        logp(x) = log n! - log (k-1)! - log (n-k)!
                  + (k-1) logF(x) + (n-k) logS(x) + logf(x)

    Discrete, the maximum and the minimum only: F(x)^n - F(x-1)^n and
    S(x-1)^n - S(x)^n.
    """

    param_names = ()

    def __dist_init__(self, dist, n, rank):
        if not isinstance(dist, Distribution):
            raise ValueError("OrderStatistic(dist=...) requires a .dist() instance")
        if dist.event_ndim != 0 or tuple(dist.shape) != ():
            raise ValueError(
                "OrderStatistic requires a scalar (iid) base distribution; "
                f"got batch shape {dist.shape!r}"
            )
        n, rank = int(n), int(rank)
        if not 1 <= rank <= n:
            raise ValueError(f"rank must be in [1, {n}]; got {rank}")
        if dist.is_discrete and rank not in (1, n):
            raise NotImplementedError(
                "Discrete order statistics are only supported for the "
                "minimum (rank=1) and maximum (rank=n)"
            )
        self.base = dist
        self.n = n
        self.rank = rank
        self.is_discrete = dist.is_discrete

    def inputs(self):
        return self.base.inputs()

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def support(self):
        return self.base.support

    def _interval_bounds(self):
        return self.base._interval_bounds()

    def _resolve_shapes(self, shape):
        self.batch_shape = () if shape is None else tuple(shape)
        self.event_shape = ()
        self.shape = self.batch_shape

    def logp(self, value, env=None, memo=None):
        memo = {} if memo is None else memo
        value = torch.as_tensor(value)
        n, k = self.n, self.rank
        if self.is_discrete:
            F = self.base.logcdf(value, env, memo)
            F_prev = self.base.logcdf(value - 1, env, memo)
            if k == n:  # max: F(x)^n - F(x-1)^n
                return _logdiffexp(n * F, n * F_prev)
            # min: S(x-1)^n - S(x)^n with S(x) = P(X > x)
            S = log1mexp(_below_zero(F))
            S_prev = log1mexp(_below_zero(F_prev))
            return _logdiffexp(n * S_prev, n * S)
        logF = self.base.logcdf(value, env, memo)
        logS = self.base.logccdf(value, env, memo)
        logf = self.base.logp(value, env, memo)
        coef = math.lgamma(n + 1.0) - math.lgamma(float(k)) - math.lgamma(n - k + 1.0)
        return coef + (k - 1) * logF + (n - k) * logS + logf

    def logcdf(self, value, env=None, memo=None):
        memo = {} if memo is None else memo
        n, k = self.n, self.rank
        F = self.base.logcdf(value, env, memo)
        if k == n:  # P(max <= x) = F^n
            return n * F
        if k == 1:  # P(min <= x) = 1 - S^n
            S = log1mexp(_below_zero(F))
            return log1mexp(_below_zero(n * S))
        raise NotImplementedError("logcdf of interior order statistics is not implemented")

    def sample(self, generator, sample_shape=(), env=None, memo=None):
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        full = tuple(sample_shape) + self.shape
        draws = self.base.sample(generator, full + (self.n,), env, memo)
        return torch.sort(draws, dim=-1).values[..., self.rank - 1]

    def support_point(self, env=None, memo=None):
        """The base's quantile at k / (n + 1) where it has one, else its
        support point."""
        memo = {} if memo is None else memo
        try:
            pt = self.base.icdf(self.rank / (self.n + 1.0), env, memo)
        except NotImplementedError:
            pt = self.base.support_point(env, memo)
        pt = pt.to(intX()) if self.is_discrete else pt
        return torch.broadcast_to(pt, self.shape)


class Max(OrderStatistic):
    """Maximum of n iid draws (reference logprob/order.py max_logprob)."""

    def __dist_init__(self, dist, n):
        super().__dist_init__(dist, n, int(n))


class Min(OrderStatistic):
    """Minimum of n iid draws (reference logprob/order.py via negated max)."""

    def __dist_init__(self, dist, n):
        super().__dist_init__(dist, n, 1)


class CumSum(Continuous):
    """Distribution of cumsum(X, axis) for a base of independent
    components: logp(v) = base.logp(diff_with_first(v)), the map being
    unit lower triangular (reference logprob/cumsum.py:53)."""

    param_names = ()

    def __dist_init__(self, dist, axis=-1):
        if not isinstance(dist, Distribution):
            raise ValueError("CumSum(dist=...) requires a .dist() instance")
        if not dist.shape:
            raise ValueError("CumSum requires a base with at least one axis")
        self.is_discrete = dist.is_discrete
        self.base = dist
        self.axis = int(axis)

    def inputs(self):
        return self.base.inputs()

    @property
    def dtype(self):
        return self.base.dtype

    def _resolve_shapes(self, shape):
        self.batch_shape = tuple(self.base.shape)
        self.event_shape = ()
        self.shape = self.batch_shape
        if shape is not None and tuple(shape) != self.batch_shape:
            raise ValueError(f"CumSum shape must match the base shape {self.batch_shape}")

    def _diff(self, value):
        first = value.narrow(self.axis, 0, 1)
        return torch.cat([first, torch.diff(value, dim=self.axis)], dim=self.axis)

    def logp(self, value, env=None, memo=None):
        value = torch.as_tensor(value)
        if not value.is_floating_point() and not self.is_discrete:
            value = value.to(_base_float(self.base, env, {} if memo is None else memo))
        return self.base.logp(self._diff(value), env, memo)

    def sample(self, generator, sample_shape=(), env=None, memo=None):
        draw = self.base.sample(generator, sample_shape, env, memo)
        return torch.cumsum(draw, dim=self.axis).to(draw.dtype)

    def support_point(self, env=None, memo=None):
        pt = torch.broadcast_to(self.base.support_point(env, memo), self.shape)
        return torch.cumsum(pt, dim=self.axis).to(pt.dtype)


class Compared(Discrete):
    """Distribution of the boolean ``X <op> c`` for a base X and a constant
    (or node) operand c, op one of >, >=, <, <=. Continuous: P(True) = S(c)
    for > and >=, F(c) for < and <=. A discrete base (reference
    logprob/binary.py:92-122), with S(c) = P(X > c):

      >  : True -> S(c),             False -> F(c)
      >= : True -> S(c) + p(c),      False -> F(c-1)
      <  : True -> F(c-1),           False -> S(c) + p(c)
      <= : True -> F(c),             False -> S(c)
    """

    param_names = ("operand",)
    _ops = (">", ">=", "<", "<=")

    def __dist_init__(self, dist, operand, op=">"):
        if not isinstance(dist, Distribution):
            raise ValueError("Compared(dist=...) requires a .dist() instance")
        if dist.event_ndim != 0:
            raise NotImplementedError("Compared supports univariate base dists")
        if op not in self._ops:
            raise ValueError(f"op must be one of {self._ops}")
        self.base = dist
        self.op = op
        # a discrete base compares with an integer operand as given
        integer = (dist.is_discrete and not isinstance(operand, Node)
                   and np.issubdtype(np.asarray(operand).dtype, np.integer))
        self.operand = as_node(np.asarray(operand)) if integer else as_param(operand)

    def inputs(self):
        return [self.operand] + self.base.inputs()

    def _resolve_shapes(self, shape):
        nat = tuple(np.broadcast_shapes(self.base.shape, tuple(self.operand.shape)))
        self.batch_shape = nat if shape is None else tuple(shape)
        self.event_shape = ()
        self.shape = self.batch_shape

    def _masses(self, env, memo):
        """(log P(True), log P(False)) elementwise over the batch."""
        c = evaluate(self.operand, env, memo)
        F = self.base.logcdf(c, env, memo)
        S = self.base.logccdf(c, env, memo)
        op = self.op
        if not self.base.is_discrete:
            return (S, F) if op in (">", ">=") else (F, S)
        if op == ">":
            return S, F
        if op == "<=":
            return F, S
        p = self.base.logp(c, env, memo)
        F_prev = self.base.logcdf(c - 1, env, memo)
        if op == ">=":
            return torch.logaddexp(S, p), F_prev
        return F_prev, torch.logaddexp(S, p)  # <

    def logp(self, value, env=None, memo=None):
        memo = {} if memo is None else memo
        value = torch.as_tensor(value)
        lt, lf = self._masses(env, memo)
        res = torch.where(value != 0, lt, lf)
        # values outside {0, 1} have no mass
        return torch.where((value == 0) | (value == 1), res, -torch.inf)

    def sample(self, generator, sample_shape=(), env=None, memo=None):
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        memo = {} if memo is None else memo
        full = tuple(sample_shape) + self.shape
        extra = full[: len(full) - len(self.base.shape)]
        draw = self.base.sample(generator, extra, env, memo)
        c = evaluate(self.operand, env, memo)
        fn = {">": torch.gt, ">=": torch.ge, "<": torch.lt, "<=": torch.le}[self.op]
        return torch.broadcast_to(fn(draw, c), full).to(intX())

    def support_point(self, env=None, memo=None):
        lt, _ = self._masses(env, {} if memo is None else memo)
        return torch.broadcast_to((torch.exp(lt) > 0.5).to(intX()), self.shape)
