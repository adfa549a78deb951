"""Derived densities of invertible elementwise chains over one random variable.

Counterpart of the elementwise half of `pymc_tpu/distributions/
transformed.py` (reference pymc/logprob/transforms.py: the measurable
transforms of exp, log, add, mul, div, pow, sqrt, cbrt, reciprocal, the
hyperbolic family, sigmoid, logit, erf; logprob/basic.py:105 `pm.logp` of
an expression). `dist_from_expression` walks a chain of invertible
elementwise ops (`DeterministicNode(fn, args)` with a known `fn`) down to
its one random leaf, a FreeRV or ObservedRV (an unnamed `.dist()` lifts to
an anonymous one, `Distribution.to_node`), every other operand free of
randomness, and builds a `TransformedDistribution` with the
change-of-variables density

    logp_Y(y) = logp_X(g^-1(y)) + log |d g^-1 / dy|     (continuous base)
    logp_Y(y) = logp_X(g^-1(y))                         (discrete base)

logcdf/logccdf/icdf follow where every link has a determinate direction.
The non-injective folds abs, even powers and cosh give a
`FoldedDistribution` (the density only), and `where(x > 0, s x, t x)` with
positive scales is one more increasing link.

The structural forms of the JAX package (joins, reductions, argmax/argmin,
indexing, cumsum, casts, broadcasts, layouts, matmul, censoring, rounding
and the switch mixture) are ROADMAP item 6b: they raise
NotImplementedError naming it. The port knows those nodes by their
callables (or by the tag `graph.structural` puts on a closure), since it
carries no measurability markers. Forms that the JAX package rejects raise
TypeError here too.

Against the JAX package, a value outside the image of the chain gets
log F = -inf and log S = 0 below the image (log F = 0 and log S = -inf
above it); the JAX package evaluates the cdfs at a clamped in-image point
instead (ROADMAP §3). The odds ratio t / (1 + t) has an image guard (y != 1)
that the JAX package lacks.

A discrete base's value must map onto the integer lattice: within 1e-6 of
an integer in float64 (the JAX package's test), and in float32 within 1e-6
absolute plus 1e-6 relative, since log(exp(k)) in float32 misses an
integer k by up to some ulps of k.
"""

from __future__ import annotations

import functools
import math as _pymath
import numbers
import operator

import numpy as np
import torch

from ..config import floatX
from ..graph import (
    ConstantNode, DeterministicNode, FreeRV, Node, ObservedRV, _cast, _cumsum, _dot, _reduce,
    _reverse_axes, _squeeze, _tuple_index, ancestors, evaluate,
)
from .distribution import Distribution

__all__ = ["TransformedDistribution", "FoldedDistribution", "dist_from_expression",
           "conditioned_on"]

_ITEM_6B = "ROADMAP item 6b, the structural matchers of the logprob engine"


def _concrete(c):
    """A constant operand's value as a numpy array (a number, an array or a
    ConstantNode's value); None for any other Node."""
    if isinstance(c, ConstantNode):
        return c.value.numpy()
    if isinstance(c, Node):
        return None
    return np.asarray(c)


def _as_const(c):
    """An op's constant as it is kept: a Node or a Python number; an array
    becomes a ConstantNode, so that it moves to the device with the model."""
    if isinstance(c, (Node, numbers.Number)):
        return c
    arr = np.asarray(c, dtype=np.float64)
    return float(arr) if arr.ndim == 0 else ConstantNode(arr)


def _t(c, like):
    """An evaluated constant as a tensor in `like`'s float type and device
    (a Python number by a fill, which a CUDA graph captures)."""
    if isinstance(c, torch.Tensor):
        return c if c.dtype == like.dtype else c.to(like.dtype)
    return torch.full((), float(c), dtype=like.dtype, device=like.device)


def _bshape(y, c):
    return torch.broadcast_shapes(y.shape, c.shape if isinstance(c, torch.Tensor) else ())


def _as_value(value):
    """A value or probability as a float tensor (a Python float as float64,
    an integer tensor in its device's float type)."""
    v = value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
    return v if v.is_floating_point() else v.to(floatX(v.device))


def _as_float(x):
    """A draw or quantile as a float tensor (a discrete base's are int64)."""
    return x if x.is_floating_point() else x.to(floatX(x.device))


class _Op:
    """One invertible elementwise link y = forward(x).

    `const` is a Node (evaluated with the env and memo at call time), a
    Python number, a tuple of those, or None. `monotone` is +1, -1 or None
    (undetermined: the density works, the cdf family raises). `valid(y, c)`
    is the image guard: a value outside the image gets logp -inf, and the
    inverse and its log-Jacobian are evaluated at `safe`, a point inside the
    image, so that the untaken branch of the `where` stays finite and adds
    no NaN to the gradient. The image is an interval holding `safe`, so a
    value outside it lies below the image where it is below `safe`.
    """

    continuous_only = False

    def __init__(self, name, forward, inverse, ljd_inv, monotone, const=None, valid=None,
                 safe=1.0):
        self.name = name
        self._forward = forward
        self._inverse = inverse
        self._ljd_inv = ljd_inv
        self.monotone = monotone
        self.const = const
        self._valid = valid
        self._safe = safe

    def consts(self):
        """The op's Node constants, which the device placement must see."""
        c = self.const if isinstance(self.const, tuple) else (self.const,)
        return [x for x in c if isinstance(x, Node)]

    def _c(self, env, memo):
        if isinstance(self.const, tuple):
            return tuple(evaluate(x, env, memo) for x in self.const)
        return evaluate(self.const, env, memo)

    def forward(self, x, env=None, memo=None):
        return self._forward(x, self._c(env, memo))

    def pull(self, y, env=None, memo=None):
        """(inverse(y), log |d inverse / dy|, the in-image mask or None
        where the image is all of R); outside the image the log-Jacobian is
        -inf."""
        c = self._c(env, memo)
        if self._valid is None:
            return self._inverse(y, c), self._ljd_inv(y, c), None
        m = self._valid(y, c)
        ys = torch.where(m, y, self._safe)
        return self._inverse(ys, c), torch.where(m, self._ljd_inv(ys, c), -torch.inf), m

    def side(self, y, m):
        """-1 where y lies below the image, +1 above it, 0 inside (mask m)."""
        return torch.where(m, torch.zeros_like(y), torch.sign(y - self._safe))


def _sign_of_const(c):
    """+1 or -1 where every element of a concrete constant has that sign,
    else None."""
    arr = _concrete(c)
    if arr is None:
        return None
    if np.all(arr > 0):
        return 1
    if np.all(arr < 0):
        return -1
    return None


# ---------------------------------------------------------------- unary ops
_LOG_2 = _pymath.log(2.0)
_LOG_3 = _pymath.log(3.0)
_LOG_10 = _pymath.log(10.0)
_HALF_LOG_PI = 0.5 * _pymath.log(_pymath.pi)
_HALF_PI = 0.5 * _pymath.pi


def _u(name, forward, inverse, ljd_inv, monotone, valid=None, safe=1.0):
    return _Op(name, lambda x, c: forward(x), lambda y, c: inverse(y),
               lambda y, c: ljd_inv(y), monotone,
               valid=None if valid is None else (lambda y, c: valid(y)), safe=safe)


@functools.cache
def _unary():
    """{callable: _Op} of the invertible unary links (pymc_tpu/distributions/
    transformed.py:142-330), keyed by the callables the port's `pm.math`,
    `dist_math` and `Node` operators put into the graph; built at first use,
    since `pm.math` imports this package."""
    from .. import math as pmm
    from . import dist_math as dm

    table = {}

    def reg(fns, *op_args, **op_kwargs):
        op = _u(*op_args, **op_kwargs)
        for fn in fns:
            table[fn] = op

    def logit_ljd(y):
        return torch.log(torch.sigmoid(y)) + torch.log(torch.sigmoid(-y))

    def softplus_inv_ljd(y):
        return -torch.log(-torch.expm1(-y))

    reg((torch.exp,), "exp", torch.exp, torch.log, lambda y: -torch.log(y), 1,
        valid=lambda y: y > 0)
    reg((torch.log,), "log", torch.log, torch.exp, lambda y: y, 1)
    reg((torch.log1p,), "log1p", torch.log1p, torch.expm1, lambda y: y, 1)
    reg((torch.expm1,), "expm1", torch.expm1, torch.log1p, lambda y: -torch.log1p(y), 1,
        valid=lambda y: y > -1.0, safe=0.0)
    reg((torch.log2,), "log2", torch.log2, torch.exp2,
        lambda y: y * _LOG_2 + _pymath.log(_LOG_2), 1)
    reg((torch.log10,), "log10", torch.log10, lambda y: torch.pow(10.0, y),
        lambda y: y * _LOG_10 + _pymath.log(_LOG_10), 1)
    reg((torch.exp2,), "exp2", torch.exp2, torch.log2,
        lambda y: -torch.log(y) - _pymath.log(_LOG_2), 1, valid=lambda y: y > 0)
    reg((torch.sqrt,), "sqrt", torch.sqrt, torch.square, lambda y: _LOG_2 + torch.log(y), 1,
        valid=lambda y: y >= 0)
    reg((pmm._cbrt,), "cbrt", pmm._cbrt, lambda y: y * y * y,
        lambda y: _LOG_3 + 2.0 * torch.log(torch.abs(y)), 1)
    reg((operator.neg, torch.neg, torch.negative), "negative", torch.neg, torch.neg,
        torch.zeros_like, -1)
    # the sign flips across 0, so the direction is undetermined: the density
    # is exact, the cdf family raises
    reg((torch.reciprocal,), "reciprocal", torch.reciprocal, torch.reciprocal,
        lambda y: -2.0 * torch.log(torch.abs(y)), None)
    reg((torch.sigmoid, torch.special.expit), "sigmoid", torch.sigmoid, pmm._logit,
        lambda y: -torch.log(y) - torch.log1p(-y), 1, valid=lambda y: (y > 0) & (y < 1),
        safe=0.5)
    reg((pmm._logit, torch.logit, torch.special.logit), "logit", pmm._logit, torch.sigmoid,
        logit_ljd, 1)
    reg((torch.special.ndtr,), "invprobit", torch.special.ndtr, torch.special.ndtri,
        lambda y: _HALF_LOG_PI + _LOG_2 / 2.0 + 0.5 * torch.special.ndtri(y) ** 2, 1,
        valid=lambda y: (y > 0) & (y < 1), safe=0.5)
    reg((torch.special.ndtri,), "probit", torch.special.ndtri, torch.special.ndtr,
        lambda y: -_HALF_LOG_PI - _LOG_2 / 2.0 - 0.5 * y**2, 1)
    reg((torch.sinh,), "sinh", torch.sinh, torch.asinh, lambda y: -0.5 * torch.log1p(y * y), 1)
    reg((torch.asinh, torch.arcsinh), "arcsinh", torch.asinh, torch.sinh,
        lambda y: torch.log(torch.cosh(y)), 1)
    reg((torch.tanh,), "tanh", torch.tanh, torch.atanh, lambda y: -torch.log1p(-y * y), 1,
        valid=lambda y: (y > -1.0) & (y < 1.0), safe=0.0)
    reg((torch.atanh, torch.arctanh), "arctanh", torch.atanh, torch.tanh,
        lambda y: torch.log1p(-torch.tanh(y) ** 2), 1)
    reg((torch.special.erf, torch.erf), "erf", torch.special.erf, torch.special.erfinv,
        lambda y: _HALF_LOG_PI - _LOG_2 + torch.special.erfinv(y) ** 2, 1,
        valid=lambda y: (y > -1.0) & (y < 1.0), safe=0.0)
    reg((torch.special.erfinv, torch.erfinv), "erfinv", torch.special.erfinv,
        torch.special.erf, lambda y: _LOG_2 - _HALF_LOG_PI - y**2, 1)
    # decreasing: logcdf(y) is the base's logccdf at erfcinv(y)
    reg((torch.special.erfc, torch.erfc), "erfc", torch.special.erfc, pmm._erfcinv,
        lambda y: _HALF_LOG_PI - _LOG_2 + pmm._erfcinv(y) ** 2, -1,
        valid=lambda y: (y > 0) & (y < 2.0), safe=1.0)
    # the images of the inverse trigonometric functions are their principal
    # branches
    reg((torch.asin, torch.arcsin), "arcsin", torch.asin, torch.sin,
        lambda y: torch.log(torch.cos(y)), 1, valid=lambda y: torch.abs(y) <= _HALF_PI,
        safe=0.0)
    reg((torch.acos, torch.arccos), "arccos", torch.acos, torch.cos,
        lambda y: torch.log(torch.sin(y)), -1, valid=lambda y: (y >= 0) & (y <= _pymath.pi),
        safe=_HALF_PI)
    reg((torch.atan, torch.arctan), "arctan", torch.atan, torch.tan,
        lambda y: -2.0 * torch.log(torch.abs(torch.cos(y))), 1,
        valid=lambda y: torch.abs(y) < _HALF_PI, safe=0.0)
    reg((torch.acosh, torch.arccosh), "arccosh", torch.acosh, torch.cosh,
        lambda y: torch.log(torch.sinh(y)), 1, valid=lambda y: y >= 0, safe=1.0)
    reg((dm.softplus,), "softplus", dm.softplus, lambda y: y - softplus_inv_ljd(y),
        softplus_inv_ljd, 1, valid=lambda y: y > 0)
    reg((pmm._erfcinv,), "erfcinv", pmm._erfcinv, torch.special.erfc,
        lambda y: _LOG_2 - _HALF_LOG_PI - y**2, -1)
    # a decreasing bijection of (-inf, 0) onto itself, its own inverse
    reg((dm.log1mexp,), "log1mexp", dm.log1mexp, dm.log1mexp,
        lambda y: y - dm.log1mexp(y), -1, valid=lambda y: y < 0, safe=-1.0)
    return table


# non-injective folds: two monotone branches, the density the sum over both
# pre-images (reference logprob/transforms.py AbsTransform, CoshTransform,
# PowerTransform's even powers)
_FOLDS = {torch.abs: "abs", torch.absolute: "abs", torch.square: "square", torch.cosh: "cosh"}

_NON_INVERTIBLE = {torch.sign: "sign", torch.sgn: "sign", torch.cos: "cos", torch.sin: "sin",
                   torch.tan: "tan"}


# --------------------------------------------------------------- binary ops
def _zeros(y, c):
    return torch.zeros(_bshape(y, c), dtype=y.dtype, device=y.device)


def _add_op(c, const_first):
    return _Op("add", lambda x, c: c + x, lambda y, c: y - c, _zeros, 1, const=c)


def _sub_op(c, const_first):
    if const_first:  # c - x
        return _Op("rsub", lambda x, c: c - x, lambda y, c: c - y, _zeros, -1, const=c)
    return _Op("sub", lambda x, c: x - c, lambda y, c: y + c, _zeros, 1, const=c)


def _mul_op(c, const_first):
    return _Op("mul", lambda x, c: c * x, lambda y, c: y / c,
               lambda y, c: torch.broadcast_to(-torch.log(torch.abs(_t(c, y))), _bshape(y, c)),
               _sign_of_const(c), const=c)


def _div_op(c, const_first):
    if const_first:  # c / x: the sign flips across 0, the direction is undetermined
        return _Op("rdiv", lambda x, c: c / x, lambda y, c: c / y,
                   lambda y, c: torch.log(torch.abs(_t(c, y))) - 2.0 * torch.log(torch.abs(y)),
                   None, const=c)
    return _Op("div", lambda x, c: x / c, lambda y, c: y * c,
               lambda y, c: torch.broadcast_to(torch.log(torch.abs(_t(c, y))), _bshape(y, c)),
               _sign_of_const(c), const=c)


def _pow_op(c, const_first):
    if const_first:  # c ** x
        base = _concrete(c)
        if base is None:
            # a symbolic base (a conditioned random variable): measurable
            # where it is positive and not 1 at run time, logp -inf
            # elsewhere; it is replaced by 2 inside the link, so that an
            # invalid base cannot turn the -inf into NaN
            def log_base(c, y):
                c = _t(c, y)
                return torch.log(torch.where((c > 0) & (c != 1.0), c, 2.0))

            return _Op("rpow", lambda x, c: torch.pow(c, x),
                       lambda y, c: torch.log(y) / log_base(c, y),
                       lambda y, c: -torch.log(y) - torch.log(torch.abs(log_base(c, y))),
                       None, const=c,
                       valid=lambda y, c: (y > 0) & (_t(c, y) > 0) & (_t(c, y) != 1.0))
        base = float(base)
        if base <= 0 or base == 1.0:
            raise TypeError(f"c**x is only measurable for constant c > 0, c != 1 (got {base})")
        return _Op("rpow", lambda x, c: torch.pow(_t(c, x), x),
                   lambda y, c: torch.log(y) / _pymath.log(base),
                   lambda y, c: -torch.log(y) - _pymath.log(abs(_pymath.log(base))),
                   1 if base > 1 else -1, const=c, valid=lambda y, c: y > 0)
    p = _concrete(c)
    if p is None:
        raise TypeError("exponent of a measurable x**p must be concrete")
    if p.ndim != 0:
        raise TypeError("exponent of a measurable x**p must be scalar")
    p = float(p)
    if p == 0:
        raise TypeError("x**0 is not an invertible transform")
    is_int = p.is_integer()
    if is_int and int(p) % 2 == 0:
        # dist_from_expression takes even powers as folds
        raise TypeError(f"x**{int(p)} (even power) is not invertible on the real line")
    if is_int:
        # an odd integer power: a bijection of R with a sign-preserving inverse
        def inverse(y, c):
            return torch.sign(y) * torch.abs(y) ** (1.0 / p)

        valid = None
    else:
        # a fractional power: its image is the non-negative half-line
        def inverse(y, c):
            return y ** (1.0 / p)

        valid = (lambda y, c: y > 0) if p < 0 else (lambda y, c: y >= 0)
    return _Op("pow", lambda x, c: x**p, inverse,
               lambda y, c: -_pymath.log(abs(p)) + (1.0 / p - 1.0) * torch.log(torch.abs(y)),
               1 if p > 0 else None, const=c, valid=valid)


def _odds_op():
    """t / (1 + t): the odds-to-probability map, with a pole at t = -1,
    so its direction is undetermined; the image is all of R but 1."""
    return _Op("odds", lambda x, c: x / (1.0 + x), lambda y, c: y / (1.0 - y),
               lambda y, c: -2.0 * torch.log(torch.abs(1.0 - y)), None,
               valid=lambda y, c: y != 1.0, safe=0.0)


_ADD = (operator.add, torch.add)
_DIV = (operator.truediv, torch.div, torch.divide, torch.true_divide)
_MUL = (operator.mul, torch.mul, torch.multiply)
_BINARY = {
    **{fn: _add_op for fn in _ADD},
    **{fn: _sub_op for fn in (operator.sub, torch.sub, torch.subtract)},
    **{fn: _mul_op for fn in _MUL},
    **{fn: _div_op for fn in _DIV},
    **{fn: _pow_op for fn in (operator.pow, torch.pow)},
}


def _match_odds_ratio(fn, num, den):
    """`t / (1 + t)` where numerator and denominator share the same node
    `t`: returns `t` where matched, else None."""
    if fn not in _DIV or not isinstance(den, DeterministicNode) or len(den.args) != 2:
        return None
    if den.fn not in _ADD:
        return None
    da, db = den.args
    for t, one in ((da, db), (db, da)):
        v = _concrete(one)
        if t is num and v is not None and v.ndim == 0 and float(v) == 1.0:
            return t
    return None


# ------------------------------------------------ non-overlapping switch
_SIGN_CONDS = {operator.gt: 1, operator.ge: 1, torch.gt: 1, torch.ge: 1, torch.greater: 1,
               torch.greater_equal: 1, operator.lt: -1, operator.le: -1, torch.lt: -1,
               torch.le: -1, torch.less: -1, torch.less_equal: -1}


def _branch_scale(branch, leaf):
    """The RV-free scale s of `branch == s * leaf` (1.0 where the branch is
    the leaf), or None where the branch does not have that form."""
    if branch is leaf:
        return 1.0
    if isinstance(branch, DeterministicNode) and len(branch.args) == 2:
        a, b = branch.args
        if branch.fn in _MUL:
            if a is leaf and _is_rv_free(b):
                return b
            if b is leaf and _is_rv_free(a):
                return a
        if branch.fn in _DIV and a is leaf and _is_rv_free(b):
            v = _concrete(b)  # leaf / c is (1 / c) * leaf
            if v is not None:
                return 1.0 / v
    return None


def _match_switch_scale(node):
    """`where(x > 0, s_pos * x, s_neg * x)` with positive RV-free scales: a
    piecewise-linear increasing bijection, the two half-lines mapped onto
    disjoint half-lines (reference logprob/transforms.py
    MeasurableSwitchNonOverlapping). Returns (op, leaf), or None."""
    if len(node.args) != 3:
        return None
    cond, a, b = node.args
    if not isinstance(cond, DeterministicNode) or len(cond.args) != 2:
        return None
    sign = _SIGN_CONDS.get(cond.fn)
    if sign is None:
        return None
    lhs, rhs = cond.args
    zero = _concrete(rhs)
    if not isinstance(lhs, (FreeRV, ObservedRV)) or zero is None or zero.ndim != 0 \
            or float(zero) != 0.0:
        return None
    leaf = lhs
    if sign < 0:  # x < 0 selects the first branch: swap to the sign order
        a, b = b, a
    s_pos, s_neg = _branch_scale(a, leaf), _branch_scale(b, leaf)
    if s_pos is None or s_neg is None:
        return None
    # the condition and scales must not broadcast x (injective per element)
    if tuple(node.shape) != tuple(leaf.shape):
        raise TypeError("measurable switch must not broadcast the base RV "
                        "(condition/scale shapes expand it)")
    for s in (s_pos, s_neg):
        v = _concrete(s)
        if v is not None and np.any(v <= 0):
            raise TypeError("switch non-overlapping scale > 0 is required for a measurable "
                            "piecewise transform")

    def ljd(y, c):
        def neg_log(s):
            s = _t(s, y)
            return torch.where(s > 0, -torch.log(torch.where(s > 0, s, 1.0)), -torch.inf)

        return torch.where(y > 0, neg_log(c[0]), neg_log(c[1]))

    op = _Op("switch_scale", lambda x, c: torch.where(x > 0, c[0] * x, c[1] * x),
             lambda y, c: torch.where(y > 0, y / c[0], y / c[1]), ljd, 1,
             const=(_as_const(s_pos), _as_const(s_neg)))
    op.continuous_only = True
    return op, leaf


def _reject_switch(node):
    """A `where` that is not the non-overlapping scale: the JAX package
    derives a component-selection mixture (ROADMAP item 6b) where a branch
    is random and the condition shares no random leaf with the branches'
    densities; it rejects every other switch."""
    if len(node.args) == 3:
        cond, t, f = node.args
        cond_ids = {id(r) for r in _rv_ancestors(cond)}
        branch_ids = {id(r) for br in (t, f) for r in _density_rv_ancestors(br)}
        if branch_ids and not cond_ids & branch_ids:
            raise NotImplementedError(f"the density of a switch mixture is {_ITEM_6B}, not "
                                      "ported to pymc_tpu_torch yet")
    raise TypeError(
        "switch(...) is only measurable as the non-overlapping form switch(x > 0, s_pos * x, "
        "s_neg * x) with positive RV-free scales, or as a component-selection mixture "
        "switch(cond, comp_true, comp_false) with an RV-free condition (reference logprob "
        "switch/mixture rewrites)")


# --------------------------------------------------- the structural forms
@functools.cache
def _structural_table():
    """{callable: form} of the port's callables whose nodes the JAX
    package's structural matchers derive (a `pm.math` closure carries a
    `graph.structural` tag instead); built at first use, as `_unary`."""
    from .. import math as pmm

    table = {fn: "a layout" for fn in (torch.reshape, torch.ravel, torch.permute, _squeeze,
                                       _reverse_axes)}
    table.update({fn: "a rounding" for fn in (torch.round, torch.floor, torch.ceil,
                                              torch.trunc)})
    # these pool mass or couple elements: no elementwise link may lie over them
    table.update({fn: "a censoring" for fn in (torch.clamp, torch.clip, torch.maximum,
                                               torch.minimum)})
    table.update({fn: "a matmul" for fn in (torch.matmul, operator.matmul, _dot, pmm._dot)})
    table.update({_cumsum: "a cumsum", _cast: "a cast", _tuple_index: "an index"})
    return table


def _structural_kind(node):
    """The structural form a node builds, or None."""
    fn = node.fn
    kind = getattr(fn, "_structural", None) or _structural_table().get(fn)
    if kind is None and fn is _reduce and node.kwargs.get("op") in ("sum", "max", "min"):
        kind = "a reduction"
    return kind


def _raise_structural(kind, under_ops):
    if under_ops and kind == "a censoring":
        raise TypeError(
            "censoring (clip/maximum/minimum) pools probability mass at the bounds; an "
            "elementwise transform OVER a censored expression has no derived density (the "
            "Jacobian does not apply at the atoms); censor outermost, or use pm.Censored "
            "explicitly")
    if under_ops and kind == "a matmul":
        raise TypeError("elementwise transforms OVER a matmul-coupled density are not "
                        "supported; apply the linear map outermost")
    if under_ops and kind == "a broadcast":
        raise TypeError(
            "broadcast_to(...) is only measurable when directly valued: the broadcast copies "
            "are degenerate, so a transform's Jacobian over them would be counted once per copy")
    raise NotImplementedError(f"the density of {kind} of random variables is {_ITEM_6B}, not "
                              "ported to pymc_tpu_torch yet")


# ----------------------------------------------------------- conditioning
# Named random variables listed here are resolved from the evaluation env
# at density time: constants of the derived density, as the reference's
# conditional_logp treats every other value-mapped variable (logprob/
# basic.py:206). `pm.logp(expr, v, env=...)` conditions on env's keys.
_CONDITIONED = [frozenset()]


class conditioned_on:
    """Context manager: the named random variables count as constants while
    an expression's density is derived."""

    def __init__(self, names):
        self.names = frozenset(names or ())

    def __enter__(self):
        self._prev = _CONDITIONED[0]
        _CONDITIONED[0] = self._prev | self.names
        return self

    def __exit__(self, *exc):
        _CONDITIONED[0] = self._prev
        return False


def _rv_ancestors(x):
    if not isinstance(x, Node):
        return []
    return [n for n in ancestors([x]) if isinstance(n, (FreeRV, ObservedRV))]


def _is_rv_free(x):
    """True where the operand adds no randomness: it has no random
    ancestor, or every one is conditioned on."""
    rvs = _rv_ancestors(x)
    if not rvs:
        return True
    cond = _CONDITIONED[0]
    return bool(cond) and all(getattr(r, "name", None) in cond for r in rvs)


def _density_rv_ancestors(x):
    """The random leaves reachable through density-bearing positions: a
    switch's condition and an index's index arrays are selectors, resolved
    from the env, and conditioned-on variables are constants."""
    out, seen, stack = [], set(), [x]
    cond = _CONDITIONED[0]
    while stack:
        n = stack.pop()
        if not isinstance(n, Node) or id(n) in seen:
            continue
        seen.add(id(n))
        if isinstance(n, (FreeRV, ObservedRV)):
            if getattr(n, "name", None) not in cond:
                out.append(n)
            continue
        args = list(getattr(n, "args", ()))
        fn = getattr(n, "fn", None)
        if fn is torch.where and len(args) == 3:
            args = args[1:]
        elif fn is _tuple_index or getattr(fn, "_structural", None) == "an index":
            args = args[:1]
        stack.extend(a for a in args if isinstance(a, Node))
    return out


def _inner_dist(x):
    """The distribution of an operand: a random variable's own, or that
    derived from a random expression."""
    if isinstance(x, (FreeRV, ObservedRV)):
        return x.dist
    if isinstance(x, Node):
        return dist_from_expression(x)
    raise TypeError("mass-pooling op needs a random operand")


# ---------------------------------------------------------------- the walk
def dist_from_expression(node):
    """The distribution of a random expression: a chain of invertible
    elementwise links over one random leaf (a `TransformedDistribution`),
    or a fold of one (a `FoldedDistribution`). Raises TypeError where the
    expression has no derived density, NotImplementedError for the
    structural forms of ROADMAP item 6b."""
    ops = []  # outer to inner
    current = node
    base = None
    while isinstance(current, DeterministicNode):
        fn = current.fn
        if fn is torch.where:
            matched = _match_switch_scale(current)
            if matched is None:
                _reject_switch(current)
            op, current = matched
            ops.append(op)
            continue
        kind = _structural_kind(current)
        if kind is not None:
            _raise_structural(kind, bool(ops))
        if fn in _FOLDS:
            args = [a for a in current.args if isinstance(a, Node)]
            if len(current.args) != 1 or len(args) != 1:
                raise TypeError(f"measurable {_FOLDS[fn]} must be unary")
            square = _FOLDS[fn] == "square"
            base = FoldedDistribution._make(_inner_dist(args[0]), "pow" if square else _FOLDS[fn],
                                            power=2.0 if square else None)
            break
        if fn in _NON_INVERTIBLE:
            raise TypeError(
                f"{_NON_INVERTIBLE[fn]}(...) is not invertible: no derived density. Use "
                "explicit combinators (Censored, Discretized, OrderStatistic, CustomDist) for "
                "non-bijective maps.")
        unary = _unary().get(fn)
        if unary is not None:
            args = [a for a in current.args if isinstance(a, Node)]
            if len(current.args) != 1 or len(args) != 1:
                raise TypeError(f"measurable {getattr(fn, '__name__', fn)} must be unary")
            ops.append(unary)
            current = args[0]
            continue
        if fn in _BINARY:
            if len(current.args) != 2:
                raise TypeError("measurable binary op must have 2 operands")
            a, b = current.args
            a_free, b_free = _is_rv_free(a), _is_rv_free(b)
            if a_free == b_free:
                # t / (1 + t) with a shared t
                shared = _match_odds_ratio(fn, a, b)
                if shared is None:
                    raise TypeError(
                        "measurable binary op needs exactly one random operand (expressions "
                        "mixing two RVs have no derived density here)")
                ops.append(_odds_op())
                current = shared
                continue
            const, rv_side, const_first = (a, b, True) if a_free else (b, a, False)
            if fn in (operator.pow, torch.pow) and not const_first:
                p = _concrete(const)
                if p is not None and p.ndim == 0 and float(p) != 0 \
                        and float(p).is_integer() and int(p) % 2 == 0:
                    # an even power: the two-branch folded density
                    base = FoldedDistribution._make(_inner_dist(rv_side), "pow", power=float(p))
                    break
            ops.append(_BINARY[fn](_as_const(const), const_first))
            current = rv_side
            continue
        raise TypeError(f"no derived density for op {getattr(fn, '__name__', fn)!r}")
    if base is None:
        if not isinstance(current, (FreeRV, ObservedRV)):
            raise TypeError(f"measurable-transform chain must terminate at a random variable, "
                            f"found {type(current).__name__}")
        if not ops:
            raise TypeError("expression is the bare RV; use its distribution")
        base = current.dist
    elif not ops:
        return base
    return TransformedDistribution._make(base, ops)


# ----------------------------------------------------------- distributions
def _derived(cls, base, batch_shape, event_shape):
    """A distribution over `base` built without its class's `dist`."""
    obj = object.__new__(cls)
    obj._shape_arg = None
    obj._size_arg = None
    obj.base = base
    obj.batch_shape = tuple(batch_shape)
    obj.event_shape = tuple(event_shape)
    obj.event_ndim = len(obj.event_shape)
    obj.shape = obj.batch_shape + obj.event_shape
    return obj


class FoldedDistribution(Distribution):
    """A non-injective elementwise map with two monotone branches +-b(y):
    `abs(x)`, an even power `x**p` and `cosh(x)` (reference logprob/
    transforms.py AbsTransform, PowerTransform, CoshTransform). The density
    is the sum over the two pre-images; the cdf family raises, as the
    reference's does."""

    param_names = ()

    @classmethod
    def _make(cls, base, kind, power=None):
        if base.is_discrete:
            raise TypeError(f"measurable {kind} of a discrete variable is not supported (the "
                            "branch densities double-count the fold point)")
        if len(base.event_shape):
            raise TypeError(f"measurable {kind} of a multivariate distribution folds 2**d sign "
                            "combinations per event: no derived density")
        obj = _derived(cls, base, base.shape, ())
        obj.kind = kind
        obj._power = None if power is None else float(power)
        return obj

    def inputs(self):
        return self.base.inputs()

    def _forward(self, x):
        if self.kind == "abs":
            return torch.abs(x)
        if self.kind == "cosh":
            return torch.cosh(x)
        return x**self._power

    def _fold(self, y):
        """(in-image mask, the positive pre-image at the clamped value, the
        log-Jacobian)."""
        if self.kind == "abs":
            m = y >= 0
            ys = torch.where(m, y, 1.0)
            return m, ys, torch.zeros_like(ys)
        if self.kind == "cosh":
            m = y >= 1.0
            ys = torch.where(m, y, 2.0)
            return m, torch.acosh(ys), -0.5 * torch.log(ys * ys - 1.0)
        p = self._power
        m = (y > 0) if p < 0 else (y >= 0)
        ys = torch.where(m, y, 1.0)
        ljd = -_pymath.log(abs(p)) + (1.0 / p - 1.0) * torch.log(ys)
        return m, ys ** (1.0 / p), ljd

    def logp(self, value, env=None, memo=None):
        memo = {} if memo is None else memo
        m, xp, ljd = self._fold(_as_value(value))
        lp = torch.logaddexp(self.base.logp(-xp, env, memo), self.base.logp(xp, env, memo)) + ljd
        lp = torch.where(m, lp, -torch.inf)
        return torch.broadcast_to(lp, torch.broadcast_shapes(lp.shape, self.batch_shape))

    def logcdf(self, value, env=None, memo=None):
        raise NotImplementedError(f"logcdf of a folded ({self.kind}) transform is not "
                                  "implemented")

    logccdf = logcdf

    def icdf(self, q, env=None, memo=None):
        raise NotImplementedError(f"icdf of a folded ({self.kind}) transform is not implemented")

    def sample(self, generator, sample_shape=(), env=None, memo=None):
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        x = self._forward(self.base.sample(generator, sample_shape, env, memo))
        return torch.broadcast_to(x, tuple(sample_shape) + self.shape)

    def support_point(self, env=None, memo=None):
        return torch.broadcast_to(self._forward(self.base.support_point(env, memo)), self.shape)


class TransformedDistribution(Distribution):
    """A chain of invertible elementwise links over a base distribution.

    `ops` run outer to inner: the value walks them forward through each
    link's inverse down to the base's space; a draw walks them backward
    through each forward map.
    """

    param_names = ()

    @classmethod
    def _make(cls, base, ops):
        if base.is_discrete and any(op.continuous_only for op in ops):
            raise TypeError("measurable switch applies to continuous RVs only (reference "
                            "logprob switch rewrite rejects discrete bases)")
        shapes = [base.shape]
        for op in ops:
            consts = op.const if isinstance(op.const, tuple) else (op.const,)
            shapes += [tuple(c.shape) for c in consts if isinstance(c, Node)]
        full = tuple(np.broadcast_shapes(*shapes))
        # the links are elementwise: the event structure is the base's
        ev = len(base.event_shape)
        obj = _derived(cls, base, full[: len(full) - ev], base.event_shape)
        obj.ops = list(ops)
        obj.is_discrete = bool(base.is_discrete)
        return obj

    def inputs(self):
        """The base's inputs and the links' Node constants (never the random
        leaf: that is the value itself)."""
        return self.base.inputs() + [c for op in self.ops for c in op.consts()]

    @property
    def _event_axes(self):
        ev = len(self.event_shape)
        return tuple(range(-ev, 0)) if ev else ()

    def _to_base(self, value, env, memo, sides=False):
        """(the value in the base's space, the summed log |d inverse / dy|,
        and with `sides` where the value lies against the chain's image: -1
        below, +1 above, 0 inside, None where every link's image is all of
        R; `sides` needs every link's direction)."""
        x, acc, side, direction = value, 0.0, None, 1
        for op in self.ops:
            x_next, ljd, m = op.pull(x, env, memo)
            if sides and m is not None:
                # the links walked so far map this link's side onto the value's
                s = op.side(x, m) * direction
                side = s if side is None else torch.where(side != 0, side, s)
            acc = acc + ljd
            x = x_next
            direction = direction * (op.monotone or 0)
        return x, acc, side

    def _direction(self):
        s = 1
        for op in self.ops:
            if op.monotone is None:
                raise NotImplementedError(
                    f"cdf-family of a transformed RV needs a determinate monotone direction; "
                    f"op {op.name!r} is sign-ambiguous")
            s *= op.monotone
        return s

    def _bcast_density(self, out):
        """A density broadcast with the batch shape (densities are
        event-reduced), the value's own shape kept."""
        return torch.broadcast_to(out, torch.broadcast_shapes(out.shape, self.batch_shape))

    def logp(self, value, env=None, memo=None):
        memo = {} if memo is None else memo
        x, ljd, _ = self._to_base(_as_value(value), env, memo)
        ax = self._event_axes
        if self.is_discrete:
            # the counting measure: the inverse must land on the integer lattice
            xr = torch.round(x)
            rtol = 1e-6 if x.dtype == torch.float32 else 0.0
            on_lattice = torch.isclose(x, xr, rtol=rtol, atol=1e-6)
            if ax:
                on_lattice = on_lattice.all(dim=ax)
            return self._bcast_density(
                torch.where(on_lattice, self.base.logp(xr, env, memo), -torch.inf))
        lp = self.base.logp(x, env, memo)
        if ax:
            # the base's logp is event-reduced: so is the Jacobian
            ljd = torch.broadcast_to(ljd, x.shape).sum(dim=ax)
        return self._bcast_density(lp + ljd)

    def _cdf(self, value, env, memo, upper):
        """logcdf (upper False) or logccdf (upper True): -inf or 0 outside
        the chain's image, by the side it lies on."""
        memo = {} if memo is None else memo
        s = self._direction()
        x, _, side = self._to_base(_as_value(value), env, memo, sides=True)
        if s < 0 and self.is_discrete:
            raise NotImplementedError(f"{'logccdf' if upper else 'logcdf'} of a decreasing "
                                      "transform of a discrete RV")
        base_upper = upper if s > 0 else not upper
        out = (self.base.logccdf if base_upper else self.base.logcdf)(x, env, memo)
        if side is not None and not self._event_axes:
            below, above = (0.0, -torch.inf) if upper else (-torch.inf, 0.0)
            out = torch.where(side < 0, below, torch.where(side > 0, above, out))
        return self._bcast_density(out)

    def logcdf(self, value, env=None, memo=None):
        return self._cdf(value, env, memo, upper=False)

    def logccdf(self, value, env=None, memo=None):
        return self._cdf(value, env, memo, upper=True)

    def icdf(self, q, env=None, memo=None):
        memo = {} if memo is None else memo
        s = self._direction()
        q = _as_value(q)
        x = _as_float(self.base.icdf(q if s > 0 else 1.0 - q, env, memo))
        for op in reversed(self.ops):
            x = op.forward(x, env, memo)
        return torch.broadcast_to(x, torch.broadcast_shapes(x.shape, self.shape))

    def sample(self, generator, sample_shape=(), env=None, memo=None):
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        x = _as_float(self.base.sample(generator, sample_shape, env, memo))
        for op in reversed(self.ops):
            x = op.forward(x, env, memo)
        return torch.broadcast_to(x, tuple(sample_shape) + self.shape)

    def support_point(self, env=None, memo=None):
        x = _as_float(self.base.support_point(env, memo))
        for op in reversed(self.ops):
            x = op.forward(x, env, memo)
        return torch.broadcast_to(x, self.shape)
