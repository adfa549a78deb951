"""Derived densities of random expressions: the logprob engine.

Counterpart of `pymc_tpu/distributions/transformed.py` (reference
pymc/logprob: the measurable transforms of exp, log, add, mul, div, pow,
sqrt, cbrt, reciprocal, the hyperbolic family, sigmoid, logit, erf,
transforms.py; censoring.py, tensor.py, cumsum.py, mixture.py, order.py,
arithmetic.py, linalg.py; basic.py:105 `pm.logp` of an expression).
`dist_from_expression` walks an expression (`DeterministicNode(fn, args)`
with a known `fn`) down to its random leaves, a FreeRV or ObservedRV (an
unnamed `.dist()` lifts to an anonymous one, `Distribution.to_node`).

A chain of invertible elementwise links over one random leaf, every other
operand free of randomness, is a `TransformedDistribution` with the
change-of-variables density

    logp_Y(y) = logp_X(g^-1(y)) + log |d g^-1 / dy|     (continuous base)
    logp_Y(y) = logp_X(g^-1(y))                         (discrete base)

logcdf/logccdf/icdf follow where every link has a determinate direction.
The non-injective folds abs, even powers and cosh give a
`FoldedDistribution` (the density only), and `where(x > 0, s x, t x)` with
positive scales is one more increasing link.

The structural forms build the base a chain may lie over: clip, maximum
and minimum censor (`Censored`); round, floor, ceil, trunc and a float to
int cast discretize (`Discretized`); a cast relabels (`_DtypeView`);
`broadcast_to`, the layouts, stack/concatenate, cumsum, basic indexing and
a random index into a stack, a switch between random branches, argmax/
argmin of a Gumbel, Exponential or Weibull race, sums of Normals, max/min
of iid variables and `A @ x` give the distributions below. The port's
nodes carry no measurability markers: a form is known by its callable and
read from its node's kwargs, or by the `graph.structural` tag and the
parameters a `pm.math` closure carries. Forms that the JAX package rejects
raise TypeError here too.

Against the JAX package, a value outside the image of the chain gets
log F = -inf and log S = 0 below the image (log F = 0 and log S = -inf
above it); the JAX package evaluates the cdfs at a clamped in-image point
instead (ROADMAP §3). The odds ratio t / (1 + t) has an image guard (y != 1)
that the JAX package lacks. `x.cumsum()` of a Node derives as
`pm.math.cumsum(x)` does (PyMC's semantics), where the JAX package's
unmarked `Node.cumsum` raises.

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
    ConstantNode, DeterministicNode, FreeRV, Node, ObservedRV, _axes, _cast, _cumsum, _dot,
    _reduce, _reverse_axes, _squeeze, _tuple_index, ancestors, apply, as_node, evaluate,
)
from .distribution import DiracDelta, Distribution

__all__ = ["TransformedDistribution", "FoldedDistribution", "dist_from_expression",
           "conditioned_on", "StackedDistribution", "LayoutDistribution",
           "BroadcastDistribution", "SelectionDistribution", "MixtureSelectionDistribution",
           "SwitchMixtureDistribution", "MatMulDistribution"]


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


# --------------------------------------------------- the structural forms
_ROUNDING = {torch.round: "round", torch.floor: "floor", torch.ceil: "ceil", torch.trunc: "trunc"}
# these pool mass at the bounds: no elementwise link may lie over them
_CENSORING = (torch.clamp, torch.clip, torch.maximum, torch.minimum)
_RESHAPE = ("reshape", None)


@functools.cache
def _kwarg_forms():
    """{callable: (form, its parameters from the node's kwargs)} of the
    port's callables whose nodes the structural matchers derive (a `pm.math`
    closure carries its form and parameters in its `graph.structural` tag
    instead); built at first use, as `_unary`."""
    from .. import math as pmm

    def reshape(kw):
        return {"layout": _RESHAPE}

    table = {fn: ("a layout", reshape) for fn in (torch.reshape, torch.ravel, _squeeze)}
    table[torch.permute] = ("a layout", lambda kw: {"layout": ("transpose", tuple(kw["dims"]))})
    table[_reverse_axes] = ("a layout", lambda kw: {"layout": ("transpose", None)})
    table[_cumsum] = ("a cumsum", lambda kw: {"axis": kw.get("axis")})
    table[_cast] = ("a cast", lambda kw: {"dtype": kw["dtype"]})
    # a tuple index with arrays in it: no marginal
    table[_tuple_index] = ("an index", lambda kw: {"index": None})
    for fn, method in _ROUNDING.items():
        table[fn] = ("a rounding", lambda kw, m=method: {"method": m})
    for fn in _CENSORING:
        table[fn] = ("a censoring", lambda kw: {})
    for fn in (torch.matmul, operator.matmul, _dot, pmm._dot):
        table[fn] = ("a matmul", lambda kw: {})
    return table


def _form(node):
    """(the structural form a node builds, its parameters), or (None,
    None): the tag of a `pm.math` closure, else the node's callable and
    kwargs (the JAX package's `_measurable_*` markers)."""
    fn = node.fn
    kind = getattr(fn, "_structural", None)
    if kind is not None:
        return kind, fn._structural_params
    if fn is _reduce:
        kw = node.kwargs
        if kw.get("op") in ("sum", "max", "min"):
            return "a reduction", {"op": kw["op"], "axis": kw.get("axis"),
                                   "keepdims": kw.get("keepdims", False)}
        return None, None
    entry = _kwarg_forms().get(fn)
    if entry is None:
        return None, None
    return entry[0], entry[1](node.kwargs)


def _join_of(x):
    """(kind, axis) where `x` is a stack or concatenate node, else None."""
    if not isinstance(x, DeterministicNode):
        return None
    kind, params = _form(x)
    return params["join"] if kind == "a join" else None


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


def _shape(x):
    """The static shape of an operand (a Node's, or a concrete value's)."""
    return tuple(int(s) for s in (x.shape if isinstance(x, (Node, torch.Tensor)) else np.shape(x)))


def _one_random(node, what):
    """The node's one Node operand; TypeError for any other number."""
    args = [a for a in node.args if isinstance(a, Node)]
    if len(node.args) != 1 or len(args) != 1:
        raise TypeError(f"measurable {what} must be unary")
    return args[0]


# --------------------------------------------------------------- matmul
def _match_matmul(node):
    """`A @ x` or `x @ A` with a square RV-free matrix A: the linear change
    of variables (reference logprob/linalg.py:24 MeasurableMatMul). The
    Jacobian is k log|det A| for the k columns (rows) of a matrix-valued x
    that A transforms, as the JAX package has it (pymc_tpu/distributions/
    transformed.py:620-627), not the reference's single slogdet."""
    if len(node.args) != 2:
        raise TypeError("measurable matmul needs two operands")
    lhs, rhs = node.args
    l_rand, r_rand = bool(_rv_ancestors(lhs)), bool(_rv_ancestors(rhs))
    if l_rand == r_rand:
        raise TypeError("measurable matmul needs exactly one random operand (products of two RVs "
                        "have no derived density)")
    rv_op, A = (rhs, lhs) if r_rand else (lhs, rhs)
    a_shape = _shape(A)
    if len(a_shape) < 2 or a_shape[-1] != a_shape[-2]:
        raise TypeError("measurable matmul requires a square matrix operand: a non-square map "
                        "loses or adds dimensions (no density)")
    rv_shape = _shape(rv_op)
    if len(rv_shape) < 1:
        raise TypeError("measurable matmul needs a vector or matrix RV")
    core = 1 if len(rv_shape) == 1 else 2
    out_shape = _shape(node)
    # a broadcast random operand would reuse one draw across the batch
    if rv_shape[:-core] != out_shape[: len(out_shape) - core]:
        raise TypeError("measurable matmul must not broadcast the random operand across batch "
                        "dimensions (broadcast draws are dependent)")
    base = _inner_dist(rv_op)
    if base.is_discrete:
        raise TypeError("matmul of a discrete RV has no derived density (the linear map does "
                        "not preserve the lattice)")
    return MatMulDistribution._make(base, _as_const(A), r_rand, core, out_shape)


# ------------------------------------------------------ switch mixture
def _match_switch_mixture(node):
    """`where(cond, comp_true, comp_false)` with at least one random branch:
    the elementwise component-selection mixture (reference logprob/
    mixture.py:383 MeasurableSwitchMixture; :459 MeasurableIfElse for a
    random condition, the density then conditional on the condition's value
    from the env). A deterministic branch is a point mass; a random
    component must not be broadcast by the condition. None where the form
    does not apply."""
    if len(node.args) != 3:
        return None
    cond, t, f = node.args
    cond_rvs = _rv_ancestors(cond)
    if cond_rvs:
        # a random condition must share no randomness with the branches'
        # density-bearing leaves (random variables in their selector slots
        # resolve from the env and do not couple)
        branch_ids = {id(r) for br in (t, f) for r in _density_rv_ancestors(br)}
        if any(id(r) in branch_ids for r in cond_rvs):
            return None
    out_shape = _shape(node)
    comps, n_random = [], 0
    for br in (t, f):
        if isinstance(br, Node) and _density_rv_ancestors(br):
            d = _inner_dist(br)
            if d.event_ndim != 0:
                raise TypeError("switch mixtures select elementwise; multivariate components are "
                                "not measurable here")
            if tuple(d.shape) != out_shape:
                raise TypeError(
                    "switch mixture must not broadcast a random component: broadcast draws are "
                    "identical (dependent), so the product density does not apply (reference "
                    "rejects component broadcast)")
            n_random += 1
            comps.append(d)
        else:
            comps.append(DiracDelta.dist(br))
    if n_random == 0:
        return None
    return SwitchMixtureDistribution._make(cond, comps[0], comps[1], out_shape,
                                           has_atoms=n_random < 2)


# ------------------------------------------------- censoring and rounding
def _resolve_censor_bound(b, rv_operand, side):
    """One bound of clip/maximum/minimum: None for the unbounded idioms (the
    censored operand itself, `clip(x, x, hi)`, or an infinite constant on
    its side), else the bound. A bound may be another random expression,
    evaluated from the env, but not one of the censored leaf."""
    if b is rv_operand:
        return None
    v = _concrete(b)
    if v is not None:
        if v.ndim == 0 and np.isinf(v) and (side == "lower") == bool(v < 0):
            return None
        return _as_const(b)
    leaf_ids = {id(r) for r in _rv_ancestors(rv_operand)}
    if any(id(r) in leaf_ids for r in _rv_ancestors(b)):
        raise TypeError("censoring bound depends on the censored variable itself: no derived "
                        "density")
    return b


def _acc_bound(old, new, combine):
    """Nested bounds fuse by maximum (lower) or minimum (upper) (reference
    find_measurable_clips)."""
    if new is None:
        return old
    if old is None:
        return new
    return apply(combine, as_node(old), as_node(new))


def _match_censoring(node):
    """A chain of clip / maximum / minimum over one random sub-expression:
    Censored (reference logprob/censoring.py:86 MeasurableClip and the
    max/min censoring)."""
    from .censored import Censored

    lower = upper = None
    current = node
    while isinstance(current, DeterministicNode) and current.fn in _CENSORING:
        fn = current.fn
        if fn in (torch.clamp, torch.clip):
            if len(current.args) != 3:
                raise TypeError("measurable clip must be clip(x, lower, upper)")
            x, lo, hi = current.args
            if _is_rv_free(x):
                raise TypeError("clip(x, ...) needs a random first operand")
            lower = _acc_bound(lower, _resolve_censor_bound(lo, x, "lower"), torch.maximum)
            upper = _acc_bound(upper, _resolve_censor_bound(hi, x, "upper"), torch.minimum)
            current = x
            continue
        if len(current.args) != 2:
            raise TypeError("measurable maximum/minimum must be binary")
        a, b = current.args
        a_free, b_free = _is_rv_free(a), _is_rv_free(b)
        if a_free == b_free:
            raise TypeError("maximum/minimum of two random expressions is not censoring: no "
                            "derived density (use OrderStatistic for iid order statistics)")
        const, rv_side = (a, b) if a_free else (b, a)
        if fn is torch.maximum:
            lower = _acc_bound(lower, _resolve_censor_bound(const, rv_side, "lower"),
                               torch.maximum)
        else:
            upper = _acc_bound(upper, _resolve_censor_bound(const, rv_side, "upper"),
                               torch.minimum)
        current = rv_side
    base = _inner_dist(current)
    if lower is None and upper is None:
        # clip(x, x, x): the useless clip, the base's own density
        return base
    return Censored.dist(base, lower=lower, upper=upper)


def _match_rounding(node, method):
    """round/floor/ceil/trunc of a continuous random expression: Discretized
    (reference logprob/censoring.py:343 round_logprob)."""
    from .censored import Censored
    from .derived import Discretized

    base = _inner_dist(_one_random(node, method))
    if isinstance(base, Censored):
        # the point masses at the bounds would lose their cells' atoms
        raise TypeError(f"{method}(...) of a censored expression is not measurable: the point "
                        "masses at the censoring bounds are not a density")
    if base.is_discrete:
        # rounding an integer-supported variable is the identity
        return base
    return Discretized.dist(base, method=method)


# ------------------------------------------------------------------ casts
def _kind_order(dtype):
    """The order of numpy's dtype kinds that a cast may widen along: bool 0,
    integer 1, float 2; None for a complex type."""
    if dtype == torch.bool:
        return 0
    if dtype.is_complex:
        return None
    return 2 if dtype.is_floating_point else 1


def _signed_int(dtype):
    return _kind_order(dtype) == 1 and torch.iinfo(dtype).min < 0


def _match_cast(node, out_dtype, has_outer_ops):
    """`x.astype(dtype)` of a random expression (reference logprob/
    tensor.py:468-530 find_measurable_casts): None where the cast keeps the
    measure and is transparent in the chain (the same or a wider kind in
    the middle of a chain), a distribution where it resolves to one (an
    outermost relabel; a float-to-int cast truncates), TypeError where it
    is not measurable."""
    from .censored import Censored
    from .derived import Discretized

    inner = _one_random(node, "cast")
    in_dt, out_dt = inner.dtype, out_dtype
    ik, ok = _kind_order(in_dt), _kind_order(out_dt)
    if ik is None or ok is None:
        raise TypeError(f"no derived density for a cast from {in_dt} to {out_dt}")
    if ok < ik:
        if in_dt.is_floating_point and _signed_int(out_dt):
            # float -> signed int rounds toward zero: a trunc and a relabel
            base = _inner_dist(inner)
            if isinstance(base, Censored):
                raise TypeError("int-cast (truncation) of a censored expression is not "
                                "measurable: the point masses at the censoring bounds are not "
                                "a density")
            return base if base.is_discrete else Discretized.dist(base, method="trunc")
        raise TypeError("cast discretizes the base variable without truncating it (unsigned "
                        "ints wrap negative values; bool collapses the support onto two "
                        "points): no derived density (reference find_measurable_casts)")
    if ik < ok == 2 and has_outer_ops:
        # a float view of a discrete variable would hide its discreteness
        # from the links over it, which would apply a continuous Jacobian
        raise TypeError("float cast of a discrete variable hides its discreteness from the "
                        "transform chain: only a directly-valued cast is measurable (reference "
                        "find_measurable_casts)")
    if has_outer_ops:
        return None
    return _DtypeView._make(_inner_dist(inner), out_dt)


# ---------------------------------------------------- broadcast and layout
def _match_broadcast(node):
    """`broadcast_to(x, shape)` of a random expression, directly valued
    (reference logprob/tensor.py:363-466 MeasurableBroadcast)."""
    rand = [a for a in node.args if _rv_ancestors(a)]
    if len(rand) != 1:
        raise TypeError("measurable broadcast_to needs exactly one random operand (the target "
                        "shape must be RV-free)")
    x = rand[0]
    return BroadcastDistribution._make(_inner_dist(x), _shape(x), _shape(node))


def _permutation(kind, ax, n):
    """The axis order of a transpose, swapaxes or moveaxis over n axes."""
    if kind == "transpose":
        return tuple(reversed(range(n))) if ax is None else tuple(a % n for a in ax)
    if kind == "swapaxes":
        perm = list(range(n))
        a, b = ax[0] % n, ax[1] % n
        perm[a], perm[b] = perm[b], perm[a]
        return tuple(perm)
    src, dst = ax
    src = (src,) if np.isscalar(src) else tuple(src)
    dst = (dst,) if np.isscalar(dst) else tuple(dst)
    perm = [a for a in range(n) if a not in {s % n for s in src}]
    for d, s in sorted(zip((d % n for d in dst), (s % n for s in src))):
        perm.insert(d, s)
    return tuple(perm)


def _permuter(axes, n):
    """arr with its last n axes in the order `axes`, the leading ones kept."""
    def permute(arr):
        lead = arr.ndim - n
        return arr.permute(tuple(range(lead)) + tuple(lead + a for a in axes))

    return permute


def _reshaper(in_ndim, out_shape):
    """arr with its last in_ndim axes reshaped to `out_shape`."""
    def reshape(arr):
        return arr.reshape(tuple(arr.shape[: arr.ndim - in_ndim]) + tuple(out_shape))

    return reshape


def _match_layout(node, layout):
    """transpose / reshape / ravel / squeeze / expand_dims / swapaxes /
    moveaxis of a random expression (reference logprob/tensor.py:255
    MeasurableDimShuffle): a bijection of the index set, so the density
    rides the same re-indexing with no Jacobian."""
    args = [a for a in node.args if isinstance(a, Node)]
    if len(args) != 1:
        raise TypeError("measurable layout op must have one random operand")
    x = args[0]
    in_shape, out_shape = _shape(x), _shape(node)
    kind, ax = layout
    base = _inner_dist(x)
    ev = int(base.event_ndim or 0)
    n = len(in_shape)
    requires_direct = False
    if kind != "reshape":
        axes = _permutation(kind, ax, n)
        fwd, inv = _permuter(axes, n), _permuter(tuple(int(i) for i in np.argsort(axes)), n)
        dfwd = fwd
        if ev:
            # the value is un-permuted whole before the base's logp, which
            # reduces the event block: the density re-applies the batch part
            # of the order only; a permutation that moves the event block
            # off the trailing axes is measurable only when directly valued
            dfwd = _permuter(tuple(a for a in axes if a < n - ev), n - ev)
            requires_direct = set(axes[n - ev:]) != set(range(n - ev, n))
    else:
        if int(np.prod(in_shape)) != int(np.prod(out_shape)):
            raise TypeError("layout reshape must preserve the element count")
        fwd, inv = _reshaper(n, out_shape), _reshaper(len(out_shape), in_shape)
        dfwd = fwd
        if ev:
            if n < ev or len(out_shape) < ev or \
                    in_shape[n - ev:] != out_shape[len(out_shape) - ev:]:
                raise TypeError(
                    "reshape across the event block of a multivariate distribution has no "
                    "derived density (the event layout is consumed by the base logp): reshape "
                    "batch dimensions only")
            dfwd = _reshaper(n - ev, out_shape[: len(out_shape) - ev])
    return LayoutDistribution._make(base, fwd, inv, out_shape, dfwd=dfwd, event_k=ev,
                                    requires_direct=requires_direct)


# ----------------------------------------------------------------- cumsum
def _match_cumsum(node, axis):
    """cumsum of a random expression: CumSum, the map unit lower triangular
    (reference logprob/cumsum.py:53-106). axis None is measurable only for
    a 1-d operand: flattening first mixes dimensions."""
    x = _one_random(node, "cumsum")
    if axis is None:
        if len(_shape(x)) != 1:
            raise TypeError("cumsum over a flattened multi-dimensional expression mixes "
                            "dimensions: no derived density (reference logprob/cumsum.py "
                            "find_measurable_cumsums)")
        axis = 0
    base = _inner_dist(x)
    if base.event_ndim != 0:
        raise TypeError("cumsum over a multivariate distribution would mix event dimensions: "
                        "no derived density")
    from .derived import CumSum

    return CumSum.dist(base, axis=int(axis))


# --------------------------------------------------------------- indexing
def _match_index(node, marker):
    """Basic (int and slice) indexing of independent components: the
    marginal of the selected ones (dropping components marginalizes them);
    a random index: `_match_index_mixture`."""
    if marker is None:
        return _match_index_mixture(node)
    (idx,) = marker
    idx_t = idx if isinstance(idx, tuple) else (idx,)
    for i in idx_t:
        if not isinstance(i, (int, np.integer, slice)):
            raise TypeError("measurable indexing supports ints and slices only: advanced indices "
                            "can replicate components, whose joint density is degenerate")
    args = [a for a in node.args if isinstance(a, Node)]
    if len(args) != 1:
        raise TypeError("measurable indexing needs one random operand")
    base = _inner_dist(args[0])
    if base.event_ndim != 0:
        raise TypeError("indexing into a multivariate event has no independent marginal here "
                        "(use the distribution's own marginalization)")
    if isinstance(base, StackedDistribution):
        raise TypeError("indexing a join of interdependent components has no product marginal; "
                        "index the components before joining")
    return SelectionDistribution._make(base, idx_t, _shape(node))


def _match_index_mixture(node):
    """`stack(comps)[I]` or `x[I]` with a random scalar integer index I: the
    component-selection mixture, its density conditional on I's value from
    the env as a model's logp conditions on its values (reference logprob/
    mixture.py:262 find_measurable_index_mixture, :309 logprob_MixtureRV;
    an integer array index could pick one component twice, and is rejected
    there too)."""
    base_arg = node.args[0]
    n_index = len(node.kwargs["index"]) if node.fn is _tuple_index else len(node.args) - 1
    if n_index != 1:
        raise TypeError("random-index selection supports a single scalar index only (reference "
                        "mixture logprob rejects multi-axis random indexing)")
    idx = node.args[1]
    if not (isinstance(idx, Node) and _rv_ancestors(idx)):
        raise TypeError("random-index selection needs a random index")
    if tuple(idx.shape) != ():
        raise TypeError(
            "a non-scalar random index can select the same component more than once: repeated "
            "selections are perfectly dependent, so the product density does not apply "
            "(reference find_measurable_index_mixture rejects integer-array indices); use "
            "pm.Mixture for marginal mixture semantics")
    if _kind_order(idx.dtype) != 1:
        raise TypeError("mixture index must be an integer-valued (discrete) RV")
    comp_ids = {id(r) for r in _density_rv_ancestors(base_arg)}
    if any(id(r) in comp_ids for r in _rv_ancestors(idx)):
        raise TypeError("the mixture index must not share randomness with the components' "
                        "density-bearing leaves: conditioning on the index value would fix "
                        "part of the measured variable itself")
    out_shape = _shape(node)
    join = _join_of(base_arg)
    if join is not None:
        kind, axis = join
        if kind != "stack" or axis % (len(out_shape) + 1) != 0:
            raise TypeError("random-index mixtures select whole components along the leading "
                            "stack axis; concatenations interleave components within the axis "
                            "(use pm.Mixture)")
        # an RV-free slot is a point mass
        comps = [_inner_dist(c) if isinstance(c, Node) and _density_rv_ancestors(c)
                 else DiracDelta.dist(c) for c in base_arg.args]
    else:
        base = _inner_dist(base_arg)
        if base.event_ndim != 0:
            raise TypeError("random-index selection into a multivariate event has no "
                            "independent component density")
        if isinstance(base, StackedDistribution):
            raise TypeError("random-index selection from a join of interdependent components "
                            "is not measurable; stack independent components instead")
        comps = [SelectionDistribution._make(base, (k,), out_shape)
                 for k in range(int(base_arg.shape[0]))]
    return MixtureSelectionDistribution._make(comps, idx, out_shape)


# ------------------------------------------------------- argmax / argmin
def _match_argext(node, kind, axis):
    """argmax/argmin of a race with a closed-form winner: Categorical
    (reference logprob/order.py:256 categorical_from_argmax):

        argmax(Gumbel(mu, beta))      -> Cat(softmax(mu / beta))
        argmin(Exponential(lam))      -> Cat(lam / sum lam)
        argmin(Weibull(alpha, beta))  -> Cat(beta^-alpha / sum beta^-alpha)

    Loc/scale lifts `a + b * rv` (RV-free a, b) fold into the parameters;
    the Gumbel scale and the Weibull shape must be constant across the race
    axes."""
    from .continuous import Exponential, Gumbel, Weibull
    from .discrete import Categorical

    current = _one_random(node, f"arg{kind}")
    shift, scale = 0.0, 1.0
    # walking outer to inner through y = shift + scale * (...): an inner
    # add A folds as shift += scale * A, an inner mul A as scale *= A
    while isinstance(current, DeterministicNode):
        fn = current.fn
        if not ((fn in _ADD or fn in _MUL) and len(current.args) == 2):
            break
        a, b = current.args
        a_free, b_free = _is_rv_free(a), _is_rv_free(b)
        if a_free == b_free:
            raise TypeError(f"arg{kind} has a closed form only for one random operand races")
        const, rv_side = (a, b) if a_free else (b, a)
        if fn in _ADD:
            shift = apply(operator.add, shift, apply(operator.mul, scale, const))
        else:
            v = _concrete(const)
            if v is not None and not np.all(v > 0):
                raise TypeError(f"arg{kind} scale lift needs positive scales")
            scale = apply(operator.mul, scale, const)
        current = rv_side
    if not isinstance(current, (FreeRV, ObservedRV)):
        raise TypeError(f"arg{kind}(...) requires a Gumbel (argmax) or Exponential/Weibull "
                        "(argmin) random operand")
    dist = current.dist
    shape = _shape(dist)
    ndim = len(shape)
    reduced = tuple(range(ndim)) if axis is None else (axis % ndim,)
    if not shape or any(shape[a] == 0 for a in reduced):
        raise TypeError(f"arg{kind} of an empty race has no density")

    def const_across(p):
        padded = (1,) * (ndim - len(_shape(p))) + _shape(p)
        return all(padded[a] == 1 for a in reduced)

    unshifted = isinstance(shift, float) and shift == 0.0
    if kind == "max" and isinstance(dist, Gumbel):
        if not const_across(dist.beta) or not const_across(scale):
            raise TypeError("argmax(gumbel): the scale must be constant across the race axes "
                            "(reference order.py:286)")
        logits = apply(lambda sh, sc, mu, beta: (sh + sc * mu) / (sc * beta), shift, scale,
                       dist.mu, dist.beta)
        weights = apply(torch.exp, logits)
    elif kind == "min" and isinstance(dist, Exponential):
        if not unshifted:
            raise TypeError("argmin(exponential): location shifts break the closed form (a "
                            "shifted exponential is not exponential)")
        weights = apply(lambda lam, sc: lam / sc, dist.lam, scale)
    elif kind == "min" and isinstance(dist, Weibull):
        if not unshifted:
            raise TypeError("argmin(weibull): location shifts break the closed form")
        if not const_across(dist.alpha):
            raise TypeError("argmin(weibull): the shape must be constant across the race axes "
                            "(reference order.py:313)")
        weights = apply(lambda a, b, sc: (b * sc) ** (-a), dist.alpha, dist.beta, scale)
    else:
        raise TypeError(f"arg{kind} has a closed-form density only for argmax(Gumbel) and "
                        "argmin(Exponential/Weibull) races (reference logprob/order.py "
                        "categorical_from_argmax)")
    n_red = int(np.prod([shape[a] for a in reduced]))
    out_shape = tuple(shape[a] for a in range(ndim) if a not in reduced)

    def to_probs(w):
        w = torch.broadcast_to(w, shape)
        w = torch.movedim(w, reduced, tuple(range(-len(reduced), 0)))
        w = w.reshape(out_shape + (n_red,))
        return w / w.sum(-1, keepdim=True)

    return Categorical.dist(p=apply(to_probs, weights))


# ------------------------------------------------------------- reductions
def _match_sum_reduction(node, axis, keepdims):
    """sum of Normals over `axis`: Normal(sum mu, sqrt(sum sigma^2))
    (reference logprob/arithmetic.py:51 sum_of_normals); the components
    left out of the sum stay independent normals."""
    from .continuous import Normal

    x = _one_random(node, "sum")
    if not isinstance(x, (FreeRV, ObservedRV)) or not isinstance(x.dist, Normal):
        raise TypeError(
            "sum(...) of a random expression has a closed-form derived density only for a "
            "Normal base (sum of independent normals is normal: reference logprob/"
            "arithmetic.py sum_of_normals); other bases have no derived density")
    if x.dist.event_shape:
        raise TypeError("sum of a multivariate base has no derived density")
    shape = _shape(x)
    mu = apply(lambda m: _reduce(torch.broadcast_to(m, shape), "sum", axis, keepdims), x.dist.mu)
    sd = apply(lambda s: torch.sqrt(_reduce(torch.broadcast_to(torch.square(s), shape), "sum",
                                            axis, keepdims)), x.dist.sigma)
    return Normal.dist(mu=mu, sigma=sd)


def _match_order_reduction(node, op, axis, keepdims):
    """max/min over every axis of an iid scalar random variable: Max/Min
    (reference logprob/order.py find_measurable_max, which rejects
    partial-axis reductions too); a sum: `_match_sum_reduction`."""
    if op == "sum":
        return _match_sum_reduction(node, axis, keepdims)
    from .derived import Max, Min
    from .shape_utils import change_dist_size

    x = _one_random(node, op)
    if not isinstance(x, (FreeRV, ObservedRV)):
        raise TypeError(f"{op}(...) order statistic requires a bare iid random variable operand "
                        "(use OrderStatistic/Max/Min explicitly for derived bases)")
    dist = x.dist
    if dist.event_ndim != 0:
        raise TypeError(f"{op} of a multivariate distribution has no derived density")
    ndim = len(dist.shape)
    ax = _axes(axis, ndim)
    if tuple(sorted(a % ndim for a in ax)) != tuple(range(ndim)):
        raise TypeError(f"{op} over a partial axis subset is not measurable: the un-reduced "
                        "components remain random; reduce over all axes (reference "
                        "logprob/order.py)")
    for name, p in zip(dist.param_names, dist.param_values()):
        if p is not None and _shape(p) != ():
            raise TypeError(f"{op} order statistic requires iid components; parameter {name!r} "
                            "varies across them")
    n = int(np.prod(dist.shape))
    if n < 1:
        raise TypeError(f"{op} of an empty variable has no density")
    return (Max if op == "max" else Min).dist(change_dist_size(dist, ()), n)


# ---------------------------------------------------------------- the walk
def dist_from_expression(node):
    """The distribution of a random expression: a chain of invertible
    elementwise links (a `TransformedDistribution`) over one random leaf, a
    fold of one (a `FoldedDistribution`), or over a structural form (a
    join, reduction, argmax/argmin, index, cumsum, cast, broadcast, layout,
    matmul, censoring, rounding or switch mixture), whose matcher builds the
    base. Raises TypeError where the expression has no derived density."""
    ops = []  # outer to inner
    current = node
    base = None
    while isinstance(current, DeterministicNode):
        fn = current.fn
        kind, params = _form(current)
        if kind == "a join":
            base = StackedDistribution._make(*params["join"], current)
            break
        if kind == "a reduction":
            base = _match_order_reduction(current, params["op"], params["axis"],
                                          params["keepdims"])
            break
        if kind in ("an argmax", "an argmin"):
            base = _match_argext(current, kind[-3:], params["axis"])
            break
        if kind == "an index":
            base = _match_index(current, params["index"])
            break
        if kind == "a cumsum":
            base = _match_cumsum(current, params["axis"])
            break
        if kind == "a cast":
            matched = _match_cast(current, params["dtype"], bool(ops))
            if matched is None:
                # a measure-preserving relabel: transparent in the chain
                current = [a for a in current.args if isinstance(a, Node)][0]
                continue
            base = matched
            break
        if kind == "a broadcast":
            if ops:
                raise TypeError(
                    "broadcast_to(...) is only measurable when directly valued: the broadcast "
                    "copies are degenerate, so a transform's Jacobian over them would be "
                    "counted once per copy (reference find_measurable_broadcast)")
            base = _match_broadcast(current)
            break
        if fn is torch.where:
            matched = _match_switch_scale(current)
            if matched is not None:
                op, current = matched
                ops.append(op)
                continue
            base = _match_switch_mixture(current)
            if base is None:
                raise TypeError(
                    "switch(...) is only measurable as the non-overlapping form switch(x > 0, "
                    "s_pos * x, s_neg * x) with positive RV-free scales, or as a "
                    "component-selection mixture switch(cond, comp_true, comp_false) with an "
                    "RV-free condition (reference logprob switch/mixture rewrites)")
            break
        if kind == "a matmul":
            if ops:
                raise TypeError("elementwise transforms OVER a matmul-coupled density are not "
                                "supported; apply the linear map outermost")
            base = _match_matmul(current)
            break
        if kind == "a censoring":
            if ops:
                raise TypeError(
                    "censoring (clip/maximum/minimum) pools probability mass at the bounds; an "
                    "elementwise transform OVER a censored expression has no derived density "
                    "(the Jacobian does not apply at the atoms); censor outermost, or use "
                    "pm.Censored explicitly")
            return _match_censoring(current)
        if kind == "a rounding":
            base = _match_rounding(current, params["method"])
            break
        if kind == "a layout":
            base = _match_layout(current, params["layout"])
            break
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
    if getattr(base, "_requires_direct_value", False):
        raise TypeError(
            "this layout moves the event block of a multivariate distribution off the trailing "
            "axes: it is only measurable when directly valued (reference "
            "find_measurable_dimshuffles)")
    if getattr(base, "_mixed_discrete", False):
        raise TypeError("elementwise transforms over a join mixing discrete and continuous "
                        "components are not measurable (the Jacobian applies only to the "
                        "continuous part)")
    if getattr(base, "_has_atoms", False):
        raise TypeError("elementwise transforms over a mixture with point-mass (deterministic) "
                        "components are not measurable: the Jacobian does not apply at the "
                        "atoms")
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


def _tensor(value):
    """A value as a tensor in its own type (a Python float as float64)."""
    return value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))


def _constant_ids(nodes):
    """The ids of the ConstantNodes among the ancestors of `nodes`."""
    return frozenset(id(c) for c in ancestors(nodes) if isinstance(c, ConstantNode))


def _constants_memo(memo, ids):
    """The device copies of the constants `ids` out of `memo`: a memo for
    an env that differs from the caller's, which must recompute every other
    node."""
    memo = memo or {}
    return {i: memo[i] for i in ids if i in memo}


# ----------------------------------------------------------------- joins
class _Part:
    """One component of a stack or concatenate: kind "rv" (a named random
    variable, whose value is put into the env so that later components'
    parameters may depend on it: the chain rule of the reference's
    interdependent joins, logprob/tensor.py), "expr" (a derived-density
    expression) or "const" (RV-free: a point mass)."""

    def __init__(self, kind, node, dist, shape):
        self.kind = kind
        self.node = node
        self.dist = dist
        self.shape = shape
        self.size = None  # the length along a concatenation's axis


def _chain_leaves(node):
    """The random leaves a transform chain or join ends at (not the
    variables that condition it through its parameters)."""
    current = node
    while isinstance(current, DeterministicNode):
        if _join_of(current) is not None:
            return [leaf for a in current.args if _rv_ancestors(a) for leaf in _chain_leaves(a)]
        rand = [a for a in current.args if _rv_ancestors(a)]
        if len(rand) != 1:
            return []
        current = rand[0]
    return [current] if isinstance(current, (FreeRV, ObservedRV)) else []


class StackedDistribution(Distribution):
    """The joint density of `stack([...])` or `concatenate([...])` over
    independent or sequentially dependent components (reference logprob/
    tensor.py:44-157 MeasurableMakeVector, MeasurableJoin): each component's
    (conditional) log-density fills its slice of the value's layout, so the
    sum is the joint. Components share one support ndim; multivariate ones
    reduce their own event block before the batch logps are joined (an
    event-axis concatenation sums them). A named component's slice of the
    value is put into the env before later components' parameters are
    evaluated, with a memo that keeps only the placed constants."""

    param_names = ()

    @classmethod
    def _make(cls, kind, axis, node):
        parts = []
        for arg in node.args:
            if isinstance(arg, (FreeRV, ObservedRV)):
                parts.append(_Part("rv", arg, arg.dist, _shape(arg)))
            elif _rv_ancestors(arg):
                d = dist_from_expression(arg)
                parts.append(_Part("expr", arg, d, tuple(d.shape)))
            else:
                parts.append(_Part("const", _as_const(arg), None, _shape(arg)))
        # one support ndim (reference logprob_join); a constant's is 0
        supp = {len(p.dist.event_shape) for p in parts if p.dist is not None}
        if any(p.dist is None for p in parts):
            supp.add(0)
        if len(supp) > 1:
            raise ValueError("Joined logps have different number of dimensions, this can happen "
                             "when joining univariate and multivariate distributions")
        k = supp.pop() if supp else 0
        seen = set()
        for leaf in _chain_leaves(node):
            if id(leaf) in seen:
                raise TypeError(
                    f"random variable {getattr(leaf, 'name', leaf)!r} is the random leaf of "
                    "more than one join component: the joint density of a replicated RV is not "
                    "measurable (it may still CONDITION later components through its "
                    "parameters)")
            seen.add(id(leaf))
        full = _shape(node)
        obj = _derived(cls, None, full[: len(full) - k], full[len(full) - k:])
        obj.kind = kind
        obj.parts = parts
        # the axis from the right, so that values with leading dims split
        obj.axis = axis if axis < 0 else axis - len(full)
        obj._support_concat = False
        if k:
            if kind == "stack":
                if -obj.axis <= k:
                    raise TypeError("measurable stack of multivariate components must stack "
                                    "along a batch axis (the inserted axis lands inside the "
                                    "event block)")
            else:
                # concatenating along an event axis fuses the components into
                # one event, whose logp is the sum of theirs
                obj._support_concat = -obj.axis <= k
        if kind == "concatenate":
            for p in parts:
                p.size = p.shape[obj.axis] if len(p.shape) >= -obj.axis else 1
        discretes = [p.dist.is_discrete if p.dist is not None else True for p in parts]
        obj.is_discrete = all(discretes)
        obj._mixed_discrete = len(set(discretes)) > 1
        obj._consts = _constant_ids(obj.inputs())
        return obj

    def inputs(self):
        out = []
        for p in self.parts:
            out += [p.node] if p.dist is None else p.dist.inputs()
        return out

    def _split(self, value):
        if self.kind == "stack":
            return [value.select(self.axis, i) for i in range(len(self.parts))]
        out, start = [], 0
        for p in self.parts:
            out.append(value.narrow(self.axis, start, p.size))
            start += p.size
        return out

    def _join(self, pieces, extra_shape=()):
        dtype = functools.reduce(torch.promote_types, [x.dtype for x in pieces])
        if self.kind == "stack":
            target = tuple(extra_shape) + tuple(np.broadcast_shapes(*(p.shape for p in self.parts)))
            return torch.stack([torch.broadcast_to(x.to(dtype), target) for x in pieces],
                               dim=self.axis)
        return torch.cat([torch.broadcast_to(x.to(dtype), tuple(extra_shape) + p.shape)
                          for p, x in zip(self.parts, pieces)], dim=self.axis)

    def _env(self, slices, env):
        env2 = dict(env or {})
        for p, sl in zip(self.parts, slices):
            if p.kind == "rv":
                env2[p.node.name] = sl
        return env2

    def _conditional_terms(self, value, env, memo, method):
        slices = self._split(value)
        env2, memo2 = self._env(slices, env), _constants_memo(memo, self._consts)
        out = []
        for p, sl in zip(self.parts, slices):
            if p.kind == "const":
                if method != "logp":
                    raise NotImplementedError("cdf-family is undefined for a constant join "
                                              "component")
                dt = sl.dtype if sl.is_floating_point() else torch.float64
                c = evaluate(p.node, env2, memo2)
                term = torch.where(torch.isclose(sl.to(dt), c.to(dt)), 0.0, -torch.inf).to(dt)
            else:
                term = getattr(p.dist, method)(sl, env2, memo2)
            out.append(torch.broadcast_to(term, sl.shape))
        return out

    def _join_like_value(self, value, pieces):
        return self._join(pieces, extra_shape=value.shape[: value.ndim - len(self.shape)])

    def logp(self, value, env=None, memo=None):
        value = _tensor(value)
        if self.event_ndim:
            return self._multivariate_logp(value, env, memo)
        return self._join_like_value(value, self._conditional_terms(value, env, memo, "logp"))

    def _multivariate_logp(self, value, env, memo):
        """A join of multivariate components: each component's logp reduces
        its own event block; a batch-axis join joins the batch logps at the
        axis shifted past the event dims, an event-axis concatenation sums
        them."""
        k = self.event_ndim
        slices = self._split(value)
        env2, memo2 = self._env(slices, env), _constants_memo(memo, self._consts)
        terms = [torch.broadcast_to(p.dist.logp(sl, env2, memo2), sl.shape[: sl.ndim - k])
                 for p, sl in zip(self.parts, slices)]
        if self.kind == "stack":
            return torch.stack(terms, dim=self.axis + k)
        if self._support_concat:
            return functools.reduce(operator.add, terms)
        return torch.cat(terms, dim=self.axis + k)

    def _cdf(self, value, env, memo, method):
        if self.event_ndim:
            raise NotImplementedError("cdf-family of a multivariate join is not defined "
                                      "componentwise")
        value = _tensor(value)
        return self._join_like_value(value, self._conditional_terms(value, env, memo, method))

    def logcdf(self, value, env=None, memo=None):
        """Each component's (conditional) marginal logcdf in its slice."""
        return self._cdf(value, env, memo, "logcdf")

    def logccdf(self, value, env=None, memo=None):
        return self._cdf(value, env, memo, "logccdf")

    def icdf(self, q, env=None, memo=None):
        raise NotImplementedError("icdf of a joint stacked density is not defined componentwise")

    def sample(self, generator, sample_shape=(), env=None, memo=None):
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        sample_shape = tuple(sample_shape)
        env2, draws = dict(env or {}), []
        for p in self.parts:
            memo2 = _constants_memo(memo, self._consts)
            if p.kind == "const":
                x = torch.broadcast_to(evaluate(p.node, env2, memo2), sample_shape + p.shape)
            else:
                x = p.dist.sample(generator, sample_shape, env2, memo2)
            if p.kind == "rv":
                env2[p.node.name] = x
            draws.append(x)
        return self._join(draws, extra_shape=sample_shape)

    def support_point(self, env=None, memo=None):
        env2, out = dict(env or {}), []
        for p in self.parts:
            memo2 = _constants_memo(memo, self._consts)
            if p.kind == "const":
                x = torch.broadcast_to(evaluate(p.node, env2, memo2), p.shape)
            else:
                x = p.dist.support_point(env2, memo2)
            if p.kind == "rv":
                env2[p.node.name] = x
            out.append(x)
        return self._join(out)


# ----------------------------------------------------------------- layout
class LayoutDistribution(Distribution):
    """An index bijection (a permutation or a C-order reshape) over a base
    (reference logprob/tensor.py:255 MeasurableDimShuffle): every element
    keeps its density, so logp/logcdf/icdf ride the same re-indexing with no
    Jacobian. `dfwd` re-indexes an event-reduced density."""

    param_names = ()

    @classmethod
    def _make(cls, base, fwd, inv, out_shape, dfwd=None, event_k=0, requires_direct=False):
        out_shape = tuple(out_shape)
        ev = int(event_k) if event_k and not requires_direct else 0
        obj = _derived(cls, base, out_shape[: len(out_shape) - ev], out_shape[len(out_shape) - ev:])
        obj._fwd, obj._inv = fwd, inv
        obj._dfwd = dfwd if dfwd is not None else fwd
        obj._event_k = int(event_k)
        obj._requires_direct_value = bool(requires_direct)
        obj.is_discrete = bool(base.is_discrete)
        obj._mixed_discrete = bool(getattr(base, "_mixed_discrete", False))
        return obj

    @property
    def dtype(self):
        return self.base.dtype

    def inputs(self):
        return self.base.inputs()

    def logp(self, value, env=None, memo=None):
        return self._dfwd(self.base.logp(self._inv(_tensor(value)), env, memo))

    def _elementwise(self, method, value, env, memo):
        if self._event_k:
            raise NotImplementedError("cdf-family of a layout over a multivariate distribution "
                                      "is not defined elementwise")
        return self._fwd(getattr(self.base, method)(self._inv(_tensor(value)), env, memo))

    def logcdf(self, value, env=None, memo=None):
        return self._elementwise("logcdf", value, env, memo)

    def logccdf(self, value, env=None, memo=None):
        return self._elementwise("logccdf", value, env, memo)

    def icdf(self, q, env=None, memo=None):
        return self._elementwise("icdf", q, env, memo)

    def sample(self, generator, sample_shape=(), env=None, memo=None):
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        return self._fwd(self.base.sample(generator, sample_shape, env, memo))

    def support_point(self, env=None, memo=None):
        return self._fwd(torch.broadcast_to(self.base.support_point(env, memo), self.base.shape))


class _DtypeView(Distribution):
    """A measure-preserving dtype relabel of a base (reference logprob/
    tensor.py:533-553 MeasurableCast). The logp takes the value as it is
    (casting it back could map an impossible value onto a possible one);
    the cdfs floor a float value against a discrete base; draws and
    quantiles carry the new dtype."""

    param_names = ()

    @classmethod
    def _make(cls, base, dtype):
        obj = _derived(cls, base, base.batch_shape, base.event_shape)
        obj._out_dtype = dtype
        obj.is_discrete = bool(base.is_discrete)
        obj._mixed_discrete = bool(getattr(base, "_mixed_discrete", False))
        obj._has_atoms = bool(getattr(base, "_has_atoms", False))
        return obj

    @property
    def dtype(self):
        return self._out_dtype

    def inputs(self):
        return self.base.inputs()

    def logp(self, value, env=None, memo=None):
        return self.base.logp(value, env, memo)

    def _floor_if_discrete(self, value):
        v = _tensor(value)
        return torch.floor(v) if self.base.is_discrete and v.is_floating_point() else v

    def logcdf(self, value, env=None, memo=None):
        return self.base.logcdf(self._floor_if_discrete(value), env, memo)

    def logccdf(self, value, env=None, memo=None):
        return self.base.logccdf(self._floor_if_discrete(value), env, memo)

    def icdf(self, q, env=None, memo=None):
        return self.base.icdf(q, env, memo).to(self._out_dtype)

    def sample(self, generator, sample_shape=(), env=None, memo=None):
        return self.base.sample(generator, sample_shape, env, memo).to(self._out_dtype)

    def support_point(self, env=None, memo=None):
        return self.base.support_point(env, memo).to(self._out_dtype)


class BroadcastDistribution(Distribution):
    """Directly valued `broadcast_to(x, shape)` (reference logprob/
    tensor.py:367-436 broadcast_logprob): the copies are degenerate
    duplicates, consumed like support dimensions: the base's logp of the
    de-duplicated value, -inf where the copies disagree (checked
    elementwise over the surviving batch dims)."""

    param_names = ()

    @classmethod
    def _make(cls, base, in_shape, out_shape):
        ev = len(base.event_shape)
        n_new = len(out_shape) - len(in_shape)
        # base batch axes that the broadcast fans out
        bcast = tuple(i for i in range(len(in_shape))
                      if in_shape[i] == 1 and out_shape[i + n_new] != 1)
        batch = tuple(s for i, s in enumerate(in_shape[: len(in_shape) - ev]) if i not in bcast)
        obj = _derived(cls, base, batch, ())
        obj._in_shape, obj._out_shape = tuple(in_shape), tuple(out_shape)
        obj._n_new, obj._ev, obj._bcast_dims = n_new, ev, bcast
        obj.is_discrete = bool(base.is_discrete)
        obj._mixed_discrete = bool(getattr(base, "_mixed_discrete", False))
        obj._requires_direct_value = True
        return obj

    @property
    def dtype(self):
        return self.base.dtype

    def inputs(self):
        return self.base.inputs()

    def logp(self, value, env=None, memo=None):
        value = _tensor(value)
        out, n_new = self._out_shape, self._n_new
        lead = value.ndim - len(out)
        bdims = tuple(d + n_new for d in self._bcast_dims)
        idx = (slice(None),) * lead + tuple(0 if (i < n_new or i in bdims) else slice(None)
                                            for i in range(len(out)))
        unb = value[idx]
        for d in self._bcast_dims:
            unb = unb.unsqueeze(lead + d)
        lp = self.base.logp(unb, env, memo)
        # the broadcast batch axes are consumed like support dims
        squeeze = tuple(lead + d for d in self._bcast_dims
                        if lead + d < lp.ndim and lp.shape[lead + d] == 1)
        if squeeze:
            lp = lp.squeeze(squeeze)
        # the copies must agree, elementwise over the surviving batch axes
        # (the new axes go after the value's leading dims, where the JAX
        # package's broadcast fails)
        valid = torch.broadcast_to(
            unb.reshape(value.shape[:lead] + (1,) * n_new + self._in_shape),
            value.shape[:lead] + out)
        core = range(len(out) - self._ev, len(out))
        reduced = tuple(lead + a for a in sorted({*range(n_new), *bdims, *core}))
        check = (value == valid).all(dim=reduced) if reduced else value == valid
        return torch.where(check, lp, -torch.inf)

    def logcdf(self, value, env=None, memo=None):
        raise NotImplementedError("cdf-family of a broadcast RV is not defined (the copies are "
                                  "degenerate, not independent)")

    logccdf = logcdf

    def icdf(self, q, env=None, memo=None):
        raise NotImplementedError("icdf of a broadcast RV is not defined")

    def sample(self, generator, sample_shape=(), env=None, memo=None):
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        x = self.base.sample(generator, sample_shape, env, memo)
        x = x.reshape(tuple(sample_shape) + (1,) * self._n_new + self._in_shape)
        return torch.broadcast_to(x, tuple(sample_shape) + self._out_shape)

    def support_point(self, env=None, memo=None):
        return torch.broadcast_to(self.base.support_point(env, memo), self._out_shape)


# --------------------------------------------------------------- indexing
def _put(full, v, idx, dim):
    """`full` with `full[..., idx]` (ints and slices from axis `dim` on)
    replaced by `v`, out of place (select_scatter and slice_scatter, which
    vmap and CUDA-graph capture take, where an in-place write into a
    captured tensor is refused under vmap)."""
    if not idx:
        return torch.broadcast_to(v, full.shape).to(full.dtype)
    i, rest = idx[0], idx[1:]
    if isinstance(i, slice):
        start, stop, step = i.indices(full.shape[dim])
        part = full[(slice(None),) * dim + (i,)]
        return torch.slice_scatter(full, _put(part, v, rest, dim + 1), dim, start, stop, step)
    i = int(i) % full.shape[dim]
    return torch.select_scatter(full, _put(full.select(dim, i), v, rest, dim), dim, i)


class SelectionDistribution(Distribution):
    """The marginal of basic-indexed independent components: `x[idx]` keeps
    the selected components' product density. A density is evaluated by
    putting the value into a full-shape buffer of the base's support point
    (the other positions in support) and selecting the same positions of
    the elementwise result."""

    param_names = ()

    @classmethod
    def _make(cls, base, idx_t, out_shape):
        obj = _derived(cls, base, out_shape, ())
        obj.idx = tuple(idx_t)
        obj.is_discrete = bool(base.is_discrete)
        return obj

    @property
    def dtype(self):
        return self.base.dtype

    def inputs(self):
        return self.base.inputs()

    def _sel(self, lead_ndim):
        # the index applies to the base's first axes, after any leading dims
        return (slice(None),) * lead_ndim + self.idx

    def _full(self, filler, v):
        lead = tuple(v.shape[: v.ndim - len(self.shape)])
        full = torch.broadcast_to(filler, lead + tuple(self.base.shape))
        dtype = torch.promote_types(full.dtype, v.dtype)
        return _put(full.to(dtype), v.to(dtype), self.idx, len(lead)), len(lead)

    def _through(self, method, value, env, memo):
        memo = {} if memo is None else memo
        v = _tensor(value)
        full, lead = self._full(self.base.support_point(env, memo), v)
        return getattr(self.base, method)(full, env, memo)[self._sel(lead)]

    def logp(self, value, env=None, memo=None):
        return self._through("logp", value, env, memo)

    def logcdf(self, value, env=None, memo=None):
        return self._through("logcdf", value, env, memo)

    def logccdf(self, value, env=None, memo=None):
        return self._through("logccdf", value, env, memo)

    def icdf(self, q, env=None, memo=None):
        # quantiles need a filler in [0, 1], not the support point
        q = _tensor(q)
        full, lead = self._full(torch.full((), 0.5, dtype=q.dtype, device=q.device), q)
        return self.base.icdf(full, env, memo)[self._sel(lead)]

    def sample(self, generator, sample_shape=(), env=None, memo=None):
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        draw = self.base.sample(generator, sample_shape, env, memo)
        return draw[self._sel(len(tuple(sample_shape)))]

    def support_point(self, env=None, memo=None):
        pt = self.base.support_point(env, memo)
        return torch.broadcast_to(pt, tuple(self.base.shape))[self._sel(0)]


def _pick(i, vals, n, oob):
    """The value of component i elementwise (a sum of where-selected terms,
    the JAX package's order), `oob` where i is outside [0, n)."""
    out = None
    for k, v in enumerate(vals):
        term = torch.where(i == k, v, torch.zeros_like(v))
        out = term if out is None else out + term
    return torch.where((i >= 0) & (i < n), out, oob)


class MixtureSelectionDistribution(Distribution):
    """The density of `stack(comps)[I]` conditional on the random scalar
    index I: the selected component's density, -inf for an index out of
    range (reference logprob/mixture.py:309 logprob_MixtureRV). I is read
    from the env at density time, as a model's logp reads its values; a
    draw draws I from its own distribution where the env has none."""

    param_names = ()

    @classmethod
    def _make(cls, comps, idx_node, out_shape):
        comps = list(comps)
        ev = {int(d.event_ndim) for d in comps}
        if len(ev) != 1:
            raise TypeError("mixture components must share event structure")
        k = ev.pop()
        obj = _derived(cls, None, out_shape[: len(out_shape) - k], out_shape[len(out_shape) - k:])
        obj.comps = comps
        obj.idx_node = idx_node
        obj.is_discrete = all(bool(d.is_discrete) for d in comps)
        obj._has_atoms = any(isinstance(d, DiracDelta) or getattr(d, "_has_atoms", False)
                             for d in comps)
        return obj

    @property
    def dtype(self):
        return functools.reduce(torch.promote_types, [d.dtype for d in self.comps])

    def inputs(self):
        return [self.idx_node] + [c for d in self.comps for c in d.inputs()]

    def _through(self, method, value, env, memo, oob):
        memo = {} if memo is None else memo
        i = evaluate(self.idx_node, env, memo)
        vals = [getattr(d, method)(value, env, memo) for d in self.comps]
        return _pick(i, vals, len(self.comps), oob)

    def logp(self, value, env=None, memo=None):
        return self._through("logp", value, env, memo, -torch.inf)

    def logcdf(self, value, env=None, memo=None):
        return self._through("logcdf", value, env, memo, -torch.inf)

    def logccdf(self, value, env=None, memo=None):
        return self._through("logccdf", value, env, memo, -torch.inf)

    def icdf(self, q, env=None, memo=None):
        return self._through("icdf", q, env, memo, torch.nan)

    def sample(self, generator, sample_shape=(), env=None, memo=None):
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        sample_shape = tuple(sample_shape)
        memo = {} if memo is None else memo
        try:
            i = evaluate(self.idx_node, env, memo)
        except KeyError:
            if not isinstance(self.idx_node, (FreeRV, ObservedRV)):
                raise
            i = self.idx_node.dist.sample(generator, sample_shape, env, memo)
        draws = [d.sample(generator, sample_shape, env, memo) for d in self.comps]
        i = i.reshape(tuple(i.shape) + (1,) * len(self.shape))
        dtype = self.dtype
        out = None
        for k, v in enumerate(draws):
            term = torch.where(i == k, v, torch.zeros_like(v)).to(dtype)
            out = term if out is None else out + term
        return out

    def support_point(self, env=None, memo=None):
        memo = {} if memo is None else memo
        pts = [torch.broadcast_to(d.support_point(env, memo), self.shape) for d in self.comps]
        try:
            i = evaluate(self.idx_node, env, memo)
        except KeyError:
            return pts[0]
        return _pick(i, pts, len(self.comps), torch.nan)


class SwitchMixtureDistribution(Distribution):
    """The elementwise component-selection mixture `where(cond, d_true,
    d_false)` (reference logprob/mixture.py:434 logprob_switch_mixture, :459
    MeasurableIfElse): each density or cdf evaluates both components and
    selects per element. The condition is RV-free, or random and disjoint
    from the branches' random variables: then the density is conditional
    on its value from the env, and a draw draws it where the env has
    none."""

    param_names = ()

    @classmethod
    def _make(cls, cond, d_true, d_false, out_shape, has_atoms):
        obj = _derived(cls, None, out_shape, ())
        obj.cond, obj.d_true, obj.d_false = cond, d_true, d_false
        obj.is_discrete = bool(d_true.is_discrete) and bool(d_false.is_discrete)
        obj._has_atoms = bool(has_atoms)
        return obj

    @property
    def dtype(self):
        return torch.promote_types(self.d_true.dtype, self.d_false.dtype)

    def inputs(self):
        return [self.cond] + self.d_true.inputs() + self.d_false.inputs()

    def _through(self, method, value, env, memo):
        memo = {} if memo is None else memo
        c = evaluate(self.cond, env, memo)
        return torch.where(c, getattr(self.d_true, method)(value, env, memo),
                           getattr(self.d_false, method)(value, env, memo))

    def logp(self, value, env=None, memo=None):
        return self._through("logp", value, env, memo)

    def logcdf(self, value, env=None, memo=None):
        return self._through("logcdf", value, env, memo)

    def logccdf(self, value, env=None, memo=None):
        return self._through("logccdf", value, env, memo)

    def icdf(self, q, env=None, memo=None):
        return self._through("icdf", q, env, memo)

    def sample(self, generator, sample_shape=(), env=None, memo=None):
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        sample_shape = tuple(sample_shape)
        memo = {} if memo is None else memo
        try:
            c = evaluate(self.cond, env, memo)
        except KeyError:
            # a random condition with no value in the env: drawn forward, a
            # draw at a time
            from ..functions import _draw_expression

            n = int(np.prod(sample_shape))
            c = _draw_expression(self.cond, n, generator, generator.device)
            c = c.reshape(sample_shape + _shape(self.cond))
        t = self.d_true.sample(generator, sample_shape, env, memo)
        f = self.d_false.sample(generator, sample_shape, env, memo)
        return torch.where(c, t, f).to(self.dtype)

    def support_point(self, env=None, memo=None):
        memo = {} if memo is None else memo
        t = torch.broadcast_to(self.d_true.support_point(env, memo), self.shape)
        try:
            c = evaluate(self.cond, env, memo)
        except KeyError:
            return t
        return torch.where(c, t, torch.broadcast_to(self.d_false.support_point(env, memo),
                                                    self.shape))


# ----------------------------------------------------------------- matmul
class MatMulDistribution(Distribution):
    """The linear change of variables y = A @ x (or x @ A) for a square
    RV-free A: logp_y(y) = logp_x(A^-1 y) - k log|det A|, k the number of
    columns (rows) of x that A transforms (reference logprob/linalg.py
    MeasurableMatMul, with the Jacobian's multiplicity corrected as in the
    JAX package). The map couples the core axes, so the density is a joint
    one over them, with no cdf; a singular A gives -inf. The solve and
    log|det A| check no error code on the host, so a CUDA graph captures
    them."""

    param_names = ()

    @classmethod
    def _make(cls, base, A, right_measurable, core, out_shape):
        split = len(out_shape) - core
        obj = _derived(cls, base, out_shape[:split], out_shape[split:])
        obj.A_op = A
        obj.right_measurable = bool(right_measurable)
        obj.core = int(core)
        obj.is_discrete = False
        return obj

    def inputs(self):
        return ([self.A_op] if isinstance(self.A_op, Node) else []) + self.base.inputs()

    def _A(self, env, memo, like):
        return _t(evaluate(self.A_op, env, memo), like)

    def _x_from_y(self, A, y):
        if not self.right_measurable:  # y = x @ A: y^T = A^T x^T
            A = A.transpose(-1, -2)
            if self.core == 2:
                return self._x_from_y_right(A, y.transpose(-1, -2)).transpose(-1, -2)
        return self._x_from_y_right(A, y)

    def _x_from_y_right(self, A, y):
        if self.core == 1:
            return torch.linalg.solve_ex(A, y[..., None], check_errors=False).result[..., 0]
        return torch.linalg.solve_ex(A, y, check_errors=False).result

    def logp(self, value, env=None, memo=None):
        memo = {} if memo is None else memo
        y = _as_value(value)
        A = self._A(env, memo, y)
        lp = self.base.logp(self._x_from_y(A, y), env, memo)
        while lp.ndim > y.ndim - self.core:
            lp = lp.sum(-1)
        # the columns transform under A @ x, the rows under x @ A
        k = 1 if self.core == 1 else y.shape[-1] if self.right_measurable else y.shape[-2]
        sign, logabsdet = torch.linalg.slogdet(A)
        return torch.where(sign == 0, -torch.inf, lp - k * logabsdet)

    def _apply(self, A, x):
        if self.right_measurable:
            return torch.matmul(A, x[..., None])[..., 0] if self.core == 1 else torch.matmul(A, x)
        return torch.matmul(x[..., None, :], A)[..., 0, :] if self.core == 1 \
            else torch.matmul(x, A)

    def sample(self, generator, sample_shape=(), env=None, memo=None):
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        memo = {} if memo is None else memo
        x = _as_float(self.base.sample(generator, tuple(sample_shape), env, memo))
        return self._apply(self._A(env, memo, x), x)

    def support_point(self, env=None, memo=None):
        memo = {} if memo is None else memo
        pt = _as_float(torch.broadcast_to(self.base.support_point(env, memo), self.base.shape))
        return self._apply(self._A(env, memo, pt), pt)
