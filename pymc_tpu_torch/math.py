"""Node-aware math API (`pm.math`).

Counterpart of `pymc_tpu/math.py` (reference pymc/math.py: logit/invlogit,
probit/invprobit, logsumexp, logaddexp, logdiffexp, log1mexp, kronecker,
cartesian, expand_packed_triangular, batched_diag, logdet, ...). Every
function takes graph Nodes or concrete values: with a Node among its
arguments it builds a node of the model's graph (numbers and arrays beside
it become constants, which the model places on the device); without one it
computes at once, on tensors, numpy arrays or numbers, in numpy's
conventions (`axis=None` reduces over every axis; `std`/`var` divide by n).
A function called with no keyword argument keeps the PyTorch function
itself as its node's function, so the distributions can recognise it (a
Bernoulli whose `p` is `sigmoid(z)` reads the logit z). `iv` and `kv`
are the Bessel functions of `ops/special.py`.
"""

from __future__ import annotations

import builtins
import functools
import math

import numpy as np
import torch

from .config import floatX as _floatX
from .distributions import dist_math as _dm
from .graph import Node, apply, as_node, as_tensor as _as_tensor, lift, structural
from .ops import special as _special
from .ops.linalg import cholesky_batched as _cholesky_batched

__all__ = [
    # elementwise
    "abs", "exp", "log", "log1p", "log2", "log10", "sqrt", "cbrt", "square",
    "sgn", "sign", "ceil", "floor", "round", "trunc",
    "sin", "cos", "tan", "arcsin", "arccos", "arctan", "arctan2",
    "sinh", "cosh", "tanh", "arcsinh", "arccosh", "arctanh",
    "erf", "erfc", "erfinv", "erfcinv",
    "sigmoid", "invlogit", "logit", "probit", "invprobit", "softmax",
    "log_softmax", "logsumexp", "logaddexp", "logdiffexp", "log1mexp",
    "expm1", "exprel", "softplus", "log1pexp",
    # reductions / linalg
    "sum", "prod", "mean", "maximum", "minimum", "max", "min", "dot",
    "matmul", "outer", "tensordot", "norm",
    "kronecker", "kron_dot", "kron_diag", "cartesian", "flat_outer",
    "expand_packed_triangular", "batched_diag", "block_diagonal", "logdet",
    "matrix_inverse", "extract_diag",
    # structural
    "where", "switch", "clip", "concatenate", "stack", "full", "full_like",
    "ones_like", "zeros_like", "eq", "neq", "lt", "gt", "le", "ge",
    "and_", "or_", "cumsum", "cumprod", "diff", "constant", "floatX",
    # numpy-style passthroughs, linalg and special functions
    "all", "any", "argmax", "argmin", "argsort", "arange", "as_tensor",
    "as_tensor_variable", "betainc", "block_diag", "broadcast_arrays",
    "broadcast_to", "cho_solve", "cholesky", "det", "diag", "digamma",
    "eigh", "expand_dims", "eye", "flatten", "flatten_list", "gamma",
    "gammainc", "gammaincc", "gammaln", "i0", "i1", "iv", "kron",
    "kron_solve_lower", "kron_solve_upper", "kv", "linspace", "logbern",
    "moveaxis", "ones", "polygamma", "repeat", "reshape", "slogdet",
    "solve", "solve_triangular", "sort", "sqr", "squeeze", "std",
    "swapaxes", "take", "tile", "trace", "transpose", "tril", "triu",
    "unique", "var", "zeros",
]


def _tensor(x):
    """A concrete value as a tensor (floats as float64)."""
    return x if isinstance(x, torch.Tensor) else _as_tensor(x)


def _call(fn, args, kwargs=None):
    """fn(*args, **kwargs): a graph node when an argument is a Node or an
    unnamed distribution (the other arguments become constants), else
    computed at once."""
    kwargs = kwargs or {}
    args = lift(tuple(args))
    if builtins.any(isinstance(a, Node) for a in args):
        return apply(fn, *[as_node(a) for a in args], **kwargs)
    return fn(*[_tensor(a) for a in args], **kwargs)


def _wrap(fn):
    """A function of tensors made node-aware; its keyword arguments are
    static."""
    @functools.wraps(fn)
    def inner(*args, **kwargs):
        return _call(fn, args, kwargs)

    return inner


def _axes(v, axis):
    return tuple(range(v.ndim)) if axis is None else axis


def _reduce(fn, v, axis, keepdims):
    """A numpy-style reduction: axis None (every axis), an int or a tuple."""
    if axis is None:
        out = fn(v.reshape(-1), 0)
        return out.reshape((1,) * v.ndim) if keepdims else out
    axes = (axis,) if isinstance(axis, int) else tuple(axis)
    axes = sorted(a % v.ndim for a in axes)
    for a in reversed(axes):
        v = fn(v, a)
        if keepdims:
            v = v.unsqueeze(a)
    return v


# elementwise
abs = _wrap(torch.abs)  # noqa: A001
exp = _wrap(torch.exp)
log = _wrap(torch.log)
log1p = _wrap(torch.log1p)
log2 = _wrap(torch.log2)
log10 = _wrap(torch.log10)
sqrt = _wrap(torch.sqrt)
square = _wrap(torch.square)
sgn = _wrap(torch.sign)
sign = sgn
ceil = _wrap(torch.ceil)
floor = _wrap(torch.floor)
round = _wrap(torch.round)  # noqa: A001
trunc = _wrap(torch.trunc)
sin = _wrap(torch.sin)
cos = _wrap(torch.cos)
tan = _wrap(torch.tan)
arcsin = _wrap(torch.asin)
arccos = _wrap(torch.acos)
arctan = _wrap(torch.atan)
arctan2 = _wrap(torch.atan2)
sinh = _wrap(torch.sinh)
cosh = _wrap(torch.cosh)
tanh = _wrap(torch.tanh)
arcsinh = _wrap(torch.asinh)
arccosh = _wrap(torch.acosh)
arctanh = _wrap(torch.atanh)
erf = _wrap(torch.special.erf)
erfc = _wrap(torch.special.erfc)
erfinv = _wrap(torch.special.erfinv)
expm1 = _wrap(torch.expm1)


def _cbrt(v):
    return torch.sign(v) * torch.abs(v) ** (1.0 / 3.0)


cbrt = _wrap(_cbrt)


def _erfcinv(v):
    return torch.special.erfinv(1.0 - v)


erfcinv = _wrap(_erfcinv)
sigmoid = _wrap(torch.sigmoid)
invlogit = sigmoid


def _logit(v):
    # log(x / (1 - x)), jax.scipy.special.logit's form
    return torch.log(v / (1.0 - v))


logit = _wrap(_logit)
probit = _wrap(torch.special.ndtri)
invprobit = _wrap(torch.special.ndtr)


def softmax(x, axis=-1):
    return _call(functools.partial(torch.softmax, dim=axis), (x,))


def log_softmax(x, axis=-1):
    return _call(functools.partial(torch.log_softmax, dim=axis), (x,))


softplus = _wrap(_dm.softplus)
log1pexp = softplus


def logsumexp(x, axis=None, keepdims=False):
    return _call(lambda v: _reduce(torch.logsumexp, v, axis, keepdims), (x,))


logaddexp = _wrap(torch.logaddexp)


def _logdiffexp(x, y):
    res = x + _dm.log1mexp(y - x)
    res = torch.where(torch.isneginf(x) & torch.isneginf(y), -torch.inf, res)
    return torch.where(y > x, torch.nan, res)


def logdiffexp(a, b):
    """log(e^a - e^b): NaN where b > a (the reference's contract), -inf
    where both are -inf."""
    return _call(_logdiffexp, (a, b))


log1mexp = _wrap(_dm.log1mexp)


def _exprel(v):
    small = torch.abs(v) < 1e-8
    safe = torch.where(small, 1.0, v)
    return torch.where(small, 1.0 + v / 2.0, torch.expm1(safe) / safe)


def exprel(x):
    """(e^x - 1) / x, with its limit near 0."""
    return _call(_exprel, (x,))


# reductions / linalg
def sum(x, axis=None, keepdims=False):  # noqa: A001
    return _call(structural(lambda v: _reduce(torch.sum, v, axis, keepdims), "a reduction",
                            op="sum", axis=axis, keepdims=keepdims), (x,))


def prod(x, axis=None, keepdims=False):
    return _call(lambda v: _reduce(torch.prod, v, axis, keepdims), (x,))


def mean(x, axis=None, keepdims=False):
    return _call(lambda v: _reduce(torch.mean, v, axis, keepdims), (x,))


def max(x, axis=None, keepdims=False):  # noqa: A001
    return _call(structural(lambda v: torch.amax(v, dim=_axes(v, axis), keepdim=keepdims),
                            "a reduction", op="max", axis=axis, keepdims=keepdims), (x,))


def min(x, axis=None, keepdims=False):  # noqa: A001
    return _call(structural(lambda v: torch.amin(v, dim=_axes(v, axis), keepdim=keepdims),
                            "a reduction", op="min", axis=axis, keepdims=keepdims), (x,))


maximum = _wrap(torch.maximum)
minimum = _wrap(torch.minimum)


def _dot(a, b):
    # numpy's dot: the last axis of a against the second-to-last of b
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    return torch.tensordot(a, b, dims=([a.ndim - 1], [builtins.max(b.ndim - 2, 0)]))


dot = _wrap(_dot)
matmul = _wrap(torch.matmul)


def _outer(a, b):
    return torch.outer(a.reshape(-1), b.reshape(-1))


outer = _wrap(_outer)


def tensordot(a, b, axes=2):
    return _call(lambda x, y: torch.tensordot(x, y, dims=axes), (a, b))


def norm(x, ord=None, axis=None):
    def _norm(v):
        if axis is None and ord is None:
            return torch.linalg.vector_norm(v)
        return torch.linalg.norm(v, ord=ord, dim=axis)

    return _call(_norm, (x,))


def _kron_all(*ms):
    out = ms[0]
    for m in ms[1:]:
        out = torch.kron(out, m)
    return out


def kronecker(*Ks):
    """Kronecker product of a sequence of matrices (reference math.py:294)."""
    return _call(_kron_all, Ks)


def _kron_vec(mat, *ks):
    sizes = [k.shape[0] for k in ks]
    vec_in = mat.ndim == 1
    x = mat[:, None] if vec_in else mat
    ncols = x.shape[1]
    for i, k in enumerate(ks):
        x = torch.einsum("ab,bcd->acd", k, x.reshape(sizes[i], -1, ncols))
        x = torch.movedim(x, 0, 1).reshape(-1, ncols)
    return x[:, 0] if vec_in else x


def kron_dot(krons, m):
    """(K1 (x) K2 (x) ...) @ m without forming the product (reference
    math.py:333), one factor at a time."""
    return _call(_kron_vec, (m, *krons))


def _kron_diag(*ds):
    out = ds[0]
    for d in ds[1:]:
        out = (out[:, None] * d[None, :]).reshape(-1)
    return out


def kron_diag(*diags):
    """Diagonal of a Kronecker product from its factors' diagonals."""
    return _call(_kron_diag, diags)


def _cartesian(*arrs):
    # a 2-D input contributes whole rows (reference semantics)
    arrs = [torch.atleast_1d(a) for a in arrs]
    arrs = [a[:, None] if a.ndim == 1 else a for a in arrs]
    grids = torch.meshgrid(*[torch.arange(a.shape[0], device=a.device) for a in arrs],
                           indexing="ij")
    return torch.cat([a[g.reshape(-1)] for a, g in zip(arrs, grids)], dim=-1)


def cartesian(*arrays):
    """The rows of the Cartesian product (reference math.py:315)."""
    return _call(_cartesian, arrays)


def flat_outer(a, b):
    return _call(lambda x, y: torch.outer(x.reshape(-1), y.reshape(-1)).reshape(-1), (a, b))


def expand_packed_triangular(n, packed, lower=True, diagonal_only=False):
    """Unpack n (n + 1) / 2 values into an (n, n) triangular matrix, or
    take its diagonal only (reference math.py:444)."""
    def _expand(p):
        if diagonal_only:
            if lower:
                idx = np.cumsum(np.arange(1, n + 1)) - 1
            else:
                idx = np.concatenate([[0], np.cumsum(np.arange(n, 1, -1))])
            return p[..., torch.as_tensor(idx, device=p.device)]
        rows, cols = torch.tril_indices(n, n) if lower else torch.triu_indices(n, n)
        out = p.new_zeros(p.shape[:-1] + (n, n))
        out[..., rows.to(p.device), cols.to(p.device)] = p
        return out

    return _call(_expand, (packed,))


def _batched_diag(v):
    if v.ndim >= 2 and v.shape[-1] == v.shape[-2]:
        return torch.diagonal(v, dim1=-2, dim2=-1)
    return v[..., None] * torch.eye(v.shape[-1], dtype=v.dtype, device=v.device)


batched_diag = _wrap(_batched_diag)


def block_diagonal(matrices):
    return _call(torch.block_diag, tuple(matrices))


def _logdet(m):
    return torch.linalg.slogdet(m)[1]


logdet = _wrap(_logdet)
matrix_inverse = _wrap(torch.linalg.inv)


def _extract_diag(m):
    return torch.diagonal(m, dim1=-2, dim2=-1)


extract_diag = _wrap(_extract_diag)

# structural
where = _wrap(torch.where)
switch = where


def clip(x, lo, hi):
    return _call(torch.clamp, (x, lo, hi))


def concatenate(xs, axis=0):
    return _call(structural(lambda *vs: torch.cat(vs, dim=axis), "a join",
                            join=("concatenate", axis)), tuple(xs))


def stack(xs, axis=0):
    return _call(structural(lambda *vs: torch.stack(vs, dim=axis), "a join",
                            join=("stack", axis)), tuple(xs))


def full(shape, fill_value, dtype=None):
    return _call(lambda v: torch.broadcast_to(v.to(dtype or v.dtype), tuple(shape)).clone(),
                 (fill_value,))


def full_like(x, fill_value):
    return _call(lambda v, f: torch.broadcast_to(f.to(v.dtype), v.shape).clone(), (x, fill_value))


ones_like = _wrap(torch.ones_like)
zeros_like = _wrap(torch.zeros_like)
eq = _wrap(torch.eq)
neq = _wrap(torch.ne)
lt = _wrap(torch.lt)
gt = _wrap(torch.gt)
le = _wrap(torch.le)
ge = _wrap(torch.ge)
and_ = _wrap(torch.logical_and)
or_ = _wrap(torch.logical_or)


def cumsum(x, axis=None):
    return _call(structural(lambda v: torch.cumsum(v.reshape(-1) if axis is None else v,
                                                   0 if axis is None else axis), "a cumsum",
                            axis=axis), (x,))


def cumprod(x, axis=None):
    return _call(lambda v: torch.cumprod(v.reshape(-1) if axis is None else v,
                                         0 if axis is None else axis), (x,))


def diff(x, n=1, axis=-1):
    return _call(lambda v: torch.diff(v, n=n, dim=axis), (x,))


def constant(x, name=None):
    return as_node(x)


def floatX(x):
    """x in the default float type of its device (float64 on the CPU,
    float32 on the card)."""
    return _call(lambda v: v.to(_floatX(v.device)), (x,))


# numpy-style passthroughs (reference pymc/math.py re-exports them); a layout
# tag holds (kind, axes): "reshape" for the C-order reshape family, else the
# permutation's own arguments
_RESHAPE = ("reshape", None)

def all(x, axis=None):  # noqa: A001
    return _call(lambda v: torch.all(v) if axis is None else torch.all(v, dim=axis), (x,))


def any(x, axis=None):  # noqa: A001
    return _call(lambda v: torch.any(v) if axis is None else torch.any(v, dim=axis), (x,))


def argmax(x, axis=None):
    return _call(structural(lambda v: torch.argmax(v, dim=axis), "an argmax", axis=axis), (x,))


def argmin(x, axis=None):
    return _call(structural(lambda v: torch.argmin(v, dim=axis), "an argmin", axis=axis), (x,))


def argsort(x, axis=-1):
    return _call(lambda v: torch.argsort(v, dim=axis, stable=True), (x,))


def broadcast_to(x, shape):
    return _call(structural(lambda v: torch.broadcast_to(v, tuple(shape)), "a broadcast",
                            shape=tuple(shape)), (x,))


diag = _wrap(torch.diag)


def expand_dims(x, axis):
    def _expand(v):
        axes = (axis,) if isinstance(axis, int) else tuple(axis)
        nd = v.ndim + len(axes)
        for a in sorted(a % nd for a in axes):
            v = v.unsqueeze(a)
        return v

    return _call(structural(_expand, "a layout", layout=_RESHAPE), (x,))


def flatten(x):
    return _call(structural(lambda v: v.reshape(-1), "a layout", layout=_RESHAPE), (x,))


def moveaxis(x, source, destination):
    return _call(structural(lambda v: torch.movedim(v, source, destination), "a layout",
                            layout=("moveaxis", (source, destination))), (x,))


def repeat(x, repeats, axis=None):
    return _call(lambda v: torch.repeat_interleave(v, repeats, dim=axis), (x,))


def reshape(x, shape):
    return _call(structural(lambda v: torch.reshape(v, tuple(shape) if not isinstance(shape, int)
                                                    else (shape,)), "a layout",
                            layout=_RESHAPE), (x,))


def sort(x, axis=-1):
    return _call(lambda v: torch.sort(v, dim=axis, stable=True).values, (x,))


sqr = square


def squeeze(x, axis=None):
    return _call(structural(lambda v: torch.squeeze(v) if axis is None else torch.squeeze(v, axis),
                            "a layout", layout=_RESHAPE), (x,))


def std(x, axis=None, keepdims=False):
    return _call(lambda v: torch.std(v, dim=_axes(v, axis), correction=0, keepdim=keepdims),
                 (x,))


def var(x, axis=None, keepdims=False):
    return _call(lambda v: torch.var(v, dim=_axes(v, axis), correction=0, keepdim=keepdims),
                 (x,))


def swapaxes(x, axis1, axis2):
    return _call(structural(lambda v: torch.swapaxes(v, axis1, axis2), "a layout",
                            layout=("swapaxes", (axis1, axis2))), (x,))


def take(x, indices, axis=None):
    def _take(v, idx):
        idx = idx.to(torch.int64)
        if axis is None:
            return torch.take(v, idx)
        a = axis % v.ndim
        out = torch.index_select(v, a, idx.reshape(-1))
        return out.reshape(v.shape[:a] + idx.shape + v.shape[a + 1:])

    return _call(_take, (x, indices))


def tile(x, reps):
    return _call(lambda v: torch.tile(v, (reps,) if isinstance(reps, int) else tuple(reps)),
                 (x,))


def _trace(v):
    return torch.diagonal(v, dim1=0, dim2=1).sum(-1)


trace = _wrap(_trace)


def transpose(x, axes=None):
    return _call(structural(lambda v: v.permute(tuple(reversed(range(v.ndim))) if axes is None
                                                else tuple(axes)), "a layout",
                            layout=("transpose", None if axes is None else tuple(axes))), (x,))


tril = _wrap(torch.tril)
triu = _wrap(torch.triu)
unique = _wrap(torch.unique)

# linalg
cholesky = _wrap(_cholesky_batched)
det = _wrap(torch.linalg.det)


def slogdet(x):
    """(sign, log|det|) of a concrete matrix; its tuple is no graph node."""
    out = torch.linalg.slogdet(_tensor(x))
    return out.sign, out.logabsdet


def eigh(x):
    """(eigenvalues, eigenvectors) of a concrete symmetric matrix; its tuple
    is no graph node."""
    out = torch.linalg.eigh(_tensor(x))
    return out.eigenvalues, out.eigenvectors


solve = _wrap(torch.linalg.solve)
kron = _wrap(torch.kron)


def _solve_tri(A, B, lower):
    vec = B.ndim == A.ndim - 1
    out = torch.linalg.solve_triangular(A, B[..., None] if vec else B, upper=not lower)
    return out[..., 0] if vec else out


def solve_triangular(a, b, lower=False, **kw):
    return _call(lambda A, B: _solve_tri(A, B, lower), (a, b))


def cho_solve(c_and_lower, b, **kw):
    c, lower = c_and_lower

    def _cho(C, B):
        vec = B.ndim == C.ndim - 1
        out = torch.cholesky_solve(B[..., None] if vec else B, C, upper=not lower)
        return out[..., 0] if vec else out

    return _call(_cho, (c, b))


def block_diag(*mats):
    return _call(torch.block_diag, mats)


def _kron_matrix_op(mats, b, op):
    """op(m, .) for each Kronecker factor without forming the product (the
    vec trick, factor by factor)."""
    def _run(*xs):
        ms, x = xs[:-1], xs[-1]
        total = 1
        for m in ms:
            total *= m.shape[-1]
        x = x.reshape(total, -1)
        for m in ms:
            n = m.shape[-1]
            x = op(m, x.reshape(n, -1))
            x = torch.swapaxes(x.reshape(n, -1), 0, 1).reshape(-1).reshape(total, -1)
        return x

    return _call(_run, (*mats, b))


def kron_solve_lower(chols, b):
    """Solve (L1 (x) L2 (x) ...) x = b for lower-triangular factors."""
    return _kron_matrix_op(chols, b, lambda L, x: _solve_tri(L, x, True))


def kron_solve_upper(chols, b):
    """Solve (L1 (x) L2 (x) ...)^T x = b for lower-triangular factors."""
    return _kron_matrix_op(chols, b, lambda L, x: _solve_tri(L.transpose(-1, -2), x, False))


# special functions
gammaln = _wrap(torch.lgamma)
digamma = _wrap(torch.digamma)
betainc = _wrap(_dm.betainc)
gammainc = _wrap(_dm.gammainc)
gammaincc = _wrap(_dm.gammaincc)
i0 = _wrap(torch.special.i0)
i1 = _wrap(torch.special.i1)


def _polygamma(n, v):
    # (-1)^(n+1) n! zeta(n + 1, v) through the Hurwitz zeta, exact to float64
    # where torch.special.polygamma's trigamma is some 1e-9 off
    if n == 0:
        return torch.digamma(v)
    order = torch.full_like(v, n + 1.0)
    return (-1) ** (n + 1) * math.factorial(n) * torch.special.zeta(order, v)


def polygamma(n, x):
    """The n-th derivative of digamma; n a non-negative integer."""
    return _call(lambda v: _polygamma(int(n), v), (x,))


def iv(v, x):
    """Modified Bessel function of the first kind, real order
    (ops/special.py)."""
    return _call(_special.bessel_iv, (v, x))


def kv(v, x):
    """Modified Bessel function of the second kind, real order
    (ops/special.py)."""
    return _call(_special.bessel_kv, (v, x))


def _gamma(v):
    # the sign of Gamma on the negative axis: negative on (-2k - 1, -2k)
    neg = (v < 0) & (torch.remainder(torch.floor(v), 2) == 1)
    return torch.exp(torch.lgamma(v)) * torch.where(neg, -1.0, 1.0)


gamma = _wrap(_gamma)


def logbern(log_p, generator=None):
    """A Bernoulli(exp(log_p)) draw in log space from `generator`."""
    log_p = _tensor(log_p)
    u = torch.rand((), generator=generator, dtype=log_p.dtype, device=log_p.device)
    return torch.log(u) < log_p


# constructors (concrete tensors, floats in float64)
def zeros(shape, dtype=torch.float64):
    return torch.zeros(shape, dtype=dtype)


def ones(shape, dtype=torch.float64):
    return torch.ones(shape, dtype=dtype)


def eye(n, m=None, dtype=torch.float64):
    return torch.eye(n, n if m is None else m, dtype=dtype)


def arange(*args, dtype=None):
    if dtype is None and builtins.any(isinstance(a, float) for a in args):
        dtype = torch.float64
    return torch.arange(*args, dtype=dtype)


def linspace(start, stop, num=50, dtype=torch.float64):
    return torch.linspace(start, stop, num, dtype=dtype)


def broadcast_arrays(*xs):
    return torch.broadcast_tensors(*[_tensor(x) for x in xs])


def as_tensor(x, *args, **kwargs):
    """Nodes pass through; anything else becomes a tensor (floats as
    float64)."""
    return x if isinstance(x, Node) else _tensor(x)


as_tensor_variable = as_tensor


def flatten_list(tensors):
    return concatenate([flatten(t) for t in tensors])

