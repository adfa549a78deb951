"""Value-space transforms (bijectors).

Counterpart of `pymc_tpu/distributions/transforms.py`: the log, log-odds,
interval, log-expm1 (softplus), circular, simplex (stick-breaking), ordered
and chained transforms. Same convention as the reference: `forward` maps
constrained -> unconstrained, `backward` maps unconstrained -> constrained,
and `log_jac_det(v)` is log|det d backward(v) / dv| at the unconstrained
value `v`. Every method takes the evaluation env and memo as optional last
arguments, which a chained transform passes through to its parts: the
interval transform's bounds are graph nodes, evaluated there (the memo
holds the constants placed on the device). The sum-to-1 and zero-sum
transforms, and the Cholesky transforms of a packed factor, a covariance
matrix and a correlation factor (the LKJ family's and Wishart's).

A packed lower triangle (row-major, as `np.tril_indices`) is unpacked and
packed by one gather through index maps built once per (n, offset,
device) (`tril_unpack`, `tril_pack`), never on each call: a call then
copies nothing from the host, as a CUDA graph's capture requires.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..graph import evaluate
from .dist_math import softplus

__all__ = [
    "Transform", "LogTransform", "LogOddsTransform", "IntervalTransform", "LogExpM1Transform",
    "CircularTransform", "SimplexTransform", "OrderedTransform", "SumTo1Transform",
    "ZeroSumTransform", "CholeskyCovPackedTransform", "CholeskyCovTransform",
    "CholeskyCorrTransform", "ChainedTransform", "Chain", "CholeskyCovPacked", "Interval", "log",
    "logodds", "log_exp_m1", "circular", "simplex", "ordered", "sum_to_1",
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


class SumTo1Transform(Transform):
    """A vector that sums to 1 (not necessarily positive) <-> its first K - 1
    entries (pymc_tpu transforms.py:255)."""

    name = "sumto1"
    event_ndim = 1

    def forward(self, x, env=None, memo=None):
        return x[..., :-1]

    def backward(self, v, env=None, memo=None):
        return torch.cat([v, 1.0 - torch.sum(v, dim=-1, keepdim=True)], dim=-1)

    def log_jac_det(self, v, env=None, memo=None):
        return torch.zeros(v.shape[:-1], dtype=v.dtype, device=v.device)

    def value_shape(self, shape):
        return tuple(shape[:-1]) + (shape[-1] - 1,)

    def constrained_shape(self, value_shape):
        return tuple(value_shape[:-1]) + (value_shape[-1] + 1,)


class ZeroSumTransform(Transform):
    """R^{n-1} values <-> vectors that sum to zero along each of the last
    `n_zerosum_axes` axes, by the Householder-reflection isometry
    (pymc_tpu transforms.py:315); the log-Jacobian is 0."""

    name = "zerosum"

    def __init__(self, n_zerosum_axes=1):
        self.n_zerosum_axes = int(n_zerosum_axes)
        self.event_ndim = self.n_zerosum_axes

    @staticmethod
    def _extend_axis_rev(x, axis):
        """zero-sum R^n -> R^{n-1} along `axis`."""
        n = x.shape[axis]
        last = x.narrow(axis, n - 1, 1)
        norm = -last * math.sqrt(n) / (math.sqrt(n) + n)
        return x.narrow(axis, 0, n - 1) + norm

    @staticmethod
    def _extend_axis(v, axis):
        """R^{n-1} -> zero-sum R^n along `axis`."""
        n = v.shape[axis] + 1
        sum_v = torch.sum(v, dim=axis, keepdim=True)
        norm = sum_v / (math.sqrt(n) + n)
        fill = norm - sum_v / math.sqrt(n)
        return torch.cat([v, fill], dim=axis) - norm

    def forward(self, x, env=None, memo=None):
        for i in range(self.n_zerosum_axes):
            x = self._extend_axis_rev(x, -(i + 1))
        return x

    def backward(self, v, env=None, memo=None):
        for i in reversed(range(self.n_zerosum_axes)):
            v = self._extend_axis(v, -(i + 1))
        return v

    def log_jac_det(self, v, env=None, memo=None):
        return torch.zeros(v.shape[: v.ndim - self.n_zerosum_axes], dtype=v.dtype,
                           device=v.device)

    def value_shape(self, shape):
        shape = list(shape)
        for i in range(self.n_zerosum_axes):
            shape[-(i + 1)] -= 1
        return tuple(shape)

    def constrained_shape(self, value_shape):
        shape = list(value_shape)
        for i in range(self.n_zerosum_axes):
            shape[-(i + 1)] += 1
        return tuple(shape)

    def __repr__(self):
        return f"ZeroSumTransform(n_zerosum_axes={self.n_zerosum_axes})"


_LOG_TINY = math.log(1e-30)  # the JAX package's floor of 1e-30 on a remainder


@functools.cache
def _tril_maps(n, k, device):
    """The index maps of the packed lower triangle of an n x n matrix
    (offset k, row-major) on `device`: the flat matrix positions it packs,
    the packed position each matrix entry unpacks from (m, the length of
    the packed vector, for an entry outside the triangle: a zero slot), the
    mask of the diagonal within the packed vector, and the diagonal's
    packed positions."""
    rows, cols = np.tril_indices(n, k)
    m = len(rows)
    unpack = np.full(n * n, m, dtype=np.int64)
    unpack[rows * n + cols] = np.arange(m)
    on_diag = rows == cols
    return (torch.as_tensor(rows * n + cols, device=device),
            torch.as_tensor(unpack, device=device),
            torch.as_tensor(on_diag, device=device),
            torch.as_tensor(np.nonzero(on_diag)[0], device=device))


def tril_pack(M, k=0):
    """The lower triangle (offset k) of (..., n, n) as a (..., m) vector."""
    n = M.shape[-1]
    return M.reshape(M.shape[:-2] + (n * n,))[..., _tril_maps(n, k, M.device)[0]]


def tril_unpack(v, n, k=0):
    """A (..., m) packed lower triangle (offset k) as (..., n, n), zero
    above it."""
    padded = torch.nn.functional.pad(v, (0, 1))
    return padded[..., _tril_maps(n, k, v.device)[1]].reshape(v.shape[:-1] + (n, n))


def packed_diag(v, n):
    """The n diagonal entries of a packed (..., n (n + 1) / 2) lower
    triangle."""
    return v[..., _tril_maps(n, 0, v.device)[3]]


def _map_diag(v, n, fn):
    """fn applied to the diagonal entries of a packed lower triangle only
    (the others never pass through fn, so a zero off the diagonal gives
    fn = log no infinite gradient)."""
    mask = _tril_maps(n, 0, v.device)[2]
    return torch.where(mask, fn(torch.where(mask, v, 1.0)), v)


class CholeskyCovPackedTransform(Transform):
    """A packed lower-triangular Cholesky factor <-> the same with its
    diagonal entries logged (pymc_tpu transforms.py:381)."""

    name = "cholesky-cov-packed"
    event_ndim = 1

    def __init__(self, n):
        self.n = int(n)

    def forward(self, x, env=None, memo=None):
        return _map_diag(x, self.n, torch.log)

    def backward(self, v, env=None, memo=None):
        return _map_diag(v, self.n, torch.exp)

    def log_jac_det(self, v, env=None, memo=None):
        return torch.sum(packed_diag(v, self.n), dim=-1)

    def __repr__(self):
        return f"CholeskyCovPackedTransform(n={self.n})"


class CholeskyCovTransform(Transform):
    """A (..., n, n) symmetric positive-definite matrix <-> the packed
    Cholesky factor with its diagonal logged (pymc_tpu transforms.py:403,
    Wishart's default). The factor in `forward` is the Cholesky kernel's
    (`ops.linalg.cholesky_batched`). log|det| = n log 2 + sum_i (n - i + 1)
    v_ii over the 0-indexed diagonal entries v_ii."""

    name = "cholesky-cov"
    event_ndim = 2

    def __init__(self, n):
        self.n = int(n)

    def value_shape(self, shape):
        return tuple(shape[:-2]) + (self.n * (self.n + 1) // 2,)

    def constrained_shape(self, value_shape):
        return tuple(value_shape[:-1]) + (self.n, self.n)

    def forward(self, x, env=None, memo=None):
        from ..ops.linalg import cholesky_batched

        return _map_diag(tril_pack(cholesky_batched(x)), self.n, torch.log)

    def backward(self, v, env=None, memo=None):
        L = tril_unpack(_map_diag(v, self.n, torch.exp), self.n)
        return L @ L.transpose(-1, -2)

    def log_jac_det(self, v, env=None, memo=None):
        n = self.n
        coeff = n + 1 - torch.arange(n, dtype=v.dtype, device=v.device)
        return n * math.log(2.0) + torch.sum(coeff * packed_diag(v, n), dim=-1)

    def __repr__(self):
        return f"CholeskyCovTransform(n={self.n})"


class CholeskyCorrTransform(Transform):
    """R^{n(n-1)/2} <-> the packed strictly-lower entries (row-major) of the
    lower Cholesky factor W of a correlation matrix, by the canonical
    partial correlations z = tanh(v) (Stan's construction; pymc_tpu
    transforms.py:454). With R_ij = prod_{k<j} (1 - z_ik^2), the part of
    row i's unit norm left after its first j entries, W_ij = z_ij sqrt(R_ij)
    and W_ii = sqrt(R_ii): the JAX package's row loop as one cumulative sum
    of log(1 - z^2) (a cumulative product's backward under vmap takes
    torch's slow path for inputs that may hold zeros)."""

    name = "cholesky-corr"
    event_ndim = 1

    def __init__(self, n):
        self.n = int(n)

    def _log_remainders(self, z):
        """(Z (..., n, n) strictly lower, log R (..., n, n)) for packed z."""
        Z = tril_unpack(z, self.n, -1)
        log1m = torch.log1p(-(Z**2))
        return Z, torch.cumsum(torch.nn.functional.pad(log1m[..., :-1], (1, 0)), dim=-1)

    def _z_to_chol(self, z):
        Z, log_R = self._log_remainders(z)
        eye = torch.eye(self.n, dtype=z.dtype, device=z.device)
        return Z * torch.exp(0.5 * log_R) + eye * torch.exp(0.5 * torch.clamp(log_R, min=_LOG_TINY))

    def backward(self, v, env=None, memo=None):
        return tril_pack(self._z_to_chol(torch.tanh(v)), -1)

    def forward(self, x, env=None, memo=None):
        L = tril_unpack(x, self.n, -1)
        rem = 1.0 - torch.cumsum(torch.nn.functional.pad(L[..., :-1] ** 2, (1, 0)), dim=-1)
        z = tril_pack(L / torch.sqrt(torch.clamp(rem, min=1e-30)), -1)
        return torch.atanh(torch.clamp(z, -1 + 1e-12, 1 - 1e-12))

    def log_jac_det(self, v, env=None, memo=None):
        # |dW/dz| |dz/dv|: dz/dv = 1 - z^2, dW_ij/dz_ij = sqrt(R_ij)
        z = torch.tanh(v)
        _, log_R = self._log_remainders(z)
        half_log_R = tril_pack(0.5 * torch.clamp(log_R, min=_LOG_TINY), -1)
        return torch.sum(torch.log1p(-(z**2)) + half_log_R, dim=-1)

    def __repr__(self):
        return f"CholeskyCorrTransform(n={self.n})"


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
sum_to_1 = SumTo1Transform()

# the reference's names
Chain = ChainedTransform
CholeskyCovPacked = CholeskyCovPackedTransform
Interval = IntervalTransform
