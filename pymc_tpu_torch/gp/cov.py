"""GP covariance functions.

Counterpart of `pymc_tpu/gp/cov.py` (reference pymc/gp/cov.py): the
covariance algebra (+, *, **), Constant, WhiteNoise, the stationary family
(ExpQuad, RatQuad, Matern52, Matern32, Matern12, Exponential, Cosine,
Periodic), Linear, Polynomial, WarpedInput, Gibbs, ScaledCov, Coregion,
Kron, Exponentiated, Circular and WrappedPeriodic, with the power spectral
densities that HSGP reads. Hyperparameters may be graph Nodes (RV outputs);
the kernel matrix is then a Node evaluated inside the model logp.
A stationary kernel with a scalar lengthscale on concrete inputs computes
the pairwise squared distances once, when the model is built, so each logp
only scales them (the JAX package's isotropic hoist, cov.py:275-287, where
XLA folds the constant instead).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..graph import Node, apply, as_tensor

__all__ = [
    "Covariance", "Constant", "WhiteNoise", "ExpQuad", "RatQuad", "Matern52",
    "Matern32", "Matern12", "Exponential", "Cosine", "Periodic", "Linear",
    "Polynomial", "WarpedInput", "Gibbs", "ScaledCov", "Coregion", "Kron",
    "Exponentiated", "Circular", "WrappedPeriodic", "Stationary",
    "Combination", "Add", "Prod", "handle_args",
]


def _float(c, X):
    """c as a tensor of X's float type on X's device; a Python number is
    filled in place, not copied from the host (a CUDA graph can capture a
    fill, not a copy)."""
    dtype = X.dtype if X.is_floating_point() else torch.float64
    if isinstance(c, torch.Tensor):
        return c.to(dtype)
    if np.ndim(c) == 0:
        return torch.full((), float(c), dtype=dtype, device=X.device)
    return torch.as_tensor(c, dtype=dtype, device=X.device)


# orders above J where the backward recurrence of I_j / I_{j-1} starts
_BESSEL_EXTRA = 100


def _ones(X):
    return torch.ones((X.shape[0],), dtype=X.dtype, device=X.device)


class Covariance:
    """Base covariance. Subclasses implement `_full(X, Xs, *params)` in
    PyTorch and list their (possibly symbolic) `_param_list()`."""

    # make `ndarray + cov` / `ndarray * cov` defer to __radd__/__rmul__
    # instead of numpy broadcasting the Covariance into an object array
    __array_ufunc__ = None

    def __init__(self, input_dim, active_dims=None):
        self.input_dim = int(input_dim)
        if active_dims is None:
            self.active_dims = np.arange(input_dim)
        else:
            self.active_dims = np.asarray(active_dims, dtype=int)
            if self.active_dims.size and self.active_dims.max() > self.input_dim:
                raise ValueError("Values in `active_dims` can't be larger than `input_dim`.")

    # -- public API --------------------------------------------------------
    def __call__(self, X, Xs=None, diag=False):
        if diag:
            return self.diag(X)
        return self.full(X, Xs)

    def full(self, X, Xs=None):
        params = self._param_list()
        if Xs is None:
            return apply(lambda Xc, *ps: self._full(self._slice(Xc), None, *ps), X, *params)
        return apply(
            lambda Xc, Xsc, *ps: self._full(self._slice(Xc), self._slice(Xsc), *ps),
            X, Xs, *params,
        )

    def diag(self, X):
        return apply(lambda Xc, *ps: self._diag(self._slice(Xc), *ps), X, *self._param_list())

    def _param_list(self):
        return []

    def _slice(self, X):
        # always index by active_dims (reference cov.py:195): repeated
        # indices like active_dims=[0, 0, 1] are meaningful
        X = as_tensor(X)
        if X.ndim == 1:
            X = X[:, None]
        # the index, made once per device (no host copy in a later call)
        index = self.__dict__.setdefault("_active_index", {})
        if X.device not in index:
            index[X.device] = torch.as_tensor(self.active_dims, device=X.device)
        return X[..., index[X.device]]

    def _diag(self, X, *params):
        return torch.diagonal(self._full(X, None, *params))

    # -- algebra -----------------------------------------------------------
    def __add__(self, other):
        return _Add(self, _as_cov(other, self.input_dim))

    def __radd__(self, other):
        return _Add(_as_cov(other, self.input_dim), self)

    def __mul__(self, other):
        return _Prod(self, _as_cov(other, self.input_dim))

    def __rmul__(self, other):
        return _Prod(_as_cov(other, self.input_dim), self)

    def __pow__(self, other):
        if isinstance(other, Covariance) or (
            not isinstance(other, Node) and np.ndim(other) > 0
        ):
            raise ValueError("A covariance function can only be exponentiated by a scalar value")
        return _Pow(self, other)

    def power_spectral_density(self, omega):
        raise ValueError(
            "Power spectral densities can only be calculated for `Stationary` "
            "covariance functions."
        )


class _Scalar(Covariance):
    """A scalar or fixed (n, n) matrix as a term of the covariance algebra:
    scalars add and scale elementwise, matrices add and multiply
    elementwise, diag takes the matrix diagonal."""

    def __init__(self, c, input_dim=1):
        super().__init__(input_dim)
        self.c = c

    def __pow__(self, other):
        # reference parity: only proper covariance functions support **
        raise TypeError(
            "Can only exponentiate covariance functions which inherit from `Covariance`"
        )

    def _param_list(self):
        return [self.c]

    def _full(self, X, Xs, c):
        n = X.shape[0]
        m = n if Xs is None else Xs.shape[0]
        c = _float(c, X)
        if c.ndim == 2:
            return c
        return torch.broadcast_to(c, (n, m))

    def _diag(self, X, c):
        c = _float(c, X)
        if c.ndim == 2:
            return torch.diagonal(c)
        return torch.broadcast_to(c, (X.shape[0],))


def handle_args(func):
    """Adapt a warping/scaling/lengthscale function to the canonical
    `f(x, args=...)` calling convention (reference gp/cov.py handle_args):
    `args=None` -> `func(x)`, a tuple -> unpacked, anything else -> passed as
    one extra argument."""

    def f(x, args=None):
        if args is None:
            return func(x)
        if isinstance(args, tuple):
            return func(x, *args)
        return func(x, args)

    return f


def _as_cov(x, input_dim):
    if isinstance(x, Covariance):
        return x
    if not isinstance(x, Node) and np.ndim(x) > 2:
        raise ValueError(
            f"cannot combine a {np.ndim(x)}-d array with a covariance function; "
            "only scalars and (n, n) matrices are valid factors"
        )
    return _Scalar(x, input_dim)


class _Binary(Covariance):
    def __init__(self, a, b):
        super().__init__(max(a.input_dim, b.input_dim))
        self.a, self.b = a, b

    def diag(self, X):
        return apply(self._op, self.a.diag(X), self.b.diag(X))

    def full(self, X, Xs=None):
        return apply(self._op, self.a.full(X, Xs), self.b.full(X, Xs))


class _Add(_Binary):
    @staticmethod
    def _op(x, y):
        return x + y

    def power_spectral_density(self, omega):
        return apply(
            torch.add, self.a.power_spectral_density(omega), self.b.power_spectral_density(omega)
        )


class _Prod(_Binary):
    @staticmethod
    def _op(x, y):
        return x * y

    def power_spectral_density(self, omega):
        # scalar amplitude times a stationary kernel: S = c * S_base
        for scale, base in ((self.a, self.b), (self.b, self.a)):
            if isinstance(scale, _Scalar):
                return apply(
                    lambda c, s: _float(c, s) * s, scale.c, base.power_spectral_density(omega)
                )
        raise NotImplementedError(
            "The power spectral density of products of covariance functions is not "
            "implemented (only scalar * stationary)"
        )


class _Pow(Covariance):
    def __init__(self, base, exponent):
        super().__init__(base.input_dim)
        self.base = base
        self.exponent = exponent

    def full(self, X, Xs=None):
        return apply(lambda k, e: k**e, self.base.full(X, Xs), self.exponent)

    def diag(self, X):
        return apply(lambda k, e: k**e, self.base.diag(X), self.exponent)


class Constant(_Scalar):
    """Reference gp/cov.py Constant."""


class WhiteNoise(Covariance):
    def __init__(self, sigma):
        super().__init__(1)
        self.sigma = sigma

    def _param_list(self):
        return [self.sigma]

    def _full(self, X, Xs, sigma):
        if Xs is None:
            eye = torch.eye(X.shape[0], dtype=X.dtype, device=X.device)
            return _float(sigma, X) ** 2 * eye
        return torch.zeros((X.shape[0], Xs.shape[0]), dtype=X.dtype, device=X.device)

    def _diag(self, X, sigma):
        return torch.broadcast_to(_float(sigma, X) ** 2, (X.shape[0],))


def _sqdist_raw(X, Xs):
    # ||x||^2 + ||y||^2 - 2 x.y, the cross term one matmul
    x2 = torch.sum(X**2, dim=-1)
    y2 = x2 if Xs is X else torch.sum(Xs**2, dim=-1)
    sq = x2[:, None] + y2[None, :] - 2.0 * (X @ Xs.T)
    return torch.clamp_min(sq, 0.0)


def _is_scalar(ls):
    shape = tuple(ls.shape) if isinstance(ls, (Node, torch.Tensor)) else np.shape(ls)
    return shape in ((), (1,))


def _inv_sq(ls):
    """1 / ls^2 for a scalar (or one-element) lengthscale."""
    if isinstance(ls, torch.Tensor):
        return 1.0 / torch.square(ls.reshape(()))
    return 1.0 / float(np.reshape(ls, ())) ** 2


def _sqdist(X, Xs, ls):
    # isotropic: sqdist(X / ls) == sqdist(X) / ls^2 for a scalar ls
    if _is_scalar(ls):
        return _sqdist_raw(X, X if Xs is None else Xs) * _inv_sq(ls)
    ls = _float(ls, X)
    Xl = X / ls
    Xsl = Xl if Xs is None else Xs / ls
    return _sqdist_raw(Xl, Xsl)


def _dist(sq):
    # the distance, kept differentiable at 0 as the JAX package keeps it
    return torch.sqrt(sq + 1e-12)


def _ls_vector(ls, omega):
    """(D,) lengthscales of omega's float type, D = omega's last dim."""
    return torch.broadcast_to(_float(ls, omega), (omega.shape[-1],))


class _Stationary(Covariance):
    """ls: scalar or (input_dim,) lengthscales (possibly symbolic).
    Subclasses map the scaled squared distance to the kernel in
    `_from_sqdist(sq, *params)`, where params are `_param_list()[1:]`."""

    def __init__(self, input_dim, ls=None, ls_inv=None, active_dims=None):
        super().__init__(input_dim, active_dims)
        if ls is None and ls_inv is None:
            ls = 1.0
        if ls is None:
            ls = (
                apply(lambda li: 1.0 / li, ls_inv)
                if isinstance(ls_inv, Node)
                else 1.0 / np.asarray(ls_inv)
            )
        if not isinstance(ls, Node) and not np.isscalar(ls):
            ls = np.asarray(ls)
        self.ls = ls

    def _param_list(self):
        return [self.ls]

    def _from_sqdist(self, sq, *params):  # pragma: no cover - abstract
        raise NotImplementedError

    def _full(self, X, Xs, ls, *params):
        return self._from_sqdist(_sqdist(X, Xs, ls), *params)

    def full(self, X, Xs=None):
        if isinstance(X, Node) or isinstance(Xs, Node) or not _is_scalar(self.ls):
            return super().full(X, Xs)
        # the hoist: the unscaled distances of concrete inputs, computed once
        Xc = self._slice(X)
        sq = _sqdist_raw(Xc, Xc if Xs is None else self._slice(Xs))
        return apply(
            lambda s, ls, *ps: self._from_sqdist(s * _inv_sq(ls), *ps),
            sq, *self._param_list(),
        )

    def _diag(self, X, *params):
        return _ones(X)

    def power_spectral_density(self, omega):
        raise NotImplementedError(
            f"No power spectral density method has been implemented for {type(self).__name__}"
        )


class ExpQuad(_Stationary):
    def _from_sqdist(self, sq):
        return torch.exp(-0.5 * sq)

    def power_spectral_density(self, omega):
        """S(w) = prod_d sqrt(2 pi) l_d * exp(-0.5 sum_d (l_d w_d)^2)."""

        def psd(om, ls):
            om = torch.atleast_2d(om)
            ls_v = _ls_vector(ls, om)
            u2 = torch.sum((ls_v * om) ** 2, dim=-1)
            return torch.prod(math.sqrt(2.0 * math.pi) * ls_v) * torch.exp(-0.5 * u2)

        return apply(psd, omega, self.ls)


class _Matern(_Stationary):
    nu = None

    def _matern_psd(self, om, ls):
        om = torch.atleast_2d(om)
        D = om.shape[-1]
        ls_v = _ls_vector(ls, om)
        u2 = torch.sum((ls_v * om) ** 2, dim=-1)
        nu = self.nu
        log_c = (
            D * math.log(2.0) + (D / 2.0) * math.log(math.pi) + math.lgamma(nu + D / 2.0)
            + nu * math.log(2.0 * nu) - math.lgamma(nu)
        )
        return torch.prod(ls_v) * torch.exp(log_c - (nu + D / 2.0) * torch.log(2.0 * nu + u2))

    def power_spectral_density(self, omega):
        return apply(self._matern_psd, omega, self.ls)


class Matern52(_Matern):
    nu = 2.5

    def _from_sqdist(self, sq):
        r = _dist(sq)
        s5r = math.sqrt(5.0) * r
        return (1.0 + s5r + 5.0 / 3.0 * r**2) * torch.exp(-s5r)


class Matern32(_Matern):
    nu = 1.5

    def _from_sqdist(self, sq):
        s3r = math.sqrt(3.0) * _dist(sq)
        return (1.0 + s3r) * torch.exp(-s3r)


class Matern12(_Matern):
    nu = 0.5

    def _from_sqdist(self, sq):
        return torch.exp(-_dist(sq))


class Exponential(_Stationary):
    """exp(-r / 2) on the ls-scaled distance (reference cov.py Exponential,
    not Matern12's exp(-r))."""

    def _from_sqdist(self, sq):
        return torch.exp(-0.5 * _dist(sq))


class RatQuad(_Stationary):
    def __init__(self, input_dim, alpha, ls=None, ls_inv=None, active_dims=None):
        super().__init__(input_dim, ls, ls_inv, active_dims)
        self.alpha = alpha

    def _param_list(self):
        return [self.ls, self.alpha]

    def _from_sqdist(self, sq, alpha):
        return (1.0 + sq / (2.0 * alpha)) ** (-alpha)


class Cosine(_Stationary):
    def _from_sqdist(self, sq):
        return torch.cos(2.0 * math.pi * _dist(sq))


class Periodic(_Stationary):
    """exp(-0.5 sum_d (sin(pi (x_d - x'_d) / period) / ls_d)^2), the
    reference's convention without the GPML factor 4."""

    def __init__(self, input_dim, period, ls=None, ls_inv=None, active_dims=None):
        super().__init__(input_dim, ls, ls_inv, active_dims)
        self.period = period

    def _param_list(self):
        return [self.ls, self.period]

    # per-dimension differences, so there is no distance matrix to hoist
    full = Covariance.full

    def _full(self, X, Xs, ls, period):
        Xs_ = X if Xs is None else Xs
        diff = X[:, None, :] - Xs_[None, :, :]
        sin2 = torch.sin(math.pi * diff / _float(period, X)) ** 2
        return torch.exp(-0.5 * torch.sum(sin2 / _float(ls, X) ** 2, dim=-1))

    def power_spectral_density_approx(self, J):
        """Coefficients of the HSGPPeriodic expansion (reference cov.py
        Periodic.power_spectral_density_approx): 2 I_j(a) / exp(a) with
        a = 1 / ls^2, the j = 0 term halved.

        I_j(a) e^-a comes from i0e(a) and the ratios I_j / I_{j-1}, which a
        backward recurrence started _BESSEL_EXTRA orders above J gives to
        ~1e-13 for ls >= 0.05. The JAX package runs the recurrence upward
        from i0e and i1e, which loses every digit where j exceeds a (its
        coefficients for ls = 1.7 and j >= 7 are noise, floored at 1e-30);
        the port keeps PyMC's values, `ive(j, a)`, and agrees with the JAX
        package wherever its recurrence is accurate."""

        def coeffs(ls):
            ls = ls if isinstance(ls, torch.Tensor) else torch.as_tensor(ls, dtype=torch.float64)
            a = 1.0 / ls**2
            r = torch.zeros_like(a)
            ratios = []
            for k in range(J - 1 + _BESSEL_EXTRA, 0, -1):
                r = 1.0 / (2.0 * k / a + r)
                if k < J:
                    ratios.append(r)
            i0 = torch.special.i0e(a)[None]
            if ratios:
                ive = torch.cat([i0, i0 * torch.cumprod(torch.stack(ratios[::-1]), dim=0)])
            else:
                ive = i0
            return torch.cat([ive[:1], 2.0 * ive[1:]])

        return apply(coeffs, self.ls)


class Linear(Covariance):
    def __init__(self, input_dim, c, active_dims=None):
        super().__init__(input_dim, active_dims)
        self.c = c

    def _param_list(self):
        return [self.c]

    def _full(self, X, Xs, c):
        c = _float(c, X)
        Xc = X - c
        Xsc = Xc if Xs is None else Xs - c
        return Xc @ Xsc.T

    def _diag(self, X, c):
        return torch.sum((X - _float(c, X)) ** 2, dim=-1)


class Polynomial(Linear):
    def __init__(self, input_dim, c, d, offset, active_dims=None):
        super().__init__(input_dim, c, active_dims)
        self.d = d
        self.offset = offset

    def _param_list(self):
        return [self.c, self.d, self.offset]

    def _full(self, X, Xs, c, d, offset):
        return (super()._full(X, Xs, c) + offset) ** d

    def _diag(self, X, c, d, offset):
        return (super()._diag(X, c) + offset) ** d


class WarpedInput(Covariance):
    """k(w(x), w(x')) (reference cov.py WarpedInput)."""

    def __init__(self, input_dim, cov_func, warp_func, args=None, active_dims=None):
        super().__init__(input_dim, active_dims)
        self.cov_func = cov_func
        self.warp_func = warp_func
        self.args = args if args is not None else ()

    def _warp(self, X):
        return apply(lambda x, *a: self.warp_func(as_tensor(x), *a), X, *self.args)

    def full(self, X, Xs=None):
        return self.cov_func.full(self._warp(X), None if Xs is None else self._warp(Xs))

    def diag(self, X):
        return self.cov_func.diag(self._warp(X))


class Gibbs(Covariance):
    """Non-stationary varying-lengthscale kernel (reference cov.py Gibbs)."""

    def __init__(self, input_dim, lengthscale_func, args=None, active_dims=None):
        super().__init__(input_dim, active_dims)
        self.lfunc = lengthscale_func
        self.args = args if args is not None else ()

    def full(self, X, Xs=None):
        def k_full(Xc, Xsc, *a):
            x = self._slice(Xc)
            rx = torch.ravel(self.lfunc(torch.ravel(x), *a))
            if Xsc is None:
                xs, rz = x, rx
            else:
                xs = self._slice(Xsc)
                rz = torch.ravel(self.lfunc(torch.ravel(xs), *a))
            rx2 = rx[:, None] ** 2
            rz2 = rz[None, :] ** 2
            sq = (x[:, None, 0] - xs[None, :, 0]) ** 2
            coef = torch.sqrt(2.0 * rx[:, None] * rz[None, :] / (rx2 + rz2))
            return coef * torch.exp(-sq / (rx2 + rz2))

        if Xs is None:
            return apply(lambda Xc, *a: k_full(Xc, None, *a), X, *self.args)
        return apply(k_full, X, Xs, *self.args)

    def diag(self, X):
        return apply(lambda Xc: _ones(as_tensor(Xc)), X)


class ScaledCov(Covariance):
    """phi(x) k(x, x') phi(x') (reference cov.py ScaledCov)."""

    def __init__(self, input_dim, cov_func, scaling_func, args=None, active_dims=None):
        super().__init__(input_dim, active_dims)
        self.cov_func = cov_func
        self.sfunc = scaling_func
        self.args = args if args is not None else ()

    def _scale(self, Xc, *a):
        return torch.ravel(self.sfunc(self._slice(Xc), *a))

    def full(self, X, Xs=None):
        K = self.cov_func.full(X, Xs)

        def scale(k, Xc, Xsc, *a):
            sx = self._scale(Xc, *a)
            sz = sx if Xsc is None else self._scale(Xsc, *a)
            return sx[:, None] * k * sz[None, :]

        if Xs is None:
            return apply(lambda k, Xc, *a: scale(k, Xc, None, *a), K, X, *self.args)
        return apply(scale, K, X, Xs, *self.args)

    def diag(self, X):
        return apply(
            lambda dd, Xc, *a: self._scale(Xc, *a) ** 2 * dd,
            self.cov_func.diag(X), X, *self.args,
        )


class Coregion(Covariance):
    """B[i, j] lookup kernel for multi-output GPs (reference cov.py Coregion)."""

    def __init__(self, input_dim, W=None, kappa=None, B=None, active_dims=None):
        super().__init__(input_dim, active_dims)
        if len(self.active_dims) != 1:
            raise ValueError(
                "Coregion requires exactly one active dimension (the integer output-index "
                "column); pass active_dims=[i]"
            )
        if B is None:
            if W is None or kappa is None:
                raise ValueError("Coregion requires B or (W, kappa)")
            self.W, self.kappa, self.B = W, kappa, None
        else:
            if W is not None or kappa is not None:
                raise ValueError("Coregion takes either B or (W, kappa), not both")
            self.B = B
            self.W = self.kappa = None

    def _param_list(self):
        if self.B is not None:
            return [self.B]
        return [self.W, self.kappa]

    def _matrix(self, X, params):
        if self.B is not None:
            return _float(params[0], X)
        W, kappa = (_float(p, X) for p in params)
        return W @ W.T + torch.diag(kappa)

    def _full(self, X, Xs, *params):
        B = self._matrix(X, params)
        i = X[:, 0].long()
        j = i if Xs is None else Xs[:, 0].long()
        return B[i][:, j]

    def _diag(self, X, *params):
        return torch.diagonal(self._matrix(X, params))[X[:, 0].long()]


class Kron(Covariance):
    """Kronecker product over input blocks (reference cov.py Kron): X's
    columns are split into each factor's block and the factor kernels
    multiplied elementwise, which on a cartesian-product grid is the
    Kronecker-product Gram matrix."""

    def __init__(self, factor_list):
        self.factors = list(factor_list)
        super().__init__(sum(f.input_dim for f in self.factors))

    def _apply(self, X, Xs=None, diag=False):
        out = None
        off = 0
        for f in self.factors:
            cols = slice(off, off + f.input_dim)
            Xf = apply(lambda x, c=cols: as_tensor(x)[:, c], X)
            Xsf = None if Xs is None else apply(lambda x, c=cols: as_tensor(x)[:, c], Xs)
            Kf = f.diag(Xf) if diag else f.full(Xf, Xsf)
            out = Kf if out is None else apply(lambda a, b: a * b, out, Kf)
            off += f.input_dim
        return out

    def full(self, X, Xs=None):
        return self._apply(X, Xs, diag=False)

    def diag(self, X):
        return self._apply(X, diag=True)


class Exponentiated(Covariance):
    """kernel ** power (reference cov.py:337)."""

    def __init__(self, kernel, power):
        super().__init__(kernel.input_dim, kernel.active_dims)
        self.kernel = kernel
        self.power = power

    def full(self, X, Xs=None):
        return apply(lambda k, p: k**p, self.kernel.full(X, Xs), self.power)

    def diag(self, X):
        return apply(lambda k, p: k**p, self.kernel.diag(X), self.power)


class Circular(Covariance):
    """Weinland-function kernel on a circular domain [0, period) (reference
    cov.py:432; Padonou & Roustant 2015). 1-D."""

    def __init__(self, input_dim, period, tau=4, active_dims=None):
        super().__init__(input_dim, active_dims)
        self.period = period
        self.tau = tau

    def _param_list(self):
        return [self.period, self.tau]

    def _full(self, X, Xs, period, tau):
        Xs_ = X if Xs is None else Xs
        c = _float(period, X) / 2.0
        d = X[:, None, 0] - Xs_[None, :, 0]
        t = torch.abs(torch.remainder(d + c, 2.0 * c) - c)
        return (1.0 + tau * t / c) * torch.clamp_min(1.0 - t / c, 0.0) ** tau

    def _diag(self, X, period, tau):
        return _ones(X)


class WrappedPeriodic(Covariance):
    """Periodic version of a stationary kernel: inputs warped by
    sin(pi (x - x') / period) (reference cov.py:976; MacKay 1998)."""

    def __init__(self, cov_func, period):
        if not isinstance(cov_func, _Stationary):
            raise TypeError("cov_func must be a Stationary covariance")
        super().__init__(cov_func.input_dim, cov_func.active_dims)
        self.cov_func = cov_func
        self.period = period

    def _param_list(self):
        return [self.cov_func.ls, self.period]

    def _full(self, X, Xs, ls, period):
        Xs_ = X if Xs is None else Xs
        diff = X[:, None, :] - Xs_[None, :, :]
        r = math.pi * diff / _float(period, X)
        r2 = torch.sum((torch.sin(r) / _float(ls, X)) ** 2, dim=-1)
        k = self.cov_func
        if isinstance(k, ExpQuad):
            return torch.exp(-0.5 * r2)
        if isinstance(k, RatQuad):
            alpha = k.alpha
            return (1.0 + r2 / (2.0 * alpha)) ** (-alpha)
        if isinstance(k, _Matern):
            rr = _dist(r2)
            if k.nu == 2.5:
                s = math.sqrt(5.0) * rr
                return (1.0 + s + 5.0 / 3.0 * r2) * torch.exp(-s)
            if k.nu == 1.5:
                s = math.sqrt(3.0) * rr
                return (1.0 + s) * torch.exp(-s)
            return torch.exp(-rr)
        raise NotImplementedError(f"WrappedPeriodic does not support {type(k).__name__}")

    def _diag(self, X, ls, period):
        return _ones(X)


# public aliases matching reference gp/cov.py class names
Stationary = _Stationary
Combination = _Binary
Add = _Add
Prod = _Prod
