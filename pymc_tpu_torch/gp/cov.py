"""GP covariance functions: the covariance algebra, Constant, WhiteNoise and
ExpQuad.

Counterpart of `pymc_tpu/gp/cov.py` (reference pymc/gp/cov.py), cut to what
the marginal and latent GP paths use. Hyperparameters may be graph Nodes (RV
outputs); the kernel matrix is then a Node evaluated inside the model logp.
A stationary kernel with a scalar lengthscale on concrete inputs computes
the pairwise squared distances once, when the model is built, so each logp
only scales them (the JAX package's isotropic hoist, cov.py:275-287, where
XLA folds the constant instead).
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph import Node, apply, as_tensor

__all__ = [
    "Covariance", "Constant", "WhiteNoise", "ExpQuad", "Stationary", "Combination",
    "Add", "Prod",
]


def _float(c, X):
    """c as a tensor of X's float type on X's device."""
    dtype = X.dtype if X.is_floating_point() else torch.float64
    if isinstance(c, torch.Tensor):
        return c.to(dtype)
    return torch.as_tensor(c, dtype=dtype, device=X.device)


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
        return X[..., torch.as_tensor(self.active_dims, device=X.device)]

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


class _Prod(_Binary):
    @staticmethod
    def _op(x, y):
        return x * y


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


class _Stationary(Covariance):
    """ls: scalar or (input_dim,) lengthscales (possibly symbolic).
    Subclasses map the scaled squared distance to the kernel in
    `_from_sqdist`."""

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

    def _from_sqdist(self, sq):  # pragma: no cover - abstract
        raise NotImplementedError

    def _full(self, X, Xs, ls):
        return self._from_sqdist(_sqdist(X, Xs, ls))

    def full(self, X, Xs=None):
        if isinstance(X, Node) or isinstance(Xs, Node) or not _is_scalar(self.ls):
            return super().full(X, Xs)
        # the hoist: the unscaled distances of concrete inputs, computed once
        Xc = self._slice(X)
        sq = _sqdist_raw(Xc, Xc if Xs is None else self._slice(Xs))
        return apply(lambda s, ls: self._from_sqdist(s * _inv_sq(ls)), sq, self.ls)

    def _diag(self, X, ls):
        return torch.ones((X.shape[0],), dtype=X.dtype, device=X.device)


class ExpQuad(_Stationary):
    def _from_sqdist(self, sq):
        return torch.exp(-0.5 * sq)


# public aliases matching reference gp/cov.py class names
Stationary = _Stationary
Combination = _Binary
Add = _Add
Prod = _Prod
