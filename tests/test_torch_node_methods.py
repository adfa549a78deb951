"""The tensor methods and operators of pymc_tpu_torch's graph `Node`
against pymc_tpu's (`pymc_tpu/graph.py:138-363`), float64 on the CPU.

Each expression is built in both packages over the same free variables
and evaluated at the same values: `@` (and a numpy array's `@` a node),
`.T`, `dot`; `sum`, `mean`, `prod`, `max`, `min`, `std`, `var` (over all
axes, one axis and a tuple, with keepdims) and `cumsum`; `reshape`,
`flatten`, `ravel`, `squeeze`, `transpose`, `astype`; `abs`, `%`, `//`
(both sides), `&`, `|`, `~`, `==`, `!=`; and a tuple index holding an
integer array (`a[county, 0]`). Values must match to rtol 1e-12, with the
JAX package's shape and kind of dtype. Then `ndim`, `size`, `len`,
iteration, `x == x` (True, so a node is found by identity in a list or a
dict) and a tuple index under `torch.func.vmap`, as a model's logp+grad
evaluates it.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from pymc_tpu.graph import evaluate as evaluate_j
from pymc_tpu_torch.graph import evaluate as evaluate_t

X = np.array([[0.5, -1.25, 2.0], [-0.75, 3.5, 1.5]])
Y = np.arange(1.0, 13.0).reshape(3, 4) / 4.0
W = np.array([0.2, -0.4, 1.1])
IX = np.array([1, 0, 1, 1])

EXPRESSIONS = {
    "matmul": lambda x, y, w: x @ y,
    "matmul_T": lambda x, y, w: (x @ y).T,
    "rmatmul": lambda x, y, w: np.ones((4, 2)) @ x,
    "dot_matrix": lambda x, y, w: x.dot(y),
    "dot_vector": lambda x, y, w: x.dot(w),
    "dot_vectors": lambda x, y, w: w.dot(w),
    "T": lambda x, y, w: x.T,
    "sum": lambda x, y, w: x.sum(),
    "sum_axis": lambda x, y, w: x.sum(axis=0),
    "sum_axes_keepdims": lambda x, y, w: x.sum(axis=(0, 1), keepdims=True),
    "mean_axis": lambda x, y, w: x.mean(axis=1),
    "prod": lambda x, y, w: x.prod(),
    "prod_axis": lambda x, y, w: x.prod(axis=0, keepdims=True),
    "prod_axes": lambda x, y, w: y.prod(axis=(0, 1)),
    "max": lambda x, y, w: x.max(),
    "min_axis": lambda x, y, w: x.min(axis=1),
    "std": lambda x, y, w: x.std(),
    "var_axis": lambda x, y, w: x.var(axis=0),
    "cumsum": lambda x, y, w: x.cumsum(),
    "cumsum_axis": lambda x, y, w: x.cumsum(axis=1),
    "reshape": lambda x, y, w: x.reshape(3, 2),
    "reshape_tuple": lambda x, y, w: x.reshape((6,)),
    "flatten": lambda x, y, w: x.flatten(),
    "ravel": lambda x, y, w: x.ravel(),
    "squeeze": lambda x, y, w: x.reshape(1, 6).squeeze(),
    "squeeze_axis": lambda x, y, w: x.reshape(1, 6, 1).squeeze(0),
    "transpose": lambda x, y, w: x.transpose(),
    "transpose_axes": lambda x, y, w: y.reshape(3, 2, 2).transpose(1, 0, 2),
    "transpose_tuple": lambda x, y, w: x.transpose((1, 0)),
    "astype": lambda x, y, w: (x * 4).astype("int64"),
    "abs": lambda x, y, w: abs(x),
    "mod": lambda x, y, w: x % 1.5,
    "rmod": lambda x, y, w: 1.5 % x,
    "floordiv": lambda x, y, w: x // 0.7,
    "rfloordiv": lambda x, y, w: 7.0 // x,
    "and": lambda x, y, w: (x > 0) & (x < 1),
    "or": lambda x, y, w: (x > 0) | (x < -1),
    "invert": lambda x, y, w: ~(x > 0),
    "eq": lambda x, y, w: x == 0.5,
    "eq_nodes": lambda x, y, w: x == x * 1.0,
    "ne": lambda x, y, w: x != 0.5,
    "tuple_index": lambda x, y, w: x[IX, 0],
    "tuple_index_slice": lambda x, y, w: y[:, np.array([2, 0])],
    "array_index": lambda x, y, w: x[np.array([1, 0])],
}


def _vars(pm):
    with pm.Model():
        return (pm.Normal("x", 0.0, 1.0, shape=(2, 3)), pm.Normal("y", 0.0, 1.0, shape=(3, 4)),
                pm.Normal("w", 0.0, 1.0, shape=3))


@pytest.fixture(scope="module")
def both():
    return _vars(pmj), _vars(pmt)


@pytest.mark.parametrize("name", sorted(EXPRESSIONS))
def test_method_matches(both, name):
    (xj, yj, wj), (xt, yt, wt) = both
    ej, et = EXPRESSIONS[name](xj, yj, wj), EXPRESSIONS[name](xt, yt, wt)
    assert tuple(et.shape) == tuple(ej.shape)
    ref = np.asarray(evaluate_j(ej, {"x": jnp.asarray(X), "y": jnp.asarray(Y),
                                     "w": jnp.asarray(W)}))
    got = evaluate_t(et, {"x": torch.as_tensor(X), "y": torch.as_tensor(Y),
                          "w": torch.as_tensor(W)}).numpy()
    assert got.shape == ref.shape and got.dtype.kind == ref.dtype.kind
    np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_sizes_iteration_and_identity(both):
    (xj, _, _), (xt, yt, _) = both
    assert (xt.ndim, xt.size, len(xt)) == (xj.ndim, xj.size, len(xj)) == (2, 6, 2)
    rows = list(xt)
    assert len(rows) == 2 and all(tuple(r.shape) == (3,) for r in rows)
    np.testing.assert_allclose(evaluate_t(rows[1], {"x": torch.as_tensor(X)}).numpy(), X[1])
    assert (xt == xt) is True and (xt != xt) is False
    assert xt in [xt] and {xt: 1}[xt] == 1 and (xt == None) is False  # noqa: E711
    with pytest.raises(TypeError, match="len"):
        len(xt.sum())


def test_tuple_index_under_vmap():
    with pmt.Model() as m:
        ab = pmt.Normal("ab", 0.0, 1.0, shape=(3, 2))
        pmt.Potential("p", (ab[IX, 0] * ab[IX, 1]).sum() + (ab.T @ ab).sum())
    q = torch.as_tensor(np.random.default_rng(0).normal(size=(5, 6)))
    lp, grad = m.logp_dlogp_fn(device="cpu")(q)
    a = q.reshape(5, 3, 2)
    want = (-0.5 * q**2).sum(-1) - 6 * 0.5 * np.log(2 * np.pi)
    want = want + (a[:, IX, 0] * a[:, IX, 1]).sum(-1) + (a.transpose(1, 2) @ a).sum((-1, -2))
    np.testing.assert_allclose(lp.numpy(), want.numpy(), rtol=1e-12)
    assert grad.shape == q.shape and torch.isfinite(grad).all()
