"""`pymc_tpu_torch.math` (`pm.math`) against `pymc_tpu.math`, float64 on
the CPU.

Each wrapper of the JAX module's `__all__`, on the same numpy input,
computed at once (no Node among the arguments): the values must agree,
rtol 1e-12 (1e-10 for the incomplete beta and gamma, where the port's
continued fraction and torch's series stand in for JAX's). Then each
elementwise and reducing wrapper applied to a free variable of a model,
which must build a node of the graph whose value under an env matches
the JAX package's node; `sigmoid` keeps torch.sigmoid as its node's
function, which the discrete distributions match. `iv` and `kv` raise
until `ops/special.py` is ported; `logbern` draws from a generator.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pymc_tpu as pmj
import pymc_tpu.math as mj
import pymc_tpu_torch as pmt
import pymc_tpu_torch.math as mt
from pymc_tpu.graph import evaluate as evaluate_j
from pymc_tpu_torch.graph import DeterministicNode, evaluate as evaluate_t

RTOL = 1e-12
rng = np.random.default_rng(7)
X = rng.normal(0.0, 1.5, size=(3, 4))
U = rng.uniform(0.05, 0.95, size=(3, 4))  # inside (0, 1)
P = rng.uniform(0.5, 3.0, size=(3, 4))  # positive
BIG = rng.uniform(1.1, 3.0, size=(3, 4))  # above 1
NEG = -P  # below 0
Y = rng.normal(0.0, 1.0, size=(3, 4))
A = rng.normal(size=(3, 3))
SPD = A @ A.T + 3.0 * np.eye(3)
L = np.linalg.cholesky(SPD)
B = rng.normal(size=(2, 2))
V3, V4 = rng.normal(size=3), rng.normal(size=4)

# name -> (args, kwargs); the arguments are numpy arrays or numbers
CASES = {
    **{n: ((X,), {}) for n in (
        "abs", "exp", "cbrt", "square", "sgn", "sign", "ceil", "floor", "round", "trunc", "sin",
        "cos", "tan", "arctan", "sinh", "cosh", "tanh", "arcsinh", "erf", "erfc", "sigmoid",
        "invlogit", "invprobit", "softplus", "log1pexp", "expm1", "exprel", "ones_like",
        "zeros_like", "sqr", "flatten", "tril", "triu", "argsort", "sort", "floatX")},
    **{n: ((P,), {}) for n in ("log", "log1p", "log2", "log10", "sqrt", "gammaln", "digamma",
                               "i0", "i1", "gamma")},
    **{n: ((U,), {}) for n in ("arcsin", "arccos", "arctanh", "logit", "probit", "erfinv",
                               "erfcinv")},
    "arccosh": ((BIG,), {}),
    "log1mexp": ((NEG,), {}),
    "arctan2": ((X, Y), {}),
    "logaddexp": ((X, Y), {}),
    "logdiffexp": ((np.maximum(X, Y) + 0.1, np.minimum(X, Y)), {}),
    "maximum": ((X, Y), {}),
    "minimum": ((X, Y), {}),
    "eq": ((X, np.where(U > 0.5, X, Y)), {}),
    "neq": ((X, np.where(U > 0.5, X, Y)), {}),
    "lt": ((X, Y), {}), "gt": ((X, Y), {}), "le": ((X, Y), {}), "ge": ((X, Y), {}),
    "and_": ((X > 0, Y > 0), {}), "or_": ((X > 0, Y > 0), {}),
    "where": ((X > 0, X, Y), {}), "switch": ((X > 0, X, 0.5), {}),
    "clip": ((X, -0.5, 0.7), {}),
    "softmax": ((X,), {"axis": 0}), "log_softmax": ((X,), {"axis": -1}),
    "logsumexp": ((X,), {"axis": 1, "keepdims": True}),
    "sum": ((X,), {"axis": (0, 1)}), "prod": ((X,), {"axis": 0}), "mean": ((X,), {}),
    "max": ((X,), {"axis": 1}), "min": ((X,), {"keepdims": True}),
    "all": ((X > -3.0,), {}), "any": ((X > 2.0,), {"axis": 0}),
    "argmax": ((X,), {"axis": 1}), "argmin": ((X,), {}),
    "std": ((X,), {"axis": 0}), "var": ((X,), {}),
    "cumsum": ((X,), {"axis": 1}), "cumprod": ((U,), {}), "diff": ((X,), {"n": 2}),
    "dot": ((X, X.T), {}), "matmul": ((A, X), {}), "outer": ((V3, V4), {}),
    "tensordot": ((X, X), {"axes": 2}), "norm": ((X,), {}),
    "kronecker": ((A, B), {}), "kron": ((A, B), {}), "kron_diag": ((V3, V4), {}),
    "flat_outer": ((V3, V4), {}), "cartesian": ((V3, np.array([1.0, 2.0])), {}),
    "batched_diag": ((X,), {}), "extract_diag": ((A,), {}), "diag": ((V3,), {}),
    "trace": ((A,), {}), "transpose": ((X,), {}), "swapaxes": ((X, 0, 1), {}),
    "moveaxis": ((X, 0, 1), {}), "expand_dims": ((X, 1), {}), "squeeze": ((X[:1],), {}),
    "reshape": ((X, (4, 3)), {}), "repeat": ((V3, 2), {}), "tile": ((V3, 2), {}),
    "take": ((V4, np.array([3, 0, 1])), {}), "broadcast_to": ((V4, (3, 4)), {}),
    "logdet": ((SPD,), {}), "det": ((A,), {}), "matrix_inverse": ((SPD,), {}),
    "solve": ((SPD, V3), {}), "solve_triangular": ((L, V3), {"lower": True}),
    "cholesky": ((SPD,), {}), "block_diag": ((A, B), {}),
    "concatenate": (([X, Y],), {"axis": 1}), "stack": (([X, Y],), {"axis": 0}),
    "block_diagonal": (([A, B],), {}),
    "expand_packed_triangular": ((3, rng.normal(size=6)), {}),
    "full": (((2, 3), 1.5), {}), "full_like": ((X, 2.5), {}),
    "betainc": ((P, BIG, U), {}), "gammainc": ((P, BIG), {}), "gammaincc": ((P, BIG), {}),
    "polygamma": ((1, P), {}),
    "cho_solve": (((L, True), V3), {}),
    "kron_dot": (([A, B], rng.normal(size=6)), {}),
    "kron_solve_lower": (([L, np.linalg.cholesky(B @ B.T + np.eye(2))],
                          rng.normal(size=6)), {}),
    "kron_solve_upper": (([L, np.linalg.cholesky(B @ B.T + np.eye(2))],
                          rng.normal(size=6)), {}),
    "unique": ((np.array([3.0, 1.0, 3.0, 2.0]),), {}),
    "slogdet": ((A,), {}), "eigh": ((SPD,), {}),
    "broadcast_arrays": ((V4, X), {}),
    "flatten_list": (([X, V3],), {}),
    "zeros": (((2, 3),), {}), "ones": ((4,), {}), "eye": ((3,), {}),
    "arange": ((5,), {}), "linspace": ((0.0, 1.0, 7), {}),
    "as_tensor": ((X,), {}), "as_tensor_variable": ((X,), {}), "constant": ((X,), {}),
}
SPECIAL = {"betainc": 1e-10, "gammainc": 1e-10, "gammaincc": 1e-10}
NOT_COMPARED = {"iv", "kv", "logbern"}  # held in test_bessel_waits_for_ops_special / random
assert sorted(set(CASES) | NOT_COMPARED) == sorted(set(mj.__all__))
assert set(mt.__all__) == set(mj.__all__)


def _np(x):
    if isinstance(x, (tuple, list)):
        return [_np(v) for v in x]
    if isinstance(x, pmt.graph.Node):
        x = evaluate_t(x)
    elif isinstance(x, pmj.graph.Node):
        x = evaluate_j(x)
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


@pytest.mark.parametrize("name", sorted(CASES))
def test_wrapper_matches(name):
    args, kwargs = CASES[name]
    got, ref = _np(getattr(mt, name)(*args, **kwargs)), _np(getattr(mj, name)(*args, **kwargs))
    for g, r in zip(*(([got], [ref]) if not isinstance(got, list) else (got, ref))):
        g, r = np.asarray(g), np.asarray(r)
        assert g.shape == r.shape, (g.shape, r.shape)
        if r.dtype == bool or g.dtype == bool:
            np.testing.assert_array_equal(g, r)
        else:
            np.testing.assert_allclose(g, r, rtol=SPECIAL.get(name, RTOL), atol=1e-13)


SYMBOLIC = ["exp", "log", "sigmoid", "logit", "softplus", "log1mexp", "erf", "sqrt", "tanh",
            "logsumexp", "sum", "mean", "max", "cumsum", "prod", "norm", "sort", "probit"]


def _on_a_node(pm, m, name):
    with pm.Model():
        x = pm.HalfNormal("x", 1.0, shape=(3, 4))
    arg = -x if name == "log1mexp" else (x / (1.0 + x) if name in ("logit", "probit") else x)
    return getattr(m, name)(arg), x


@pytest.mark.parametrize("name", SYMBOLIC)
def test_wrapper_builds_a_node(name):
    node_t, _ = _on_a_node(pmt, mt, name)
    node_j, _ = _on_a_node(pmj, mj, name)
    assert isinstance(node_t, DeterministicNode)
    got = evaluate_t(node_t, {"x": torch.as_tensor(P)})
    ref = evaluate_j(node_j, {"x": jnp.asarray(P)})
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)


def test_sigmoid_node_keeps_torch_sigmoid_and_numbers_become_constants():
    node, x = _on_a_node(pmt, mt, "sigmoid")
    assert node.fn is torch.sigmoid and node.args == (x,) and not node.kwargs
    both = mt.maximum(x, 0.5)
    assert isinstance(both.args[1], pmt.graph.ConstantNode)
    np.testing.assert_allclose(evaluate_t(both, {"x": torch.as_tensor(U)}).numpy(),
                               np.maximum(U, 0.5))


@pytest.mark.parametrize("name", ["iv", "kv"])
def test_bessel_waits_for_ops_special(name):
    # named when pm.math.iv/kv raised; ops/special.py is ported now and is
    # held to pymc_tpu's here (the whole grid: tests/test_torch_special.py)
    got = getattr(mt, name)(1.0, P).numpy()
    np.testing.assert_allclose(got, np.asarray(getattr(mj, name)(1.0, jnp.asarray(P))),
                               rtol=RTOL)


def test_logbern_draws_from_a_generator():
    g = torch.Generator().manual_seed(0)
    draws = torch.stack([mt.logbern(np.log(0.3), g) for _ in range(4000)])
    assert draws.dtype == torch.bool
    assert abs(float(draws.double().mean()) - 0.3) < 5 * (0.3 * 0.7 / 4000) ** 0.5
