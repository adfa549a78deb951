"""The logprob engine's structural matchers in the port against pymc_tpu,
float64 on the CPU, the same expression built in both packages from seeded
inputs, pymc_tpu evaluated eagerly at one shape a case.

Cases are chosen from tests/logprob/ (test_measurable_censoring.py, _casts,
_broadcast, _layout, _joins, _cumsum, _indexing, _mixture, _argext, _order,
_linalg, test_derived_matrix.py, test_mixture_matrix.py,
test_compositions.py and the mixture cases of _switch) and from
tests/distributions/test_custom_symbolic.py:150-170: censoring by clip,
maximum and minimum (nested, with infinite, vector and random bounds),
the four roundings, the casts, broadcast_to, every layout, stack and
concatenate (with dependent and constant components), cumsum, basic
indexing, the index and switch mixtures, the argmax/argmin races, sums of
Normals, max/min and A @ x. logp, and logcdf/logccdf/icdf where the form
has them, are held to pymc_tpu's at RTOL, the value's gradient to
jax.grad for a handful of forms; every form pymc_tpu rejects raises
TypeError in both.

Marked divergences (ROADMAP §3): `x.cumsum()` of a Node derives as
`pm.math.cumsum(x)` in the port (PyMC's semantics) and raises TypeError in
pymc_tpu, whose Node.cumsum carries no marker; a directly valued broadcast
takes values with leading dims in the port, where pymc_tpu's broadcast of
the de-duplicated value fails; a rounding cell whose edge lies below the
image of a chain (round(exp(x)) at 0) gets its true mass in the port,
where pymc_tpu's clamped cdf (the out-of-image fault of ROADMAP §3) makes
the cell's mass underflow.

The slice as a whole: `models.survival_minimum_model`, the survival
example's likelihood written as CustomDist(dist=minimum(Weibull, t_end)),
built by both packages, against pymc_tpu and against the port's own
`survival_model` (Censored(Weibull)).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from pymc_tpu.blocking import unravel_vector
from pymc_tpu.distributions.transformed import dist_from_expression as derive_j
from pymc_tpu.functions import _dist_of as dist_of_j
from pymc_tpu_torch import models
from pymc_tpu_torch.distributions.transformed import dist_from_expression as derive_t


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = 1e-10
ATOL = 1e-14
# a scalar form is evaluated at N values; pymc_tpu's values of a case come
# from one jitted call, compiled at XLA's lowest optimization level (FAST),
# since its eager operations compile one by one
N = 6
FAST = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
Q = np.array([0.05, 0.3, 0.5, 0.8, 0.97, 0.6])
GRID = np.array([[0.4, -1.2, 2.0], [1.1, 0.3, -0.7]])


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _close(got, ref, rtol=RTOL):
    np.testing.assert_allclose(_np(got), _np(ref), rtol=rtol, atol=ATOL)


def _run(fn, *args):
    """fn(*args) of pymc_tpu, through one jitted call compiled with FAST."""
    return jax.jit(fn).lower(*args).compile(compiler_options=FAST)(*args)


def _env(pm, env):
    if env is None:
        return None
    if pm is pmt:
        return {k: torch.as_tensor(np.asarray(v)) for k, v in env.items()}
    return {k: jnp.asarray(v) for k, v in env.items()}


def case(cid, build, values, fns=("logp",), env=None):
    return pytest.param(build, values, fns, env, id=cid)


def n(pm, *args, **kw):
    return pm.Normal.dist(*args, **kw)


def _named(pm, spec):
    """A model of named random variables `spec` {name: (class, args,
    kwargs)}, built in order; returns {name: node}."""
    with pm.Model() as m:
        for name, (cls, args, kw) in spec.items():
            getattr(pm, cls)(name, *args, **kw)
    return {name: m[name] for name in spec}


def _mix(pm):
    return _named(pm, {"X": ("Normal", (0.0, 1.0), {}), "Y": ("Gamma", (), dict(alpha=2.0,
                                                                               beta=0.5)),
                       "I": ("Categorical", (), dict(p=np.array([0.3, 0.5, 0.2])))})


def _ifelse(pm):
    return _named(pm, {"X": ("Normal", (2.0, 1.0), {}), "A": ("Normal", (-3.0, 1.0), {}),
                       "B": ("Normal", (3.0, 2.0), {})})


def _dependent(pm):
    with pm.Model():
        x = pm.HalfNormal("x", sigma=1.0)
        z = pm.Normal("z", mu=0.0, sigma=x)
        w = pm.Normal("w", mu=z, sigma=0.5)
    return pm.math.stack([x, z, w])


CENSORING = [
    case("clip", lambda pm: pm.math.clip(n(pm, 0.3, 1.2), -1.0, 1.5),
         [-1.0, -0.3, 0.4, 1.5, 2.0, -1.5], ("logp", "logcdf", "logccdf", "icdf")),
    case("clip(x, x, hi)", lambda pm: (lambda x: pm.math.clip(x, x, 1.0))(n(pm, 0.0, 1.0)),
         [-3.0, 0.2, 1.0, 1.3]),
    case("clip(x, -inf, hi)", lambda pm: pm.math.clip(n(pm, 0.0, 1.0), -np.inf, 1.0),
         [-3.0, 0.2, 1.0, 1.3], ("logp", "logcdf")),
    case("clip, vector bounds", lambda pm: pm.math.clip(n(pm, 0.0, 1.0, size=3),
                                                        np.array([-1.0, 0.0, -2.0]),
                                                        np.array([1.0, 2.0, 0.5])),
         [[-1.0, 0.0, 0.5], [0.3, 2.0, -2.0]], ("logp", "logcdf", "logccdf")),
    case("clip Poisson", lambda pm: pm.math.clip(pm.Poisson.dist(3.0), 1, 5),
         [1, 2, 4, 5, 0, 6]),
    case("maximum(x, 0)", lambda pm: pm.math.maximum(n(pm, 0.3, 1.0), 0.0), [0.0, 0.4, 2.0, -0.1],
         ("logp", "logcdf", "logccdf", "icdf")),
    case("minimum(Weibull, 4)", lambda pm: pm.math.minimum(pm.Weibull.dist(1.6, 3.0), 4.0),
         [0.5, 2.0, 4.0, 4.5], ("logp", "logcdf", "logccdf", "icdf")),
    case("nested clip", lambda pm: pm.math.clip(pm.math.clip(n(pm, 0.0, 1.0), -2.0, 0.5), -1.0,
                                                1.0), [-1.0, 0.2, 0.5, 0.7]),
    case("maximum(x, y), y given", lambda pm: (lambda r: pm.math.maximum(
        _named(pm, {"x": ("Normal", (0.0, 1.0), {})})["x"], r["y"]))(
            _named(pm, {"y": ("Normal", (0.0, 1.0), {})})), [-0.5, 0.0, 1.2],
         ("logp", "logcdf"), {"y": -0.5}),
]

ROUNDING = [
    case(method, lambda pm, m=method: getattr(pm.math, m)(n(pm, 0.3, 1.4)),
         [-2.0, -1.0, 0.0, 1.0, 3.0], ("logp", "logcdf", "logccdf"))
    for method in ("round", "floor", "ceil", "trunc")
] + [
    case("round(exp(x))", lambda pm: pm.math.round(pm.math.exp(n(pm, 0.0, 1.0))), [1.0, 4.0]),
]

CASTS = [
    case("Poisson as float64", lambda pm: pm.Poisson.dist(3.0).to_node().astype("float64"),
         [0.0, 2.0, 5.0, 2.5], ("logp", "logcdf", "logccdf")),
    case("exp(x as float64)", lambda pm: pm.math.exp(n(pm, 0.0, 1.0).to_node().astype("float64")),
         [0.5, 1.0, 3.0], ("logp", "logcdf")),
    case("x as int64", lambda pm: n(pm, 0.3, 1.5).to_node().astype("int64"), [-2, 0, 1, 3],
         ("logp", "logcdf")),
    case("Bernoulli as int64 mid-chain", lambda pm: 2.0 * pm.Bernoulli.dist(0.3).to_node()
         .astype("int64") + 1.0, [1.0, 3.0]),
]

BROADCAST_LAYOUT = [
    case("broadcast_to", lambda pm: pm.math.broadcast_to(n(pm, np.array([[0.0], [1.0]]), 1.0),
                                                         (4, 2, 3)),
         np.broadcast_to(np.array([[0.1], [0.7]]), (4, 2, 3))),
    case("Node.reshape", lambda pm: n(pm, np.arange(6.0), 1.0).to_node().reshape((2, 3)),
         GRID, ("logp", "logcdf", "logccdf", "icdf")),
    case("ravel", lambda pm: n(pm, np.arange(6.0).reshape(2, 3), 1.0).to_node().ravel(),
         GRID.ravel()),
    case("squeeze", lambda pm: n(pm, np.arange(3.0).reshape(1, 3), 1.0).to_node().squeeze(),
         GRID[0]),
    case("expand_dims", lambda pm: pm.math.expand_dims(n(pm, np.arange(3.0), 1.0), 0), GRID[:1]),
    case(".T", lambda pm: n(pm, np.arange(6.0).reshape(2, 3), 1.0).to_node().T,
         GRID.T, ("logp", "logcdf")),
    case("transpose(axes)", lambda pm: n(pm, np.arange(24.0).reshape(2, 3, 4), 2.0).to_node()
         .transpose(2, 0, 1), np.linspace(-1, 20, 24).reshape(4, 2, 3)),
    case("swapaxes", lambda pm: pm.math.swapaxes(n(pm, np.arange(6.0).reshape(2, 3), 1.0), 0, 1),
         GRID.T),
    case("moveaxis", lambda pm: pm.math.moveaxis(n(pm, np.arange(24.0).reshape(2, 3, 4), 2.0),
                                                 0, -1),
         np.linspace(-1, 20, 24).reshape(3, 4, 2), ("logp", "icdf")),
    case("MvNormal batch transpose", lambda pm: pm.math.transpose(pm.MvNormal.dist(
        np.zeros(2), np.array([[1.0, 0.3], [0.3, 2.0]]), size=(3, 4)), (1, 0, 2)),
         np.linspace(-1, 1, 24).reshape(4, 3, 2)),
]

JOINS = [
    case("stack", lambda pm: pm.math.stack([n(pm, 0.0, 1.0), pm.Exponential.dist(2.0)]),
         [[0.3, 0.5], [-1.0, 1.5]], ("logp", "logcdf", "logccdf")),
    case("stack axis 1", lambda pm: pm.math.stack([n(pm, 0.0, 1.0, size=3),
                                                   n(pm, 1.0, 2.0, size=3)], axis=1),
         GRID.T),
    case("concatenate", lambda pm: pm.math.concatenate([n(pm, 0.0, 1.0, size=2),
                                                        pm.Gamma.dist(2.0, 1.0, size=1)]),
         [[0.3, -0.2, 1.5], [1.0, 0.0, 0.4]]),
    case("stack with a dependent component", _dependent, [0.8, -0.3, 0.1]),
    case("stack with a constant", lambda pm: pm.math.stack([n(pm, 0.0, 1.0), 3.0]),
         [[0.2, 3.0], [0.2, 2.9]]),
    case("exp(stack)", lambda pm: pm.math.exp(pm.math.stack([n(pm, 0.0, 1.0),
                                                             n(pm, 1.0, 0.5)])),
         [[0.5, 2.0], [1.2, 3.0]], ("logp", "logcdf")),
    case("stack of MvNormals", lambda pm: pm.math.stack([
        pm.MvNormal.dist(np.zeros(2), np.eye(2)),
        pm.MvNormal.dist(np.ones(2), np.array([[1.0, 0.3], [0.3, 2.0]]))]),
         [[0.2, -0.4], [1.5, 0.7]]),
    case("concatenate MvNormals on the event axis", lambda pm: pm.math.concatenate([
        pm.MvNormal.dist(np.zeros(2), np.eye(2)), pm.MvNormal.dist(np.ones(3), np.eye(3))]),
         [0.2, -0.4, 1.5, 0.7, 1.0]),
]

CUMSUM_INDEX = [
    case("cumsum", lambda pm: pm.math.cumsum(n(pm, 0.0, 1.0, size=4)), [0.3, -0.2, 1.5, 1.0]),
    case("cumsum axis 1", lambda pm: pm.math.cumsum(n(pm, 0.5, 1.0, size=(2, 3)), axis=1), GRID),
    case("x[0]", lambda pm: n(pm, np.arange(3.0), 1.0)[0], [0.5, -1.0, 2.5],
         ("logp", "logcdf", "logccdf", "icdf")),
    case("x[1:]", lambda pm: n(pm, np.arange(3.0), 1.0)[1:], GRID[:, :2], ("logp", "icdf")),
    case("x[1, ::2]", lambda pm: n(pm, np.arange(6.0).reshape(2, 3), 1.0)[1, ::2], GRID[:, :2]),
    case("exp(x[1])", lambda pm: pm.math.exp(n(pm, np.arange(3.0), 1.0)[1]), [0.5, 1.0, 2.5],
         ("logp", "logcdf")),
]

MIXTURES = [
    case(f"stack(X, Y)[I], I = {i}", lambda pm: (lambda r: pm.math.stack([r["X"], r["Y"]])[r["I"]])(
        _mix(pm)), [0.5, 1.3, 4.0], fns, {"I": i})
    for i, fns in ((0, ("logp", "logcdf", "logccdf", "icdf")), (2, ("logp",)))
] + [
    case("stack with a constant slot [I]", lambda pm: (lambda r: pm.math.stack(
        [r["X"], 4.0])[r["I"]])(_mix(pm)), [0.2, 4.0], ("logp",), {"I": 1}),
    case("x[I], vector components", lambda pm: (lambda r, x: x[r["I"]])(
        _mix(pm), n(pm, np.array([[0.0, 1.0], [5.0, 6.0], [-3.0, 2.0]]), 1.0)),
         [[0.2, 0.9], [5.5, 6.5]], ("logp", "logcdf"), {"I": 1}),
    case("exp(stack[I])", lambda pm: (lambda r: pm.math.exp(pm.math.stack(
        [r["X"], r["Y"]])[r["I"]]))(_mix(pm)), [0.5, 2.0], ("logp", "logcdf"), {"I": 1}),
    case("switch, RV-free condition", lambda pm: pm.math.where(np.array([True, False, True]),
                                                              n(pm, 0.0, 1.0, size=3),
                                                              pm.Exponential.dist(2.0, size=3)),
         [[0.5, 0.3, -1.0], [1.2, 2.0, 0.1]], ("logp", "logcdf", "logccdf", "icdf")),
    case("switch, random condition", lambda pm: (lambda r: pm.math.where(
        r["X"] > 0, r["A"], r["B"]))(_ifelse(pm)), [0.5, -2.0], ("logp", "logcdf"),
         {"X": -1.0}),
    case("switch with a constant branch", lambda pm: pm.math.where(
        np.array([True, False]), n(pm, 0.0, 1.0, size=2), 5.0), [[0.2, 5.0], [0.2, 4.9]]),
    case("exp(switch)", lambda pm: pm.math.exp(pm.math.where(
        np.array([True, False]), n(pm, 0.0, 1.0, size=2), n(pm, 3.0, 1.0, size=2))),
         [[0.5, 20.0], [1.2, 5.0]], ("logp", "logcdf")),
]

RACES = [
    case("argmax Gumbel", lambda pm: pm.math.argmax(pm.Gumbel.dist(np.array([0.0, 0.5, 1.5]),
                                                                   2.0)), [0, 1, 2]),
    case("argmax(2 + 3 Gumbel)", lambda pm: pm.math.argmax(2.0 + 3.0 * pm.Gumbel.dist(
        np.array([0.0, 0.5, 1.5]), 1.0)), [0, 1, 2]),
    case("argmin Exponential", lambda pm: pm.math.argmin(pm.Exponential.dist(
        np.array([1.0, 2.0, 4.0]))), [0, 1, 2]),
    case("argmin Weibull", lambda pm: pm.math.argmin(pm.Weibull.dist(1.5, np.array(
        [1.0, 2.0, 0.5]))), [0, 1, 2]),
    case("sum", lambda pm: pm.math.sum(n(pm, np.array([0.0, 1.0, 2.0]),
                                         np.array([1.0, 0.5, 2.0]))),
         [0.5, 3.0], ("logp", "logcdf")),
    case("sum axis 0", lambda pm: pm.math.sum(n(pm, np.arange(6.0).reshape(2, 3), 1.5), axis=0),
         GRID),
    case("Node.sum", lambda pm: n(pm, 0.0, 1.0, size=4).to_node().sum(), [0.5, -2.0]),
    case("max", lambda pm: pm.math.max(n(pm, 0.0, 1.0, size=5)), [0.5, 1.5, -0.5],
         ("logp", "logcdf")),
    case("min", lambda pm: pm.math.min(pm.Exponential.dist(2.0, size=(2, 2))), [0.1, 0.5]),
    case("Node.max of Poissons", lambda pm: pm.Poisson.dist(3.0, size=4).to_node().max(),
         [2, 5, 7]),
]

MATMUL = [
    case("A @ x", lambda pm: np.array([[2.0, 0.5], [0.3, 1.5]]) @ n(pm, 0.0, 1.0, size=2),
         GRID[:, :2]),
    case("x @ A", lambda pm: n(pm, np.array([0.5, -1.0]), 1.0, size=2) @ np.array(
        [[2.0, 0.5], [0.3, 1.5]]), GRID[:, :2]),
    case("A @ X", lambda pm: np.array([[2.0, 0.5], [0.3, 1.5]]) @ n(pm, 0.0, 1.0, size=(2, 3)),
         GRID),
    case("X @ A", lambda pm: n(pm, 0.0, 1.0, size=(3, 2)) @ np.array([[2.0, 0.5], [0.3, 1.5]]),
         GRID.T),
]

CASES = CENSORING + ROUNDING + CASTS + BROADCAST_LAYOUT + JOINS + CUMSUM_INDEX + MIXTURES \
    + RACES + MATMUL


@pytest.mark.parametrize("build, values, fns, env", CASES)
def test_form_matches_pymc_tpu(build, values, fns, env):
    et, ej = build(pmt), build(pmj)
    v = np.resize(values, N) if et.shape == () else np.asarray(values)
    q = np.resize(Q, et.shape or N)
    env_j = _env(pmj, env)
    dj = dist_of_j(ej, env_j)
    refs = _run(lambda v, q: [getattr(dj, fn)(q if fn == "icdf" else v, env=env_j)
                              for fn in fns], v, q)
    for fn, ref in zip(fns, refs):
        _close(getattr(pmt, fn)(et, q if fn == "icdf" else v, env=_env(pmt, env)), ref)


GRADS = [
    case("clip", lambda pm: pm.math.clip(n(pm, 0.3, 1.2), -1.0, 1.5), [-0.5, 0.4, 1.2]),
    case("minimum(Weibull, 4)", lambda pm: pm.math.minimum(pm.Weibull.dist(1.6, 3.0), 4.0),
         [0.5, 2.0, 3.5]),
    case("stack with a dependent component", _dependent, [0.8, -0.3, 0.1]),
    case("stack(X, Y)[I]", lambda pm: (lambda r: pm.math.stack([r["X"], r["Y"]])[r["I"]])(
        _mix(pm)), [0.5, 1.3, 4.0], (), {"I": 1}),
    case("switch", lambda pm: pm.math.where(np.array([True, False, True]),
                                            n(pm, 0.0, 1.0, size=3),
                                            pm.Exponential.dist(2.0, size=3)),
         [0.5, 0.3, -1.0]),
    case("A @ X", lambda pm: np.array([[2.0, 0.5], [0.3, 1.5]]) @ n(pm, 0.0, 1.0, size=(2, 3)),
         GRID),
    case("x[1:]", lambda pm: n(pm, np.arange(3.0), 1.0)[1:], [0.5, 2.5]),
    case("broadcast_to", lambda pm: pm.math.broadcast_to(n(pm, 0.5, 2.0), (3,)),
         [0.2, 0.2, 0.2]),
]


@pytest.mark.parametrize("build, values, fns, env", GRADS)
def test_value_gradient_matches_jax(build, values, fns, env):
    et = build(pmt)
    v = np.resize(values, N) if et.shape == () else np.asarray(values)
    v = torch.tensor(v, dtype=torch.float64, requires_grad=True)
    lp = pmt.logp(et, v, env=_env(pmt, env))
    (got,) = torch.autograd.grad(lp.sum(), v)
    env_j = _env(pmj, env)
    dj = dist_of_j(build(pmj), env_j)
    ref = _run(jax.grad(lambda y: dj.logp(y, env=env_j).sum()), v.detach().numpy())
    _close(got, ref)


def _rejected(pm):
    """Expressions pymc_tpu rejects: each raises TypeError."""
    m, x = pm.math, n(pm, 0.0, 1.0)
    mix, ifelse = _mix(pm), _ifelse(pm)
    mv = pm.MvNormal.dist(np.zeros(2), np.eye(2), size=3)
    return {
        "maximum(x, y)": lambda: m.maximum(x, n(pm, 1.0, 1.0)),
        "clip(constant, ...)": lambda: m.clip(m.constant(np.array(0.5)), x, 1.0),
        "clip(x, x + 1, 2)": lambda: m.clip(x, x + 1.0, 2.0),
        "round(clip)": lambda: m.round(m.clip(x, -1.0, 1.0)),
        "clip as int64": lambda: m.clip(x, -1.0, 1.0).astype("int64"),
        "x as uint8": lambda: x.to_node().astype("uint8"),
        "x as bool": lambda: x.to_node().astype("bool"),
        "x as complex64": lambda: x.to_node().astype("complex64"),
        "2 Poisson as float64": lambda: 2.0 * pm.Poisson.dist(2.0).to_node().astype("float64"),
        "exp(broadcast)": lambda: m.exp(m.broadcast_to(x, (3,))),
        "reshape across the event": lambda: mv.to_node().reshape((6,)),
        "exp(transpose of the event)": lambda: m.exp(m.transpose(mv, (1, 0))),
        "cumsum of a matrix, axis None": lambda: m.cumsum(n(pm, 0.0, 1.0, size=(2, 2))),
        "cumsum of an MvNormal": lambda: m.cumsum(mv, axis=0),
        "x[[0, 1]]": lambda: n(pm, 0.0, 1.0, size=3)[np.array([0, 1])],
        "MvNormal[0]": lambda: mv[0],
        "stack[0]": lambda: m.stack([x, n(pm, 1.0, 1.0)])[0],
        "x[I, 0]": lambda: n(pm, 0.0, 1.0, size=(3, 2))[mix["I"], 0],
        "x[vector I]": lambda: n(pm, 0.0, 1.0, size=3)[pm.Categorical.dist(
            p=np.array([0.5, 0.5]), size=2).to_node()],
        "x[X]": lambda: n(pm, 0.0, 1.0, size=3)[mix["X"]],
        "concatenate[I]": lambda: m.concatenate([n(pm, 0.0, 1.0, size=1),
                                                 n(pm, 1.0, 1.0, size=1)])[mix["I"]],
        "stack(X, X)[I], X indexing itself": lambda: m.stack([mix["I"], mix["I"]])[mix["I"]],
        "switch, condition shares the branch": lambda: m.where(ifelse["X"] > 0,
                                                               ifelse["X"] + 1.0, ifelse["B"]),
        "switch of constants": lambda: m.where(x > 0, 1.0, 2.0),
        "switch broadcasting a component": lambda: m.where(np.array([True, False]), x,
                                                           n(pm, 1.0, 1.0, size=2)),
        "exp(switch with an atom)": lambda: m.exp(m.where(np.array([True, False]),
                                                          n(pm, 0.0, 1.0, size=2), 5.0)),
        "exp(stack with an atom)[I]": lambda: m.exp(m.stack([mix["X"], 4.0])[mix["I"]]),
        "argmax Normal": lambda: m.argmax(n(pm, 0.0, 1.0, size=3)),
        "argmin(1 + Exponential)": lambda: m.argmin(1.0 + pm.Exponential.dist(1.0, size=3)),
        "argmax(-Gumbel)": lambda: m.argmax(-1.0 * pm.Gumbel.dist(0.0, 1.0, size=3)),
        "argmax Gumbel, varying scale": lambda: m.argmax(pm.Gumbel.dist(
            0.0, np.array([1.0, 2.0, 3.0]))),
        "argmin Weibull, varying shape": lambda: m.argmin(pm.Weibull.dist(
            np.array([1.0, 2.0, 3.0]), 1.0)),
        "sum of Exponentials": lambda: m.sum(pm.Exponential.dist(1.0, size=3)),
        "sum(exp(x))": lambda: m.sum(m.exp(n(pm, 0.0, 1.0, size=3))),
        "max over axis 0": lambda: m.max(n(pm, 0.0, 1.0, size=(2, 3)), axis=0),
        "max, not iid": lambda: m.max(n(pm, np.array([0.0, 1.0]), 1.0)),
        "max(exp(x))": lambda: m.max(m.exp(n(pm, 0.0, 1.0, size=3))),
        "A @ B, two RVs": lambda: n(pm, 0.0, 1.0, size=(2, 2)) @ n(pm, 0.0, 1.0, size=2),
        "non-square A @ x": lambda: np.ones((3, 2)) @ n(pm, 0.0, 1.0, size=2),
        "A @ x, x broadcast": lambda: np.ones((4, 2, 2)) @ n(pm, 0.0, 1.0, size=2),
        "A @ Poisson": lambda: np.eye(2) @ pm.Poisson.dist(1.0, size=2),
        "exp(stack of mixed kinds)": lambda: m.exp(m.stack([x, pm.Poisson.dist(2.0)])),
        "stack(x, x)": lambda: m.stack([x, x]),
        "stack(x, exp(x))": lambda: m.stack([x, m.exp(x)]),
    }


@pytest.mark.parametrize("name", list(_rejected(pmt)))
def test_rejected_forms_raise_type_error(name):
    for pm, derive in ((pmj, derive_j), (pmt, derive_t)):
        with pytest.raises(TypeError):
            derive(_rejected(pm)[name]())


def test_join_of_univariate_and_multivariate_raises_value_error():
    for pm, derive in ((pmj, derive_j), (pmt, derive_t)):
        with pytest.raises(ValueError, match="different number of dimensions"):
            derive(pm.math.stack([pm.MvNormal.dist(np.zeros(2), np.eye(2)),
                                  pm.Normal.dist(0.0, 1.0, size=2)]))


def test_cdf_family_raises_where_pymc_tpu_does():
    """No cdf for a join's constant slot, a broadcast, a coupled matmul, a
    multivariate layout or join; no icdf for a join."""
    def forms(pm):
        m, x = pm.math, n(pm, 0.0, 1.0)
        mv = pm.MvNormal.dist(np.zeros(2), np.eye(2), size=3)
        return [(m.stack([x, 3.0]), "logcdf", [0.2, 3.0]),
                (m.stack([x, n(pm, 1.0, 1.0)]), "icdf", [0.2, 0.5]),
                (m.broadcast_to(x, (3,)), "logcdf", [0.2, 0.2, 0.2]),
                (np.eye(2) @ n(pm, 0.0, 1.0, size=2), "logcdf", [0.2, 0.4]),
                (m.transpose(mv, (1, 0)), "logcdf", np.zeros((2, 3))),
                (m.stack([mv, mv + 1.0]), "logcdf", np.zeros((2, 3, 2)))]

    for (et, fn, v), (ej, _, _) in zip(forms(pmt), forms(pmj)):
        for pm, e in ((pmt, et), (pmj, ej)):
            with pytest.raises((NotImplementedError, TypeError)):
                getattr(pm, fn)(e, np.asarray(v))


def test_node_cumsum_diverges_from_pymc_tpu():
    """Marked divergence: x.cumsum() of a Node is pm.math.cumsum(x) in the
    port, as in PyMC; pymc_tpu's Node.cumsum has no marker and raises."""
    v = np.array([0.3, -0.2, 1.5, 1.0])
    got = pmt.logp(n(pmt, 0.0, 1.0, size=4).to_node().cumsum(), v)
    dj = derive_j(pmj.math.cumsum(n(pmj, 0.0, 1.0, size=4)))
    _close(got, _run(dj.logp, v))
    with pytest.raises(TypeError):
        derive_j(n(pmj, 0.0, 1.0, size=4).to_node().cumsum())


def test_rounding_below_the_image_diverges_from_pymc_tpu():
    """Marked divergence (ROADMAP §3, the out-of-image cdfs): the cell of
    round(exp(x)) at 0 is [-0.5, 0.5), whose lower edge lies below the
    image of exp; the port's log F there is -inf, so the mass is
    Phi(log 0.5); pymc_tpu clamps -0.5 into the image, F(-0.5) reads 1/2,
    and the difference of cdfs underflows."""
    got = float(pmt.logp(pmt.math.round(pmt.math.exp(n(pmt, 0.0, 1.0))), 0.0))
    np.testing.assert_allclose(got, float(torch.special.log_ndtr(torch.tensor(np.log(0.5)))),
                               rtol=1e-12)
    dj = derive_j(pmj.math.round(pmj.math.exp(n(pmj, 0.0, 1.0))))
    assert float(_run(dj.logp, np.float64(0.0))) < -700.0


def test_broadcast_values_with_leading_dims():
    """Marked divergence: a value with leading dims is taken row by row in
    the port; pymc_tpu's broadcast of the de-duplicated value fails."""
    rows = np.array([[0.5, 0.5, 0.5], [0.2, 0.2, 0.3]])
    got = _np(pmt.logp(pmt.math.broadcast_to(n(pmt, 0.0, 1.0), (3,)), rows))
    dj = derive_j(pmj.math.broadcast_to(n(pmj, 0.0, 1.0), (3,)))
    _close(got[0], _run(dj.logp, rows[0]))
    assert np.isneginf(got[1])
    with pytest.raises(ValueError, match="Incompatible shapes"):
        dj.logp(rows)


def test_derived_inputs_never_hold_the_leaf():
    """inputs() holds the parameters and constants a model must place, never
    the random leaf the value stands for."""
    x = n(pmt, 0.0, 1.0, size=2)
    for expr in (pmt.math.clip(x, -1.0, 1.0), pmt.math.stack([x, n(pmt, 1.0, 1.0, size=2)]),
                 pmt.math.transpose(x), np.eye(2) @ x, x[0],
                 pmt.math.where(np.array([True, False]), x, n(pmt, 1.0, 1.0, size=2))):
        assert all(c is not x.to_node() for c in derive_t(expr).inputs())


def test_draws_of_the_mixtures():
    """Draws of the index mixture (tests/distributions/test_custom_symbolic.py:
    150-170) and of the switch mixture with a random condition, through
    CustomDist(dist=): each component's share within 4 standard errors of
    its weight."""
    def cmix(pm):
        def dist(p, sigma, size):
            idx = pm.Bernoulli.dist(p=p).to_node(name="mix_idx")
            return pm.math.stack([pm.Normal.dist(-sigma, 0.1, size=size),
                                  pm.Normal.dist(sigma, 0.1, size=size)])[idx]

        return pm.CustomDist.dist(0.3, 10.0, dist=dist)

    c, env_j = cmix(pmt), {"mix_idx": jnp.asarray(0)}
    cj = cmix(pmj)
    _close(pmt.logp(c, -9.9, env={"mix_idx": torch.tensor(0)}),
           _run(lambda v: cj.logp(v, env=env_j), np.float64(-9.9)))
    d = pmt.draw(c, draws=2000, random_seed=1, device="cpu")
    frac = float((d > 0).double().mean())
    assert abs(frac - 0.3) < 4 * np.sqrt(0.3 * 0.7 / 2000)

    def cswitch(pm):
        return pm.CustomDist.dist(0.5, dist=lambda mu, size: pm.math.where(
            pm.Normal.dist(mu, 1.0) > 0, pm.Normal.dist(-3.0, 0.5, size=size),
            pm.Normal.dist(3.0, 0.5, size=size)))

    d = pmt.draw(cswitch(pmt), draws=2000, random_seed=2, device="cpu")
    share = float((d < 0).double().mean())
    p = 0.6914624612740131  # P(Normal(0.5, 1) > 0)
    assert abs(share - p) < 4 * np.sqrt(p * (1 - p) / 2000)


@pytest.mark.parametrize("name", models.STRUCTURAL_MODELS)
def test_structural_model_matches_pymc_tpu(name):
    """chip_smoke.py phase 18b's models (a CustomDist(dist=) likelihood of a
    clip, a stack with a dependent component, a switch mixture, A @ X):
    logp and gradient at seeded points."""
    mt, mj = models.structural_model(name), models.structural_model(name, pmj)
    q = np.random.default_rng(18).normal(0.0, 0.3, size=(3, 2))
    lp, g = mt.logp_dlogp_fn(device="cpu")(torch.tensor(q))
    info, lf = mj.raveled_info(), mj.logp_fn()
    lp_j, g_j = _run(jax.vmap(jax.value_and_grad(lambda x: lf(unravel_vector(x, info)))), q)
    _close(lp, lp_j)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=RTOL, atol=1e-12)


def _survival_points(D):
    return np.random.default_rng(17).normal(0.0, 0.3, size=(4, D))


def test_survival_minimum_model_matches_pymc_tpu_and_survival_model():
    """The slice as a whole: the survival example's likelihood as
    CustomDist(dist=minimum(Weibull, t_end)), built by both packages: logp
    and gradient at seeded points against pymc_tpu at RTOL, and equal to
    the port's survival_model (Censored(Weibull, upper=t_end))."""
    mt = models.survival_minimum_model()
    assert isinstance(mt["t"].dist._derived, pmt.Censored)
    D = mt.raveled_info().total_size
    assert D == 3
    q = _survival_points(D)
    lp, g = mt.logp_dlogp_fn(device="cpu")(torch.tensor(q))
    mj = models.survival_minimum_model(pmj)
    info, lf = mj.raveled_info(), mj.logp_fn()
    lp_j, g_j = _run(jax.vmap(jax.value_and_grad(lambda x: lf(unravel_vector(x, info)))), q)
    _close(lp, lp_j)
    np.testing.assert_allclose(g.numpy(), np.asarray(g_j), rtol=RTOL, atol=1e-9)
    lp_c, g_c = models.survival_model().logp_dlogp_fn(device="cpu")(torch.tensor(q))
    np.testing.assert_allclose(lp.numpy(), lp_c.numpy(), rtol=1e-15)
    np.testing.assert_allclose(g.numpy(), g_c.numpy(), rtol=1e-15)
