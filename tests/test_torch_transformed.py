"""The logprob engine's elementwise chains in the port against pymc_tpu,
float64 on the CPU, the same expression built in both packages from seeded
inputs.

Cases are chosen from tests/logprob/test_measurable_transforms.py,
test_transforms.py, test_measurable_special.py, the scale cases of
test_measurable_switch.py and tests/distributions/test_custom_symbolic.py:
every invertible unary link of the registry, the arithmetic links with a
constant (and the odds ratio t / (1 + t)), the folds abs / even powers /
cosh, the non-overlapping switch scale, over a base that suits each (Normal,
Exponential, Kumaraswamy on the unit interval, Poisson for the lattice).
logp, logcdf, logccdf and icdf are held to pymc_tpu's at RTOL (looser,
SPECIAL_RTOL, where a link goes through erfinv or ndtri, whose float64
implementations differ in the last digits), and gradients by autograd to
jax.grad. The forms pymc_tpu rejects raise TypeError in both; the
structural forms it derives (ROADMAP item 6b) match its logp.

Marked divergence (ROADMAP §3): a value outside the image of a chain gets
log F = -inf and log S = 0 below the image (mirrored above it) in the
port; pymc_tpu evaluates the cdfs at a clamped in-image point, so
pm.logcdf(exp(x), -1) is log 0.5 there. The odds ratio's pole value y = 1
gets logp -inf in the port and NaN in pymc_tpu.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy import special as jsp

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from pymc_tpu.blocking import unravel_vector
from pymc_tpu.distributions.transformed import dist_from_expression as derive_j
from pymc_tpu_torch import models
from pymc_tpu_torch.distributions.transformed import (
    FoldedDistribution, TransformedDistribution, dist_from_expression as derive_t,
)

@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


RTOL = 1e-10
SPECIAL_RTOL = 1e-8
# a tail probability such as log S = -2e-12 differs in its last digits
ATOL = 1e-14
# every case is evaluated at N points (pymc_tpu's eager operations compile
# once a shape, so one shape keeps this module quick)
N = 8
Q = np.linspace(0.03, 0.97, N)

# the callables that pm.math does not wrap, by package
RAW = {
    pmj: {"exp2": jnp.exp2, "reciprocal": jnp.reciprocal, "expit": jsp.expit,
          "square": jnp.square, "apply": pmj.graph.apply},
    pmt: {"exp2": torch.exp2, "reciprocal": torch.reciprocal, "expit": torch.special.expit,
          "square": torch.square, "apply": pmt.graph.apply},
}


def normal(pm, size=None):
    return pm.Normal.dist(0.3, 1.2, size=size)


def expo(pm):
    return pm.Exponential.dist(1.5)


def unit(pm):
    return pm.Kumaraswamy.dist(2.0, 3.0)


def raw(name):
    return lambda pm, x: RAW[pm]["apply"](RAW[pm][name], x)


def math(name):
    return lambda pm, x: getattr(pm.math, name)(x)


def _case(cid, link, base, values, below=(), above=(), rtol=RTOL, cdf=True):
    """One chain: `link(pm, base(pm))` at N points, `values` inside the
    image (repeated to fill), then those below it and above it."""
    n_in = N - len(below) - len(above)
    points = np.concatenate([np.resize(np.asarray(values, float), n_in), below, above])
    return pytest.param(link, base, points, n_in, len(below), rtol, cdf, id=cid)


# every op of the unary registry, then the binary links, the odds ratio and
# chains of two links
CHAINS = [
    _case("exp", math("exp"), normal, [0.5, 1.3, 4.0], below=[-1.0, 0.0]),
    _case("log", math("log"), expo, [-1.0, 0.2, 1.5]),
    _case("log1p", math("log1p"), expo, [0.1, 0.5, 2.0]),
    _case("expm1", math("expm1"), normal, [-0.5, 0.3, 3.0], below=[-1.5]),
    _case("log2", math("log2"), expo, [-1.0, 0.5, 2.0]),
    _case("log10", math("log10"), expo, [-1.0, 0.5, 2.0]),
    _case("exp2", raw("exp2"), normal, [0.5, 2.0, 5.0], below=[-1.0]),
    _case("sqrt", math("sqrt"), expo, [0.5, 1.2, 2.0], below=[-0.5]),
    _case("cbrt", math("cbrt"), normal, [-1.2, 0.4, 1.5]),
    _case("negative", lambda pm, x: -x, expo, [-2.0, -0.5, -0.1]),
    _case("reciprocal", raw("reciprocal"), expo, [0.5, 2.0], cdf=False),
    _case("sigmoid", math("sigmoid"), normal, [0.2, 0.5, 0.9], below=[-0.2], above=[1.3]),
    _case("expit", raw("expit"), normal, [0.2, 0.5, 0.9], below=[0.0], above=[1.0]),
    _case("logit", math("logit"), unit, [-1.0, 0.0, 2.0]),
    _case("invprobit", math("invprobit"), normal, [0.1, 0.5, 0.95], below=[-0.5],
          above=[1.5], rtol=SPECIAL_RTOL),
    _case("probit", math("probit"), unit, [-1.0, 0.3, 1.0], rtol=SPECIAL_RTOL),
    _case("sinh", math("sinh"), normal, [-2.0, 0.3, 3.0]),
    _case("arcsinh", math("arcsinh"), normal, [-1.0, 0.2, 2.0]),
    _case("tanh", math("tanh"), normal, [-0.9, 0.1, 0.7], below=[-1.0], above=[1.2]),
    _case("arctanh", math("arctanh"), unit, [0.2, 0.6, 1.1]),
    _case("erf", math("erf"), normal, [-0.5, 0.2, 0.8], below=[-1.5], above=[1.5],
          rtol=SPECIAL_RTOL),
    _case("erfinv", math("erfinv"), unit, [0.1, 0.5, 1.2], rtol=SPECIAL_RTOL),
    _case("erfc", math("erfc"), normal, [0.3, 1.0, 1.7], below=[-0.5], above=[2.5],
          rtol=SPECIAL_RTOL),
    _case("erfcinv", math("erfcinv"), unit, [0.2, 0.6, 1.2], rtol=SPECIAL_RTOL),
    _case("arcsin", math("arcsin"), unit, [0.2, 0.7, 1.3], above=[2.0]),
    _case("arccos", math("arccos"), unit, [0.3, 0.9, 1.4], below=[-0.5], above=[3.5]),
    _case("arctan", math("arctan"), normal, [-1.0, 0.3, 1.2], below=[-1.7], above=[1.7]),
    _case("arccosh(1 + x)", lambda pm, x: pm.math.arccosh(1.0 + x), expo, [0.3, 1.0, 2.0],
          below=[-0.5]),
    _case("softplus", math("softplus"), normal, [0.2, 1.0, 3.0], below=[-0.3]),
    _case("log1mexp(-x)", lambda pm, x: pm.math.log1mexp(-x), expo, [-2.0, -0.5, -0.05],
          above=[0.5]),
    _case("x + 2", lambda pm, x: x + 2.0, normal, [0.5, 2.3, 4.0]),
    _case("3 - x", lambda pm, x: 3.0 - x, normal, [0.5, 2.3, 4.0]),
    _case("x - 1.5", lambda pm, x: x - 1.5, normal, [-2.0, 0.0, 1.0]),
    _case("2.5 x", lambda pm, x: 2.5 * x, normal, [-2.0, 0.5, 3.0]),
    _case("x * -2", lambda pm, x: x * -2.0, normal, [-2.0, 0.5, 3.0]),
    _case("x / 4", lambda pm, x: x / 4.0, normal, [-0.5, 0.1, 0.6]),
    _case("2 / x", lambda pm, x: 2.0 / x, expo, [0.5, 2.0, 7.0], cdf=False),
    _case("2 ** x", lambda pm, x: 2.0 ** x, normal, [0.5, 1.2, 3.0], below=[-1.0]),
    _case("0.5 ** x", lambda pm, x: 0.5 ** x, normal, [0.5, 1.2, 3.0], below=[0.0]),
    _case("x ** 3", lambda pm, x: x ** 3, normal, [-2.0, 0.1, 1.5]),
    _case("x ** 0.5", lambda pm, x: x ** 0.5, expo, [0.3, 1.0, 1.7], below=[-0.1]),
    _case("x ** -1.5", lambda pm, x: x ** -1.5, expo, [0.3, 1.0, 4.0], cdf=False),
    _case("x + array", lambda pm, x: x + np.linspace(0.0, 1.4, N), normal, [0.2, 1.5, 2.0]),
    _case("array x", lambda pm, x: np.resize([1.0, -2.0, 3.0], N) * x, normal,
          [0.2, 1.5, 2.0], cdf=False),
    _case("t / (1 + t)", lambda pm, x: (lambda t: t / (1.0 + t))(pm.math.exp(x)), normal,
          [0.2, 0.5, 0.9], cdf=False),
    _case("2 sigmoid(x) + 1", lambda pm, x: 2.0 * pm.math.sigmoid(x) + 1.0, normal,
          [1.2, 2.0, 2.9], below=[0.5], above=[3.5]),
    _case("-exp(x / 2)", lambda pm, x: -pm.math.exp(x / 2.0), normal, [-3.0, -1.0, -0.2],
          above=[0.5]),
    _case("log(1 - sigmoid(x))", lambda pm, x: pm.math.log(1.0 - pm.math.sigmoid(x)), normal,
          [-3.0, -1.0, -0.2], above=[0.5]),
]

ODDS = [c.id for c in CHAINS].index("t / (1 + t)")

FOLDS = [
    pytest.param(lambda pm, x: abs(x), id="abs"),
    pytest.param(lambda pm, x: x ** 2, id="x ** 2"),
    pytest.param(lambda pm, x: RAW[pm]["apply"](RAW[pm]["square"], x), id="square"),
    pytest.param(lambda pm, x: x ** 4, id="x ** 4"),
    pytest.param(math("cosh"), id="cosh"),
    pytest.param(lambda pm, x: pm.math.exp(abs(x)), id="exp(abs(x))"),
    pytest.param(lambda pm, x: abs(2.0 * x - 1.0), id="abs(2x - 1)"),
]

SWITCHES = [
    pytest.param(lambda pm, x: pm.math.where(x > 0, 2.0 * x, 0.5 * x),
                 np.resize([-2.0, -0.3, 0.4, 3.0], N), id="x > 0"),
    pytest.param(lambda pm, x: pm.math.switch(x < 0, x / 4.0, x * 3.0),
                 np.resize([-0.4, -0.1, 0.4, 3.0], N), id="x < 0"),
    pytest.param(lambda pm, x: pm.math.where(x >= 0, x, 0.2 * x) + 1.0,
                 np.resize([0.3, 0.9, 1.4, 2.5], N), id="leaky + 1"),
    pytest.param(lambda pm, x: pm.math.exp(pm.math.where(x > 0, x, 3.0 * x)),
                 np.resize([0.05, 0.6, 1.5, 4.0], N), id="exp(switch)"),
]
FOLD_VALUES = np.array([-0.5, 0.0, 0.3, 1.0, 1.7, 4.0, 0.8, 2.5])

LATTICE = [
    pytest.param(lambda pm, k: pm.math.exp(k), np.exp([0, 2, 2.5, 5, 11, 1, 0.5, 3]), id="exp"),
    pytest.param(lambda pm, k: 2.0 * k + 1.0, np.array([1.0, 3, 4, 7, 9, 2, 11, 13]),
                 id="2k + 1"),
    pytest.param(lambda pm, k: pm.math.sqrt(k), np.sqrt([0, 1, 2.5, 4, 9, 3, 3.5, 6]),
                 id="sqrt"),
]


def poisson(pm):
    return pm.Poisson.dist(3.0)


GRADS = [
    pytest.param(math("exp"), normal, [0.5, 1.3, 4.0], id="exp"),
    pytest.param(math("sigmoid"), normal, [0.2, 0.5, 0.9], id="sigmoid"),
    pytest.param(lambda pm, x: 2.0 * x + 3.0, normal, [-1.0, 2.5, 5.0], id="2x + 3"),
    pytest.param(lambda pm, x: pm.math.log1mexp(-x), expo, [-2.0, -0.5, -0.05],
                 id="log1mexp(-x)"),
    pytest.param(lambda pm, x: x ** 0.5, expo, [0.3, 1.0, 1.7], id="x ** 0.5"),
    pytest.param(lambda pm, x: abs(x), normal, [0.1, 0.7, 2.0], id="abs"),
    pytest.param(SWITCHES[0].values[0], normal, [-2.0, 0.4, 3.0], id="switch"),
]


def _chain_reference(link, base, points, n_in, n_below, rtol, cdf):
    ej = link(pmj, base(pmj))
    out = {"logp": pmj.logp(ej, points)}
    if cdf:
        out.update(logcdf=pmj.logcdf(ej, points), logccdf=pmj.logccdf(ej, points),
                   icdf=pmj.icdf(ej, Q))
    return out


@functools.lru_cache(maxsize=None)
def _reference():
    """pymc_tpu's values for every case of the tables above."""
    def run():
        out = {"chain": {p.id: _chain_reference(*p.values) for p in CHAINS},
               "fold": {p.id: pmj.logp(p.values[0](pmj, normal(pmj)), FOLD_VALUES)
                        for p in FOLDS},
               "lattice": {}, "switch": {}, "grad": {}}
        for p in SWITCHES:
            ej, v = p.values[0](pmj, normal(pmj)), np.asarray(p.values[1])
            out["switch"][p.id] = {fn: getattr(pmj, fn)(ej, v)
                                   for fn in ("logp", "logcdf", "logccdf")}
            out["switch"][p.id]["icdf"] = pmj.icdf(ej, Q)
        for p in LATTICE:
            ej = p.values[0](pmj, poisson(pmj))
            out["lattice"][p.id] = {fn: getattr(pmj, fn)(ej, p.values[1])
                                    for fn in ("logp", "logcdf", "logccdf")}
        for p in GRADS:
            ej = p.values[0](pmj, p.values[1](pmj))
            out["grad"][p.id] = jax.grad(lambda y: pmj.logp(ej, y).sum())(
                jnp.asarray(np.resize(p.values[2], N), dtype=jnp.float64))
        return out

    return jax.tree.map(np.asarray, run())


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _pair(link, base):
    return link(pmt, base(pmt)), link(pmj, base(pmj))


def _close(got, ref, rtol):
    np.testing.assert_allclose(_np(got), _np(ref), rtol=rtol, atol=ATOL)


@pytest.mark.parametrize("link, base, points, n_in, n_below, rtol, cdf", CHAINS)
def test_chain_matches_pymc_tpu(request, link, base, points, n_in, n_below, rtol, cdf):
    ref = _reference()["chain"][request.node.callspec.id]
    et, ej = _pair(link, base)
    assert isinstance(derive_t(et), TransformedDistribution)
    # outside the image the density is -inf, with a finite (zero) gradient
    v = torch.tensor(points, requires_grad=True)
    lp = pmt.logp(et, v)
    _close(lp, ref["logp"], rtol)
    (g,) = torch.autograd.grad(torch.where(torch.isfinite(lp), lp, 0.0).sum(), v)
    assert torch.isfinite(g).all()
    assert np.isneginf(_np(lp[n_in:])).all()
    if not cdf:
        for fn, arg in (("logcdf", points), ("logccdf", points), ("icdf", Q)):
            with pytest.raises(NotImplementedError, match="monotone direction"):
                getattr(pmt, fn)(et, arg)
            with pytest.raises(NotImplementedError, match="monotone direction"):
                getattr(pmj, fn)(ej, arg)
        return
    for fn in ("logcdf", "logccdf"):
        _close(_np(getattr(pmt, fn)(et, points))[:n_in], ref[fn][:n_in], rtol)
    _close(pmt.icdf(et, Q), ref["icdf"], rtol)


@pytest.mark.parametrize("link, base, points, n_in, n_below, rtol, cdf",
                         [c for c in CHAINS if c.values[3] < N and c.values[6]])
def test_cdfs_outside_the_image_diverge_from_pymc_tpu(request, link, base, points, n_in,
                                                       n_below, rtol, cdf):
    """Marked divergence: below the image log F = -inf and log S = 0, above
    it log F = 0 and log S = -inf; pymc_tpu clamps the value into the image
    and gives the cdfs at the clamped point (ROADMAP §3)."""
    ref = _reference()["chain"][request.node.callspec.id]
    et = link(pmt, base(pmt))
    got = np.stack([_np(pmt.logcdf(et, points)), _np(pmt.logccdf(et, points))])[:, n_in:]
    expected = np.zeros_like(got)
    expected[0, :n_below] = -np.inf
    expected[1, n_below:] = -np.inf
    np.testing.assert_array_equal(got, expected)
    assert not np.allclose(got, np.stack([ref["logcdf"], ref["logccdf"]])[:, n_in:])


def test_logcdf_of_exp_below_its_image():
    """The example of ROADMAP §3: pm.logcdf(exp(x), -1) is -inf in the port
    and log 0.5 in pymc_tpu, which clamps -1 to the safe point 1."""
    v = np.full(N, -1.0)
    got = _np(pmt.logcdf(pmt.math.exp(pmt.Normal.dist(0.0, 1.0)), v))
    ref = _np(pmj.logcdf(pmj.math.exp(pmj.Normal.dist(0.0, 1.0)), v))
    assert np.isneginf(got).all()
    np.testing.assert_allclose(ref, np.log(0.5), rtol=1e-12)


def test_odds_ratio_pole_diverges_from_pymc_tpu():
    """t / (1 + t) at y = 1 (no pre-image): -inf in the port, NaN in
    pymc_tpu, which has no image guard there."""
    et, ej = _pair(CHAINS[ODDS].values[0], normal)
    assert np.isneginf(_np(pmt.logp(et, np.ones(N)))).all()
    assert np.isnan(_np(pmj.logp(ej, np.ones(N)))).all()


@pytest.mark.parametrize("link", FOLDS)
def test_fold_matches_pymc_tpu(request, link):
    et, ej = _pair(link, normal)
    assert isinstance(derive_t(et), (FoldedDistribution, TransformedDistribution))
    _close(pmt.logp(et, FOLD_VALUES), _reference()["fold"][request.node.callspec.id], RTOL)
    for fn, arg in (("logcdf", FOLD_VALUES), ("logccdf", FOLD_VALUES), ("icdf", Q)):
        with pytest.raises(NotImplementedError):
            getattr(pmt, fn)(et, arg)
        with pytest.raises(NotImplementedError):
            getattr(pmj, fn)(ej, arg)


@pytest.mark.parametrize("link, values", SWITCHES)
def test_switch_scale_matches_pymc_tpu(request, link, values):
    ref = _reference()["switch"][request.node.callspec.id]
    et = link(pmt, normal(pmt))
    for fn in ("logp", "logcdf", "logccdf"):
        _close(getattr(pmt, fn)(et, values), ref[fn], RTOL)
    _close(pmt.icdf(et, Q), ref["icdf"], RTOL)


def test_switch_scale_with_array_scales():
    def link(pm, x):
        return pm.math.where(x > 0, np.linspace(1.0, 2.0, N) * x, 0.5 * x)

    et, ej = _pair(link, lambda pm: normal(pm, size=N))
    v = np.resize([-1.0, 0.7, 0.3, -2.0], N)
    for fn in ("logp", "logcdf", "logccdf"):
        _close(getattr(pmt, fn)(et, v), getattr(pmj, fn)(ej, v), RTOL)


@pytest.mark.parametrize("link, values", LATTICE)
def test_discrete_base_lattice_matches_pymc_tpu(request, link, values):
    """A Poisson base: the value's pre-image must be an integer (within
    1e-6 in float64), else logp is -inf."""
    ref = _reference()["lattice"][request.node.callspec.id]
    et = link(pmt, poisson(pmt))
    assert derive_t(et).is_discrete
    got = _np(pmt.logp(et, values))
    _close(got, ref["logp"], RTOL)
    assert np.isfinite(got).sum() == 6
    for fn in ("logcdf", "logccdf"):
        _close(getattr(pmt, fn)(et, values), ref[fn], RTOL)


def test_float32_lattice_tolerance():
    """In float32 log(exp(k)) misses an integer k by some ulps of k: the
    port's float32 lattice test is 1e-6 absolute plus 1e-6 relative, so each
    exp(k) up to k = 80 (below float32's overflow) is on the lattice."""
    k = torch.arange(0, 81, dtype=torch.float32)
    expr = pmt.math.exp(pmt.Poisson.dist(30.0))
    assert torch.isfinite(pmt.logp(expr, torch.exp(k))).all()
    assert torch.isneginf(pmt.logp(expr, torch.exp(k + 0.01))).all()


@pytest.mark.parametrize("link, base, values", GRADS)
def test_value_gradient_matches_jax(request, link, base, values):
    v = torch.tensor(np.resize(values, N), dtype=torch.float64, requires_grad=True)
    (got,) = torch.autograd.grad(pmt.logp(link(pmt, base(pmt)), v).sum(), v)
    _close(got, _reference()["grad"][request.node.callspec.id], RTOL)


def _rejected(pm):
    """Expressions pymc_tpu has no density for: each raises TypeError."""
    x, k = pm.Normal.dist(0.0, 1.0), pm.Poisson.dist(2.0)
    return {
        "sin": lambda: pm.math.sin(x), "cos": lambda: pm.math.cos(x),
        "tan": lambda: pm.math.tan(x), "sign": lambda: pm.math.sgn(x),
        "x ** 0": lambda: x ** 0, "x + y": lambda: x + pm.Normal.dist(1.0, 1.0),
        "x + x": lambda: x + x, "(-2) ** x": lambda: (-2.0) ** x, "1 ** x": lambda: 1.0 ** x,
        "x ** [1, 3]": lambda: x ** np.array([1.0, 3.0]),
        "x ** y": lambda: x ** pm.Normal.dist(1.0, 1.0),
        "abs(k)": lambda: abs(k), "switch(k)": lambda: pm.math.where(k > 0, 2.0 * k, k),
        "negative scale": lambda: pm.math.where(x > 0, -2.0 * x, x),
        "gammaln": lambda: pm.math.gammaln(pm.Exponential.dist(1.0)),
        "mean": lambda: pm.math.mean(pm.Normal.dist(0.0, 1.0, size=3)),
        "switch of a constant": lambda: pm.math.where(x > 0, 1.0, 2.0),
        "exp(clip)": lambda: pm.math.exp(pm.math.clip(x, -1.0, 1.0)),
        "exp(A @ x)": lambda: pm.math.exp(np.eye(2) @ pm.Normal.dist(0.0, 1.0, size=2)),
        "exp(broadcast)": lambda: pm.math.exp(pm.math.broadcast_to(x, (3,))),
    }


@pytest.mark.parametrize("name", list(_rejected(pmt)))
def test_rejected_forms_raise_type_error(name):
    for pm, derive in ((pmj, derive_j), (pmt, derive_t)):
        with pytest.raises(TypeError):
            derive(_rejected(pm)[name]())


def test_bare_and_constant_expressions_raise_type_error():
    for pm, derive in ((pmj, derive_j), (pmt, derive_t)):
        x = pm.Normal.dist(0.0, 1.0)
        with pytest.raises(TypeError, match="bare RV"):
            derive(x.to_node())
        with pytest.raises(TypeError, match="terminate at a random variable"):
            derive(pm.math.exp(pm.math.constant(np.array(1.0))))


def _structural(pm):
    """Structural forms (ROADMAP item 6b), each with values of its shape
    (two rows where the form has a batch), all inside its support."""
    m, n = pm.math, pm.Normal.dist
    grid = np.array([[0.4, -1.2, 2.0], [1.1, 0.3, -0.7]])
    return {
        "sum": (lambda: m.sum(n(0, 1, size=3)), [0.5, -1.0, 2.5]),
        "max": (lambda: m.max(n(0, 1, size=3)), [0.3, 1.2, -0.4]),
        "Node.min": (lambda: n(0, 1, size=3).to_node().min(), [0.3, -1.2, -0.4]),
        "stack": (lambda: m.stack([n(0, 1), n(1, 2)]), grid[:, :2]),
        "concatenate": (lambda: m.concatenate([n(0, 1, size=2), n(1, 2, size=1)]), grid),
        "cumsum": (lambda: m.cumsum(n(0, 1, size=3)), grid),
        "argmax": (lambda: m.argmax(pm.Gumbel.dist(np.array([0.0, 0.5, 1.0]), 1.0)),
                   [0, 1, 2]),
        "index": (lambda: n(0, 1, size=3)[0], [0.5, -1.0, 2.5]),
        "exp(index)": (lambda: m.exp(n(0, 1, size=3)[1]), [0.5, 1.0, 2.5]),
        "reshape": (lambda: n(0, 1, size=4).to_node().reshape((2, 2)), grid[:, :2]),
        "transpose": (lambda: m.transpose(n(np.arange(6.0).reshape(2, 3), 1)),
                      np.resize(grid, (3, 2))),
        "astype": (lambda: pm.Poisson.dist(3.0).to_node().astype("float64"), [0.0, 2.0, 5.0]),
        "broadcast_to": (lambda: m.broadcast_to(n(0, 1), (3,)), [0.5, 0.5, 0.5]),
        "matmul": (lambda: np.array([[2.0, 0.5], [0.3, 1.5]]) @ n(0, 1, size=2), grid[:, :2]),
        "clip": (lambda: m.clip(n(0, 1), -1.0, 1.0), [-1.0, 0.3, 1.0]),
        "maximum": (lambda: m.maximum(n(0, 1), 0.0), [0.0, 0.3, 1.7]),
        "round": (lambda: m.round(n(0, 1)), [-2.0, 0.0, 1.0]),
        "floor": (lambda: m.floor(n(0, 1)), [-2.0, 0.0, 1.0]),
        "switch mixture": (lambda: m.where(np.array([True, False]), n(0, 1, size=2),
                                           n(5, 1, size=2)), grid[:, :2] + 4.0),
    }


@pytest.mark.parametrize("name", list(_structural(pmt)))
def test_structural_forms_match_pymc_tpu(name):
    """Each structural form's logp is pymc_tpu's (ROADMAP item 6b is
    ported; tests/test_torch_structural.py holds every form in depth)."""
    (build_t, values), (build_j, _) = _structural(pmt)[name], _structural(pmj)[name]
    v = np.asarray(values, dtype=float)
    _close(pmt.logp(build_t(), v), pmj.logp(build_j(), v), RTOL)


def test_one_dist_object_is_one_leaf():
    x = pmt.Normal.dist(0.0, 1.0)
    assert x.to_node() is x.to_node()
    e = x + x
    assert e.args[0] is e.args[1]
    np.testing.assert_allclose(_np(pmt.logp(np.float64(3.0) + x, 3.5)),
                               _np(pmj.logp(np.float64(3.0) + pmj.Normal.dist(0.0, 1.0), 3.5)),
                               rtol=RTOL)


def _conditioned(pm):
    with pm.Model() as m:
        s = pm.HalfNormal("s", 2.0)
        pm.Normal("x", 0.5, s)
    return m


def test_conditioned_expressions_match_pymc_tpu():
    """Random variables named in env are constants of the derived density:
    x * s, x + s and s ** x (a symbolic base) given s; x + s without env has
    two random operands."""
    mt, mj = _conditioned(pmt), _conditioned(pmj)
    v = np.resize([0.4, 1.3, 2.2], N)
    env_t, env_j = {"s": torch.tensor(1.7, dtype=torch.float64)}, {"s": jnp.float64(1.7)}
    for link in (lambda m: m["x"] * m["s"], lambda m: m["s"] ** m["x"]):
        _close(pmt.logp(link(mt), v, env=env_t), pmj.logp(link(mj), v, env=env_j), RTOL)
    for fn in ("logp", "logcdf", "logccdf"):
        _close(getattr(pmt, fn)(mt["x"] + mt["s"], v, env=env_t),
               getattr(pmj, fn)(mj["x"] + mj["s"], v, env=env_j), RTOL)
    for pm, m in ((pmt, mt), (pmj, mj)):
        with pytest.raises(TypeError, match="exactly one random operand"):
            pm.logp(m["x"] + m["s"], v)


def _lognormal(pm):
    return lambda mu, s, size: pm.math.exp(pm.Normal.dist(mu, s, size=size))


def test_custom_dist_of_an_expression_matches_pymc_tpu():
    """CustomDist(dist=) returning exp of a Normal as a .dist(): its logp,
    logcdf, logccdf, icdf and shape are pymc_tpu's, and log of its draws
    has mean mu within 4 standard errors."""
    ct = pmt.CustomDist.dist(1.0, 1.25, dist=_lognormal(pmt), size=(N,))
    cj = pmj.CustomDist.dist(1.0, 1.25, dist=_lognormal(pmj), size=(N,))
    assert ct.shape == tuple(cj.shape) == (N,)
    v = np.resize([0.4, 2.7, 0.05, 9.0], N)
    for fn in ("logp", "logcdf", "logccdf"):
        _close(getattr(pmt, fn)(ct, v), getattr(pmj, fn)(cj, v), RTOL)
    _close(pmt.icdf(ct, Q), pmj.icdf(cj, Q), RTOL)
    draws = pmt.draw(ct, draws=1000, random_seed=3, device="cpu")
    assert draws.shape == (1000, N) and bool((draws > 0).all())
    logs = torch.log(draws)
    assert abs(float(logs.mean()) - 1.0) < 4 * 1.25 / np.sqrt(logs.numel())
    # the expression itself, drawn through its one random ancestor
    expr = pmt.draw(pmt.math.exp(pmt.Normal.dist(1.0, 1.25)), draws=1000, random_seed=3,
                    device="cpu")
    assert expr.shape == (1000,) and bool((expr > 0).all())
    assert abs(float(torch.log(expr).mean()) - 1.0) < 4 * 1.25 / np.sqrt(1000)


def test_custom_dist_expression_variable_in_a_model():
    """A free CustomDist(dist=exp(Normal)) has the JAX package's (absent)
    default transform and its logp."""
    def build(pm):
        with pm.Model() as m:
            mu = pm.Normal("mu", 0.0, 1.0)
            pm.CustomDist("z", mu, 0.5, dist=_lognormal(pm))
        return m

    mt, mj = build(pmt), build(pmj)
    assert mt.value_vars == mj.value_vars == ["mu", "z"]
    q = np.array([[0.2, 1.4], [-0.3, 0.6]])
    lp, g = mt.logp_dlogp_fn(device="cpu")(torch.tensor(q))
    info, lf = mj.raveled_info(), mj.logp_fn()
    lp_j, g_j = jax.jit(jax.vmap(jax.value_and_grad(lambda x: lf(unravel_vector(x, info)))))(q)
    _close(lp, lp_j, RTOL)
    _close(g, g_j, RTOL)


def _radon_points(D):
    return np.random.default_rng(16).normal(0.0, 0.4, size=(4, D))


@functools.lru_cache(maxsize=None)
def _radon_reference():
    mj = models.radon_lognormal_model(pmj)
    info, lf = mj.raveled_info(), mj.logp_fn()
    run = jax.jit(jax.vmap(jax.value_and_grad(lambda x: lf(unravel_vector(x, info)))))
    return tuple(np.asarray(a) for a in run(_radon_points(info.total_size)))


def test_radon_lognormal_model_matches_pymc_tpu():
    """The slice as a whole: the radon GLM with the CustomDist lognormal
    likelihood, built by both packages: logp and gradient at seeded points;
    and it is the Normal radon GLM less sum(log y)."""
    mt = models.radon_lognormal_model()
    D = mt.raveled_info().total_size
    assert D == 175
    q = torch.tensor(_radon_points(D))
    lp, g = mt.logp_dlogp_fn(device="cpu")(q)
    lp_ref, g_ref = _radon_reference()
    np.testing.assert_allclose(lp.numpy(), lp_ref, rtol=RTOL)
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=RTOL, atol=1e-10)
    from bench import build_model

    lp_n, g_n = build_model(pmt).logp_dlogp_fn(device="cpu")(q)
    log_y = models.radon_data()[2].sum()
    np.testing.assert_allclose(lp.numpy(), lp_n.numpy() - log_y, rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), g_n.numpy(), rtol=1e-12, atol=1e-12)


def test_folded_and_transformed_inputs_are_the_constants():
    """inputs() holds the base's parameters and the links' Node constants,
    never the random leaf, so the model places them and does not take the
    leaf for a free variable."""
    x = pmt.Normal.dist(0.3, 1.2, size=3)
    d = derive_t(pmt.math.exp(x + np.array([0.0, 1.0, 2.0])))
    assert all(c is not x.to_node() for c in d.inputs())
    assert len(d.inputs()) == 3 and all(isinstance(c, pmt.graph.ConstantNode)
                                        for c in d.inputs())
    f = derive_t(abs(x))
    assert isinstance(f, FoldedDistribution) and f.inputs() == x.inputs()
