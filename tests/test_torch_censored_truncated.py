"""Censored and Truncated in the port against pymc_tpu, float64 on the CPU.

Each combinator over a continuous base (Normal; Gamma, whose quantile is
a bisection) and a discrete one (Poisson), with a lower bound only, an
upper bound only and both: logp, logcdf, icdf and support_point at the same
numpy inputs (rtol 1e-12, 1e-9 through a bisection); the logp and its
gradient of models that hold them, through `logp_dlogp_fn`; NaN
observations imputed through `_gathered`; a bound that float32 cannot hold
compared with float32 data; and draws against the exact truncated and
censored moments (scipy), within 5 standard errors. Where the port keeps
PyMC's semantics: `Truncated.icdf` of q outside [0, 1] is NaN, where
pymc_tpu maps it into the base's range.
"""

import functools
import warnings

import numpy as np
import pytest
import scipy.stats as st
import torch

import jax
import jax.numpy as jnp

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from pymc_tpu.blocking import unravel_vector
from pymc_tpu.exceptions import ImputationWarning as ImputationWarningJ
from pymc_tpu_torch.exceptions import ImputationWarning

BOUNDS = {"lower": (-1.0, None), "upper": (None, 1.5), "both": (-1.0, 1.5)}
INT_BOUNDS = {"lower": (2, None), "upper": (None, 6), "both": (2, 6)}
VALUES = np.array([-2.0, -1.0, -0.3, 0.5, 1.5, 2.5])
COUNTS = np.arange(0, 10)
Q = np.array([0.0, 0.02, 0.3, 0.5, 0.8, 0.99, 1.0])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _pair(kind, base, bounds):
    """(pymc_tpu's, the port's) combinator over the same base."""
    lo, hi = bounds
    make = {"normal": lambda pm: pm.Normal.dist(0.5, 1.3),
            "gamma": lambda pm: pm.Gamma.dist(3.0, 2.0),
            "poisson": lambda pm: pm.Poisson.dist(3.5)}[base]
    return (getattr(pmj, kind).dist(make(pmj), lower=lo, upper=hi),
            getattr(pmt, kind).dist(make(pmt), lower=lo, upper=hi))


CASES = [(kind, base, side) for kind in ("Censored", "Truncated")
         for base in ("normal", "poisson") for side in BOUNDS]
FUNCTIONS = ("logp", "logcdf", "logccdf")
# the bisection case: Truncated Gamma(3, 2) on [0.5, 2.5]
GAMMA_Q = np.array([0.01, 0.3, 0.7, 0.99])


def _case(kind, base, side):
    """(pymc_tpu's, the port's) combinator and the values to evaluate."""
    bounds = (INT_BOUNDS if base == "poisson" else BOUNDS)[side]
    return (*_pair(kind, base, bounds), COUNTS if base == "poisson" else VALUES)


@functools.lru_cache(maxsize=None)
def _references():
    """Every pymc_tpu value of this module's tests, traced and compiled as
    one jitted function (a compile a case would take most of the module's
    time): each case's log-densities and support point, the quantiles, and
    each model's logp and gradient at `_model_points`. Returns (values,
    {model name: raveled info})."""
    cases = {c: _case(*c)[0] for c in CASES}
    icdfs = {(kind, side): _pair(kind, "normal", BOUNDS[side])[0]
             for kind in ("Censored", "Truncated") for side in BOUNDS}
    gamma = _pair("Truncated", "gamma", (0.5, 2.5))[0]
    models = {}
    for name, (build_j, _) in MODELS.items():
        mj = build_j(pmj)
        info, lf = mj.raveled_info(), mj.logp_fn()
        models[name] = (info, jax.vmap(jax.value_and_grad(
            lambda x, lf=lf, info=info: lf(unravel_vector(x, info)))))

    def evaluate(points):
        out = {c: tuple(getattr(d, fn)(jnp.asarray(_case(*c)[2])) for fn in FUNCTIONS)
               + (d.support_point(),) for c, d in cases.items()}
        out.update({("icdf",) + k: d.icdf(jnp.asarray(Q)) for k, d in icdfs.items()})
        out[("outside",)] = icdfs[("Truncated", "both")].icdf(jnp.asarray([-0.1, 1.1]))
        out[("gamma",)] = gamma.icdf(jnp.asarray(GAMMA_Q))
        out.update({("model", n): f(points[n]) for n, (_, f) in models.items()})
        return out

    points = {n: _model_points(info) for n, (info, _) in models.items()}
    out = jax.jit(evaluate)(points)
    return jax.tree_util.tree_map(np.asarray, out), {n: i for n, (i, _) in models.items()}


def _model_points(info):
    return np.random.default_rng(3).normal(0.0, 0.3, size=(6, info.total_size))


@pytest.mark.parametrize("kind,base,side", CASES)
def test_logp_logcdf_and_support_point_match(kind, base, side):
    dj, dt, v = _case(kind, base, side)
    refs = _references()[0][(kind, base, side)]
    for fn, ref in zip(FUNCTIONS, refs):
        got = _np(getattr(dt, fn)(torch.as_tensor(v)))
        np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-14, err_msg=fn)
    sp_t, sp_j = _np(dt.support_point()), refs[-1]
    np.testing.assert_allclose(sp_t, sp_j, rtol=1e-12)
    # the port's is int64 for a discrete base, as its values are (pymc_tpu's
    # Censored gives a float there)
    assert sp_t.dtype == (np.int64 if base == "poisson" else np.float64)
    assert dt.default_transform() is None if kind == "Censored" or base == "poisson" else (
        type(dt.default_transform()).__name__ == type(dj.default_transform()).__name__)


@pytest.mark.parametrize("kind,side", [(k, s) for k in ("Censored", "Truncated") for s in BOUNDS])
def test_icdf_matches(kind, side):
    dt = _pair(kind, "normal", BOUNDS[side])[1]
    refs = _references()[0]
    got = _np(dt.icdf(torch.as_tensor(Q)))
    np.testing.assert_allclose(got, refs[("icdf", kind, side)], rtol=1e-12)
    out = _np(dt.icdf(torch.tensor([-0.1, 1.1], dtype=torch.float64)))
    assert np.isnan(out).all()
    if kind == "Truncated" and side == "both":
        # pymc_tpu maps these into (0, 1) and gives quantiles outside the bounds
        assert np.isfinite(refs[("outside",)]).all()
    with pytest.raises(NotImplementedError):
        _pair(kind, "poisson", INT_BOUNDS[side])[1].icdf(torch.as_tensor(Q))


def test_truncated_gamma_icdf_goes_through_the_bisection():
    dt = _pair("Truncated", "gamma", (0.5, 2.5))[1]
    got = _np(dt.icdf(torch.as_tensor(GAMMA_Q)))
    np.testing.assert_allclose(got, _references()[0][("gamma",)], rtol=1e-9)
    g = st.gamma(3.0, scale=0.5)
    lo, hi = g.cdf(0.5), g.cdf(2.5)
    np.testing.assert_allclose(got, g.ppf(lo + GAMMA_Q * (hi - lo)), rtol=1e-9)


def censored_model(pm):
    data = np.array([-1.0, -0.4, 0.2, 1.5, 1.5, 0.9, -1.0, 0.7])
    with pm.Model() as m:
        mu = pm.Normal("mu", 0.0, 2.0)
        sigma = pm.HalfNormal("sigma", 1.0)
        pm.Censored("y", pm.Normal.dist(mu, sigma), lower=-1.0, upper=1.5, observed=data)
        lam = pm.Gamma("lam", 2.0, 1.0)
        pm.Censored("k", pm.Poisson.dist(lam), lower=None, upper=4,
                    observed=np.array([0, 2, 4, 4, 1, 3]))
    return m


def truncated_model(pm):
    with pm.Model() as m:
        mu = pm.Normal("mu", 0.0, 2.0)
        sigma = pm.HalfNormal("sigma", 1.0)
        pm.Truncated("x", pm.Normal.dist(mu, sigma), lower=-1.0, upper=2.0)
        pm.Truncated("z", pm.Normal.dist(mu, 1.0), lower=0.3, upper=None, shape=2)
        pm.Truncated("y", pm.Gamma.dist(2.0, sigma), lower=0.5, upper=3.0,
                     observed=np.array([0.6, 1.1, 2.9, 1.7]))
        pm.Truncated("k", pm.Poisson.dist(sigma + 1.0), lower=1, upper=5,
                     observed=np.array([1, 2, 5, 3]))
    return m


def _imputed(pm, warning, kind):
    data = np.array([0.4, np.nan, 1.5, -0.2, np.nan, 1.5])
    with pytest.warns(warning):
        with pm.Model() as m:
            mu = pm.Normal("mu", 0.0, 2.0)
            sigma = pm.HalfNormal("sigma", 1.0)
            getattr(pm, kind)("y", pm.Normal.dist(mu, sigma), lower=-1.0, upper=1.5,
                              observed=data)
    return m


MODELS = {
    "censored": (censored_model, censored_model),
    "truncated": (truncated_model, truncated_model),
    "imputed censored": (lambda pm: _imputed(pm, ImputationWarningJ, "Censored"),
                         lambda pm: _imputed(pm, ImputationWarning, "Censored")),
    "imputed truncated": (lambda pm: _imputed(pm, ImputationWarningJ, "Truncated"),
                          lambda pm: _imputed(pm, ImputationWarning, "Truncated")),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_model_logp_and_grad_match(name):
    refs, infos = _references()
    mt, ij = MODELS[name][1](pmt), infos[name]
    it = mt.raveled_info()
    assert list(it.names) == list(ij.names) and it.shapes == ij.shapes
    lj, gj = refs[("model", name)]
    lt, gt = mt.logp_dlogp_fn(device="cpu")(torch.as_tensor(_model_points(ij)))
    assert np.isfinite(lt.numpy()).all()
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-10)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-10, atol=1e-10)


def test_imputed_variables_take_the_gathered_distribution():
    for kind, transform in (("Censored", None), ("Truncated", "interval")):
        m = _imputed(pmt, ImputationWarning, kind)
        free = m["y_unobserved"]
        assert type(free.dist).__name__ == kind and free.shape == (2,)
        assert (free.transform is None) == (transform is None)
        assert type(free.dist.base).__name__ == "Normal"


def test_a_bound_float32_cannot_hold_matches_float32_data():
    # 0.1 in float32 is not 0.1: the float64 bound is rounded to the data's
    # type before the comparison, so the censored value takes the tail mass
    d = pmt.Censored.dist(pmt.Normal.dist(0.0, 1.0), lower=-0.3, upper=0.1)
    value = torch.tensor([0.1, -0.3, 0.05], dtype=torch.float32)
    lp = _np(d.logp(value))
    mass = [st.norm.logsf(np.float32(0.1)), st.norm.logcdf(np.float32(-0.3))]
    np.testing.assert_allclose(lp[:2], mass, rtol=1e-6)
    np.testing.assert_allclose(lp[2], st.norm.logpdf(np.float32(0.05)), rtol=1e-6)
    # the same model placed in float32 and in float64 agree
    with pmt.Model() as m:
        mu = pmt.Normal("mu", 0.0, 1.0)
        pmt.Censored("y", pmt.Normal.dist(mu, 1.0), lower=-0.3, upper=0.1,
                     observed=np.array([0.1, 0.1, -0.3, 0.0]))
    q = torch.tensor([[0.2], [-0.1]], dtype=torch.float64)
    l64 = m.logp_dlogp_fn(device="cpu")(q)[0]
    l32 = m.logp_dlogp_fn(device="cpu", dtype=torch.float32)(q.float())[0]
    np.testing.assert_allclose(l32.double().numpy(), l64.numpy(), rtol=1e-5)


def _truncated_moments(kind):
    if kind == "normal":
        a, b = (-1.0 - 0.5) / 1.3, (1.5 - 0.5) / 1.3
        return st.truncnorm(a, b, loc=0.5, scale=1.3).stats("mv")
    if kind == "gamma":
        g = st.gamma(3.0, scale=0.5)
        x = np.linspace(0.5, 2.5, 200_001)
        w = g.pdf(x) / (g.cdf(2.5) - g.cdf(0.5))
        m = np.trapezoid(x * w, x)
        return m, np.trapezoid((x - m) ** 2 * w, x)
    po = st.poisson(3.5)
    k = np.arange(2, 7)
    w = po.pmf(k) / po.pmf(k).sum()
    m = (k * w).sum()
    return m, ((k - m) ** 2 * w).sum()


@pytest.mark.parametrize("base", ["normal", "gamma", "poisson"])
def test_truncated_draws_match_the_exact_moments(base):
    bounds = {"normal": (-1.0, 1.5), "gamma": (0.5, 2.5), "poisson": (2, 6)}[base]
    _, dt = _pair("Truncated", base, bounds)
    n = 4000
    x = _np(dt.sample(torch.Generator().manual_seed(0), (n,)))
    assert x.shape == (n,) and (x >= bounds[0]).all() and (x <= bounds[1]).all()
    assert x.dtype == (np.int64 if base == "poisson" else np.float64)
    mean, var = _truncated_moments(base)
    c = x - x.mean()
    assert abs(x.mean() - mean) / np.sqrt(var / n) < 5.0
    assert abs(c.var() - var) / np.sqrt((np.mean(c**4) - np.mean(c**2) ** 2) / n) < 5.0


def test_censored_draws_match_the_exact_moments():
    _, dt = _pair("Censored", "normal", BOUNDS["both"])
    n = 4000
    x = _np(dt.sample(torch.Generator().manual_seed(1), (n,)))
    assert x.min() == -1.0 and x.max() == 1.5
    nd = st.norm(0.5, 1.3)
    p_lo, p_hi = nd.cdf(-1.0), nd.sf(1.5)
    tn = st.truncnorm((-1.0 - 0.5) / 1.3, (1.5 - 0.5) / 1.3, loc=0.5, scale=1.3)
    p_in = 1.0 - p_lo - p_hi
    m1 = -1.0 * p_lo + 1.5 * p_hi + p_in * tn.mean()
    m2 = p_lo + 1.5**2 * p_hi + p_in * (tn.var() + tn.mean() ** 2)
    assert abs(x.mean() - m1) / np.sqrt((m2 - m1**2) / n) < 5.0
    assert abs((x == 1.5).mean() - p_hi) / np.sqrt(p_hi * (1 - p_hi) / n) < 5.0


def test_prior_predictive_draws_anew_for_each_point():
    # the forward sampler vmaps the draws: Truncated's uniforms and the
    # discrete scan run out of place
    with pmt.Model() as m:
        mu = pmt.Normal("mu", 0.0, 1.0)
        pmt.Truncated("x", pmt.Normal.dist(mu, 1.0), lower=0.0, upper=None)
        pmt.Truncated("k", pmt.Poisson.dist(3.0), lower=1, upper=None)
        pmt.Censored("c", pmt.Normal.dist(mu, 1.0), lower=-0.5, upper=0.5)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        draws = pmt.sample_prior_predictive(draws=300, model=m, random_seed=0, device="cpu",
                                            return_inferencedata=False)
    assert (draws["x"] >= 0).all() and len(np.unique(draws["x"])) == 300
    assert (draws["k"] >= 1).all() and draws["k"].dtype == np.int64
    assert 1.5 < draws["k"].mean() < 5.0
    assert (np.abs(draws["c"]) <= 0.5).all()


def test_exceptions_match():
    for kind in ("Censored", "Truncated"):
        with pytest.raises(ValueError, match="dist"):
            getattr(pmt, kind).dist(1.5, lower=0)
        with pytest.raises(NotImplementedError, match="univariate"):
            getattr(pmt, kind).dist(pmt.MvNormal.dist(np.zeros(2), np.eye(2)), lower=0)
    with pytest.raises(ValueError, match="lower and/or upper"):
        pmt.Truncated.dist(pmt.Normal.dist(0, 1))
