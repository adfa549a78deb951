"""The continuous distributions of pymc_tpu_torch against pymc_tpu's.

One case per class and method, float64 on the CPU, the same parameters
and values through both packages:
- `logp` (and `logcdf` where the JAX class has one) on a grid with values
  outside the support, at its edges and inside, and a set of invalid
  parameters (-inf there): rtol 1e-12, or 1e-10 where the port's
  continued fraction for the incomplete beta (Beta, StudentT,
  HalfStudentT, SkewStudentT) or torch's Bessel functions (VonMises, Rice)
  stand in for JAX's; atol 1e-15 besides, for log-cdfs a few ulp of 1
  below 0, where torch's log_ndtr is exact and JAX's is not (-6.22e-16
  against -6.66e-16 at z = 8);
- the gradient of logp in the value and the parameters at an interior
  point against `jax.grad`, rtol 1e-10;
- `support_point`, rtol 1e-12;
- 20,000 draws from a seeded `torch.Generator`: mean and variance within 5
  standard errors of the analytic ones (scipy's, or the formula named);
  the two packages cannot draw the same numbers. Cauchy and HalfCauchy,
  which have no moments, pass a one-sample KS test against scipy's cdf
  instead (p > 1e-3); Flat and HalfFlat cannot be drawn from.
Then `icdf` of three classes against pymc_tpu and scipy (every class:
tests/test_torch_icdf.py), and the default transform of every class,
which must be the JAX package's.
"""

import functools
import math

import numpy as np
import pytest
import scipy.integrate as si
import scipy.special as sp
import scipy.stats as st
import torch

import jax
import jax.numpy as jnp

import pymc_tpu as pmj
import pymc_tpu_torch as pmt

RTOL = 1e-12
RTOL_SPECIAL = 1e-10
N_DRAWS = 20_000


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kumaraswamy_mv(a, b):
    m1 = b * sp.beta(1 + 1 / a, b)
    m2 = b * sp.beta(1 + 2 / a, b)
    return m1, m2 - m1**2


def _half_t_mv(nu, sigma):
    m = 2 * sigma * math.sqrt(nu / math.pi) * math.exp(
        sp.gammaln((nu + 1) / 2) - sp.gammaln(nu / 2)) / (nu - 1)
    return m, sigma**2 * nu / (nu - 2) - m**2


def _polya_gamma_mv(h, z):
    # Polson, Scott & Windle (2013): E = h tanh(z/2) / (2z),
    # Var = h (sinh z - z) / (4 z^3 cosh^2(z/2))
    return (h * math.tanh(z / 2) / (2 * z),
            h * (math.sinh(z) - z) / (4 * z**3 * math.cosh(z / 2) ** 2))


def _quad_mv(logpdf, lo, hi):
    """Mean and variance of a density on (lo, hi) by quadrature."""
    m = [si.quad(lambda x: x**k * math.exp(logpdf(x)), lo, hi, limit=200)[0] for k in (0, 1, 2)]
    mean = m[1] / m[0]
    return mean, m[2] / m[0] - mean**2


def _logit_normal_mv(mu, sigma):
    def logpdf(x):
        return (st.norm.logpdf(math.log(x / (1 - x)), mu, sigma) - math.log(x) - math.log1p(-x))
    return _quad_mv(logpdf, 0.0, 1.0)


INTERP_X = np.linspace(-2.0, 3.0, 11)
INTERP_PDF = np.exp(-0.5 * INTERP_X**2) + 0.2 * (INTERP_X > 0.5)


def _interpolated_mv():
    p = INTERP_PDF / np.trapezoid(INTERP_PDF, INTERP_X)

    def pdf(x):
        return np.interp(x, INTERP_X, p)

    m = [si.quad(lambda x: x**k * pdf(x), -2.0, 3.0, points=list(INTERP_X), limit=200)[0]
         for k in (0, 1, 2)]
    return m[1] / m[0], m[2] / m[0] - (m[1] / m[0]) ** 2


# name -> params (valid sets first, then an invalid set), values, the
# parameters to differentiate (default: all), the grad point, and the
# moments of the first parameter set: a frozen scipy distribution, a
# (mean, var) pair, None (no moments: KS against `ks`) or "none" (no draws)
SPECS = {
    "Uniform": dict(
        params=[dict(lower=-1.0, upper=2.5), dict(lower=1.0, upper=0.0)],
        values=[-2.0, -1.0, 0.3, 2.5, 3.0], grad=0.7,
        moments=st.uniform(-1.0, 3.5)),
    "Flat": dict(params=[{}], values=[-3.0, 0.0, 5.0], grad=0.3, moments="none"),
    "HalfFlat": dict(params=[{}], values=[-1.0, 0.0, 2.0], grad=0.3, moments="none"),
    "Normal": dict(
        params=[dict(mu=0.5, sigma=2.0), dict(mu=0.0, tau=4.0), dict(mu=0.0, sigma=-1.0)],
        values=[-3.0, 0.0, 0.5, 4.0], grad=0.2, moments=st.norm(0.5, 2.0)),
    "TruncatedNormal": dict(
        params=[dict(mu=0.5, sigma=1.5, lower=-1.0, upper=2.0), dict(mu=0.0, sigma=1.0, lower=0.3),
                dict(mu=1.0, sigma=2.0, upper=0.0), dict(mu=0.0, sigma=-1.0, lower=0.0)],
        values=[-2.0, -1.0, 0.0, 0.5, 2.0, 2.5], grad=0.4,
        moments=st.truncnorm((-1.0 - 0.5) / 1.5, (2.0 - 0.5) / 1.5, 0.5, 1.5)),
    "HalfNormal": dict(
        params=[dict(sigma=1.5), dict(tau=0.25), dict(sigma=-1.0)],
        values=[-1.0, 0.0, 0.4, 3.0], grad=0.8, moments=st.halfnorm(scale=1.5)),
    "Wald": dict(
        params=[dict(mu=1.5, lam=2.0), dict(mu=1.0, phi=3.0), dict(lam=2.0, phi=1.5),
                dict(mu=1.0, lam=2.0, alpha=0.5), dict(mu=-1.0, lam=2.0)],
        values=[-0.5, 0.0, 0.5, 1.0, 4.0], grad=1.2, moments=st.invgauss(1.5 / 2.0, scale=2.0)),
    "Beta": dict(
        params=[dict(alpha=2.0, beta=3.5), dict(mu=0.3, sigma=0.2), dict(mu=0.6, nu=5.0),
                dict(alpha=0.5, beta=0.5), dict(alpha=-1.0, beta=2.0)],
        values=[-0.1, 0.0, 0.2, 0.7, 1.0, 1.1], grad=0.35, moments=st.beta(2.0, 3.5),
        special=("logcdf",)),
    "Kumaraswamy": dict(
        params=[dict(a=2.0, b=3.0), dict(a=0.5, b=1.5), dict(a=-1.0, b=2.0)],
        values=[-0.1, 0.0, 0.3, 0.9, 1.0, 1.2], grad=0.4, moments=_kumaraswamy_mv(2.0, 3.0)),
    "Exponential": dict(
        params=[dict(lam=1.5), dict(scale=2.0), dict(lam=-1.0)],
        values=[-1.0, 0.0, 0.3, 4.0], grad=0.6, moments=st.expon(scale=1 / 1.5)),
    "Laplace": dict(
        params=[dict(mu=0.5, b=1.5), dict(mu=0.0, b=-1.0)],
        values=[-40.0, -3.0, 0.5, 1.0, 40.0], grad=1.3, moments=st.laplace(0.5, 1.5)),
    "AsymmetricLaplace": dict(
        params=[dict(kappa=1.5, mu=0.5, b=2.0), dict(q=0.3, mu=0.0, b=1.0),
                dict(kappa=-1.0, b=1.0)],
        values=[-3.0, 0.5, 0.0, 2.0], grad=1.1, moments=st.laplace_asymmetric(1.5, 0.5, 0.5)),
    "LogNormal": dict(
        params=[dict(mu=0.3, sigma=0.6), dict(mu=0.0, tau=2.0), dict(mu=0.0, sigma=-1.0)],
        values=[-1.0, 0.0, 0.5, 2.0], grad=1.4,
        moments=st.lognorm(0.6, scale=math.exp(0.3))),
    "StudentT": dict(
        params=[dict(nu=5.0, mu=0.5, sigma=1.5), dict(nu=3.0, mu=0.0, lam=4.0),
                dict(nu=0.5, mu=1.0, sigma=2.0), dict(nu=-1.0, mu=0.0, sigma=1.0)],
        values=[-1e4, -3.0, 0.5, 2.0, 1e4], grad=1.0, moments=st.t(5.0, 0.5, 1.5),
        special=("logcdf",)),
    "HalfStudentT": dict(
        params=[dict(nu=6.0, sigma=1.5), dict(nu=3.0, lam=0.5), dict(nu=-1.0, sigma=1.0)],
        values=[-1.0, 0.0, 0.5, 3.0, 1e4], grad=0.9, moments=_half_t_mv(6.0, 1.5),
        special=("logcdf",)),
    "Pareto": dict(
        params=[dict(alpha=4.0, m=1.5), dict(alpha=-1.0, m=1.0)],
        values=[0.5, 1.5, 2.0, 10.0], grad=2.5, moments=st.pareto(4.0, scale=1.5)),
    "Cauchy": dict(
        params=[dict(alpha=0.5, beta=1.5), dict(alpha=0.0, beta=-1.0)],
        values=[-10.0, 0.0, 0.5, 3.0], grad=0.8, moments=None, ks=st.cauchy(0.5, 1.5)),
    "HalfCauchy": dict(
        params=[dict(beta=1.5), dict(beta=-1.0)],
        values=[-1.0, 0.0, 0.5, 3.0], grad=0.8, moments=None, ks=st.halfcauchy(scale=1.5)),
    "Gamma": dict(
        params=[dict(alpha=2.5, beta=1.5), dict(mu=2.0, sigma=0.5), dict(alpha=0.5, beta=2.0),
                dict(alpha=-1.0, beta=1.0)],
        values=[-1.0, 0.0, 0.5, 3.0], grad=1.1, moments=st.gamma(2.5, scale=1 / 1.5)),
    "InverseGamma": dict(
        params=[dict(alpha=5.0, beta=2.0), dict(alpha=2.0), dict(mu=1.5, sigma=0.5),
                dict(alpha=-1.0, beta=1.0)],
        values=[-1.0, 0.0, 0.2, 0.5, 3.0], grad=0.6, moments=st.invgamma(5.0, scale=2.0)),
    "ChiSquared": dict(
        params=[dict(nu=3.0), dict(nu=-1.0)],
        values=[-1.0, 0.0, 0.5, 4.0], grad=1.7, moments=st.chi2(3.0)),
    "Weibull": dict(
        params=[dict(alpha=1.5, beta=2.0), dict(alpha=-1.0, beta=1.0)],
        values=[-1.0, 0.0, 0.7, 3.0], grad=1.3, moments=st.weibull_min(1.5, scale=2.0)),
    "ExGaussian": dict(
        params=[dict(mu=0.5, sigma=1.0, nu=2.0), dict(mu=0.0, sigma=1.0, nu=0.01),
                dict(mu=0.0, sigma=-1.0, nu=1.0)],
        values=[-3.0, 0.0, 0.5, 5.0], grad=1.0, moments=st.exponnorm(2.0, 0.5, 1.0)),
    "VonMises": dict(
        params=[dict(mu=0.0, kappa=2.0), dict(mu=-2.0, kappa=0.5), dict(mu=0.0, kappa=-1.0)],
        values=[-4.0, -math.pi, 0.0, 1.0, math.pi, 4.0], grad=0.7,
        moments=st.vonmises(2.0), special=("logp",)),
    "SkewNormal": dict(
        params=[dict(mu=0.5, sigma=1.5, alpha=2.0), dict(mu=0.0, tau=2.0, alpha=-1.0),
                dict(mu=0.0, sigma=-1.0, alpha=1.0)],
        values=[-3.0, 0.0, 0.5, 4.0], grad=0.9, moments=st.skewnorm(2.0, 0.5, 1.5)),
    "Triangular": dict(
        params=[dict(lower=-1.0, c=0.5, upper=2.0), dict(lower=0.0, c=2.0, upper=1.0)],
        values=[-2.0, -1.0, 0.0, 0.5, 1.5, 2.0, 3.0], grad=0.2,
        moments=st.triang(0.5, loc=-1.0, scale=3.0)),
    "Gumbel": dict(
        params=[dict(mu=0.5, beta=1.5), dict(mu=0.0, beta=-1.0)],
        values=[-3.0, 0.5, 2.0, 10.0], grad=0.9, moments=st.gumbel_r(0.5, 1.5)),
    "Logistic": dict(
        params=[dict(mu=0.5, s=1.5), dict(mu=0.0, s=-1.0)],
        values=[-50.0, 0.0, 0.5, 50.0], grad=0.9, moments=st.logistic(0.5, 1.5)),
    "LogitNormal": dict(
        params=[dict(mu=0.3, sigma=0.8), dict(mu=0.0, tau=2.0), dict(mu=0.0, sigma=-1.0)],
        values=[-0.1, 0.0, 0.2, 0.7, 1.0, 1.1], grad=0.45, moments=_logit_normal_mv(0.3, 0.8)),
    "Rice": dict(
        params=[dict(nu=1.5, sigma=1.0), dict(b=2.0, sigma=0.5), dict(nu=-1.0, sigma=1.0)],
        values=[-1.0, 0.0, 0.5, 2.0, 30.0], grad=1.2, moments=st.rice(1.5, scale=1.0),
        special=("logp",)),
    "Moyal": dict(
        params=[dict(mu=0.5, sigma=1.5), dict(mu=0.0, sigma=-1.0)],
        values=[-3.0, 0.5, 2.0, 10.0], grad=0.9, moments=st.moyal(0.5, 1.5)),
    "Interpolated": dict(
        params=[dict(x_points=INTERP_X, pdf_points=INTERP_PDF)],
        values=[-3.0, -2.0, -0.25, 0.5, 1.7, 3.0, 3.5], grad=0.3, grad_params=(),
        moments=_interpolated_mv()),
    "SkewStudentT": dict(
        params=[dict(a=3.0, b=2.0, mu=0.5, sigma=1.5), dict(a=1.0, b=4.0, lam=2.0),
                dict(a=-1.0, b=2.0)],
        values=[-10.0, 0.0, 0.5, 3.0], grad=0.7, moments=st.jf_skew_t(3.0, 2.0, 0.5, 1.5),
        special=("logcdf",)),
    "PolyaGamma": dict(
        params=[dict(h=1.0, z=1.5), dict(h=2.0, z=0.0), dict(h=-1.0, z=1.0)],
        values=[-1.0, 0.0, 0.1, 0.4, 1.5], grad=0.3, moments=_polya_gamma_mv(1.0, 1.5)),
}
assert sorted([*SPECS, "Lognormal"]) == sorted(pmj.distributions.continuous.__all__)
LOGCDF = sorted(n for n in SPECS if "_logcdf" in vars(getattr(pmj, n)))


def _values(name):
    return np.asarray(SPECS[name]["values"], dtype=np.float64)


def compare(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-15)


ICDF_NAMES = ("Normal", "Beta", "StudentT")
ICDF_Q = np.array([0.05, 0.5, 0.9])
TRANSFORM_V = np.linspace(-2.0, 2.0, 5)


def _grad_args(name):
    """(the parameters held fixed, the names of those differentiated, the
    point: the value first, then those parameters)."""
    spec = SPECS[name]
    params = spec["params"][0]
    keys = [k for k in params if k in spec.get("grad_params", params)]
    fixed = {k: v for k, v in params.items() if k not in keys}
    return fixed, keys, [spec["grad"]] + [params[k] for k in keys]


@functools.lru_cache(maxsize=None)
def _references():
    """Every pymc_tpu value of this module's tests, traced and compiled as
    one jitted function (a compile, or an eager dispatch of every op, a
    case took most of the module's time): each parameter set's logp and
    logcdf at the values, the support points, the gradients of logp, the
    quantiles and the default transforms' backward maps."""

    def run():
        out = {}
        for name, spec in SPECS.items():
            v = jnp.asarray(_values(name))
            for i, params in enumerate(spec["params"]):
                d = getattr(pmj, name).dist(**params)
                out[f"logp {name} {i}"] = d.logp(v)
                if name in LOGCDF:
                    out[f"logcdf {name} {i}"] = d.logcdf(v)
                if i < 2:
                    out[f"support_point {name} {i}"] = jnp.asarray(d.support_point())
            fixed, keys, x0 = _grad_args(name)

            def f_jax(*xs, name=name, fixed=fixed, keys=keys):
                d = getattr(pmj, name).dist(**fixed, **dict(zip(keys, xs[1:])))
                return jnp.sum(d.logp(xs[0]))

            out[f"grad {name}"] = jax.grad(f_jax, argnums=tuple(range(len(x0))))(
                *[jnp.asarray(float(x)) for x in x0])
            tj = getattr(pmj, name).dist(**spec["params"][0]).default_transform()
            if tj is not None:
                out[f"transform {name}"] = tj.backward(jnp.asarray(TRANSFORM_V))
        for name in ICDF_NAMES:
            d = getattr(pmj, name).dist(**SPECS[name]["params"][0])
            out[f"icdf {name}"] = d.icdf(jnp.asarray(ICDF_Q))
        return out

    return jax.tree.map(np.asarray, jax.jit(run)())


def both(name, method, i):
    """(port's, JAX package's) `method` of `.dist(**params)`, the i-th
    parameter set, at the values."""
    d = getattr(pmt, name).dist(**SPECS[name]["params"][i])
    got = getattr(d, method)(torch.as_tensor(_values(name)))
    return got.detach().numpy(), _references()[f"{method} {name} {i}"]


@pytest.mark.parametrize("name", sorted(SPECS))
def test_logp_matches(name):
    rtol = RTOL_SPECIAL if "logp" in SPECS[name].get("special", ()) else RTOL
    for i in range(len(SPECS[name]["params"])):
        got, ref = both(name, "logp", i)
        compare(got, ref, rtol)
    if len(SPECS[name]["params"]) > 1:
        assert np.isneginf(both(name, "logp", len(SPECS[name]["params"]) - 1)[0]).all()


@pytest.mark.parametrize("name", LOGCDF)
def test_logcdf_matches(name):
    rtol = RTOL_SPECIAL if "logcdf" in SPECS[name].get("special", ()) else RTOL
    for i in range(len(SPECS[name]["params"])):
        got, ref = both(name, "logcdf", i)
        compare(got, ref, rtol)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_logp_gradient_matches(name):
    fixed, keys, x0 = _grad_args(name)
    ref = _references()[f"grad {name}"]
    xs = [torch.tensor(float(x), dtype=torch.float64, requires_grad=True) for x in x0]
    d = getattr(pmt, name).dist(**fixed, **dict(zip(keys, xs[1:])))
    out = d.logp(xs[0]).sum()
    # a flat density does not depend on its value at all
    got = torch.autograd.grad(out, xs, allow_unused=True) if out.requires_grad else [None] * len(xs)
    for g, r in zip(got, ref):
        g = 0.0 if g is None else float(g)
        np.testing.assert_allclose(g, float(r), rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_support_point_matches(name):
    for i, params in enumerate(SPECS[name]["params"][:2]):
        ref = _references()[f"support_point {name} {i}"]
        got = getattr(pmt, name).dist(**params).support_point().numpy()
        np.testing.assert_allclose(got, ref, rtol=RTOL)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_draws_match_moments(name):
    spec = SPECS[name]
    d = getattr(pmt, name).dist(**spec["params"][0])
    gen = torch.Generator().manual_seed(sum(map(ord, name)))
    if spec["moments"] == "none":
        with pytest.raises(NotImplementedError, match="Cannot sample"):
            d.sample(gen, N_DRAWS)
        return
    x = d.sample(gen, N_DRAWS).numpy()
    assert x.shape == (N_DRAWS,) and x.dtype == np.float64 and np.isfinite(x).all()
    if spec["moments"] is None:
        assert st.kstest(x, spec["ks"].cdf).pvalue > 1e-3
        return
    m = spec["moments"]
    mean, var = (m.mean(), m.var()) if hasattr(m, "mean") else m
    se_mean = math.sqrt(var / N_DRAWS)
    c = x - x.mean()
    se_var = math.sqrt(max(np.mean(c**4) - np.mean(c**2) ** 2, 0.0) / N_DRAWS)
    assert abs(x.mean() - mean) < 5 * se_mean, (x.mean(), mean, se_mean)
    assert abs(x.var() - var) < 5 * se_var, (x.var(), var, se_var)


def test_lognormal_alias():
    assert pmt.Lognormal is pmt.LogNormal


@pytest.mark.parametrize("name", ICDF_NAMES)
def test_icdf_is_not_ported_yet(name):
    # named when icdf raised; the quantiles are ported now and are held to
    # pymc_tpu's and to scipy's here (every class: tests/test_torch_icdf.py)
    params = SPECS[name]["params"][0]
    q = ICDF_Q
    got = getattr(pmt, name).dist(**params).icdf(torch.as_tensor(q)).numpy()
    ref = _references()[f"icdf {name}"]
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-9)
    # StudentT's median comes out of the bisection 2e-8 off, in both packages
    np.testing.assert_allclose(got, SPECS[name]["moments"].ppf(q), rtol=1e-8, atol=1e-7)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_default_transform_matches(name):
    tj = getattr(pmj, name).dist(**SPECS[name]["params"][0]).default_transform()
    tt = getattr(pmt, name).dist(**SPECS[name]["params"][0]).default_transform()
    assert (tt is None) == (tj is None)
    if tj is not None:
        assert type(tt).__name__ == type(tj).__name__ and tt.name == tj.name
        np.testing.assert_allclose(tt.backward(torch.as_tensor(TRANSFORM_V)).numpy(),
                                   _references()[f"transform {name}"], rtol=RTOL)


def test_interpolated_free_variable_matches():
    # its tables are graph constants and its lookup runs under vmap
    from pymc_tpu.blocking import unravel_vector

    def build(pm):
        with pm.Model() as m:
            a = pm.Interpolated("a", INTERP_X, INTERP_PDF)
            pm.Normal("y", a, 1.0, observed=np.array([0.3, -0.4]))
        return m

    mj, mt = build(pmj), build(pmt)
    q = np.array([[-8.0], [-0.5], [0.0], [1.3], [6.0]])
    lp, grad = mt.logp_dlogp_fn(device="cpu")(torch.as_tensor(q))
    info = mj.raveled_info()
    f = jax.jit(jax.vmap(jax.value_and_grad(lambda z: mj.logp_fn()(unravel_vector(z, info)))))
    ref_lp, ref_grad = f(jnp.asarray(q))
    np.testing.assert_allclose(lp.numpy(), np.asarray(ref_lp), rtol=1e-10)
    np.testing.assert_allclose(grad.numpy(), np.asarray(ref_grad), rtol=1e-10, atol=1e-12)
