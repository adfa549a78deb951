"""The quantile functions of the port against pymc_tpu, float64 on the CPU.

Every class that has an `_icdf` in the JAX package (23 continuous, 3
discrete) at one grid of probabilities, the same numpy inputs on both
sides: rtol 1e-12 for the closed forms, 1e-10 at their extreme tails (q =
1e-10 and 1 - 1e-10, where erfinv's condition number reaches 1e10); rtol
1e-9 after `icdf_bisection` (Beta, StudentT, HalfStudentT, Gamma,
InverseGamma, ChiSquared), with an absolute floor of 1e-8 times the scale
where the quantile is 0 (StudentT at q = 1/2 comes out of the bisection
near 3e-9 in both packages). The Student-t log-cdf never reaches 0, so at
q = 1 exactly the bisection answers with the top of its bracket, not a
quantile: StudentT and HalfStudentT are held there only to be huge. Then
NaN for q outside [0, 1] and for invalid parameters (each class's
quantiles come from one call, the valid and the invalid parameters side by
side), batched parameters against a column of q, `pm.icdf`, and the
helpers of dist_math.

Two places where the port keeps PyMC's semantics and the JAX package does
not (ROADMAP §3): ChiSquared's quantile raises TypeError in pymc_tpu (its
`_icdf` hands Gamma's parameters to ChiSquared's `_logcdf`), so the port's
is held to pymc_tpu's Gamma(nu / 2, 1 / 2) and to scipy; and an invalid
parameter gives NaN in the port (PyMC's `check_icdf_parameters`) where
pymc_tpu returns a number.
"""

import functools

import numpy as np
import pytest
import scipy.stats as st
import torch

import jax
import jax.numpy as jnp

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from pymc_tpu.distributions import dist_math as dmj
from pymc_tpu_torch.distributions import dist_math as dmt

INTERP_X = np.linspace(-2.0, 3.0, 11)
INTERP_PDF = np.exp(-0.5 * INTERP_X**2) + 0.2 * (INTERP_X > 0.5)

Q = np.array([0.0, 1e-10, 1e-3, 0.05, 0.3, 0.5, 0.7, 0.95, 0.999, 1.0 - 1e-10, 1.0])
BISECTION = {"Beta", "StudentT", "HalfStudentT", "Gamma", "InverseGamma", "ChiSquared"}
# Student-t's log-cdf stays below 0 up to the bracket's top, so q = 1
# lands there
BRACKET_TOP = {"StudentT", "HalfStudentT"}

# name -> (valid parameters, an invalid set or None)
CASES = {
    "Uniform": (dict(lower=-1.0, upper=2.5), dict(lower=1.0, upper=0.0)),
    "Normal": (dict(mu=0.5, sigma=2.0), dict(mu=0.0, sigma=-1.0)),
    "HalfNormal": (dict(sigma=1.5), dict(sigma=-1.0)),
    "Beta": (dict(alpha=2.0, beta=3.5), dict(alpha=-1.0, beta=2.0)),
    "Kumaraswamy": (dict(a=2.0, b=3.0), dict(a=-1.0, b=2.0)),
    "Exponential": (dict(lam=1.5), dict(lam=-1.0)),
    "Laplace": (dict(mu=0.5, b=1.5), dict(mu=0.0, b=-1.0)),
    "LogNormal": (dict(mu=0.3, sigma=0.8), dict(mu=0.0, sigma=-1.0)),
    "StudentT": (dict(nu=4.0, mu=0.5, sigma=2.0), dict(nu=-1.0, mu=0.0, sigma=1.0)),
    "HalfStudentT": (dict(nu=3.0, sigma=1.5), dict(nu=3.0, sigma=-1.0)),
    "Pareto": (dict(alpha=3.0, m=1.2), dict(alpha=-1.0, m=1.0)),
    "Cauchy": (dict(alpha=0.5, beta=2.0), dict(alpha=0.0, beta=-1.0)),
    "HalfCauchy": (dict(beta=1.5), dict(beta=-1.0)),
    "Gamma": (dict(alpha=2.5, beta=1.5), dict(alpha=-1.0, beta=1.0)),
    "InverseGamma": (dict(alpha=3.0, beta=2.0), dict(alpha=3.0, beta=-2.0)),
    "ChiSquared": (dict(nu=4.0), dict(nu=-1.0)),
    "Weibull": (dict(alpha=1.6, beta=2.0), dict(alpha=-1.0, beta=1.0)),
    "Triangular": (dict(lower=0.0, c=1.0, upper=3.0), dict(lower=0.0, c=4.0, upper=3.0)),
    "Gumbel": (dict(mu=1.0, beta=2.0), dict(mu=0.0, beta=-1.0)),
    "Logistic": (dict(mu=1.0, s=2.0), dict(mu=0.0, s=-1.0)),
    "LogitNormal": (dict(mu=0.2, sigma=0.8), dict(mu=0.0, sigma=-1.0)),
    "Moyal": (dict(mu=1.0, sigma=2.0), dict(mu=0.0, sigma=-1.0)),
    "Interpolated": (dict(x_points=INTERP_X, pdf_points=INTERP_PDF), None),
    "Bernoulli": (dict(p=0.3), dict(p=1.5)),
    "Geometric": (dict(p=0.3), dict(p=1.5)),
    "DiscreteUniform": (dict(lower=-2, upper=7), dict(lower=3, upper=1)),
}


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


# probabilities outside [0, 1], appended to Q in the same call
Q_OUT = np.array([-0.1, -1e-12, 1.0 + 1e-12, 2.0, np.nan])
QQ = np.concatenate([Q, Q_OUT])[:, None]
# the extreme tails, where the quantile's condition number q f'/f reaches
# 1e10 (erfinv near 1): held at rtol 1e-10 there
TAILS = (Q == 1e-10) | (Q == 1.0 - 1e-10)


def _reference(name, q):
    """pymc_tpu's quantiles of CASES[name]'s valid parameter set at q."""
    valid = CASES[name][0]
    if name == "ChiSquared":
        return pmj.Gamma.dist(valid["nu"] / 2.0, 0.5).icdf(q)
    return getattr(pmj, name).dist(**valid).icdf(q)


@functools.lru_cache(maxsize=None)
def _references():
    """{name: pymc_tpu's quantiles at QQ} of every class, traced and compiled
    as one jitted function (a compile a class would take most of this
    module's time)."""
    out = jax.jit(lambda q: {name: _reference(name, q) for name in CASES})(
        jnp.asarray(QQ[:, 0]))
    return {name: np.asarray(ref, dtype=np.float64) for name, ref in out.items()}


@functools.lru_cache(maxsize=None)
def _quantiles(name):
    """(port, pymc_tpu) quantiles at QQ: the port's with the valid and the
    invalid parameter set side by side (columns 0 and 1), in one call, so
    that a bisection runs once a class; pymc_tpu's for the valid set."""
    valid, invalid = CASES[name]
    if invalid is None or name == "Interpolated":
        got = _np(getattr(pmt, name).dist(**valid).icdf(torch.as_tensor(QQ)))
        got = np.concatenate([got, np.full_like(got, np.nan)], axis=1)
    else:
        both = {k: np.array([valid[k], invalid[k]]) for k in valid}
        got = _np(getattr(pmt, name).dist(**both).icdf(torch.as_tensor(QQ)))
    if name == "ChiSquared":
        with pytest.raises(TypeError):
            pmj.ChiSquared.dist(**valid).icdf(jnp.asarray(Q))
    return got, _references()[name]


@pytest.mark.parametrize("name", sorted(CASES))
def test_icdf_matches(name):
    full, full_ref = _quantiles(name)
    assert full.dtype == np.float64 and full.shape == (len(QQ), 2)
    got, ref = full[: len(Q), 0], full_ref[: len(Q)]
    keep = np.ones(len(Q), bool)
    if name in BRACKET_TOP:
        keep[-1] = False
        assert got[-1] > 1e30 and ref[-1] > 1e30
    if name == "Geometric":
        # pymc_tpu casts the quantile at q = 1, inf, to int64
        keep[-1] = False
        assert got[-1] == np.inf and ref[-1] > 9e18
    if name in BISECTION:
        scale = float(np.nanmax(np.abs(ref[(Q > 0.01) & (Q < 0.99)])))
        np.testing.assert_allclose(got[keep], ref[keep], rtol=1e-9, atol=1e-8 * scale)
    else:
        np.testing.assert_allclose(got[keep & ~TAILS], ref[keep & ~TAILS], rtol=1e-12, atol=0.0)
        np.testing.assert_allclose(got[keep & TAILS], ref[keep & TAILS], rtol=1e-10, atol=0.0)


def test_chi_squared_against_scipy():
    got = _quantiles("ChiSquared")[0][2: len(Q) - 2, 0]
    np.testing.assert_allclose(got, st.chi2(4.0).ppf(Q[2:-2]), rtol=1e-9)


@pytest.mark.parametrize("name", sorted(CASES))
def test_icdf_is_nan_outside_the_unit_interval(name):
    got, ref = _quantiles(name)
    assert np.isnan(got[len(Q):]).all()
    assert np.isnan(ref[len(Q):]).all()


@pytest.mark.parametrize("name", sorted(n for n in CASES if CASES[n][1] is not None))
def test_icdf_is_nan_for_invalid_parameters(name):
    got = _quantiles(name)[0][:, 1]
    assert np.isnan(got).all(), got


def test_batched_parameters_broadcast_against_q():
    mu, sigma = np.array([0.0, 1.0, -2.0]), np.array([1.0, 0.5, 3.0])
    q = np.array([[0.1], [0.5], [0.975]])
    got = _np(pmt.Normal.dist(mu, sigma).icdf(torch.as_tensor(q)))
    ref = np.asarray(pmj.Normal.dist(mu, sigma).icdf(jnp.asarray(q)))
    assert got.shape == (3, 3)
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    # pymc_tpu's bisection carries q's shape and raises for parameters with a
    # larger batch (ROADMAP §3); the port broadcasts them, held to scipy
    alpha = np.array([0.5, 2.0, 30.0])
    got = _np(pmt.Gamma.dist(alpha, 2.0).icdf(torch.as_tensor(q)))
    assert got.shape == (3, 3)
    np.testing.assert_allclose(got, st.gamma(alpha, scale=0.5).ppf(q), rtol=1e-9)


def test_pm_icdf_dispatches_to_the_distribution():
    with pmt.Model() as mt:
        x = pmt.Logistic("x", 2.0, 3.0)
    with pmj.Model() as mj:
        xj = pmj.Logistic("x", 2.0, 3.0)
    q = np.array([0.2, 0.5, 0.9])
    np.testing.assert_allclose(_np(pmt.icdf(x, q)), np.asarray(pmj.icdf(xj, q)), rtol=1e-12)
    np.testing.assert_allclose(_np(pmt.icdf(pmt.Weibull.dist(1.6, 2.0), q)),
                               np.asarray(pmj.icdf(pmj.Weibull.dist(1.6, 2.0), q)), rtol=1e-12)
    assert mt["x"] is x and mj["x"] is xj
    np.testing.assert_allclose(_np(pmt.icdf(2.0 * x, q)), np.asarray(pmj.icdf(2.0 * xj, q)),
                               rtol=1e-12)
    with pytest.raises(NotImplementedError, match="icdf not implemented for Poisson"):
        pmt.Poisson.dist(3.0).icdf(torch.tensor([0.5], dtype=torch.float64))


def test_dist_math_helpers_match():
    v = np.array([0.3, -1.0, 2.0, 4.0])
    q = np.array([0.5, -0.2, 1.0, 1.5])
    ok = v > 0
    np.testing.assert_array_equal(
        _np(dmt.check_icdf_parameters(torch.as_tensor(v), torch.as_tensor(ok))),
        np.asarray(dmj.check_icdf_parameters(jnp.asarray(v), jnp.asarray(ok))))
    np.testing.assert_array_equal(
        _np(dmt.check_icdf_value(torch.as_tensor(v), torch.as_tensor(q))),
        np.asarray(dmj.check_icdf_value(jnp.asarray(v), jnp.asarray(q))))
    # the bisection on each warp of the support, with and without Newton
    qs = np.array([0.01, 0.4, 0.8, 0.99])
    for support, dist, lo, hi in (("real", st.norm(1.0, 2.0), None, None),
                                  ("positive", st.lognorm(0.7), None, None),
                                  ("interval", st.beta(2.0, 5.0), 0.0, 1.0)):
        def logcdf_t(x, dist=dist):
            return torch.as_tensor(dist.logcdf(x.numpy()))

        def logcdf_j(x, dist=dist):
            return jnp.asarray(dist.logcdf(np.asarray(x)))

        for newton in (None, True):
            got = _np(dmt.icdf_bisection(
                logcdf_t, torch.as_tensor(qs), support, lo, hi,
                logpdf_fn=(lambda x, d=dist: torch.as_tensor(d.logpdf(x.numpy()))) if newton
                else None))
            np.testing.assert_allclose(got, dist.ppf(qs), rtol=1e-9, atol=1e-12)
            if newton is None:
                with jax.disable_jit():
                    ref = np.asarray(dmj.icdf_bisection(logcdf_j, jnp.asarray(qs), support,
                                                        lo, hi))
                np.testing.assert_allclose(got, ref, rtol=1e-12)
