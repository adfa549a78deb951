"""The time-series family of the port against pymc_tpu, float64 on the CPU.

For each of RandomWalk, GaussianRandomWalk, MvGaussianRandomWalk,
MvStudentTRandomWalk, AR (with and without a constant, and with a
multivariate init), GARCH11 and EulerMaruyama: the logp and its gradient
of `models.timeseries_model`, which holds the class as a free variable,
with parameters that are free variables too, and as observed data whose
shape gives the steps, through `logp_dlogp_fn` at random points (rtol
1e-10); batched logps and
support points of the unnamed distributions; the errors for steps and
shapes and the warnings for a default init; draws' shapes and moments
against the processes' exact ones (5 standard errors); and EulerMaruyama
with its `sde_fn` written once with jax.numpy and once with torch.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from pymc_tpu.blocking import unravel_vector
from pymc_tpu_torch.models import TIMESERIES_MODELS, TS_COV, timeseries_model


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _sde(xp):
    """dx = -k tanh(x) dt + (0.3 + 0.1 x^2) dW with `xp`'s functions."""
    return lambda x, k: (-k * xp.tanh(x), 0.3 + 0.1 * x**2)


SDE = {"jax": _sde(jnp), "torch": _sde(torch)}
COV = TS_COV


def _model(name, pm, sde):
    return timeseries_model(name, pm, sde_fn=sde)


MODELS = list(TIMESERIES_MODELS)


@pytest.mark.parametrize("name", MODELS)
def test_logp_and_grad_match(name):
    mj, mt = _model(name, pmj, SDE["jax"]), _model(name, pmt, SDE["torch"])
    ij, it = mj.raveled_info(), mt.raveled_info()
    assert list(it.names) == list(ij.names) and it.shapes == ij.shapes
    q = np.random.default_rng(2).normal(0.0, 0.5, size=(4, ij.total_size))
    lf = mj.logp_fn()
    lj, gj = jax.jit(jax.vmap(jax.value_and_grad(lambda x: lf(unravel_vector(x, ij)))))(q)
    lt, gt = mt.logp_dlogp_fn(device="cpu")(torch.as_tensor(q))
    assert np.isfinite(lt.numpy()).all()
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-10)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-10, atol=1e-10)


def _dists(pm, sde):
    """Unnamed distributions with batched parameters: {name: (dist, value)}."""
    rng = np.random.default_rng(4)
    mus = np.array([0.2, -0.1, 0.5])
    return {
        "GaussianRandomWalk batched mu": (
            pm.GaussianRandomWalk.dist(mu=mus, sigma=0.7, init_dist=pm.Normal.dist(1.0, 1.0),
                                       steps=4),
            rng.normal(size=(3, 5))),
        "MvGaussianRandomWalk default init": (
            pm.MvGaussianRandomWalk.dist(mu=np.array([0.1, 0.2]), cov=COV, shape=(2, 4, 2)),
            rng.normal(size=(2, 4, 2))),
        "AR batched rho": (
            pm.AR.dist(rho=np.array([[0.5], [-0.3]]), sigma=np.array([1.0, 0.4]), steps=5),
            rng.normal(size=(2, 6))),
        "GARCH11 batched omega": (
            pm.GARCH11.dist(omega=np.array([0.5, 1.0, 2.0]), alpha_1=0.2, beta_1=0.3,
                            initial_vol=1.0, shape=(3, 6)),
            rng.normal(size=(3, 6))),
        "GARCH11 nonstationary": (
            pm.GARCH11.dist(omega=0.5, alpha_1=0.7, beta_1=0.6, initial_vol=1.0, steps=5),
            rng.normal(size=6)),
        "GARCH11 invalid omega": (
            pm.GARCH11.dist(omega=-1.0, alpha_1=0.2, beta_1=0.3, initial_vol=1.0, steps=3),
            np.zeros(4)),
        "EulerMaruyama batched k": (
            pm.EulerMaruyama.dist(dt=0.05, sde_fn=sde, sde_pars=(np.array([0.5, 2.0]),),
                                  steps=6),
            rng.normal(size=(2, 7))),
    }


def test_batched_logps_and_support_points_match():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        dj, dt = _dists(pmj, SDE["jax"]), _dists(pmt, SDE["torch"])
    for label in dj:
        (a, v), (b, _) = dj[label], dt[label]
        assert a.shape == b.shape, label
        got, ref = _np(b.logp(torch.as_tensor(v))), np.asarray(jax.jit(a.logp)(jnp.asarray(v)))
        np.testing.assert_allclose(got, ref, rtol=1e-12, err_msg=label)
        np.testing.assert_allclose(_np(b.support_point()), np.asarray(a.support_point()),
                                   rtol=1e-12, err_msg=label)
    assert _np(dt["GARCH11 invalid omega"][0].logp(torch.zeros(4, dtype=torch.float64))) == -np.inf


def test_support_points_of_the_models_match():
    from pymc_tpu.initial_point import make_initial_point
    from pymc_tpu_torch.initial_point import support_point_values

    for name in ("GaussianRandomWalk", "AR constant", "GARCH11", "EulerMaruyama"):
        mj, mt = _model(name, pmj, SDE["jax"]), _model(name, pmt, SDE["torch"])
        ref = make_initial_point(mj, jax.random.PRNGKey(0), jitter=0.0)
        got = support_point_values(mt)
        assert list(got) == list(ref)
        for k in ref:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-12)


def test_steps_and_shape():
    d = pmt.GaussianRandomWalk.dist(sigma=1.0, init_dist=pmt.Normal.dist(), shape=(3, 9))
    assert d.steps == 8 and d.shape == (3, 9)
    d = pmt.MvGaussianRandomWalk.dist(mu=np.zeros(2), cov=COV, shape=(6, 2),
                                      init_dist=pmt.MvNormal.dist(np.zeros(2), cov=COV))
    assert d.steps == 5 and d.shape == (6, 2)
    assert pmt.AR.dist(rho=[0.3, 0.2], init_dist=pmt.Normal.dist(shape=(2,)),
                       shape=(10,)).steps == 8
    assert pmt.GARCH11.dist(omega=1.0, alpha_1=0.2, beta_1=0.3, initial_vol=1.0,
                            shape=(9,)).steps == 8
    for make in (lambda pm: pm.GaussianRandomWalk.dist(init_dist=pm.Normal.dist(), steps=3,
                                                       shape=(6,)),
                 lambda pm: pm.GARCH11.dist(omega=1.0, alpha_1=0.2, beta_1=0.3,
                                            initial_vol=1.0, steps=2, shape=(5,))):
        with pytest.raises(ValueError, match="Inconsistent steps"):
            make(pmj)
        with pytest.raises(ValueError, match="Inconsistent steps"):
            make(pmt)
    with pytest.raises(ValueError, match="Provide steps= or shape="):
        pmt.GaussianRandomWalk.dist(init_dist=pmt.Normal.dist())
    with pytest.raises(ValueError, match="innovation_dist"):
        pmt.RandomWalk.dist(innovation_dist=1.0, init_dist=pmt.Normal.dist(), steps=3)
    with pytest.raises(TypeError, match="init_dist must be a distribution"):
        pmt.RandomWalk.dist(innovation_dist=pmt.Normal.dist(), steps=3)
    with pytest.raises(TypeError, match="same support dimensionality"):
        pmt.RandomWalk.dist(innovation_dist=pmt.Normal.dist(),
                            init_dist=pmt.MvNormal.dist(np.zeros(2), cov=COV), steps=3)


@pytest.mark.parametrize("make", [
    lambda pm: pm.GaussianRandomWalk.dist(steps=3),
    lambda pm: pm.MvGaussianRandomWalk.dist(mu=np.zeros(2), cov=COV, steps=3),
    lambda pm: pm.MvStudentTRandomWalk.dist(nu=4.0, mu=np.zeros(2), scale=COV, steps=3),
    lambda pm: pm.AR.dist(rho=[0.5], steps=3),
    lambda pm: pm.EulerMaruyama.dist(dt=0.1, sde_fn=lambda x, k: (-k * x, 1.0),
                                     sde_pars=(1.0,), steps=3),
], ids=["GaussianRandomWalk", "MvGaussianRandomWalk", "MvStudentTRandomWalk", "AR",
        "EulerMaruyama"])
def test_default_init_warns(make):
    with pytest.warns(UserWarning, match="Initial distribution not specified"):
        dt = make(pmt)
    with pytest.warns(UserWarning, match="Initial distribution not specified"):
        dj = make(pmj)
    assert dt.init_dist.shape == dj.init_dist.shape
    assert type(dt.init_dist).__name__ == type(dj.init_dist).__name__


def _z(x, mean, var):
    """|mean - known| in standard errors, per entry."""
    return np.abs(x.mean(0) - mean) / np.sqrt(var / len(x))


def test_draws_match_the_processes_moments():
    gen = torch.Generator().manual_seed(0)
    n = 4000
    # Gaussian walk: x_t ~ N(1 + 0.5 t, 1 + 4 t)
    d = pmt.GaussianRandomWalk.dist(mu=0.5, sigma=2.0, init_dist=pmt.Normal.dist(1.0, 1.0),
                                    steps=5)
    x = _np(d.sample(gen, (n,)))
    t = np.arange(6)
    assert x.shape == (n, 6) and _z(x, 1.0 + 0.5 * t, 1.0 + 4.0 * t).max() < 5
    # batched multivariate walk: each coordinate's variance grows by COV's diagonal
    d = pmt.MvGaussianRandomWalk.dist(mu=np.array([0.2, -0.1]), cov=COV, steps=3,
                                      init_dist=pmt.MvNormal.dist(np.zeros(2), cov=COV),
                                      shape=(2, 4, 2))
    x = _np(d.sample(gen, (n,)))
    assert x.shape == (n, 2, 4, 2)
    tt = np.arange(4)[:, None]
    assert _z(x[:, 1], np.array([0.2, -0.1]) * tt, np.diag(COV) * (tt + 1)).max() < 5
    # stationary AR(1): variance sigma^2 / (1 - rho^2)
    d = pmt.AR.dist(rho=[0.6], sigma=0.5, init_dist=pmt.Normal.dist(0.0, 0.625, shape=(1,)),
                    steps=10)
    x = _np(d.sample(gen, (n,)))
    assert x.shape == (n, 11)
    assert _z(x[:, -1], 0.0, 0.390625) < 5 and _z(x[:, -1] ** 2, 0.390625, 2 * 0.390625**2) < 5
    # AR with a constant: mean c / (1 - rho)
    d = pmt.AR.dist(rho=[1.0, 0.5], sigma=0.3, constant=True, steps=40,
                    init_dist=pmt.Normal.dist(2.0, 0.3464, shape=(1,)))
    x = _np(d.sample(gen, (n,)))
    assert _z(x[:, -1], 2.0, 0.12) < 5
    # GARCH(1, 1): unconditional variance omega / (1 - alpha - beta)
    d = pmt.GARCH11.dist(omega=0.2, alpha_1=0.1, beta_1=0.5, initial_vol=np.sqrt(0.5), steps=30)
    x = _np(d.sample(gen, (n,)))
    assert x.shape == (n, 31) and abs(x[:, -1].var() / 0.5 - 1.0) < 0.1
    # Ornstein-Uhlenbeck by Euler-Maruyama: stationary variance s^2 / (2 lam)
    d = pmt.EulerMaruyama.dist(dt=0.02, sde_fn=lambda x, lam: (-lam * x, 1.0), sde_pars=(1.0,),
                               init_dist=pmt.Normal.dist(0.0, np.sqrt(0.5)), steps=50)
    x = _np(d.sample(gen, (n,)))
    assert x.shape == (n, 51) and abs(x[:, -1].var() / 0.5 - 1.0) < 0.1


def test_prior_predictive_draws_anew_for_each_point():
    # the forward sampler vmaps the draws: every path draws out of place
    with pmt.Model() as m:
        s = pmt.HalfNormal("s", 1.0)
        pmt.GaussianRandomWalk("w", sigma=s, init_dist=pmt.Normal.dist(), steps=4)
        pmt.AR("a", rho=[0.5], sigma=s, init_dist=pmt.Normal.dist(shape=(1,)), steps=4)
        pmt.GARCH11("g", omega=s, alpha_1=0.1, beta_1=0.2, initial_vol=1.0, steps=4)
        pmt.EulerMaruyama("e", dt=0.1, sde_fn=lambda x, k: (-k * x, k), sde_pars=(s,),
                          init_dist=pmt.Normal.dist(), steps=4)
    draws = pmt.sample_prior_predictive(draws=200, model=m, random_seed=0, device="cpu",
                                        return_inferencedata=False)
    for name in ("w", "a", "g", "e"):
        x = draws[name]
        assert x.shape == (200, 5) and np.isfinite(x).all()
        assert len(np.unique(x[:, -1])) == 200, name
