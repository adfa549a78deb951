"""Simulator and the ABC branch of `sample_smc` in the port against
pymc_tpu, float64 on the CPU. The specification is
`tests/smc/test_simulator_abc.py`.

The simulation function takes a torch.Generator where pymc_tpu's takes a
key. A Simulator whose function ignores its generator is deterministic,
so its pseudo-likelihood is held to pymc_tpu's exactly (rtol 1e-12) for
every distance (gaussian, laplace, kullback_leibler, a callable) and
summary statistic (identity, mean, median, sort, a callable), in one
jitted call. The stochastic ABC posterior of `examples/abc_simulator.py`
at its own size (2 chains of 1,000 draws; about 2 s on the CPU) is held
within 5 combined seed-to-seed standard deviations of pymc_tpu's mean
over 5 seeds (`tests/data/torch_abc_reference.json`). Every particle of
every evaluation of the tempered density gets a simulation of its own.
"""

import functools
import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from pymc_tpu_torch import models
from pymc_tpu_torch.smc.sampling import has_simulator, tempered_density


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DATA = np.random.default_rng(3).normal(0.7, 1.3, 40)
BASE = np.random.default_rng(4).normal(size=40)
REFERENCE = os.path.join(os.path.dirname(__file__), "data", "torch_abc_reference.json")


def _fixed(rng, mu, sigma):
    """A 'simulation' that ignores its generator."""
    return mu + sigma * torch.as_tensor(BASE, dtype=mu.dtype)


def _fixed_j(key, mu, sigma):
    return mu + sigma * jnp.asarray(BASE)


def _abs_diff(pm):
    def distance(eps, obs, sim):
        return pm.math.mean(-pm.math.abs(obs - sim) / eps)

    return distance


def _quantiles(x):
    s = x.reshape(-1).sort().values if isinstance(x, torch.Tensor) else jnp.sort(x.reshape(-1))
    return s[np.array([10, 20, 30])]


# the Kullback-Leibler estimate needs more than one summary value
CASES = [(d, s) for d in ("gaussian", "laplace") for s in ("identity", "mean", "median", "sort")]
CASES += [("kullback_leibler", "identity"), ("kullback_leibler", "sort"),
          ("callable", "callable")]


def _model(pm, distance, sum_stat):
    fn = _fixed if pm is pmt else _fixed_j
    with pm.Model() as m:
        mu = pm.Normal("mu", 0.0, 1.0)
        sigma = pm.HalfNormal("sigma", 1.0)
        pm.Simulator("s", fn, mu, sigma, epsilon=0.7, observed=DATA,
                     distance=_abs_diff(pm) if distance == "callable" else distance,
                     sum_stat=_quantiles if sum_stat == "callable" else sum_stat)
    return m


POINTS = [{"mu": 0.3, "sigma_log__": np.log(1.1)}, {"mu": -0.5, "sigma_log__": np.log(0.6)}]


@functools.lru_cache(maxsize=None)
def _references():
    fns = {c: _model(pmj, *c).compile_logp() for c in CASES}

    @jax.jit
    def run():
        return {c: [fn(p) for p in POINTS] for c, fn in fns.items()}

    return jax.tree.map(np.asarray, run())


@pytest.mark.parametrize("distance, sum_stat", CASES)
def test_deterministic_simulator_logp_matches(distance, sum_stat):
    fn = _model(pmt, distance, sum_stat).compile_logp(device="cpu")
    got = [float(fn(p)) for p in POINTS]
    np.testing.assert_allclose(got, _references()[(distance, sum_stat)], rtol=1e-12)


def test_abc_example_posterior_matches_pymc_tpu():
    with open(REFERENCE) as f:
        ref = json.load(f)["mu"]
    model = models.abc_simulator_model()
    assert has_simulator(model)
    idata = pmt.sample_smc(model=model, random_seed=0, progressbar=False, device="cpu",
                           **models.ABC_SMC_KWARGS)
    mu = idata.posterior["mu"].values
    assert mu.shape == (2, 1000) and (idata.sample_stats["beta"].values == 1.0).all()
    z = (float(mu.mean()) - ref["mean"]) / np.hypot(ref["seed_sd"], ref["seed_sd"])
    assert abs(z) < 5.0
    np.testing.assert_allclose(mu.std(), ref["posterior_sd"], rtol=0.25)


def test_tempered_density_simulates_anew():
    model = models.abc_simulator_model()
    density = tempered_density(model, "cpu", torch.float64,
                               torch.Generator().manual_seed(0))
    q = torch.full((6, 1), 1.4, dtype=torch.float64)
    prior1, like1 = density(q)
    prior2, like2 = density(q)
    assert torch.equal(prior1, prior2)
    assert not torch.equal(like1, like2) and len(set(like1.tolist())) == 6
    # without a generator of the caller's, one seeded 0
    a = tempered_density(model, "cpu", torch.float64)(q)[1]
    b = tempered_density(model, "cpu", torch.float64)(q)[1]
    assert torch.equal(a, b)


def test_draws_support_point_and_initial_point():
    def sim(rng, m, s):
        return m + s * torch.randn(50, generator=rng, dtype=m.dtype)

    for mu, sigma in ((0.0, 1.0), (3.0, 0.5)):
        d = pmt.Simulator.dist(sim, mu, sigma, shape=(50,))
        sp = d.support_point().numpy()
        assert sp.shape == (50,)
        assert abs(sp.mean() - mu) < 4.0 * sigma / np.sqrt(10 * 50)
    d = pmt.Simulator.dist(sim, 1.0, 2.0)
    assert d.shape == (50,)
    draws = d.sample(torch.Generator().manual_seed(1), (400,))
    assert draws.shape == (400, 50)
    np.testing.assert_allclose(draws.mean(), 1.0, atol=5 * 2.0 / np.sqrt(20_000))
    model = models.abc_simulator_model()
    lp = model.compile_logp(device="cpu")(model.initial_point(device="cpu"))
    assert np.isfinite(float(lp))
    prior = pmt.sample_prior_predictive(draws=20, model=model, random_seed=2, device="cpu")
    assert prior.prior_predictive["s"].values.shape == (1, 20, 200)
    with pytest.raises(ValueError, match="Unknown distance"):
        pmt.Simulator.dist(sim, 1.0, 2.0, distance="cosine")


def test_two_simulators_recover_their_locations():
    rng = np.random.default_rng(8)
    d1, d2 = rng.normal(-2.0, 1.0, 100), rng.normal(3.0, 1.0, 100)

    def sim(rng, mu):
        return mu + torch.randn(100, generator=rng, dtype=mu.dtype)

    with pmt.Model() as m:
        m1 = pmt.Normal("m1", 0.0, 5.0)
        m2 = pmt.Normal("m2", 0.0, 5.0)
        pmt.Simulator("s1", sim, m1, sum_stat="sort", epsilon=0.5, observed=d1)
        pmt.Simulator("s2", sim, m2, distance="laplace", sum_stat="sort", epsilon=0.5,
                      observed=d2)
    idata = pmt.sample_smc(draws=300, chains=2, model=m, random_seed=8, progressbar=False,
                           device="cpu", compute_convergence_checks=False)
    assert abs(float(idata.posterior["m1"].values.mean()) - d1.mean()) < 0.3
    assert abs(float(idata.posterior["m2"].values.mean()) - d2.mean()) < 0.3
