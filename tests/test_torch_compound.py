"""Compound sampling of pymc_tpu_torch against pymc_tpu: the automatic
assignment of step methods, one CompoundStep fed the JAX step's draws
(stat names and values, rtol 1e-10), the routes of `sample(step=...)`, and
the mixed NUTS + BinaryGibbsMetropolis model of
tests/step_methods/test_steps.py::test_mixed_compound sampled by both
packages (4 chains, 100 + 100 draws, NUTS trees cut at depth 4), held
within 5 combined MCSE.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from pymc_tpu.step_methods.compound import assign_step_methods as assign_j
from pymc_tpu_torch.models import changepoint_model
from pymc_tpu_torch.step_methods.compound import CompoundStep, assign_step_methods as assign_t
from pymc_tpu_torch.stats.convergence import mcse_mean

from test_torch_step_methods import (
    ReplayDraws, assert_tree_close, flags, mixed_model, mixed_point, per_chain, to_torch,
    without_cached_logp,
)

C = 6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bernoulli(pm):
    with pm.Model() as m:
        pm.Bernoulli("x", 0.5)
    return m


def _normal(pm):
    with pm.Model() as m:
        pm.Normal("x", 0, 1)
    return m


def _categorical(pm):
    with pm.Model() as m:
        pm.Categorical("x", np.array([0.25, 0.70, 0.05]))
    return m


def _binomial(pm):
    with pm.Model() as m:
        pm.Binomial("x", 10, 0.5)
    return m


def _mixed(pm):
    with pm.Model() as m:
        pm.Normal("mu", 0, 1)
        pm.Bernoulli("z", 0.5)
        pm.Gamma("g", 2, 1)
    return m


def _changepoint(pm):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return changepoint_model(pm)


def _layout(step):
    methods = step.methods if hasattr(step, "methods") else [step]
    return [(type(s).__name__, [rv.name for rv in s.rvs]) for s in methods]


@pytest.mark.parametrize("build", [_bernoulli, _normal, _categorical, _binomial, _mixed,
                                   _changepoint], ids=lambda f: f.__name__.strip("_"))
def test_assign_step_methods_matches_pymc_tpu(build):
    """tests/sampling/test_mcmc_depth.py::TestAssignStepMethods and the
    change-point model."""
    assert _layout(assign_t(build(pmt))) == _layout(assign_j(build(pmj)))


def test_given_steps_keep_their_variables():
    mj, mt = _mixed(pmj), _mixed(pmt)
    ref = assign_j(mj, step=pmj.Metropolis(vars=[mj["g"]], model=mj))
    got = assign_t(mt, step=pmt.Metropolis(vars=[mt["g"]], model=mt))
    assert isinstance(got, CompoundStep)
    assert _layout(got) == _layout(ref) == [
        ("Metropolis", ["g"]), ("NUTS", ["mu"]), ("BinaryGibbsMetropolis", ["z"])]
    assert repr(got) == "CompoundStep([Metropolis(['g']), NUTS(['mu']), " \
                        "BinaryGibbsMetropolis(['z'])])"


def test_compound_step_matches_pymc_tpu():
    """One CompoundStep(Metropolis, BinaryGibbsMetropolis): each step draws
    from fold_in(key, i), and its stats come out as {name}{i}_{stat}."""
    mj, mt = mixed_model(pmj), mixed_model(pmt)
    cj = pmj.CompoundStep([pmj.Metropolis(vars=[mj["x"], mj["k"]], model=mj),
                           pmj.BinaryGibbsMetropolis(vars=[mj["b"]], model=mj)])
    ct = CompoundStep([pmt.Metropolis(vars=[mt["x"], mt["k"]], model=mt),
                       pmt.BinaryGibbsMetropolis(vars=[mt["b"]], model=mt)])
    point = mixed_point(4)
    pj = {k: jnp.asarray(v) for k, v in point.items()}
    key = jax.random.PRNGKey(21)
    states_j = cj.init_state(pj, C, key)
    states_t = ct.init_state(to_torch(point), C, None)
    k0 = jax.vmap(jax.random.split)(jax.random.split(jax.random.fold_in(key, 0), C))
    draws = [("normal", per_chain(lambda k: jax.random.normal(k[0], (3,)), k0)),
             ("uniform", per_chain(lambda k: jax.random.uniform(k[1]), k0))]
    k = jax.random.split(jax.random.fold_in(key, 1), C)
    for _ in range(3):
        ks = jax.vmap(jax.random.split)(k)
        k = ks[:, 0]
        draws.append(("uniform", per_chain(lambda s: jax.random.uniform(s, dtype=float),
                                           ks[:, 1])))
    fj, ft = flags(tune_now=True)
    point_j, new_j, stats_j = cj.step(key, pj, states_j, fj)
    source = ReplayDraws(draws)
    point_t, new_t, stats_t = ct.step(source, to_torch(point), states_t, ft)
    assert not source.queue
    assert sorted(stats_t) == sorted(stats_j) == [
        "metropolis0_accept_rate", "metropolis0_accepted", "metropolis0_scaling"]
    assert_tree_close(point_t, point_j, "point")
    assert_tree_close(stats_t, stats_j, "stats")
    assert_tree_close(new_t[0], without_cached_logp(new_j[0]), "state")
    assert ct.host_seconds[0] > 0.0 and ct.host_seconds[1] > 0.0


def test_metropolis_takes_the_ratio_at_the_current_point():
    """A reference fault the port does not copy (ROADMAP.md §3): the JAX
    Metropolis keeps the logp of its own last draw, stale once another step
    of a compound moved the point; the port, as PyMC, evaluates the current
    point and keeps no logp in its state. The port's step is the JAX step
    fed the true logp, and the JAX step fed a stale one differs."""
    mj, mt = mixed_model(pmj), mixed_model(pmt)
    sj = pmj.Metropolis(vars=[mj["k"]], model=mj)
    st = pmt.Metropolis(vars=[mt["k"]], model=mt)
    point = mixed_point(5)
    pj = {k: jnp.asarray(v) for k, v in point.items()}
    key = jax.random.PRNGKey(22)
    true_j = sj.init_state(pj, C, key)
    stale_j = dict(true_j, logp=true_j["logp"] + 50.0)
    state_t = st.init_state(to_torch(point), C, None)
    assert "logp" not in state_t
    keys = jax.vmap(jax.random.split)(jax.random.split(key, C))
    draws = [("normal", per_chain(lambda k: jax.random.normal(k[0], (1,)), keys)),
             ("uniform", per_chain(lambda k: jax.random.uniform(k[1]), keys))]
    fj, ft = flags()
    _, _, ref = sj.step(key, pj, true_j, fj)
    _, _, ref_stale = sj.step(key, pj, stale_j, fj)
    _, _, got = st.step(ReplayDraws(draws), to_torch(point), state_t, ft)
    np.testing.assert_array_equal(got["accepted"].numpy(), np.asarray(ref["accepted"]))
    assert not np.array_equal(np.asarray(ref_stale["accepted"]), np.asarray(ref["accepted"]))


def test_sample_routes_step_and_discrete_models():
    m = _mixed(pmt)
    base = dict(model=m, draws=20, tune=20, chains=3, random_seed=1, device="cpu",
                compute_convergence_checks=False)
    idata = pmt.sample(**base)
    assert idata.posterior.attrs["stepper"] == (
        "CompoundStep([NUTS(['mu', 'g']), BinaryGibbsMetropolis(['z'])])")
    assert idata.posterior["z"].values.dtype == np.int64
    assert set(idata.sample_stats.keys()) >= {"nuts0_tree_depth", "nuts0_n_steps",
                                               "nuts0_acceptance_rate"}
    trace = pmt.sample(step=[pmt.Slice(vars=[m["g"]], model=m)], return_inferencedata=False,
                       var_names=["g", "z"], **base)
    assert isinstance(trace, pmt.MultiTrace)
    assert sorted(trace.varnames) == ["g", "z"] and trace.get_values("g").shape == (60,)
    warm = pmt.sample(discard_tuned_samples=False, **base)
    assert warm.warmup_posterior["z"].shape == (3, 20)
    np.testing.assert_array_equal(warm.posterior["z"].values, idata.posterior["z"].values)
    with pytest.raises(NotImplementedError, match="compound step methods"):
        m.logp_dlogp_fn(device="cpu")


def _mixed_compound(pm):
    y = np.random.default_rng(9).normal(3.0, 1.0, 60)
    with pm.Model() as m:
        mu = pm.Normal("mu", 0, 5)
        z = pm.Bernoulli("z", 0.5)
        pm.Normal("y", mu + 2.0 * z, 1.0, observed=y)
    return m


def test_mixed_compound_matches_pymc_tpu():
    """z moves only through mu, so each chain keeps a mode; mu + 2 z is the
    same in both modes, and is held to pymc_tpu's and to its known
    posterior mean."""
    config = dict(draws=100, tune=100, chains=4, random_seed=10,
                  compute_convergence_checks=False)
    out = {}
    for name, pm in (("jax", pmj), ("torch", pmt)):
        m = _mixed_compound(pm)
        step = [pm.NUTS(vars=[m["mu"]], model=m, max_treedepth=4)]
        kw = {"progressbar": False} if pm is pmj else {"device": "cpu"}
        idata = pm.sample(model=m, step=step, **config, **kw)
        post = idata.posterior
        out[name] = post["mu"].values + 2.0 * post["z"].values
    y = np.random.default_rng(9).normal(3.0, 1.0, 60)
    v = 1.0 / (1.0 / 25.0 + y.size)
    xj, xt = out["jax"], out["torch"]
    z = (xt.mean() - xj.mean()) / np.hypot(mcse_mean(xt), mcse_mean(xj))
    assert abs(z) < 5, z
    assert abs(xt.mean() - v * y.sum()) < 5 * mcse_mean(xt) + 2 * v / 25


def test_rhat_of_discrete_draws_ranks_ties_at_their_mean():
    """Two reference faults the port does not copy (ROADMAP.md §3):
    pymc_tpu ranks tied draws by position, so independent Poisson draws
    read R-hat 1.0988, where ranked at their mean (Vehtari et al. 2021,
    scipy's rankdata) they read 1.00; and its R-hat overwrites a (chain,
    draw) float64 input with the draws' normal scores."""
    from scipy.special import ndtri
    from scipy.stats import rankdata

    from pymc_tpu.stats.convergence import ess as ess_j, rhat as rhat_j
    from pymc_tpu_torch.stats import convergence as cv

    x = np.random.default_rng(0).poisson(1.29, (64, 4000)).astype(float)
    before = x.copy()
    assert float(cv.rhat(x)) < 1.001
    assert float(cv.ess(x)) > 0.9 * x.size
    # the port leaves its input as it was; pymc_tpu writes its normal scores there
    np.testing.assert_array_equal(x, before)
    assert float(rhat_j(x)) > 1.09
    assert not np.array_equal(x, before)
    z = x[:4, :50]
    ranks = rankdata(z.ravel()).reshape(z.shape)
    np.testing.assert_allclose(cv._rank_normalize(z),
                               ndtri((ranks - 3.0 / 8.0) / (z.size + 1.0 / 4.0)), rtol=1e-12)
    # continuous draws have no ties: the bulk ESS is pymc_tpu's
    y = np.random.default_rng(1).normal(size=(4, 100, 3))
    np.testing.assert_array_equal(cv.ess(y), ess_j(y))
