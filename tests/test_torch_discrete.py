"""Bernoulli and the stress GLM (BASELINE config #3) in both packages.

Bernoulli's logp in pymc_tpu_torch against pymc_tpu's in float64, rtol
1e-12 (-inf where pymc_tpu gives -inf): both parametrisations, logits at
+-40, p at 0 and 1 and outside [0, 1], values 0, 1, 2 and -1. Then the
support point, the two parametrisation errors, int64 observed data, and
the error a discrete free variable raises. The stress GLM of
`benchmarks/suite.py::_stress_model`, cut to 20 groups and 200
observations, built through both packages from the same numpy seed:
layout, and logp and gradient at 8 points to rtol 1e-10; and NUTS on it
in both packages, whose hyperparameter means must agree within 4 combined
MCSE.
"""

import numpy as np
import pytest
import torch

import jax

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from pymc_tpu.backends.arviz import to_inference_data as to_inference_data_j
from pymc_tpu.blocking import unravel_vector
from pymc_tpu.initial_point import make_initial_point
from pymc_tpu_torch.backends.arviz import to_inference_data as to_inference_data_t
from pymc_tpu_torch.initial_point import support_point_values
from pymc_tpu_torch.models import STRESS_HYPERS, stress_glm_model
from pymc_tpu_torch.stats.convergence import mcse_mean

VALUES = np.array([0, 1, 2, -1])
P = np.array([0.0, 1e-300, 0.2, 0.5, 0.999, 1.0, -0.1, 1.2])[:, None]
LOGIT_P = np.array([-40.0, -25.0, -3.0, 0.0, 2.5, 21.0, 40.0])[:, None]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _logp(pm, values, **param):
    d = pm.Bernoulli.dist(**param)
    if pm is pmt:
        return d.logp(torch.as_tensor(values)).numpy()
    return np.asarray(d.logp(values))


@pytest.mark.parametrize("param, grid", [("p", P), ("logit_p", LOGIT_P)])
def test_bernoulli_logp_matches(param, grid):
    ref = _logp(pmj, VALUES, **{param: grid})
    got = _logp(pmt, VALUES, **{param: grid})
    assert got.shape == ref.shape == (len(grid), len(VALUES))
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    # values outside {0, 1} and p outside [0, 1] have no mass
    assert np.isneginf(got[:, 2:]).all()
    if param == "p":
        assert np.isneginf(got[-2:]).all()


def test_bernoulli_logit_gradient_matches():
    values = np.array([0, 1, 1, 0, 1, 0, 1])
    z = LOGIT_P[:, 0]
    ref = jax.grad(lambda t: pmj.Bernoulli.dist(logit_p=t).logp(values).sum())(z)
    t = torch.as_tensor(z).requires_grad_()
    d = pmt.Bernoulli.dist(logit_p=z)
    d._logp(torch.as_tensor(values), None, logit_p=t).sum().backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(ref), rtol=1e-12, atol=1e-300)


@pytest.mark.parametrize("param, grid", [("p", P[:6]), ("logit_p", LOGIT_P)])
def test_bernoulli_support_point_matches(param, grid):
    ref = np.asarray(pmj.Bernoulli.dist(**{param: grid}).support_point())
    got = pmt.Bernoulli.dist(**{param: grid}).support_point()
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("pm", [pmj, pmt], ids=["pymc_tpu", "pymc_tpu_torch"])
def test_bernoulli_parametrisation_errors(pm):
    with pytest.raises(ValueError, match="Can't specify both p and logit_p"):
        pm.Bernoulli.dist(p=0.5, logit_p=0.0)
    with pytest.raises(ValueError, match="Must specify either p or logit_p"):
        pm.Bernoulli.dist()


@pytest.mark.parametrize("observed", [[0, 1, 1, 0], [0.0, 1.0, 1.0, 0.0]], ids=["int", "float"])
def test_bernoulli_observed_data_is_int64(observed):
    models = {}
    for pm in (pmj, pmt):
        with pm.Model() as m:
            z = pm.Normal("z", 0.0, 1.0)
            pm.Bernoulli("y", logit_p=z, observed=np.asarray(observed))
        models[pm] = m
    obs_j = to_inference_data_j(models[pmj], {}, {}).observed_data["y"].values
    obs_t = to_inference_data_t(models[pmt], {}, {}).observed_data["y"].values
    assert obs_j.dtype == obs_t.dtype == np.int64
    assert models[pmt].observed_RVs[0].observed.value.dtype == torch.int64
    np.testing.assert_array_equal(obs_t, obs_j)
    # the logp is the prior's and the integer data's
    lj = float(models[pmj].logp_fn()({"z": np.float64(0.4)}))
    lt = float(models[pmt].logp_fn(device="cpu")({"z": torch.tensor(0.4, dtype=torch.float64)}))
    expected = -0.5 * 0.4**2 - 0.5 * np.log(2 * np.pi) - 2 * np.log1p(np.exp(0.4)) - 2 * np.log1p(
        np.exp(-0.4))
    np.testing.assert_allclose(lt, lj, rtol=1e-12)
    np.testing.assert_allclose(lt, expected, rtol=1e-12)


def test_continuous_observed_data_stays_float64():
    with pmt.Model() as m:
        pmt.Normal("y", 0.0, 1.0, observed=np.array([1, 2, 3]))
    assert m.observed_RVs[0].observed.value.dtype == torch.float64


def test_discrete_observed_with_nan_imputes():
    """Missing discrete data becomes the discrete free variable
    y_unobserved, as in pymc_tpu (tests/test_torch_imputation.py holds the
    densities to it)."""
    from pymc_tpu_torch.exceptions import ImputationWarning

    with pmt.Model() as m:
        with pytest.warns(ImputationWarning, match="missing values"):
            pmt.Bernoulli("y", p=0.5, observed=np.array([0.0, np.nan, 1.0]))
    assert [rv.name for rv in m.free_RVs] == ["y_unobserved"]
    assert m.named_vars["y_unobserved"].dtype == torch.int64
    assert [rv.name for rv in m.observed_RVs] == ["y_observed"]
    # the fill: the observed mean 0.5, rounded half to even as numpy does
    assert m.observed_RVs[0].observed.value.tolist() == [0, 0, 1]


def test_discrete_free_variable_routes_to_compound():
    with pmt.Model() as m:
        pmt.Normal("z", 0.0, 1.0)
        pmt.Bernoulli("b", p=0.3)
    assert [rv.name for rv in m.discrete_value_vars] == ["b"]
    assert m.named_vars["b"].dtype == torch.int64
    with pytest.raises(NotImplementedError, match="compound step"):
        m.logp_dlogp_fn(device="cpu")
    idata = pmt.sample(model=m, draws=4, tune=2, chains=2, device="cpu",
                       compute_convergence_checks=False)
    assert idata.posterior.attrs["stepper"] == (
        "CompoundStep([NUTS(['z']), BinaryGibbsMetropolis(['b'])])")
    assert idata.posterior["b"].values.dtype == np.int64


N_GROUPS, N_OBS = 20, 200


@pytest.fixture(scope="module")
def stress_pair():
    return (
        stress_glm_model(N_GROUPS, N_OBS, pm=pmj),
        stress_glm_model(N_GROUPS, N_OBS, pm=pmt),
    )


def test_stress_glm_layout_matches(stress_pair):
    mj, mt = stress_pair
    ij, it = mj.raveled_info(), mt.raveled_info()
    names = ["mu_a", "sd_a_log__", "mu_b", "sd_b_log__", "a_t", "b_t"]
    assert list(it.names) == list(ij.names) == names
    assert it.shapes == ij.shapes and it.sizes == ij.sizes
    assert it.total_size == 2 * N_GROUPS + 4
    np.testing.assert_array_equal(
        mt.observed_RVs[0].observed.value.numpy(), np.asarray(mj.observed_RVs[0].observed)
    )


def test_stress_glm_logp_and_grad_match(stress_pair):
    mj, mt = stress_pair
    info = mj.raveled_info()
    q = np.random.default_rng(0).normal(0.0, 0.7, size=(8, info.total_size))
    lf = mj.logp_fn()
    lj, gj = jax.vmap(jax.value_and_grad(lambda x: lf(unravel_vector(x, info))))(q)
    lt, gt = mt.logp_dlogp_fn(device="cpu")(torch.as_tensor(q))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-10)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-10, atol=1e-10)


def test_stress_glm_support_point_matches(stress_pair):
    mj, mt = stress_pair
    ref = make_initial_point(mj, jax.random.PRNGKey(0), jitter=0.0)
    got = support_point_values(mt)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-12)


def test_stress_glm_full_width_layout():
    m = stress_glm_model()
    assert m.raveled_info().total_size == 10004
    y = m.observed_RVs[0].observed.value
    assert y.shape == (20000,) and y.dtype == torch.int64


STRESS_CONFIG = dict(draws=100, tune=100, chains=4, random_seed=5,
                     compute_convergence_checks=False, var_names=list(STRESS_HYPERS))


def test_nuts_on_the_small_stress_glm_agrees():
    idata_j = pmj.sample(model=stress_glm_model(20, 200, pm=pmj), progressbar=False,
                         **STRESS_CONFIG)
    idata_t = pmt.sample(model=stress_glm_model(20, 200), device="cpu", **STRESS_CONFIG)
    assert list(idata_t.posterior.keys()) == list(STRESS_HYPERS)
    for name in STRESS_HYPERS:
        xj, xt = idata_j.posterior[name].values, idata_t.posterior[name].values
        assert xt.shape == xj.shape and np.isfinite(xt).all()
        z = abs(xt.mean() - xj.mean()) / np.hypot(mcse_mean(xj), mcse_mean(xt))
        assert z < 4.0, (name, z)
    assert idata_t.observed_data["y"].values.dtype == np.int64
