"""pymc_tpu_torch.sample end to end on the CPU against pymc_tpu.sample.

Eight Schools in float64, with NUTS (4 chains) and with ChEES (8 chains,
pooled mass). The two packages draw different random numbers, so the
posteriors are compared by their means: each within 4 combined MCSE
(sqrt(mcse_torch^2 + mcse_jax^2)) of the other. The InferenceData must have
the same variables, dims and sample_stats fields. Then ChEES's number of
leapfrogs, jittered draw to draw, and `var_names`. NUTS on the small stress
GLM is in test_torch_discrete.py.
"""

import logging
import subprocess
import sys

import numpy as np
import pytest
import torch

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from pymc_tpu_torch.initial_point import make_initial_points_per_chain
from pymc_tpu_torch.sampling import mcmc
from pymc_tpu_torch.stats.convergence import mcse_mean


def eight_schools(pm):
    y = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
    sigma = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])
    with pm.Model(coords={"school": np.arange(8)}) as m:
        mu = pm.Normal("mu", 0, 5)
        tau = pm.HalfCauchy("tau", 5)
        theta_t = pm.Normal("theta_t", 0, 1, dims="school")
        theta = pm.Deterministic("theta", mu + tau * theta_t, dims="school")
        pm.Normal("obs", theta, sigma, observed=y, dims="school")
    return m


CONFIG = dict(draws=120, tune=120, chains=4, random_seed=3, compute_convergence_checks=False)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def both():
    idata_j = pmj.sample(model=eight_schools(pmj), progressbar=False, **CONFIG)
    idata_t = pmt.sample(model=eight_schools(pmt), device="cpu", **CONFIG)
    return idata_j, idata_t


@pytest.mark.parametrize("name", ["mu", "tau", "theta_t", "theta"])
def test_posterior_means_agree(both, name):
    idata_j, idata_t = both
    xj = idata_j.posterior[name].values
    xt = idata_t.posterior[name].values
    assert xt.shape == xj.shape and np.isfinite(xt).all()
    se = np.hypot(mcse_mean(xj), mcse_mean(xt))
    z = np.abs(xt.mean(axis=(0, 1)) - xj.mean(axis=(0, 1))) / se
    assert np.all(z < 4.0), z


def test_inference_data_layout_matches(both):
    idata_j, idata_t = both
    assert set(idata_t.posterior.keys()) == set(idata_j.posterior.keys())
    for name in idata_j.posterior.keys():
        assert idata_t.posterior[name].dims == idata_j.posterior[name].dims
    assert set(idata_t.sample_stats.keys()) == set(idata_j.sample_stats.keys())
    for name in idata_j.sample_stats.keys():
        assert idata_t.sample_stats[name].shape == idata_j.sample_stats[name].shape
    assert idata_t.observed_data["obs"].dims == idata_j.observed_data["obs"].dims
    np.testing.assert_array_equal(
        idata_t.posterior.coords["school"], idata_j.posterior.coords["school"]
    )


def test_sampler_health_and_counters(both):
    _, idata_t = both
    stats, attrs = idata_t.sample_stats, idata_t.posterior.attrs
    assert stats["diverging"].values.sum() < 10
    assert float(pmt.rhat(idata_t.posterior["mu"].values)) < 1.05
    assert attrs["n_leapfrog"] >= stats["tree_depth"].values.max(axis=0).sum()
    assert attrs["sampling_host_syncs"] > 0
    # one subtree per doubling of each draw's deepest tree, tuning included
    depth_max = stats["tree_depth"].values.max(axis=0)
    assert attrs["n_subtrees"] >= depth_max.sum()
    assert 1 <= attrs["n_step_search"] < attrs["n_leapfrog"] - attrs["n_subtrees"] + 1
    # while drawing: one sync per leapfrog and per doubling, one per draw
    assert attrs["sampling_host_syncs"] >= depth_max.sum() + len(depth_max)
    assert attrs["compile_time"] == 0  # no kernel is built for CPU tensors


def test_same_seed_same_draws():
    model = eight_schools(pmt)
    cfg = dict(CONFIG, draws=5, tune=5)
    a = pmt.sample(model=model, device="cpu", **cfg).posterior["mu"].values
    b = pmt.sample(model=model, device="cpu", **cfg).posterior["mu"].values
    np.testing.assert_array_equal(a, b)


def test_bad_arguments_raise():
    model = eight_schools(pmt)
    with pytest.raises(ValueError, match="mass_adapt"):
        pmt.sample(model=model, mass_adapt="full", device="cpu")
    with pytest.raises(ValueError, match="draws"):
        pmt.sample(model=model, draws=0, device="cpu")
    for pm in (pmj, pmt):
        with pytest.raises(ValueError, match="Unknown sampler 'foo'"):
            kw = {"progressbar": False} if pm is pmj else {"device": "cpu"}
            pm.sample(model=eight_schools(pm), draws=2, tune=2, sampler="foo", **kw)


def _means_agree(idata_j, idata_t, names, z_max=4.0):
    for name in names:
        xj = idata_j.posterior[name].values
        xt = idata_t.posterior[name].values
        assert xt.shape == xj.shape and np.isfinite(xt).all()
        se = np.hypot(mcse_mean(xj), mcse_mean(xt))
        z = np.abs(xt.mean(axis=(0, 1)) - xj.mean(axis=(0, 1))) / se
        assert np.all(z < z_max), (name, z)


CHEES_CONFIG = dict(draws=300, tune=300, chains=8, random_seed=42, sampler="chees",
                    mass_adapt="pooled", compute_convergence_checks=False)


@pytest.fixture(scope="module")
def both_chees():
    idata_j = pmj.sample(model=eight_schools(pmj), progressbar=False, **CHEES_CONFIG)
    idata_t = pmt.sample(model=eight_schools(pmt), device="cpu", **CHEES_CONFIG)
    return idata_j, idata_t


def test_chees_posterior_means_agree(both_chees):
    idata_j, idata_t = both_chees
    _means_agree(idata_j, idata_t, ["mu", "tau", "theta_t", "theta"])
    assert set(idata_t.sample_stats.keys()) == set(idata_j.sample_stats.keys())
    assert abs(idata_t.posterior["mu"].values.mean() - 4.4) < 0.8
    assert float(np.nanmax(pmt.rhat(idata_t.posterior["mu"].values))) < 1.05


def test_chees_counters(both_chees):
    _, idata_t = both_chees
    attrs, n_steps = idata_t.posterior.attrs, idata_t.sample_stats["n_steps"].values
    assert attrs["sampler"] == "chees" and attrs["n_subtrees"] == 0
    # one host read of the number of leapfrogs per draw
    assert attrs["sampling_host_syncs"] == CHEES_CONFIG["draws"]
    # every chain takes the same number of leapfrogs in a draw
    assert (n_steps == n_steps[:1]).all()
    assert attrs["n_leapfrog"] > n_steps[0].sum() + attrs["n_step_search"]
    assert attrs["n_logp_grad"] == attrs["n_leapfrog"] + 2
    depth = idata_t.sample_stats["tree_depth"].values
    np.testing.assert_array_equal(depth, np.ceil(np.log2(n_steps + 1.0)))


def test_chees_trajectory_adapts():
    """tests/sampling/test_chees.py::test_trajectory_adapts on the port: the
    jittered number of leapfrogs varies draw to draw and exceeds 1 on
    average, and the draws recover the covariance."""
    cov = np.array([[1.0, 0.95], [0.95, 1.0]])
    with pmt.Model() as m:
        pmt.MvNormal("x", mu=np.zeros(2), cov=cov)
    idata = pmt.sample(draws=300, tune=400, chains=16, model=m, random_seed=1,
                       compute_convergence_checks=False, sampler="chees", device="cpu")
    n_steps = idata.sample_stats["n_steps"].values
    assert n_steps.mean() > 2
    assert np.unique(n_steps).size > 3
    x = idata.posterior["x"].values
    np.testing.assert_allclose(np.cov(x.reshape(-1, 2).T), cov, atol=0.12)


def test_var_names_subset_on_the_device(monkeypatch, caplog):
    model = eight_schools(pmt)
    cfg = dict(CONFIG, draws=7, tune=5)
    full = pmt.sample(model=model, device="cpu", **cfg)
    # chunks of 5 rows: 7 draws x 4 chains split unevenly
    monkeypatch.setattr(mcmc, "_POST_CHUNK", 5)
    with caplog.at_level(logging.WARNING, logger="pymc_tpu_torch"):
        sub = pmt.sample(model=model, device="cpu", var_names=["theta", "mu", "nope"], **cfg)
    assert "['nope'] not found in the model" in caplog.text
    assert list(sub.posterior.keys()) == ["mu", "theta"]
    for name in ("mu", "theta"):
        assert sub.posterior[name].dims == full.posterior[name].dims
        np.testing.assert_array_equal(sub.posterior[name].values, full.posterior[name].values)
    np.testing.assert_array_equal(
        sub.sample_stats["n_steps"].values, full.sample_stats["n_steps"].values
    )


def test_var_names_warning_matches_jax(caplog):
    cfg = dict(CONFIG, draws=3, tune=3, var_names=["mu", "nope"])
    with caplog.at_level(logging.WARNING):
        idata_j = pmj.sample(model=eight_schools(pmj), progressbar=False, **cfg)
        idata_t = pmt.sample(model=eight_schools(pmt), device="cpu", **cfg)
    assert list(idata_t.posterior.keys()) == list(idata_j.posterior.keys()) == ["mu"]
    messages = [r.getMessage() for r in caplog.records if "not found" in r.getMessage()]
    assert len(messages) == 2 and messages[0] == messages[1]


def _run(code):
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)


def test_import_leaves_jax_out():
    proc = _run(
        "import sys, pymc_tpu_torch, pymc_tpu_torch.smc.sampling, "
        "pymc_tpu_torch.sampling.forward, pymc_tpu_torch.distributions.mixture; "
        "sys.exit(int(any(m.split('.')[0] in ('jax', 'pymc_tpu') for m in sys.modules)))"
    )
    assert proc.returncode == 0, proc.stderr


def test_bench_arguments_are_accepted():
    # bench.py:71-82's keyword arguments, at its many-chain settings
    idata = pmt.sample(
        draws=3, tune=3, chains=2, model=eight_schools(pmt), random_seed=0,
        progressbar=False, compute_convergence_checks=False, mass_adapt="pooled",
        step_adapt="pooled", target_accept=0.95, device="cpu",
    )
    assert idata.posterior["theta"].shape == (2, 3, 8)


def test_arguments_that_do_nothing_on_one_device_are_accepted():
    trace = pmt.sample(
        draws=3, tune=3, chains=2, model=eight_schools(pmt), random_seed=0, device="cpu",
        progressbar=True, cores=4, idata_kwargs={"log_likelihood": False},
        nuts_sampler="pymc", return_inferencedata=False, postprocessing_chunks=4,
        keep_warning_stat=True,
    )
    assert isinstance(trace, pmt.MultiTrace)
    assert sorted(trace.varnames) == ["mu", "tau", "theta", "theta_t"]
    assert trace.get_values("theta").shape == (6, 8)


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        pmt.sample(draws=2, tune=2, chains=1, model=eight_schools(pmt), device="cuda")


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default would run there")
    model = eight_schools(pmt)
    with pytest.raises(RuntimeError, match="cuda"):
        pmt.sample(draws=2, tune=2, chains=1, model=model)
    for build in (model.logp_fn, model.logp_dlogp_fn, model.postprocess_fn):
        with pytest.raises(RuntimeError, match="cuda"):
            build()
    with pytest.raises(RuntimeError, match="cuda"):
        make_initial_points_per_chain(model, lambda q: q[:, 0], 2, torch.Generator())
