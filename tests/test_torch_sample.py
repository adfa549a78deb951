"""pymc_tpu_torch.sample end to end on the CPU against pymc_tpu.sample.

Eight Schools, 4 chains, in float64. The two packages draw different random
numbers, so the posteriors are compared by their means: each within 4
combined MCSE (sqrt(mcse_torch^2 + mcse_jax^2)) of the other. The
InferenceData must have the same variables, dims and sample_stats fields.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from pymc_tpu_torch.initial_point import make_initial_points_per_chain
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


def _run(code):
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True)


def test_import_leaves_jax_out():
    proc = _run("import sys, pymc_tpu_torch; sys.exit(int('jax' in sys.modules))")
    assert proc.returncode == 0, proc.stderr


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
