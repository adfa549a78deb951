"""Prior and posterior predictive sampling of the port, on the CPU in
float64, against pymc_tpu's rules and moments.

The volatility rule of `sample_posterior_predictive` (free RVs in the trace
kept, missing ones and the observed RVs drawn anew, `sample_vars`,
`freeze_vars`, ImplicitFreezeWarning), `var_names` and the default
outputs, copied from `tests/sampling/test_forward_volatility.py` (its Data
cases wait for the Data containers) and run through both packages where
the outputs are deterministic; the predictive groups (`prior`,
`prior_predictive`, `posterior_predictive`, `predictions`,
`extend_inferencedata`); prior predictive moments against pymc_tpu's; and
a GP conditional's draws, which must equal mean + L z for the port's own
standard normals and whose moments must agree with `Marginal.predict`.
"""

import warnings

import numpy as np
import pytest
import torch

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from pymc_tpu.exceptions import ImplicitFreezeWarning as ImplicitFreezeWarningJ
from pymc_tpu_torch.exceptions import ImplicitFreezeWarning
from pymc_tpu_torch.graph import evaluate
from pymc_tpu_torch.models import gp_marginal_model


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fake_idata(pm, model, posterior):
    post = {k: np.asarray(v, dtype=float) for k, v in posterior.items()}
    return pm.backends.arviz.to_inference_data(model, posterior=post)


def _ppc(pm, idata, **kw):
    kw = dict(kw, return_inferencedata=False, random_seed=0)
    if pm is pmt:
        kw["device"] = "cpu"
    return pm.sample_posterior_predictive(idata, **kw)


BOTH = pytest.mark.parametrize("pm", [pmj, pmt], ids=["pymc_tpu", "port"])


@BOTH
def test_var_names_output_vs_sample_vars_resample(pm):
    with pm.Model() as model:
        mu = pm.Normal("mu", 0, 1)
        pm.Normal("obs", mu, 1, observed=np.zeros(5))
    idata = _fake_idata(pm, model, {"mu": np.ones((1, 100))})
    copied = _ppc(pm, idata, model=model, var_names=["mu", "obs"])
    np.testing.assert_array_equal(copied["mu"].flatten(), np.ones(100))
    assert copied["obs"].shape == (1, 100, 5)
    resampled = _ppc(pm, idata, model=model, var_names=["mu", "obs"], sample_vars=["mu"])
    assert not np.all(resampled["mu"] == 1.0)
    assert abs(resampled["mu"].std() - 1.0) < 0.25


@BOTH
def test_argument_errors(pm):
    with pm.Model() as model:
        mu = pm.Normal("mu")
        pm.Normal("extra", 0, 1)
        pm.Normal("obs", mu, 1, observed=np.zeros(1))
    idata = _fake_idata(pm, model, {"mu": np.ones((1, 5))})
    with pytest.raises(ValueError, match="both sample_vars and freeze_vars"):
        _ppc(pm, idata, model=model, sample_vars=["mu"], freeze_vars=["mu"])
    with pytest.raises(ValueError, match="not present in the trace"):
        _ppc(pm, idata, model=model, freeze_vars=["extra"])
    with pytest.raises(ValueError, match="not random variables or deterministics"):
        _ppc(pm, idata, model=model, sample_vars=["nothing"])
    with pytest.raises(KeyError):
        _ppc(pm, idata, model=model, var_names=["nothing"])


@BOTH
def test_resampled_ancestor_freezes_a_trace_rv_with_a_warning(pm):
    warning = ImplicitFreezeWarning if pm is pmt else ImplicitFreezeWarningJ
    with pm.Model() as model:
        y = pm.Normal("y")
        z = pm.Normal("z", y)
        pm.Normal("obs", z, 1e-6, observed=np.zeros(1))
    z_vals = np.array([[0.3, -0.7]])
    idata = _fake_idata(pm, model, {"y": np.array([[0.1, 1.2]]), "z": z_vals})
    with pytest.warns(warning, match="ancestor is resampled"):
        ppc = _ppc(pm, idata, model=model, sample_vars=["y"], var_names=["z"])
    np.testing.assert_allclose(ppc["z"], z_vals)
    assert set(ppc) == {"z"}
    with warnings.catch_warnings():
        warnings.simplefilter("error", warning)
        _ppc(pm, idata, model=model, sample_vars=["y"], freeze_vars=["z"], var_names=["z"])
        _ppc(pm, idata, model=model, sample_vars=["y", "z"], var_names=["z"])


@BOTH
def test_a_free_rv_missing_from_the_trace_is_drawn(pm):
    with pm.Model() as model:
        mu = pm.Normal("mu")
        sigma = pm.HalfNormal("sigma", 1.0)
        pm.Normal("obs", mu, sigma, observed=np.zeros(3))
    idata = _fake_idata(pm, model, {"mu": np.zeros((1, 50))})
    ppc = _ppc(pm, idata, model=model, var_names=["sigma", "obs"])
    assert ppc["sigma"].shape == (1, 50) and ppc["obs"].shape == (1, 50, 3)
    assert np.all(ppc["sigma"] > 0) and len(np.unique(ppc["sigma"])) > 10


@BOTH
def test_deterministics_copied_recomputed_and_frozen(pm):
    with pm.Model() as model:
        x = pm.Normal("x")
        det = pm.Deterministic("det", x**2)
        pm.Normal("obs", det, 1e-6, observed=np.zeros(1))
    x_trace = np.array([[0.5, -1.5, 2.0]])
    stale = np.array([[9.9, 8.8, 7.7]])  # not x**2
    idata = _fake_idata(pm, model, {"x": x_trace, "det": stale})
    # a trace deterministic with no volatile input is copied
    ppc = _ppc(pm, idata, model=model, var_names=["det", "obs"])
    np.testing.assert_allclose(ppc["det"], stale)
    np.testing.assert_allclose(ppc["obs"][..., 0], stale, atol=1e-4)
    # sample_vars forces its recomputation from the trace's inputs
    ppc = _ppc(pm, idata, model=model, var_names=["det"], sample_vars=["det"])
    np.testing.assert_allclose(ppc["det"], x_trace**2)
    # a resampled input makes it volatile, unless it is frozen
    ppc = _ppc(pm, idata, model=model, var_names=["x", "det"], sample_vars=["x"])
    np.testing.assert_allclose(ppc["det"], ppc["x"] ** 2)
    ppc = _ppc(pm, idata, model=model, var_names=["det", "obs"], sample_vars=["x"],
               freeze_vars=["det"])
    np.testing.assert_allclose(ppc["det"], stale)
    np.testing.assert_allclose(ppc["obs"][..., 0], stale, atol=1e-4)


@BOTH
def test_default_outputs_are_the_observed_and_their_deterministics(pm):
    with pm.Model() as model:
        mu = pm.Normal("mu")
        obs = pm.Normal("obs", mu, 1, observed=np.zeros(4))
        pm.Deterministic("obs_twice", 2.0 * obs)
        pm.Deterministic("mu_sq", mu**2)  # not observed-dependent
    idata = _fake_idata(pm, model, {"mu": np.zeros((1, 5))})
    ppc = _ppc(pm, idata, model=model)
    assert set(ppc) == {"obs", "obs_twice"}
    np.testing.assert_allclose(ppc["obs_twice"], 2.0 * ppc["obs"], rtol=1e-12)


def _normal_model(pm):
    with pm.Model(coords={"i": range(4)}) as model:
        mu = pm.Normal("mu", 1.0, 2.0)
        sigma = pm.HalfNormal("sigma", 0.5)
        pm.Deterministic("shift", mu + 3.0)
        pm.Normal("obs", mu, sigma, observed=np.zeros(4), dims="i")
    return model


def test_groups_and_options():
    model = _normal_model(pmt)
    post = {"mu": np.random.default_rng(0).normal(size=(2, 30)),
            "sigma": np.full((2, 30), 0.5)}
    idata = _fake_idata(pmt, model, post)
    pp = pmt.sample_posterior_predictive(idata, model=model, random_seed=1, device="cpu")
    assert pp.groups() == ["posterior_predictive", "observed_data"]
    assert pp.posterior_predictive["obs"].dims == ("chain", "draw", "i")
    pred = pmt.sample_posterior_predictive(idata, model=model, random_seed=1, device="cpu",
                                           predictions=True)
    assert "predictions" in pred.groups() and "posterior_predictive" not in pred.groups()
    np.testing.assert_array_equal(pred.predictions["obs"].values,
                                  pp.posterior_predictive["obs"].values)
    out = pmt.sample_posterior_predictive(idata, model=model, random_seed=1, device="cpu",
                                          extend_inferencedata=True)
    assert out is idata and "posterior_predictive" in idata.groups()
    points = [{"mu": 0.5, "sigma": 0.5}, {"mu": -0.5, "sigma": 0.5}]
    from_points = pmt.sample_posterior_predictive(points, model=model, random_seed=1,
                                                  device="cpu", return_inferencedata=False)
    assert from_points["obs"].shape == (1, 2, 4)
    with pytest.raises(NotImplementedError, match="Data"):
        idata.add_group("constant_data", {"x": np.ones(3)})
        pmt.sample_posterior_predictive(idata, model=model, device="cpu")


def test_same_seed_same_draws():
    model = _normal_model(pmt)
    idata = _fake_idata(pmt, model, {"mu": np.zeros((1, 20)), "sigma": np.ones((1, 20))})
    a, b = (pmt.sample_posterior_predictive(idata, model=model, random_seed=7, device="cpu",
                                            return_inferencedata=False)["obs"] for _ in range(2))
    np.testing.assert_array_equal(a, b)


def test_prior_predictive_matches_pymc_tpu_in_distribution():
    draws = 4000
    ij = pmj.sample_prior_predictive(draws, model=_normal_model(pmj), random_seed=0)
    it = pmt.sample_prior_predictive(draws, model=_normal_model(pmt), random_seed=0,
                                     device="cpu")
    assert it.groups() == ij.groups() == ["prior", "prior_predictive", "observed_data"]
    assert sorted(it.prior.keys()) == sorted(ij.prior.keys()) == ["mu", "shift", "sigma"]
    for group, name, sd in (("prior", "mu", 2.0), ("prior", "sigma", 0.5 * np.sqrt(1 - 2 / np.pi)),
                            ("prior_predictive", "obs", None)):
        xt = np.asarray(it[group][name].values)
        xj = np.asarray(ij[group][name].values)
        assert xt.shape == xj.shape
        se = np.hypot(xt.std(), xj.std()) / np.sqrt(draws)
        assert abs(xt.mean() - xj.mean()) < 5 * se
        if sd is not None:
            assert abs(xt.std() - sd) < 0.05 * sd
    np.testing.assert_allclose(it.prior["shift"].values, it.prior["mu"].values + 3.0)
    only = pmt.sample_prior_predictive(10, model=_normal_model(pmt), var_names=["obs"],
                                       return_inferencedata=False, device="cpu", random_seed=0)
    assert set(only) == {"obs"} and only["obs"].shape == (10, 4)


# -- GP prediction through the predictive -------------------------------------

XNEW = np.linspace(0.0, 12.0, 9)[:, None]


def _gp_trace(draws=400):
    rng = np.random.default_rng(2)
    return {"ls": rng.uniform(1.0, 2.0, (2, draws)), "eta": rng.uniform(1.0, 2.5, (2, draws)),
            "sigma": rng.uniform(0.25, 0.4, (2, draws))}


def _gp_with_conditional(pred_noise):
    model, gp = gp_marginal_model(20, return_gp=True)
    with model:
        gp.conditional("f_pred", XNEW, pred_noise=pred_noise)
    return model, gp


def test_conditional_draws_are_mean_plus_factor_times_the_normals():
    model, _ = _gp_with_conditional(True)
    post = _gp_trace(10)
    idata = _fake_idata(pmt, model, post)
    draws = pmt.sample_posterior_predictive(idata, model=model, var_names=["f_pred"],
                                            random_seed=5, device="cpu",
                                            return_inferencedata=False)["f_pred"]
    # the only draw is f_pred's: one (draws, points) block of standard normals
    z = torch.randn((20, len(XNEW)), generator=torch.Generator().manual_seed(5),
                    dtype=torch.float64)
    rv = model["f_pred"]
    for d in (0, 7, 19):
        env = {k: torch.tensor(v.reshape(-1)[d]) for k, v in post.items()}
        mu, L = evaluate(rv.dist.mu, env), evaluate(rv.dist.chol, env)
        np.testing.assert_allclose(draws.reshape(20, -1)[d], (mu + L @ z[d]).numpy(), rtol=1e-10)


def test_predictive_moments_agree_with_predict():
    model, gp = _gp_with_conditional(True)
    post = _gp_trace()
    idata = _fake_idata(pmt, model, post)
    y = pmt.sample_posterior_predictive(idata, model=model, var_names=["f_pred"],
                                        random_seed=3, device="cpu",
                                        return_inferencedata=False)["f_pred"].reshape(-1, 9)
    fn = torch.func.vmap(gp.predict_fn(XNEW, diag=True, pred_noise=True, device="cpu"))
    mu, var = (t.numpy() for t in fn({k: torch.as_tensor(v.reshape(-1)) for k, v in post.items()}))
    N = mu.shape[0]
    mean_ref, var_ref = mu.mean(0), var.mean(0) + mu.var(0)
    z_mean = (y.mean(0) - mean_ref) / np.sqrt(var.mean(0) / N)
    se_var = np.sqrt(4 * ((mu - mean_ref) ** 2 * var).sum(0) + 2 * (var**2).sum(0)) / N
    z_var = (y.var(0) - var_ref) / se_var
    assert np.abs(z_mean).max() < 5 and np.abs(z_var).max() < 5, (z_mean, z_var)
