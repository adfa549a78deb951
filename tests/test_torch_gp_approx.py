"""The port's GP classes and prediction against pymc_tpu on the CPU, in
float64.

TP, MarginalApprox (FITC, VFE, DTC), LatentKron, MarginalKron, HSGP and
HSGPPeriodic: the raveled layout must be equal and logp+grad at 8 points
must match at rtol 1e-9. `conditional` (Latent, Marginal with and without
noise, TP, MarginalApprox, HSGP) and `Marginal.predict` (full and diagonal,
with `given=` for a component of an additive GP): the predictive mean and
covariance at rtol 1e-9; a drawn value is mean + L z with the z the port's
generator gives. MvStudentT, ChiSquared and KroneckerNormal against scipy
and pymc_tpu. The cases copy `tests/test_gp_tp_kron.py`,
`tests/gp/test_gp_depth.py` and `tests/test_gp_and_map.py`. Sizes stay at
n <= 20, but for config #4's latent GP (n = 150): `models.gp_latent_logp_plain`
against the model, and the model in float32 with its default prior jitter
against that reference in float64 with the same jitter.
"""

import json
import os

import numpy as np
import pytest
import scipy.stats as st
import torch

import jax

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from benchmarks.suite import _gp_data
from pymc_tpu.blocking import unravel_vector
from pymc_tpu.graph import evaluate as evaluate_j
from pymc_tpu_torch import models
from pymc_tpu_torch.graph import evaluate as evaluate_t

DATA = os.path.join(os.path.dirname(__file__), "data")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 20
_, X, Y = models.gp_data(N)
XNEW = np.linspace(-1.0, 12.0, 7)[:, None]
XU = np.linspace(0.0, 10.0, 6)[:, None]


def _hsgpp_model(pm):
    # ls = 0.5 keeps pymc_tpu's Bessel recurrence accurate over the 8
    # orders (test_torch_gp_cov.py::test_periodic_expansion_coefficients_match_pymc_tpu)
    with pm.Model() as m:
        period = pm.Gamma("period", 20, 5)
        eta = pm.HalfNormal("eta", 2)
        gp = pm.gp.HSGPPeriodic(m=8, scale=eta, cov_func=pm.gp.cov.Periodic(1, period, ls=0.5))
        f = gp.prior("f", X=X[:, 0])
        pm.Normal("y", f, pm.HalfNormal("sigma", 1), observed=Y)
    return m


def _hsgp_2d_model(pm, drop_first, parametrization):
    x = np.random.default_rng(4).uniform(-2, 3, size=(N, 2))
    with pm.Model() as m:
        ls = pm.Gamma("ls", 2, 1)
        gp = pm.gp.HSGP(m=[3, 4], c=1.8, drop_first=drop_first, parametrization=parametrization,
                        cov_func=pm.gp.cov.Matern52(2, ls=ls))
        f = gp.prior("f", X=x)
        pm.Normal("y", f, 0.5, observed=Y)
    return m


MODELS = {
    "tp": lambda pm: models.gp_tp_model(N, pm=pm, jitter=1e-4),
    "tp_mvstudentt": lambda pm: _tp_mvt_model(pm),
    "fitc": lambda pm: models.gp_approx_model("FITC", N, 6, pm=pm),
    "vfe": lambda pm: models.gp_approx_model("VFE", N, 6, pm=pm),
    "dtc": lambda pm: models.gp_approx_model("DTC", N, 6, pm=pm),
    # an 8 x 6 grid: on a coarser one a short lengthscale makes a factor the
    # identity to 1e-14, its eigenvalues coincide, and the eigendecomposition's
    # gradient is ill-conditioned in both packages
    "latent_kron": lambda pm: models.gp_kron_model("latent", 8, 6, pm=pm, jitter=1e-4),
    "marginal_kron": lambda pm: models.gp_kron_model("marginal", 8, 6, pm=pm),
    "hsgp": lambda pm: models.gp_hsgp_model(N, 12, pm=pm),
    "hsgp_2d_drop_first_centered": lambda pm: _hsgp_2d_model(pm, True, "centered"),
    "hsgp_periodic": _hsgpp_model,
}


def _tp_mvt_model(pm):
    with pm.Model() as m:
        ls = pm.Gamma("ls", 2, 1)
        tp = pm.gp.TP(cov_func=pm.gp.cov.ExpQuad(1, ls=ls), nu=4.0)
        f = tp.prior("f", X=X, reparameterize=False, jitter=1e-2)
        pm.Normal("y", f, 0.5, observed=Y)
    return m


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request):
    build = MODELS[request.param]
    return build(pmj), build(pmt)


def test_raveled_layout_matches(pair):
    mj, mt = pair
    ij, it = mj.raveled_info(), mt.raveled_info()
    assert (it.names, it.shapes, it.sizes) == (ij.names, ij.shapes, ij.sizes)


def test_logp_and_grad_match(pair):
    mj, mt = pair
    info = mj.raveled_info()
    q = np.random.default_rng(0).normal(0.0, 0.5, size=(8, info.total_size))
    lf = mj.logp_fn()
    lj, gj = jax.jit(jax.vmap(jax.value_and_grad(lambda x: lf(unravel_vector(x, info)))))(q)
    lt, gt = mt.logp_dlogp_fn(device="cpu")(torch.as_tensor(q))
    assert np.isfinite(lt.numpy()).all()
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-9)
    gj = np.asarray(gj)
    np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-9, atol=1e-9 * np.abs(gj).max())


@pytest.mark.parametrize("approx", ["FITC", "VFE", "DTC"])
def test_marginal_approx_with_a_fixed_sigma_is_a_potential(approx):
    def build(pm):
        with pm.Model() as m:
            ls = pm.Gamma("ls", 2, 1)
            gp = pm.gp.MarginalApprox(approx=approx, cov_func=pm.gp.cov.ExpQuad(1, ls=ls))
            gp.marginal_likelihood("y", X=X, Xu=XU, y=Y, sigma=0.3)
        return m

    mj, mt = build(pmj), build(pmt)
    assert [p.name for p in mt.potentials] == ["y"] and not mt.observed_RVs
    q = {"ls_log__": np.log(1.4)}
    ref = mj.logp_fn()({k: np.asarray(v) for k, v in q.items()})
    got = mt.logp_fn(device="cpu")({k: torch.tensor(v) for k, v in q.items()})
    np.testing.assert_allclose(float(got), float(ref), rtol=1e-9)


# -- prediction ---------------------------------------------------------------

POINT = {"ls": 1.3, "eta": 1.7, "sigma": 0.4, "ls2": 0.9}


def _env_t(point):
    return {k: torch.as_tensor(np.asarray(v, dtype=np.float64)) for k, v in point.items()}


def _rv_moments(rv, point, evaluate, env):
    """(mean, covariance) of an MvNormal/MvStudentT rv at `point`."""
    mu = np.asarray(evaluate(rv.dist.mu, env(point)))
    L = np.asarray(evaluate(rv.dist.chol, env(point)))
    return np.broadcast_to(mu, L.shape[:1]), L @ L.T


def _latent(pm, conditional_kw=None):
    with pm.Model() as m:
        ls = pm.Gamma("ls", 2, 1)
        eta = pm.HalfNormal("eta", 2)
        gp = pm.gp.Latent(mean_func=pm.gp.mean.Constant(0.3),
                          cov_func=eta**2 * pm.gp.cov.ExpQuad(1, ls=ls))
        gp.prior("f", X=X)
        gp.conditional("f_new", XNEW, **(conditional_kw or {}))
    return m


def _marginal(pm, **kw):
    with pm.Model() as m:
        ls = pm.Gamma("ls", 2, 1)
        eta = pm.HalfNormal("eta", 2)
        sigma = pm.HalfNormal("sigma", 1)
        gp = pm.gp.Marginal(mean_func=pm.gp.mean.Linear(coeffs=np.array([0.2]), intercept=0.1),
                            cov_func=eta**2 * pm.gp.cov.Matern32(1, ls=ls))
        gp.marginal_likelihood("y", X=X, y=Y, sigma=sigma)
        gp.conditional("f_new", XNEW, **kw)
    return m, gp


def _additive_marginal(pm):
    with pm.Model() as m:
        ls = pm.Gamma("ls", 2, 1)
        ls2 = pm.Gamma("ls2", 2, 1)
        sigma = pm.HalfNormal("sigma", 1)
        gp1 = pm.gp.Marginal(cov_func=pm.gp.cov.ExpQuad(1, ls=ls))
        gp2 = pm.gp.Marginal(cov_func=0.5 * pm.gp.cov.Periodic(1, period=3.0, ls=ls2))
        gp = gp1 + gp2
        gp.marginal_likelihood("y", X=X, y=Y, sigma=sigma)
        gp1.conditional("f_new", XNEW, given={"X": X, "y": Y, "sigma": sigma, "gp": gp})
    return m, gp1, {"X": X, "y": Y, "sigma": sigma, "gp": gp}


def _additive_latent(pm):
    with pm.Model() as m:
        ls = pm.Gamma("ls", 2, 1)
        ls2 = pm.Gamma("ls2", 2, 1)
        gp1 = pm.gp.Latent(cov_func=pm.gp.cov.ExpQuad(1, ls=ls))
        gp2 = pm.gp.Latent(cov_func=pm.gp.cov.Matern52(1, ls=ls2))
        gp = gp1 + gp2
        f = gp.prior("f", X=X)
        gp1.conditional("f_new", XNEW, given={"X": X, "f": f, "gp": gp})
    return m


def _tp_conditional(pm):
    with pm.Model() as m:
        ls = pm.Gamma("ls", 2, 1)
        tp = pm.gp.TP(cov_func=pm.gp.cov.ExpQuad(1, ls=ls), nu=6.0)
        tp.prior("f", X=X, jitter=1e-4)
        tp.conditional("f_new", XNEW)
    return m


def _approx_conditional(approx, pred_noise):
    def build(pm):
        with pm.Model() as m:
            ls = pm.Gamma("ls", 2, 1)
            sigma = pm.HalfNormal("sigma", 1)
            gp = pm.gp.MarginalApprox(approx=approx, cov_func=pm.gp.cov.ExpQuad(1, ls=ls))
            gp.marginal_likelihood("y", X=X, Xu=XU, y=Y, sigma=sigma)
            gp.conditional("f_new", XNEW, pred_noise=pred_noise)
        return m
    return build


CONDITIONALS = {
    "latent": _latent,
    "latent_additive_given": _additive_latent,
    "marginal": lambda pm: _marginal(pm)[0],
    "marginal_pred_noise": lambda pm: _marginal(pm, pred_noise=True)[0],
    "marginal_additive_given": lambda pm: _additive_marginal(pm)[0],
    "tp": _tp_conditional,
    "fitc": _approx_conditional("FITC", False),
    "vfe_pred_noise": _approx_conditional("VFE", True),
}


@pytest.mark.parametrize("name", sorted(CONDITIONALS))
def test_conditional_mean_and_covariance_match(name):
    mj, mt = CONDITIONALS[name](pmj), CONDITIONALS[name](pmt)
    point = {k: v for k, v in POINT.items() if k in mj.named_vars}
    if "f_rotated_" in mj.named_vars:
        point["f_rotated_"] = np.random.default_rng(1).normal(size=N)
    if "f_chi2_" in mj.named_vars:
        point["f_chi2_"] = 4.5
    mu_j, cov_j = _rv_moments(mj["f_new"], point, evaluate_j, dict)
    mu_t, cov_t = _rv_moments(mt["f_new"], point, evaluate_t, _env_t)
    np.testing.assert_allclose(mu_t, mu_j, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(cov_t, cov_j, rtol=1e-9, atol=1e-9 * np.abs(cov_j).max())
    if name == "tp":
        nu_t = evaluate_t(mt["f_new"].dist.nu, _env_t(point))
        assert float(nu_t) == 6.0 + N


@pytest.mark.parametrize("diag", [False, True])
@pytest.mark.parametrize("pred_noise", [False, True])
@pytest.mark.parametrize("additive", [False, True])
def test_predict_matches(diag, pred_noise, additive):
    if additive:
        (_, gj, gvn_j), (_, gt, gvn_t) = _additive_marginal(pmj), _additive_marginal(pmt)
    else:
        (_, gj), (_, gt) = _marginal(pmj), _marginal(pmt)
        gvn_j = gvn_t = None
    point = {k: v for k, v in POINT.items() if k in ("ls", "eta", "sigma", "ls2")}
    kw = dict(point=point, diag=diag, pred_noise=pred_noise)
    mu_j, var_j = gj.predict(XNEW, given=gvn_j, **kw)
    mu_t, var_t = gt.predict(XNEW, given=gvn_t, device="cpu", **kw)
    np.testing.assert_allclose(mu_t, mu_j, rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(var_t, var_j, rtol=1e-9, atol=1e-9 * np.abs(var_j).max())


def test_component_conditional_differs_from_the_total():
    # the component's conditional reads the total's Kxx, so it is not the
    # total's own conditional (tests/gp/test_gp_depth.py:82)
    _, g1, given = _additive_marginal(pmt)
    mu1, _ = g1.predict(XNEW, point=POINT, given=given, device="cpu")
    mu_total, _ = given["gp"].predict(XNEW, point=POINT, device="cpu")
    assert np.abs(mu1 - mu_total).max() > 1e-3


def test_conditional_draw_is_mean_plus_factor_times_normals():
    mt, _ = _marginal(pmt, pred_noise=True)
    rv = mt["f_new"]
    env = _env_t({k: POINT[k] for k in ("ls", "eta", "sigma")})
    draw = rv.dist.sample(torch.Generator().manual_seed(3), (), dict(env), {})
    z = torch.randn(len(XNEW), generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    mu, L = evaluate_t(rv.dist.mu, env), evaluate_t(rv.dist.chol, env)
    np.testing.assert_allclose(draw.numpy(), (mu + L @ z).numpy(), rtol=1e-12)


def test_hsgp_basis_and_conditional_match():
    x = np.random.default_rng(4).uniform(-2, 3, size=(N, 2))
    xs = np.random.default_rng(5).uniform(-2, 3, size=(5, 2))
    out = {}
    for pm in (pmj, pmt):
        with pm.Model():
            gp = pm.gp.HSGP(m=[3, 4], c=1.8, drop_first=True,
                            cov_func=1.5 * pm.gp.cov.ExpQuad(2, ls=[0.7, 1.1]))
            phi, sqrt_psd = gp.prior_linearized(x)
            gp.prior("f", X=x)
            fs = gp.conditional("fs", xs)
        beta = np.random.default_rng(6).normal(size=gp.n_basis)
        env = {"f_hsgp_coeffs_": beta}
        if pm is pmt:
            fs = evaluate_t(fs, _env_t(env))
        else:
            fs = evaluate_j(fs, env)
        out[pm] = [np.asarray(a) for a in (phi, sqrt_psd, fs)] + [gp._L, gp._center]
    assert gp.n_basis == 11
    for a, b in zip(out[pmt], out[pmj]):
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-14)


def test_hsgp_helpers_match():
    for c in (1.2, 3.0):
        for a, b in zip(pmt.gp.set_boundary(X, c), pmj.gp.set_boundary(X, c)):
            np.testing.assert_allclose(a, b, rtol=1e-14)
    for kind in ("expquad", "matern52", "matern32"):
        assert (pmt.gp.approx_hsgp_hyperparams([0, 10], [1, 4], kind)
                == pmj.gp.approx_hsgp_hyperparams([0, 10], [1, 4], kind))


def test_latent_kron_implied_covariance_is_the_kronecker_product():
    # tests/test_gp_tp_kron.py: f = (L1 (x) L2) v, so Cov f = K1 (x) K2
    x1, x2 = np.linspace(0, 1, 3)[:, None], np.linspace(0, 2, 4)[:, None]
    k1, k2 = pmt.gp.cov.ExpQuad(1, 0.5), pmt.gp.cov.Matern32(1, 0.8)
    with pmt.Model() as m:
        pmt.gp.LatentKron(cov_funcs=[k1, k2]).prior("f", Xs=[x1, x2])
    M = torch.stack([evaluate_t(m["f"], {"f_rotated_": e}) for e in torch.eye(12,
                                                                      dtype=torch.float64)], 1)
    K = np.kron(k1(x1).numpy(), k2(x2).numpy())
    np.testing.assert_allclose((M @ M.T).numpy(), K, atol=5e-5)


# -- distributions ------------------------------------------------------------

def _mvt_inputs(d=4):
    rng = np.random.default_rng(8)
    B = rng.normal(size=(d, d))
    return rng.normal(size=d), B @ B.T + d * np.eye(d), rng.normal(size=(5, d))


@pytest.mark.parametrize("form", ["scale", "cov", "tau", "chol"])
def test_mvstudentt_logp_matches_pymc_tpu_and_scipy(form):
    mu, S, x = _mvt_inputs()
    kw = {"scale": dict(scale=S), "cov": dict(cov=S), "tau": dict(tau=np.linalg.inv(S)),
          "chol": dict(chol=np.linalg.cholesky(S))}[form]
    got = pmt.MvStudentT.dist(nu=3.5, mu=mu, **kw).logp(torch.as_tensor(x)).numpy()
    ref = np.asarray(pmj.MvStudentT.dist(nu=3.5, mu=mu, **kw).logp(x))
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    np.testing.assert_allclose(got, st.multivariate_t(mu, S, df=3.5).logpdf(x), rtol=1e-10)


def test_mvstudentt_draws_have_its_moments():
    mu, S, _ = _mvt_inputs(3)
    d = pmt.MvStudentT.dist(nu=7.0, mu=mu, scale=S)
    x = d.sample(torch.Generator().manual_seed(0), (40_000,)).numpy()
    np.testing.assert_allclose(x.mean(0), mu, atol=0.06)
    np.testing.assert_allclose(np.cov(x.T), S * 7.0 / 5.0, rtol=0.08, atol=0.15)


@pytest.mark.parametrize("form", ["cov", "tau"])
def test_mvnormal_draws_of_the_cov_and_tau_forms(form):
    mu, S, _ = _mvt_inputs(3)
    kw = {"cov": dict(cov=S), "tau": dict(tau=np.linalg.inv(S))}[form]
    x = pmt.MvNormal.dist(mu=mu, **kw).sample(torch.Generator().manual_seed(1), (40_000,))
    np.testing.assert_allclose(x.numpy().mean(0), mu, atol=0.05)
    np.testing.assert_allclose(np.cov(x.numpy().T), S, rtol=0.05, atol=0.1)


def test_chisquared_logp_matches_pymc_tpu_and_scipy():
    v = np.array([-1.0, 0.0, 0.3, 2.0, 9.0])
    got = pmt.ChiSquared.dist(3.0).logp(torch.as_tensor(v)).numpy()
    np.testing.assert_allclose(got, np.asarray(pmj.ChiSquared.dist(3.0).logp(v)), rtol=1e-12)
    np.testing.assert_allclose(got[2:], st.chi2(3.0).logpdf(v[2:]), rtol=1e-12)
    assert np.isneginf(got[0])


def test_kronecker_normal_is_the_dense_normal():
    rng = np.random.default_rng(9)
    K1 = pmt.gp.cov.ExpQuad(1, 0.7)(np.linspace(0, 2, 3)[:, None]).numpy()
    K2 = pmt.gp.cov.Matern52(1, 0.9)(np.linspace(0, 1, 4)[:, None]).numpy()
    x = rng.normal(size=(2, 12))
    got = pmt.KroneckerNormal.dist(mu=0.2, covs=[K1, K2], sigma=0.3).logp(torch.as_tensor(x))
    dense = st.multivariate_normal(np.full(12, 0.2), np.kron(K1, K2) + 0.09 * np.eye(12))
    np.testing.assert_allclose(got.numpy(), dense.logpdf(x), rtol=1e-10)


# -- utilities and the fixture ------------------------------------------------

def test_kmeans_inducing_points_and_replace_with_values_match():
    Xk = np.random.default_rng(3).normal(size=(40, 2))
    got = pmt.gp.util.kmeans_inducing_points(5, Xk, seed=0)
    ref = pmj.gp.util.kmeans_inducing_points(5, Xk, seed=0)
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    with pmt.Model():
        ls = pmt.Gamma("ls", 2, 1)
        K = pmt.gp.cov.ExpQuad(1, ls=ls)(X)
    out = pmt.gp.util.replace_with_values([K], {"ls": 0.7})
    np.testing.assert_allclose(out, pmt.gp.cov.ExpQuad(1, ls=0.7)(X).numpy(), rtol=1e-12)


def test_latent_model_data_is_the_benchmark_data():
    ref = _gp_data(150)
    for pm in (pmj, pmt):
        m = models.gp_latent_model(150, pm=pm)
        np.testing.assert_array_equal(np.asarray(m["y"].observed.value
                                                 if pm is pmt else m["y"].observed), ref[2])
        assert [rv.name for rv in m.free_RVs] == ["ls", "eta", "f_rotated_", "sigma"]
    assert models.GP_LATENT_SAMPLE_KWARGS["chains"] == 64
    assert models.GP_LATENT_SAMPLE_KWARGS["mass_adapt"] == "pooled"


@pytest.mark.parametrize("name", models.GP_SCALARS)
def test_latent_fixture_agrees_with_the_marginal_fixture(name):
    # f integrated out, both models give y ~ N(0, eta^2 K + (sigma^2 + 1e-6) I)
    with open(os.path.join(DATA, "torch_gp_latent_reference.json")) as f:
        latent = json.load(f)["params"][name]
    with open(os.path.join(DATA, "torch_gp_marginal_reference.json")) as f:
        marginal = json.load(f)["params"][name]
    z = (latent["mean"] - marginal["mean"]) / np.hypot(latent["mcse"], marginal["mcse"])
    assert abs(z) < 5.0, z
    assert latent["rhat"] < 1.05


# The latent GP's float32 prior jitter, max(1e-4, F32_PRIOR_JITTER eta^2):
# chip_smoke.py phase 9a holds the card's float32 model to
# models.gp_latent_logp_plain with these tolerances


@pytest.mark.parametrize("jitter, rtol", [(None, 1e-7), (1e-2, 1e-9)])
def test_latent_logp_plain_is_the_model(jitter, rtol):
    # at the float64 default 1e-6 K's condition reaches ~1e8, so the two
    # constructions of K, equal to their last bits, give logps equal to ~1e-9
    m = models.gp_latent_model(150, jitter=jitter)
    q = np.random.default_rng(1).normal(0.0, 0.5, size=(8, 153))
    lp, g = m.logp_dlogp_fn(device="cpu")(torch.as_tensor(q))
    lp_r, g_r = models.gp_latent_logp_plain(q, jitter_min=1e-6 if jitter is None else jitter)
    np.testing.assert_allclose(lp.numpy(), lp_r.numpy(), rtol=rtol)
    np.testing.assert_allclose(g.numpy(), g_r.numpy(), rtol=0,
                               atol=rtol * float(g_r.abs().max()))


def test_float32_prior_jitter_is_relative_to_the_diagonal():
    from pymc_tpu_torch.gp.gp import F32_COND_JITTER, F32_PRIOR_JITTER, _cond_jitter

    K = torch.tensor([[4.0, 1.0], [1.0, 2.0]])
    for scale, j in ((0.01, 1e-4), (100.0, 300.0 * F32_PRIOR_JITTER)):
        out = evaluate_t(pmt.gp.util.stabilize(scale * K))
        torch.testing.assert_close(out, scale * K + j * torch.eye(2), rtol=1e-6, atol=0)
    out = _cond_jitter(100.0 * K, None, 1e-6)
    torch.testing.assert_close(out, 100.0 * K + 300.0 * F32_COND_JITTER * torch.eye(2),
                               rtol=1e-6, atol=0)
    assert F32_PRIOR_JITTER == 1e-4 and F32_COND_JITTER == 3e-4


def test_float32_latent_model_is_the_float64_model_with_its_jitter():
    from pymc_tpu_torch.gp.gp import F32_PRIOR_JITTER

    m = models.gp_latent_model(150)
    q = np.random.default_rng(0).normal(0.0, 0.5, size=(64, 153))
    lp, g = m.logp_dlogp_fn(device="cpu", dtype=torch.float32)(
        torch.as_tensor(q, dtype=torch.float32))
    lp, g = lp.double(), g.double()

    def errs(rel, floor):
        lp_r, g_r = models.gp_latent_logp_plain(q, jitter_rel=rel, jitter_min=floor)
        return (float(((lp - lp_r).abs() / lp_r.abs()).max()),
                float((g - g_r).abs().max() / g_r.abs().max()))

    lp_err, g_err = errs(F32_PRIOR_JITTER, 1e-4)
    assert lp_err < 1e-2 and g_err < 5e-3, (lp_err, g_err)
    # the tolerance tells the rule apart from the JAX package's float32 rule
    # (3e-4), from the earlier one of the port (3e-5), under which float32
    # NUTS did not converge on the card, and from the float64 model
    assert errs(3e-4, 1e-4)[0] > 1e-2 and errs(3e-5, 1e-4)[0] > 1e-2
    assert errs(0.0, 1e-6)[0] > 1e-2


@pytest.mark.parametrize("eta", [0.5, 2.35, 8.0])
def test_float32_cholesky_at_the_prior_jitter(eta):
    from pymc_tpu_torch.gp.gp import F32_PRIOR_JITTER
    from pymc_tpu_torch.ops.linalg import cholesky_plain

    x = torch.as_tensor(_gp_data(150)[1][:, 0])
    ls = torch.as_tensor(np.geomspace(0.05, 50.0, 200))[:, None, None]
    jitter = max(1e-4, F32_PRIOR_JITTER * eta**2)
    A = eta**2 * torch.exp(-0.5 * (x[:, None] - x[None, :]) ** 2 / ls**2)
    A = A + jitter * torch.eye(150, dtype=A.dtype)
    L = cholesky_plain(A.float()).double()
    assert torch.isfinite(L).all()
    back = torch.linalg.matrix_norm(L @ L.mT - A, ord=2) / jitter
    assert float(back.max()) < 0.5, float(back.max())
