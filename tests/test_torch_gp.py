"""The GP path of the port against pymc_tpu on the CPU, in float64.

Covariance functions and their algebra (full and diag), the mean functions,
and the Gamma, HalfNormal and MvNormal log-densities are held against
pymc_tpu at rtol 1e-12 (MvNormal also against scipy). The marginal GP at
n = 30 and the latent GP prior at n = 20 are built in both packages from the
same numpy data: the raveled layout must be equal, and logp+grad at 16
points must match at rtol 1e-10. The latent prior there takes jitter 1e-4
(1e-2 for its MvNormal form, whose gradient is K^-1 f): at the float64
default of 1e-6 its kernel matrix has a condition number near 1e8, and the
two packages' gradients, each exact up to rounding, then differ by ~1e-8
relative through the triangular solves. Sampling the n = 30 marginal GP on
the CPU must give posterior means within 4 combined MCSE of
pymc_tpu.sample.
"""

import numpy as np
import pytest
import scipy.stats as st
import torch

import jax

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from benchmarks.suite import _gp_data
from pymc_tpu.blocking import unravel_vector
from pymc_tpu.sampling.mcmc import _make_postprocess_fn
from pymc_tpu_torch.graph import Node
from pymc_tpu_torch.models import GP_SCALARS, gp_data, gp_marginal_model
from pymc_tpu_torch.stats.convergence import mcse_mean


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


X1 = np.sort(np.random.default_rng(0).uniform(0, 10, 12))[:, None]
XS1 = np.linspace(-1.0, 11.0, 5)[:, None]
X2 = np.random.default_rng(1).normal(size=(9, 2))
XS2 = np.random.default_rng(2).normal(size=(4, 2))

COVS = {
    "expquad": lambda pm: pm.gp.cov.ExpQuad(1, ls=1.7),
    "expquad_ls_inv": lambda pm: pm.gp.cov.ExpQuad(1, ls_inv=0.5),
    "white_noise": lambda pm: pm.gp.cov.WhiteNoise(0.3),
    "scaled": lambda pm: 2.5**2 * pm.gp.cov.ExpQuad(1, ls=0.8),
    "sum": lambda pm: pm.gp.cov.ExpQuad(1, ls=0.8) + pm.gp.cov.ExpQuad(1, ls=3.0),
    "pow": lambda pm: pm.gp.cov.ExpQuad(1, ls=1.2) ** 2,
    "plus_constant": lambda pm: pm.gp.cov.ExpQuad(1, ls=1.2) + pm.gp.cov.Constant(0.7),
    "matrix_factor": lambda pm: pm.gp.cov.ExpQuad(1, ls=1.2) * np.full((12, 12), 0.5),
}


@pytest.mark.parametrize("name", sorted(COVS))
@pytest.mark.parametrize("part", ["full", "diag"])
def test_covariance_matches_pymc_tpu(name, part):
    cj, ct = COVS[name](pmj), COVS[name](pmt)
    ref = cj.diag(X1) if part == "diag" else cj.full(X1)
    got = ct.diag(X1) if part == "diag" else ct.full(X1)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("ls", [1.3, [0.7, 2.0]])
def test_cross_covariance_matches_pymc_tpu(ls):
    ref = pmj.gp.cov.ExpQuad(2, ls=ls).full(X2, XS2)
    got = pmt.gp.cov.ExpQuad(2, ls=ls).full(X2, XS2)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-12, atol=1e-14)
    ref = pmj.gp.cov.ExpQuad(1, ls=ls[0] if isinstance(ls, list) else ls, active_dims=[1])
    got = pmt.gp.cov.ExpQuad(1, ls=ls[0] if isinstance(ls, list) else ls, active_dims=[1])
    np.testing.assert_allclose(_np(got(X2, XS2)), np.asarray(ref(X2, XS2)), rtol=1e-12)
    np.testing.assert_allclose(
        _np(pmt.gp.cov.WhiteNoise(0.2)(X1, XS1)), np.asarray(pmj.gp.cov.WhiteNoise(0.2)(X1, XS1))
    )


def test_covariance_of_a_node_defers_to_the_covariance():
    with pmt.Model():
        eta = pmt.HalfNormal("eta", 2)
        ls = pmt.Gamma("ls", 2, 1)
        base = pmt.gp.cov.ExpQuad(1, ls=ls)
        assert eta.__mul__(base) is NotImplemented
        assert eta.__add__(base) is NotImplemented
        for cov in (eta**2 * base, base * eta, eta + base, base + eta):
            assert isinstance(cov, pmt.gp.cov.Covariance)
            K = cov(X1)
            assert isinstance(K, Node) and K.shape == (12, 12)
        assert isinstance(eta * np.ones(3), Node)
    with pytest.raises(ValueError, match="scalar"):
        base ** np.ones(2)


MEANS = {
    "zero": lambda pm: pm.gp.mean.Zero(),
    "constant": lambda pm: pm.gp.mean.Constant(1.5),
    "linear": lambda pm: pm.gp.mean.Linear(coeffs=np.array([0.5, -2.0]), intercept=0.3),
    "add": lambda pm: pm.gp.mean.Constant(1.5) + pm.gp.mean.Linear(np.array([1.0, 2.0])),
    "prod": lambda pm: pm.gp.mean.Constant(2.0) * pm.gp.mean.Linear(np.array([1.0, 2.0])),
}


@pytest.mark.parametrize("name", sorted(MEANS))
def test_mean_functions_match_pymc_tpu(name):
    ref = MEANS[name](pmj)(X2)
    got = MEANS[name](pmt)(X2)
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-12)


VALUES = np.array([-1.0, 0.0, 1e-3, 0.4, 1.0, 2.5, 9.0])
DISTS = {
    "gamma": lambda pm: pm.Gamma.dist(2.0, 1.0),
    "gamma_alpha_below_one": lambda pm: pm.Gamma.dist(0.5, 3.0),
    "gamma_mu_sigma": lambda pm: pm.Gamma.dist(mu=2.0, sigma=0.7),
    "halfnormal": lambda pm: pm.HalfNormal.dist(2.0),
    "halfnormal_tau": lambda pm: pm.HalfNormal.dist(tau=4.0),
}


@pytest.mark.parametrize("name", sorted(DISTS))
def test_univariate_logp_matches_pymc_tpu(name):
    ref = np.asarray(DISTS[name](pmj).logp(VALUES))
    got = DISTS[name](pmt).logp(torch.as_tensor(VALUES)).numpy()
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    assert DISTS[name](pmt).default_transform().name == "log"


def _mvn_inputs(d=5, seed=3):
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(d, d))
    cov = B @ B.T + d * np.eye(d)
    return rng.normal(size=d), cov, rng.normal(size=(4, d))


@pytest.mark.parametrize("form", ["cov", "tau", "chol"])
def test_mvnormal_logp_matches_pymc_tpu_and_scipy(form):
    mu, cov, x = _mvn_inputs()
    kw = {
        "cov": dict(cov=cov),
        "tau": dict(tau=np.linalg.inv(cov)),
        "chol": dict(chol=np.linalg.cholesky(cov)),
    }[form]
    dt = pmt.MvNormal.dist(mu=mu, **kw)
    assert dt.shape == (5,) and dt.batch_shape == () and dt.event_shape == (5,)
    got = dt.logp(torch.as_tensor(x)).numpy()
    ref = np.asarray(pmj.MvNormal.dist(mu=mu, **kw).logp(x))
    np.testing.assert_allclose(got, ref, rtol=1e-12)
    np.testing.assert_allclose(got, st.multivariate_normal(mu, cov).logpdf(x), rtol=1e-10)


def test_mvnormal_batch_shape_and_bad_covariance():
    mu, cov, x = _mvn_inputs()
    d = pmt.MvNormal.dist(mu=np.zeros((3, 5)), cov=cov)
    assert d.shape == (3, 5) and d.batch_shape == (3,)
    assert pmt.MvNormal.dist(mu=0.0, cov=cov, shape=(2, 5)).batch_shape == (2,)
    with pytest.raises(ValueError, match="event shape"):
        pmt.MvNormal.dist(mu=0.0, cov=cov, shape=(5, 2))
    bad = pmt.MvNormal.dist(mu=mu, cov=-cov)
    assert torch.isneginf(bad.logp(torch.as_tensor(x))).all()


def gp_latent_model(pm, n=20, reparameterize=True, jitter=1e-4):
    _, X, y = gp_data(n)
    with pm.Model() as m:
        ls = pm.Gamma("ls", 2, 1)
        eta = pm.HalfNormal("eta", 2)
        gp = pm.gp.Latent(cov_func=eta**2 * pm.gp.cov.ExpQuad(1, ls=ls))
        f = gp.prior("f", X=X, reparameterize=reparameterize, jitter=jitter)
        sigma = pm.HalfNormal("sigma", 1)
        pm.Normal("y", f, sigma, observed=y)
    return m


MODELS = {
    "marginal_30": lambda pm: gp_marginal_model(30, pm),
    "latent_20": lambda pm: gp_latent_model(pm),
    "latent_20_mvnormal": lambda pm: gp_latent_model(pm, reparameterize=False, jitter=1e-2),
}


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
    q = np.random.default_rng(0).normal(0.0, 0.7, size=(16, info.total_size))
    lf = mj.logp_fn()
    lj, gj = jax.vmap(jax.value_and_grad(lambda x: lf(unravel_vector(x, info))))(q)
    lt, gt = mt.logp_dlogp_fn(device="cpu")(torch.as_tensor(q))
    assert np.isfinite(lt.numpy()).all()
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-10)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-10, atol=1e-10)


def test_deterministics_from_flat_draws_match(pair):
    mj, mt = pair
    info = mj.raveled_info()
    q = np.random.default_rng(1).normal(0.0, 0.7, size=(5, info.total_size))
    ref = jax.vmap(_make_postprocess_fn(mj, info))(q)
    got = mt.postprocess_fn(device="cpu")(torch.as_tensor(q))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-10, atol=1e-12)


def test_model_data_is_the_benchmark_data():
    for n in (30, 150):
        ref, got = _gp_data(n), gp_data(n)
        assert got[0] == ref[0] == n
        np.testing.assert_array_equal(got[1], ref[1])
        np.testing.assert_array_equal(got[2], ref[2])


def test_pairwise_distances_are_hoisted_out_of_the_logp():
    # the isotropic hoist: the unscaled (n, n) distances are a constant of
    # the model, so the logp only scales them
    mt = gp_marginal_model(30)
    shapes = [tuple(c.value.shape) for c in mt.constants()]
    assert (30, 30) in shapes


SAMPLE = dict(draws=100, tune=100, chains=4, random_seed=1, compute_convergence_checks=False)


@pytest.fixture(scope="module")
def sampled():
    idata_j = pmj.sample(model=gp_marginal_model(30, pmj), progressbar=False, **SAMPLE)
    idata_t = pmt.sample(model=gp_marginal_model(30), device="cpu", **SAMPLE)
    return idata_j, idata_t


@pytest.mark.parametrize("name", GP_SCALARS)
def test_sampled_posterior_means_agree(sampled, name):
    idata_j, idata_t = sampled
    xj = idata_j.posterior[name].values
    xt = idata_t.posterior[name].values
    assert xt.shape == xj.shape == (4, 100) and np.isfinite(xt).all()
    z = abs(xt.mean() - xj.mean()) / np.hypot(mcse_mean(xj), mcse_mean(xt))
    assert z < 4.0, z


def test_sampler_counts_every_logp_grad_call(sampled):
    attrs = sampled[1].posterior.attrs
    # the starting points' candidates and the starting points themselves
    assert attrs["n_logp_grad"] == attrs["n_leapfrog"] + 2
