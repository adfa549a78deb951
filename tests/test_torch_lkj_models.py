"""The slice as a whole, float64 on the CPU: PyMC's correlated-effects
radon model (`models.radon_lkj_model`: LKJCholeskyCov, `(chol @ z).T`, the
tuple gather `ab[county, 0]`) and an LKJCorr prior, built by
`pymc_tpu_torch.models` in both packages from the same data.

- radon_lkj_model: the layout (value names, transforms, 176 values) and
  the support point as pymc_tpu's (rtol 1e-12); logp and gradient at 16
  points drawn as pymc_tpu's point dicts and carried across with
  `convert.point_from_numpy`, equal to pymc_tpu's to rtol 1e-9 (the
  gradient with atol 1e-9 of its largest entry); and the deterministics
  chol_chol, chol_corr, chol_stds and ab of those points as pymc_tpu's
  (rtol 1e-9).
- NUTS on `lkj_corr_prior_model(n=4, eta=2)` in the port, 4 chains, trees
  cut at depth 4, 40 tuning and 80 kept draws (about 8 s): each of
  the 6 correlations has mean 0 and variance 1 / (2 eta + n - 1) = 1/7
  within 5 MCSE (the variance's MCSE from the squared draws' MCSE of the
  mean); every draw a positive-definite correlation matrix.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from pymc_tpu.initial_point import make_initial_point
from pymc_tpu_torch.convert import point_from_numpy
from pymc_tpu_torch.initial_point import support_point_values
from pymc_tpu_torch.models import lkj_corr_prior_model, radon_lkj_model
from pymc_tpu_torch.stats.convergence import mcse_mean


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def radon():
    return radon_lkj_model(pmj), radon_lkj_model(pmt)


def test_radon_lkj_layout_and_support_point(radon):
    mj, mt = radon
    ij, it = mj.raveled_info(), mt.raveled_info()
    assert list(it.names) == list(ij.names) == [
        "chol_cholesky-cov-packed__", "mu_ab", "z", "sigma_log__"]
    assert it.shapes == ij.shapes and it.total_size == 176
    assert [d.name for d in mt.deterministics] == [d.name for d in mj.deterministics] == [
        "chol_chol", "chol_corr", "chol_stds", "ab"]
    ref = make_initial_point(mj, jax.random.PRNGKey(0), jitter=0.0)
    got = support_point_values(mt)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-12)


def test_radon_lkj_logp_grad_and_deterministics(radon):
    mj, mt = radon
    rng = np.random.default_rng(11)
    info = mj.raveled_info()
    points = [{name: rng.normal(0.0, 0.6, size=shape) for name, shape in
               zip(info.names, info.shapes)} for _ in range(16)]
    logp_j = jax.jit(jax.value_and_grad(mj.logp_fn()))
    logp_t = mt.logp_fn(device="cpu")
    post_j = jax.jit(lambda p: {d.name: pmj.graph.evaluate(d, mj.constrain(p))
                                for d in mj.deterministics})
    for point in points:
        ref, ref_grad = logp_j({k: jnp.asarray(v) for k, v in point.items()})
        pt = {k: v.requires_grad_(True) for k, v in point_from_numpy(point).items()}
        lp = logp_t(pt)
        grads = torch.autograd.grad(lp, list(pt.values()))
        np.testing.assert_allclose(float(lp.detach()), float(ref), rtol=1e-9)
        scale = max(float(jnp.max(jnp.abs(g))) for g in ref_grad.values())
        for g, name in zip(grads, pt):
            np.testing.assert_allclose(g.numpy(), np.asarray(ref_grad[name]), rtol=1e-9,
                                       atol=1e-9 * scale)
        env = mt.constrain(point_from_numpy(point), mt.placed_constants("cpu", torch.float64))
        dets = post_j({k: jnp.asarray(v) for k, v in point.items()})
        for d in mt.deterministics:
            got = pmt.graph.evaluate(d, env, mt.placed_constants("cpu", torch.float64))
            np.testing.assert_allclose(got.detach().numpy(), np.asarray(dets[d.name]),
                                       rtol=1e-9, atol=1e-12)


def test_nuts_on_lkj_corr_prior_has_the_exact_moments():
    n, eta = 4, 2.0
    idata = pmt.sample(model=lkj_corr_prior_model(n=n, eta=eta), chains=4, tune=40, draws=80,
                       random_seed=3, device="cpu", compute_convergence_checks=False,
                       nuts={"max_treedepth": 4})
    x = idata.posterior["corr"].values
    assert x.shape == (4, 80, 6) and np.isfinite(x).all()
    C = np.zeros(x.shape[:-1] + (n, n))
    r, c = np.tril_indices(n, -1)
    C[..., r, c] = x
    C = C + np.swapaxes(C, -1, -2) + np.eye(n)
    assert (np.linalg.eigvalsh(C) > 0).all()
    var = 1.0 / (2 * eta + n - 1)
    for k in range(x.shape[-1]):
        z_mean = x[..., k].mean() / mcse_mean(x[..., k])
        z_var = ((x[..., k] ** 2).mean() - var) / mcse_mean(x[..., k] ** 2)
        assert abs(z_mean) < 5 and abs(z_var) < 5, (k, z_mean, z_var)
