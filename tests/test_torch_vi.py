"""Variational inference of pymc_tpu_torch against pymc_tpu, fed the same
draws, in float64 on the CPU: the families, the objectives and the
operators (`fit` and the approximations' views are in test_torch_vi_fit.py).

The port takes its randomness as an input: an approximation's
`sample_q(params, noise)` maps the noise `noise(params, n, generator)`
draws, and `fit` takes a draw source. `JaxVIDraws` replays the JAX
package's key stream (inference.py:206-210 `fold_in(key, done)` and
`split(m)`, :153-156 `split(k)` into `(k_q, k_mb)`, then the family's own
draw from `k_q`), so both packages take the same steps. Tolerances:
sample_q, entropy and logq of every family, the KL objective, its
gradient, rbf, Stein's phi and KSD at rtol 1e-10.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from pymc_tpu.variational import approximations as ap_j
from pymc_tpu.variational import operators as op_j
from pymc_tpu_torch.variational import approximations as ap_t
from pymc_tpu_torch.variational import operators as op_t

COV = np.array([[1.0, 0.8, 0.3], [0.8, 2.0, -0.5], [0.3, -0.5, 0.7]])
MU = np.array([1.0, -2.0, 0.5])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def eight_schools(pm):
    y = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
    sigma = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])
    with pm.Model(coords={"school": np.arange(8)}) as m:
        mu = pm.Normal("mu", 0, 5)
        tau = pm.HalfCauchy("tau", 5)
        theta_t = pm.Normal("theta_t", 0, 1, dims="school")
        pm.Deterministic("theta", mu + tau * theta_t, dims="school")
        pm.Normal("obs", mu + tau * theta_t, sigma, observed=y, dims="school")
    return m


def gaussian(pm):
    with pm.Model() as m:
        pm.MvNormal("x", mu=MU, cov=COV)
    return m


MODELS = {"eight_schools": eight_schools, "gaussian": gaussian}


def _t(x):
    return torch.as_tensor(np.array(x))


def _normal(key, shape):
    return jax.random.normal(key, shape, dtype=jnp.float64)


def jax_noise(approx_cls, params, key, n):
    """The JAX package's draws behind `approx_cls.sample_q(params, key, n)`,
    as the port's noise."""
    if issubclass(approx_cls, ap_t.Empirical):
        P = params["particles"].shape[0]
        return _t(jax.random.randint(key, (n,), 0, P))
    if issubclass(approx_cls, ap_t.Blocked):
        eps = np.zeros((n, approx_cls._D))
        for j, idx in enumerate(approx_cls._indices):
            eps[:, idx] = np.asarray(_normal(jax.random.fold_in(key, j), (n, len(idx))))
        return torch.as_tensor(eps)
    return _t(_normal(key, (n, params["mu"].shape[0])))


class JaxVIDraws:
    """The noise of each step of `pymc_tpu`'s `Inference.fit(n, chunk)`."""

    def __init__(self, seed, n, chunk=100):
        self.key, self.n, self.chunk = jax.random.PRNGKey(seed), n, chunk

    def __call__(self, step, approx_cls, params, n_mc):
        done = step // self.chunk * self.chunk
        ks = jax.random.split(jax.random.fold_in(self.key, done), min(self.chunk, self.n - done))
        k_q, _ = jax.random.split(ks[step - done])
        return jax_noise(approx_cls, params, k_q, n_mc)


def _params(D, seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "mean_field":
        return {"mu": rng.normal(size=D), "rho": rng.normal(-1.0, 0.5, size=D)}
    if kind == "full_rank":
        return {"mu": rng.normal(size=D), "L_packed": rng.normal(0.0, 0.4, size=D * (D + 1) // 2)}
    return {"particles": rng.normal(size=(7, D))}


def _as(params, lib):
    conv = (lambda v: jnp.asarray(v)) if lib == "jax" else (lambda v: torch.as_tensor(v))
    return {k: _as(v, lib) if isinstance(v, dict) else conv(v) for k, v in params.items()}


FAMILIES = [("mean_field", ap_j.MeanField, ap_t.MeanField),
            ("full_rank", ap_j.FullRank, ap_t.FullRank),
            ("empirical", ap_j.Empirical, ap_t.Empirical)]


@pytest.mark.parametrize("kind, cls_j, cls_t", FAMILIES, ids=[f[0] for f in FAMILIES])
def test_family_sample_q_entropy_logq_match(kind, cls_j, cls_t):
    D, n = 6, 9
    p = _params(D, 0, kind)
    pj, pt = _as(p, "jax"), _as(p, "torch")
    key = jax.random.PRNGKey(1)
    zj = cls_j.sample_q(pj, key, n)
    zt = cls_t.sample_q(pt, jax_noise(cls_t, pt, key, n))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-10)
    np.testing.assert_allclose(float(cls_t.entropy(pt)), float(cls_j.entropy(pj)), rtol=1e-10)
    if kind == "empirical":
        with pytest.raises(NotImplementedError):
            cls_t.logq(pt, zt)
        return
    z = np.random.default_rng(2).normal(size=(n, D))
    np.testing.assert_allclose(cls_t.logq(pt, torch.as_tensor(z)).numpy(),
                               np.asarray(cls_j.logq(pj, jnp.asarray(z))), rtol=1e-10)


def _blocked(pm, model):
    with model:
        return pm.Approximation([pm.Group([model["mu"]], vfam="full_rank"), pm.Group(None)],
                                **({} if pm is pmj else {"device": "cpu"}))


def test_blocked_sample_q_entropy_logq_match():
    aj, at = _blocked(pmj, eight_schools(pmj)), _blocked(pmt, eight_schools(pmt))
    assert type(at).__name__ == "Blocked" and at._D == aj._D == 10
    rng = np.random.default_rng(3)
    # move the parameters off their start so every term counts
    pj = jax.tree.map(lambda v: v + jnp.asarray(rng.normal(0, 0.3, size=v.shape)), aj.params)
    pt = {g: {k: _t(v) for k, v in d.items()} for g, d in pj.items()}
    key = jax.random.PRNGKey(4)
    zj = type(aj).sample_q(pj, key, 5)
    zt = type(at).sample_q(pt, jax_noise(type(at), pt, key, 5))
    np.testing.assert_allclose(zt.numpy(), np.asarray(zj), rtol=1e-10)
    np.testing.assert_allclose(float(type(at).entropy(pt)), float(type(aj).entropy(pj)),
                               rtol=1e-10)
    np.testing.assert_allclose(type(at).logq(pt, zt).numpy(),
                               np.asarray(type(aj).logq(pj, zj)), rtol=1e-10)


@pytest.mark.parametrize("cls", ["ADVI", "FullRankADVI"])
def test_kl_objective_and_gradient_match(cls):
    mj, mt = eight_schools(pmj), eight_schools(pmt)
    ij = getattr(pmj, cls)(model=mj, random_seed=0, obj_n_mc=4)
    it = getattr(pmt, cls)(model=mt, random_seed=0, obj_n_mc=4, device="cpu")
    kind = "mean_field" if cls == "ADVI" else "full_rank"
    p = _params(10, 5, kind)
    pj, pt = _as(p, "jax"), _as(p, "torch")
    key = jax.random.PRNGKey(6)
    loss_j, g_j = jax.value_and_grad(ij.objective)(pj, key)
    k_q, _ = jax.random.split(key)
    loss_t, g_t = it.loss_and_grad(pt, jax_noise(it.approx_cls, pt, k_q, 4))
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-10)
    for k in p:
        np.testing.assert_allclose(g_t[k].numpy(), np.asarray(g_j[k]), rtol=1e-10, atol=1e-12)
    # the KL operator: E_q[log q - log p] at the same points
    kl_j = op_j.KL(ij._wrap(pj, [])).apply_value(pj, key, 4)
    kl_t = op_t.KL(it._wrap(pt, [])).apply_value(pt, jax_noise(it.approx_cls, pt, key, 4))
    np.testing.assert_allclose(float(kl_t), float(kl_j), rtol=1e-10)
    assert pmt.variational.ObjectiveFunction(op_t.KL(it._wrap(pt, [])))(
        pt, jax_noise(it.approx_cls, pt, key, 4)) == kl_t


@pytest.mark.parametrize("P", [6, 5])
def test_rbf_stein_ksd_match(P):
    """An even particle count makes the median the mean of two values."""
    rng = np.random.default_rng(P)
    X = rng.normal(size=(P, 3))
    Kj, rj = op_j.rbf()(jnp.asarray(X))
    Kt, rt = op_t.rbf()(torch.as_tensor(X))
    np.testing.assert_allclose(Kt.numpy(), np.asarray(Kj), rtol=1e-10)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-10, atol=1e-14)
    sq = ((X[:, None] - X[None]) ** 2).sum(-1)
    assert float(op_t._median(torch.as_tensor(sq))) == pytest.approx(float(np.median(sq)),
                                                                     rel=1e-14)
    Pj, Pt = jnp.asarray(np.linalg.inv(COV)), torch.as_tensor(np.linalg.inv(COV))
    phi_j = op_j.Stein(lambda q: -(Pj @ (q - MU))).phi(jnp.asarray(X))
    phi_t = op_t.Stein(lambda q: -(q - torch.as_tensor(MU)) @ Pt).phi(torch.as_tensor(X))
    np.testing.assert_allclose(phi_t.numpy(), np.asarray(phi_j), rtol=1e-10, atol=1e-14)
    mj, mt = gaussian(pmj), gaussian(pmt)
    ksd_j = op_j.KSD(ap_j.Empirical(mj, mj.raveled_info(), {"particles": jnp.asarray(X)}))
    at = ap_t.Empirical(mt, mt.raveled_info(), {"particles": torch.as_tensor(X)})
    ksd_t = op_t.KSD(at)
    np.testing.assert_allclose(float(ksd_t.apply_value({"particles": torch.as_tensor(X)})),
                               float(ksd_j.apply_value({"particles": jnp.asarray(X)}, None)),
                               rtol=1e-10)
