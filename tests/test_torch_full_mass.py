"""The full mass and the exp-weighted diagonal of pymc_tpu_torch against
pymc_tpu, fed the same draws.

A full mass runs NUTS and ChEES in the whitened coordinates x = L^-1 q
with a unit mass (`sampling/full_mass.py`), which reorders the arithmetic
of the JAX package's route (p = L^-T xi, velocity Sigma p): one transition
is held to `nuts_transition_batched` with a (D, D) Sigma, and one
`chees_step` to the JAX package's with full_mass, at rtol 1e-8 in float64,
on a correlated Gaussian and (NUTS) on the radon GLM. The Welford full state,
its covariance and every `expw_*` function are held at rtol 1e-12, and
the step-size search with a full mass at rtol 1e-10.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pymc_tpu.sampling import adaptation as ad_j
from pymc_tpu.sampling import chees as chees_j
from pymc_tpu.sampling.nuts import nuts_transition_batched
from pymc_tpu_torch.sampling import adaptation as ad_t
from pymc_tpu_torch.sampling import chees as chees_t
from pymc_tpu_torch.sampling.full_mass import DenseMass
from pymc_tpu_torch.sampling.nuts import nuts_transition
from test_torch_nuts import JaxKeyDraws, _gaussian_target, _radon_target

C = 8


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _sigma(D, seed):
    """A well-conditioned random SPD (D, D)."""
    A = np.random.default_rng(seed).normal(size=(D, D))
    return A @ A.T / D + 0.5 * np.eye(D)


def _t(x):
    return torch.as_tensor(np.array(x))


@pytest.mark.parametrize("target, step, seed, scale", [
    ("gaussian", 0.4, 0, 1.0), ("gaussian", 1.3, 1, 1.0), ("radon", 0.05, 2, 0.02),
])
def test_full_mass_nuts_transition_matches_jax(target, step, seed, scale):
    D, logp_grad_j, logp_grad_t = _gaussian_target() if target == "gaussian" else _radon_target()
    rng = np.random.default_rng(seed)
    q0 = rng.normal(0.0, 0.5, size=(C, D))
    sigma = _sigma(D, seed) * scale
    keys = jax.random.split(jax.random.PRNGKey(seed), C)
    step_size = np.full((C,), step)
    logp0, grad0 = jax.vmap(logp_grad_j)(jnp.asarray(q0))
    (qj, lj, gj), sj = nuts_transition_batched(
        logp_grad_j, keys, jnp.asarray(q0), logp0, grad0, jnp.asarray(step_size),
        jnp.asarray(sigma), max_treedepth=6, full_mass=True,
    )
    (qt, lt, gt), st = nuts_transition(
        logp_grad_t, JaxKeyDraws(keys, D), _t(q0), _t(logp0), _t(grad0), _t(step_size),
        DenseMass(_t(sigma)), max_treedepth=6,
    )
    np.testing.assert_array_equal(st.depth.numpy(), np.asarray(sj.depth))
    np.testing.assert_array_equal(st.n_steps.numpy(), np.asarray(sj.n_steps))
    np.testing.assert_array_equal(st.diverging.numpy(), np.asarray(sj.diverging))
    assert int(st.n_steps.sum()) > C
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=1e-8, atol=1e-10)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-8)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-8, atol=1e-8)
    for f in ("energy", "acceptance_rate", "lp", "max_energy_error", "energy_error"):
        np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(sj, f)),
                                   rtol=1e-8, atol=1e-9)


@pytest.mark.parametrize("target, adapt_T, seed", [("gaussian", True, 0), ("gaussian", False, 1)])
def test_full_mass_chees_step_matches_jax(target, adapt_T, seed):
    D, logp_grad_j, logp_grad_t = _gaussian_target() if target == "gaussian" else _radon_target()
    rng = np.random.default_rng(seed)
    q0 = rng.normal(0.0, 0.5, size=(C, D))
    sigma = _sigma(D, seed) * (1.0 if target == "gaussian" else 0.02)
    eps = rng.uniform(0.1, 0.3, size=C) * (1.0 if target == "gaussian" else 0.2)
    logp0, grad0 = jax.vmap(logp_grad_j)(jnp.asarray(q0))
    key = jax.random.PRNGKey(seed)
    sj = chees_j.chees_init(jnp.asarray(q0), logp0, grad0, initial_T=1.0)
    out_j, ch_j = chees_j.chees_step(
        logp_grad_j, key, sj, jnp.asarray(eps), jnp.asarray(sigma), 0.7, adapt_T=adapt_T,
        max_leapfrogs=64, full_mass=True,
    )
    # chees.py:83 split, :97 normals, :147 uniforms
    k_mom, k_acc = jax.random.split(key)
    xi = _t(jax.random.normal(k_mom, (C, D), dtype=jnp.float64))
    u = _t(jax.random.uniform(k_acc, (C,), dtype=jnp.float64))
    st = chees_t.chees_init(_t(q0), _t(logp0), _t(grad0), initial_T=1.0)
    out_t, ch_t = chees_t.chees_step(
        logp_grad_t, st, _t(eps), DenseMass(_t(sigma)), torch.tensor(0.7, dtype=torch.float64),
        xi, u, adapt_T=adapt_T, max_leapfrogs=64, host_read=chees_t.HostReads(),
    )
    assert int(ch_t["n_steps"][0]) == int(ch_j["n_steps"][0]) > 1
    for f in chees_j.CheesState._fields:
        np.testing.assert_allclose(getattr(out_t, f).numpy(), np.asarray(getattr(out_j, f)),
                                   rtol=1e-8, atol=1e-9, err_msg=f)
    for f in ("acceptance_rate", "accepted", "lp", "energy", "trajectory_length", "diverging"):
        np.testing.assert_allclose(np.asarray(ch_t[f].numpy(), dtype=np.float64),
                                   np.asarray(ch_j[f], dtype=np.float64), rtol=1e-8, atol=1e-9,
                                   err_msg=f)


def test_full_mass_step_size_search_matches_jax():
    D, logp_grad_j, logp_grad_t = _gaussian_target()
    rng = np.random.default_rng(3)
    q0 = rng.normal(size=(C, D))
    sigma = _sigma(D, 3)
    logp0, grad0 = jax.vmap(logp_grad_j)(jnp.asarray(q0))
    keys = jax.random.split(jax.random.PRNGKey(3), C)
    eps_j = jax.vmap(lambda q, lp, g, k: ad_j.find_reasonable_step_size(
        logp_grad_j, q, lp, g, k, jnp.asarray(sigma)))(jnp.asarray(q0), logp0, grad0, keys)
    xi = _t(jax.vmap(lambda k: jax.random.normal(k, (D,), dtype=jnp.float64))(keys))
    eps_t = ad_t.find_reasonable_step_size(logp_grad_t, _t(q0), _t(logp0), _t(grad0), xi,
                                           DenseMass(_t(sigma)))
    np.testing.assert_allclose(eps_t.numpy(), np.asarray(eps_j), rtol=1e-10)


def test_welford_full_matches_jax():
    rng = np.random.default_rng(4)
    D = 6
    sj = ad_j.welford_init(D, full=True, dtype=jnp.float64)
    st = ad_t.welford_init(C, D, full=True)
    for k in range(5):
        X = rng.normal(size=(C, D)) @ rng.normal(size=(D, D)) + k
        sj = ad_j.welford_update_batch(sj, jnp.asarray(X))
        st = ad_t.welford_update_batch(st, _t(X))
        for f in ad_j.WelfordState._fields:
            np.testing.assert_allclose(getattr(st, f).numpy(), np.asarray(getattr(sj, f)),
                                       rtol=1e-12)
    for regularize in (True, False):
        np.testing.assert_allclose(ad_t.welford_covariance(st, regularize).numpy(),
                                   np.asarray(ad_j.welford_covariance(sj, regularize)),
                                   rtol=1e-12)
    assert ad_t.welford_init(C, D).mean.shape == (C, D)


def test_expw_matches_jax():
    rng = np.random.default_rng(5)
    shape = (C, 7)
    ej, et = ad_j.expw_init(shape, dtype=jnp.float64), ad_t.expw_init(shape)
    q, g = rng.normal(size=shape), rng.normal(size=shape)
    ej, et = ad_j.expw_seed(jnp.asarray(q), jnp.asarray(g)), ad_t.expw_seed(_t(q), _t(g))
    for k in range(10):
        q, g = rng.normal(size=shape) * 2.0, rng.normal(size=shape) + k
        ej = ad_j.expw_update(ej, jnp.asarray(q), jnp.asarray(g))
        et = ad_t.expw_update(et, _t(q), _t(g))
    for f in ad_j.ExpWeightedState._fields:
        np.testing.assert_allclose(getattr(et, f).numpy(), np.asarray(getattr(ej, f)),
                                   rtol=1e-12)
    np.testing.assert_allclose(ad_t.expw_inv_mass(et).numpy(),
                               np.asarray(ad_j.expw_inv_mass(ej)), rtol=1e-12)
    zero = ad_t.expw_init(shape)
    np.testing.assert_array_equal(ad_t.expw_inv_mass(zero).numpy(),
                                  np.asarray(ad_j.expw_inv_mass(ad_j.expw_init(shape))))


def test_dense_mass_maps_are_inverse():
    sigma = _t(_sigma(5, 6))
    m = DenseMass(sigma)
    q = torch.randn(3, 5, dtype=torch.float64)
    torch.testing.assert_close(m.to_q(m.to_x(q)), q, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(m.L @ m.L.T, sigma, rtol=1e-12, atol=1e-12)
    # kinetic energy: p_x . p_x = p^T Sigma p with p = L^-T p_x
    p_x = torch.randn(3, 5, dtype=torch.float64)
    p = m.to_q_momentum(p_x)
    torch.testing.assert_close((p_x * p_x).sum(-1), ((p @ sigma) * p).sum(-1), rtol=1e-12,
                               atol=1e-12)
