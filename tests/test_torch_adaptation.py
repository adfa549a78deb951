"""Warmup adaptation of pymc_tpu_torch against pymc_tpu on the same inputs.

The JAX functions are per chain and vmapped; the port's carry the chain
axis. States cross from numpy through pymc_tpu_torch.convert. Tolerance:
rtol 1e-12 in float64; the schedule is compared exactly.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from bench import build_model
import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from pymc_tpu.blocking import unravel_vector
from pymc_tpu.sampling import adaptation as aj
from pymc_tpu_torch.convert import sampler_state_from_numpy
from pymc_tpu_torch.sampling import adaptation as at
from pymc_tpu_torch.sampling.nuts import SamplerState

C, D = 6, 4


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(state):
    return type(state)(*[np.array(v) for v in state])


def _assert_state_close(got, ref):
    assert type(got)._fields == type(ref)._fields
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-12, atol=1e-300)


def test_dual_averaging_sequence_matches():
    rng = np.random.default_rng(0)
    eps0 = rng.uniform(0.01, 1.0, size=C)
    dj = jax.vmap(aj.da_init)(jnp.asarray(eps0))
    dt = at.da_init(torch.as_tensor(eps0))
    _assert_state_close(dt, dj)
    for i in range(12):
        acc = rng.uniform(0.0, 1.0, size=C)
        dj = jax.vmap(lambda d, a: aj.da_update(d, a, 0.9))(dj, jnp.asarray(acc))
        dt = at.da_update(dt, torch.as_tensor(acc), 0.9)
        if i == 6:
            dj = jax.vmap(aj.da_restart)(dj)
            dt = at.da_restart(dt)
        _assert_state_close(dt, dj)


def test_da_state_crosses_from_numpy():
    eps0 = np.array([0.3, 0.05])
    dj = _np(jax.vmap(aj.da_update, in_axes=(0, 0, None))(
        jax.vmap(aj.da_init)(jnp.asarray(eps0)), jnp.asarray([0.7, 0.99]), 0.8
    ))
    dt = at.da_update(sampler_state_from_numpy(dj), torch.tensor([0.5, 0.1], dtype=torch.float64), 0.8)
    ref = jax.vmap(aj.da_update, in_axes=(0, 0, None))(dj, jnp.asarray([0.5, 0.1]), 0.8)
    _assert_state_close(dt, ref)


def test_welford_matches():
    rng = np.random.default_rng(1)
    wj = jax.vmap(lambda _: aj.welford_init(D, dtype=jnp.float64))(jnp.arange(C))
    wt = at.welford_init(C, D)
    for _ in range(9):
        x = rng.normal(size=(C, D)) * rng.uniform(0.1, 3.0, size=D)
        wj = jax.vmap(aj.welford_update)(wj, jnp.asarray(x))
        wt = at.welford_update(wt, torch.as_tensor(x))
    _assert_state_close(wt, wj)
    np.testing.assert_allclose(
        at.welford_variance(wt).numpy(), np.asarray(jax.vmap(aj.welford_variance)(wj)),
        rtol=1e-12,
    )
    # a state handed over from numpy continues identically
    x = rng.normal(size=(C, D))
    _assert_state_close(
        at.welford_update(sampler_state_from_numpy(_np(wj)), torch.as_tensor(x)),
        jax.vmap(aj.welford_update)(wj, jnp.asarray(x)),
    )


def test_welford_variance_floor_with_few_draws():
    wt = at.welford_update(at.welford_init(2, 3), torch.ones(2, 3, dtype=torch.float64))
    wj = jax.vmap(aj.welford_update)(
        jax.vmap(lambda _: aj.welford_init(3, dtype=jnp.float64))(jnp.arange(2)),
        jnp.ones((2, 3)),
    )
    np.testing.assert_allclose(
        at.welford_variance(wt).numpy(), np.asarray(jax.vmap(aj.welford_variance)(wj)),
        rtol=1e-12,
    )


@pytest.mark.parametrize("tune", [0, 1, 50, 149, 150, 300, 1000, 2000])
def test_build_schedule_matches(tune):
    ref, got = aj.build_schedule(tune), at.build_schedule(tune)
    for k in ("update_mass", "switch_mass"):
        np.testing.assert_array_equal(got[k], ref[k])


@pytest.fixture(scope="module")
def radon_step_size():
    """(jitted per-chain JAX step-size search, its logp_grad, the port's
    batched logp_grad, D), built once for the module."""
    mj, mt = build_model(pmj), build_model(pmt)
    info = mj.raveled_info()
    lf = mj.logp_fn()
    logp_grad_j = jax.value_and_grad(lambda x: lf(unravel_vector(x, info)))
    search = jax.jit(jax.vmap(
        lambda q, l, g, k, m: aj.find_reasonable_step_size(logp_grad_j, q, l, g, k, m)
    ))
    return search, logp_grad_j, mt.logp_dlogp_fn(), info.total_size


@pytest.mark.parametrize("initial_scale", [0.3, 1.0, 30.0])
def test_find_reasonable_step_size_matches(radon_step_size, initial_scale):
    search, logp_grad_j, logp_grad_t, Dr = radon_step_size
    Cr = 4
    rng = np.random.default_rng(2)
    q = rng.normal(0.0, 0.5, size=(Cr, Dr))
    inv_mass = rng.uniform(0.5, 1.5, size=(Cr, Dr)) * initial_scale**2
    keys = jax.random.split(jax.random.PRNGKey(5), Cr)
    logp, grad = jax.vmap(logp_grad_j)(q)
    ref = search(q, logp, grad, keys, inv_mass)
    # the JAX function draws its momentum from the key; the port takes it
    xi = jax.vmap(lambda k: jax.random.normal(k, (Dr,), jnp.float64))(keys)
    state = sampler_state_from_numpy(
        SamplerState(q, np.array(logp), np.array(grad), inv_mass, np.ones(Cr))
    )
    got = at.find_reasonable_step_size(
        logp_grad_t, state.q, state.logp, state.grad,
        torch.as_tensor(np.array(xi)), state.inv_mass,
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-12)


def test_sampler_state_from_numpy_rejects_unknown_fields():
    from collections import namedtuple

    Other = namedtuple("Other", "a b")
    with pytest.raises(TypeError, match="no port state"):
        sampler_state_from_numpy(Other(np.zeros(1), np.zeros(1)))


def test_sampler_state_from_numpy_places_dtype():
    cd, c = np.zeros((2, 3)), np.zeros(2)
    st = sampler_state_from_numpy(SamplerState(cd, c, cd, cd + 1.0, c + 0.1), dtype=torch.float32)
    assert isinstance(st, SamplerState)
    assert all(v.dtype == torch.float32 for v in st)
