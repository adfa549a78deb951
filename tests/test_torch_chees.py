"""One ChEES draw of pymc_tpu_torch against pymc_tpu's `chees_step`, fed the
same random draws.

The port takes the momentum normals and the acceptance uniforms as inputs;
here they are the ones the JAX step draws from its key (chees.py:83 split,
:97 normals, :147 uniforms). Float64, rtol 1e-10: q, logp, grad, log_T and
the Adam state, the number of leapfrogs L and every stat. Cases: the stress
GLM cut to 20 groups and 200 observations, with T adapted and not; a
Gaussian with a wall where logp is -inf, so that lanes freeze mid
trajectory; and L at both of its clips.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pymc_tpu as pmj
from pymc_tpu.blocking import unravel_vector
from pymc_tpu.sampling import chees as chees_j
from pymc_tpu_torch.models import stress_glm_model
from pymc_tpu_torch.sampling import chees as chees_t

C = 8
STATS = ("acceptance_rate", "accepted", "lp", "energy", "n_steps", "trajectory_length",
         "diverging")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_halton_sequence_is_bit_equal():
    for n, base in ((1, 2), (428, 2), (1000, 3)):
        ref = chees_j.halton_sequence(n, base)
        got = chees_t.halton_sequence(n, base)
        assert got.dtype == ref.dtype == np.float64
        np.testing.assert_array_equal(got, ref)
    h = chees_t.halton_sequence(428) * 0.9 + 0.1
    assert h.min() > 0.1 and h.max() <= 1.0


def _stress_fns():
    mj = stress_glm_model(20, 200, pm=pmj)
    info = mj.raveled_info()
    lf = mj.logp_fn()
    fj = jax.value_and_grad(lambda x: lf(unravel_vector(x, info)))
    ft = stress_glm_model(20, 200).logp_dlogp_fn(device="cpu")
    return fj, ft, info.total_size


WALL = 1.0


def _wall_fns():
    """A standard Gaussian in 6 dimensions whose logp is -inf where q[0] >
    WALL; its gradient stays finite there."""

    def fj(x):
        lp = -0.5 * jnp.sum(x**2)
        return jnp.where(x[0] > WALL, -jnp.inf, lp), -x

    def ft(q):
        lp = -0.5 * torch.sum(q**2, dim=-1)
        return torch.where(q[:, 0] > WALL, -torch.inf, lp), -q

    return fj, ft, 6


def _case(fns, *, log_T, eps_range, adapt_T, max_leapfrogs, halton_u=0.61, seed=0,
          q_scale=0.5):
    fj, ft, D = fns
    rng = np.random.default_rng(seed)
    q = rng.normal(0.0, q_scale, size=(C, D))
    if fns[2] == 6:
        q[:, 0] = rng.uniform(0.2, 0.95, C)  # chains start close to the wall
    eps = rng.uniform(*eps_range, size=C)
    inv_mass = rng.uniform(0.5, 1.5, size=(C, D))
    adam = (0.3, 2.5, 4.0)  # m, v, t: a state mid warmup

    lj, gj = jax.vmap(fj)(q)
    state_j = chees_j.CheesState(
        jnp.asarray(q), lj, gj, jnp.float64(log_T), *map(jnp.float64, adam)
    )
    key = jax.random.PRNGKey(seed + 11)
    new_j, stats_j = chees_j.chees_step(
        fj, key, state_j, jnp.asarray(eps), jnp.asarray(inv_mass), jnp.float64(halton_u),
        adapt_T=adapt_T, max_leapfrogs=max_leapfrogs,
    )
    k_mom, k_acc = jax.random.split(key)
    xi = torch.as_tensor(np.array(jax.random.normal(k_mom, (C, D), jnp.float64)))
    u = torch.as_tensor(np.array(jax.random.uniform(k_acc, (C,), jnp.float64)))

    qt = torch.as_tensor(q)
    lt, gt = ft(qt)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-10)
    state_t = chees_t.CheesState(
        qt, lt, gt, *(torch.tensor(v, dtype=torch.float64) for v in (log_T, *adam))
    )
    reads = chees_t.HostReads()
    new_t, stats_t = chees_t.chees_step(
        ft, state_t, torch.as_tensor(eps), torch.as_tensor(inv_mass),
        torch.tensor(halton_u, dtype=torch.float64), xi, u,
        adapt_T=adapt_T, max_leapfrogs=max_leapfrogs, host_read=reads,
    )
    assert reads.count == 1  # L, the step's one read to the host
    for field in chees_j.CheesState._fields:
        got, ref = getattr(new_t, field).numpy(), np.asarray(getattr(new_j, field))
        np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12, err_msg=field)
    for name in STATS:
        got, ref = stats_t[name].numpy(), np.asarray(stats_j[name])
        assert got.shape == ref.shape == (C,), name
        if got.dtype == bool:
            np.testing.assert_array_equal(got, ref, err_msg=name)
        else:
            np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12, err_msg=name)
    return stats_t


@pytest.mark.parametrize("adapt_T", [True, False])
def test_step_matches_jax_on_the_stress_glm(adapt_T):
    stats = _case(_stress_fns(), log_T=np.log(0.9), eps_range=(0.08, 0.15),
                  adapt_T=adapt_T, max_leapfrogs=64)
    L = int(stats["n_steps"][0])
    assert 4 <= L < 64 and (stats["n_steps"] == L).all()
    assert stats["accepted"].any()


@pytest.mark.parametrize("adapt_T", [True, False])
def test_step_matches_jax_with_frozen_lanes(adapt_T):
    stats = _case(_wall_fns(), log_T=np.log(3.0), eps_range=(0.2, 0.4), adapt_T=adapt_T,
                  max_leapfrogs=64, seed=3)
    # some lanes ran into the wall: logp -inf, frozen, rejected
    assert stats["diverging"].any() and not stats["diverging"].all()
    assert (stats["acceptance_rate"][stats["diverging"]] == 0).all()


@pytest.mark.parametrize(
    "log_T, max_leapfrogs, L",
    [(np.log(1e-3), 64, 1), (np.log(50.0), 16, 16), (50.0, 32, 32)],
    ids=["one", "cap", "cap-far-past-int32"],
)
def test_number_of_leapfrogs_at_its_clips(log_T, max_leapfrogs, L):
    stats = _case(_stress_fns(), log_T=log_T, eps_range=(0.01, 0.02), adapt_T=True,
                  max_leapfrogs=max_leapfrogs, seed=1)
    assert (stats["n_steps"] == L).all()


def test_full_mass_is_refused():
    _, ft, D = _wall_fns()
    q = torch.zeros(C, D, dtype=torch.float64)
    lp, g = ft(q)
    state = chees_t.chees_init(q, lp, g)
    with pytest.raises(NotImplementedError, match="diagonal"):
        chees_t.chees_step(
            ft, state, torch.full((C,), 0.1, dtype=torch.float64),
            torch.eye(D, dtype=torch.float64), 0.5, torch.zeros(C, D, dtype=torch.float64),
            torch.full((C,), 0.5, dtype=torch.float64), adapt_T=True,
            host_read=chees_t.HostReads(),
        )


def test_init_matches_jax():
    q = np.random.default_rng(0).normal(size=(C, 3))
    sj = chees_j.chees_init(jnp.asarray(q), jnp.zeros(C), jnp.asarray(q), initial_T=2.5)
    st = chees_t.chees_init(torch.as_tensor(q), torch.zeros(C, dtype=torch.float64),
                            torch.as_tensor(q), initial_T=2.5)
    for field in chees_j.CheesState._fields:
        np.testing.assert_allclose(getattr(st, field).numpy(), np.asarray(getattr(sj, field)),
                                   rtol=1e-15)
