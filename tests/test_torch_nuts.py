"""One batched NUTS transition of pymc_tpu_torch against pymc_tpu's
`nuts_transition_batched`, fed the same random draws.

The port takes its randomness from a draw source; `JaxKeyDraws` below
replays the JAX package's key derivations (nuts.py:601-604 split, :637-639
direction, :646 tree keys, :443-448 leaf uniforms, :656-658 merge
uniforms), so both packages walk the same trees. Tolerance: (q, logp, grad)
to rtol 1e-10 in float64; depth, n_steps and diverging exactly equal.
Each leaf of the port runs `nuts_leaf_step` (its plain version on the CPU),
so these cases hold the fused leaf's arithmetic against the JAX package.
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
from pymc_tpu.sampling.nuts import _build_subtree_b, _uniform_b, nuts_transition_batched
from pymc_tpu_torch.ops.leapfrog import SubtreeState, nuts_leaf_step_plain, popcount
from pymc_tpu_torch.sampling.nuts import TorchDraws, nuts_transition

C = 8
MAX_TREEDEPTH = 6


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxKeyDraws:
    """The draws of `nuts_transition_batched` for per-chain `keys`."""

    def __init__(self, keys, dim):
        ks = jax.vmap(lambda k: jax.random.split(k, 4))(keys)
        self.k_mom, self.k_dir, self.k_tree, self.k_acc = (ks[:, i] for i in range(4))
        self.dim = dim

    def momentum(self):
        xi = jax.vmap(lambda k: jax.random.normal(k, (self.dim,), jnp.float64))(self.k_mom)
        return torch.as_tensor(np.array(xi))

    def direction(self, depth):
        d = jnp.asarray(depth.numpy())
        go = jax.vmap(lambda k, d: jax.random.bernoulli(jax.random.fold_in(k, d)))(
            self.k_dir, d
        )
        return torch.as_tensor(np.array(go))

    def leaf_uniform(self, depth, n):
        tree = jax.vmap(jax.random.fold_in)(self.k_tree, jnp.asarray(depth.numpy()))
        u = jax.vmap(
            lambda k, c: jax.random.uniform(jax.random.fold_in(k, c), dtype=jnp.float64)
        )(tree, jnp.asarray(n.numpy()))
        return torch.as_tensor(np.array(u))

    def accept_uniform(self, depth):
        u = jax.vmap(
            lambda k, d: jax.random.uniform(jax.random.fold_in(k, d), dtype=jnp.float64)
        )(self.k_acc, jnp.asarray(depth.numpy()))
        return torch.as_tensor(np.array(u))


def _gaussian_target():
    """The 5-D correlated Gaussian of tests/sampling/test_nuts_batched.py."""
    D = 5
    rng = np.random.default_rng(0)
    A = rng.normal(size=(D, D))
    P = np.linalg.inv(A @ A.T + D * np.eye(D))
    Pj, Pt = jnp.asarray(P), torch.as_tensor(P)

    def logp_grad_t(q):
        return -0.5 * torch.einsum("cd,de,ce->c", q, Pt, q), -(q @ Pt)

    return D, jax.value_and_grad(lambda q: -0.5 * q @ Pj @ q), logp_grad_t


def _radon_target():
    mj, mt = build_model(pmj), build_model(pmt)
    info = mj.raveled_info()
    lf = mj.logp_fn()
    return (
        info.total_size,
        jax.value_and_grad(lambda q: lf(unravel_vector(q, info))),
        mt.logp_dlogp_fn(device="cpu"),
    )


def _compare(D, logp_grad_j, logp_grad_t, q0, step, seed, max_treedepth=MAX_TREEDEPTH):
    """step: one step size for every chain, or one per chain."""
    keys = jax.random.split(jax.random.PRNGKey(seed), C)
    rng = np.random.default_rng(seed)
    inv_mass = rng.uniform(0.5, 1.5, size=(C, D))
    step_size = np.broadcast_to(np.asarray(step, dtype=np.float64), (C,)).copy()
    logp0, grad0 = jax.vmap(logp_grad_j)(jnp.asarray(q0))
    (qj, lj, gj), sj = nuts_transition_batched(
        logp_grad_j, keys, jnp.asarray(q0), logp0, grad0, jnp.asarray(step_size),
        jnp.asarray(inv_mass), max_treedepth=max_treedepth,
    )
    t = torch.as_tensor
    (qt, lt, gt), st = nuts_transition(
        logp_grad_t, JaxKeyDraws(keys, D), t(q0), t(np.array(logp0)),
        t(np.array(grad0)), t(step_size), t(inv_mass), max_treedepth=max_treedepth,
    )
    np.testing.assert_array_equal(st.depth.numpy(), np.asarray(sj.depth))
    np.testing.assert_array_equal(st.n_steps.numpy(), np.asarray(sj.n_steps))
    np.testing.assert_array_equal(st.diverging.numpy(), np.asarray(sj.diverging))
    np.testing.assert_allclose(qt.numpy(), np.asarray(qj), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-10)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-10, atol=1e-10)
    for f in ("energy", "acceptance_rate", "lp", "max_energy_error"):
        np.testing.assert_allclose(
            getattr(st, f).numpy(), np.asarray(getattr(sj, f)), rtol=1e-9, atol=1e-12
        )
    return st


@pytest.mark.parametrize("seed,step", [(0, 0.3), (1, 0.9), (2, 2.5)])
def test_transition_matches_jax_gaussian(seed, step):
    D, lg_j, lg_t = _gaussian_target()
    q0 = np.random.default_rng(100 + seed).normal(size=(C, D))
    _compare(D, lg_j, lg_t, q0, step, seed)


@pytest.mark.parametrize("seed,step", [(0, 0.02), (1, 0.08)])
def test_transition_matches_jax_radon(seed, step):
    D, lg_j, lg_t = _radon_target()
    q0 = np.random.default_rng(200 + seed).normal(0.0, 0.3, size=(C, D))
    _compare(D, lg_j, lg_t, q0, step, seed)


# per-chain steps from 0.02 to 400: full-depth trees, U-turns at different
# leaves, divergence at the first leaf and mid-subtree, in one batch
MIXED_STEPS = [0.02, 0.028, 0.9, 5.0, 400.0, 0.3, 2.5, 0.03]


@pytest.mark.parametrize(
    "target, step, max_treedepth",
    [("gaussian", MIXED_STEPS, MAX_TREEDEPTH), ("radon", MIXED_STEPS, MAX_TREEDEPTH),
     ("radon", 0.003, 10)],
    ids=["gaussian-mixed-steps", "radon-mixed-steps", "radon-depth-10"],
)
def test_transition_matches_jax_edge_batches(target, step, max_treedepth):
    """The radon batch with mixed steps diverges mid-subtree (a tree with
    fewer leaves than its depth allows); at depth 10 the deepest subtree
    writes and checks every slot of the 11 it has."""
    if target == "gaussian":
        D, lg_j, lg_t = _gaussian_target()
        q0 = np.random.default_rng(104).normal(size=(C, D))
    else:
        D, lg_j, lg_t = _radon_target()
        q0 = np.random.default_rng(204).normal(0.0, 0.3, size=(C, D))
    st = _compare(D, lg_j, lg_t, q0, step, 4, max_treedepth=max_treedepth)
    depth, n_steps = st.depth.numpy(), st.n_steps.numpy()
    assert depth.max() == max_treedepth  # a full tree: every checkpoint slot in use
    if step is MIXED_STEPS:
        assert st.diverging.any() and not st.diverging.all()
        assert len(set(depth.tolist())) >= 3  # trees end at different depths
    if target == "radon" and step is MIXED_STEPS:
        assert (n_steps < 2**depth - 1).any()


def test_huge_step_diverges_like_jax():
    D, lg_j, lg_t = _gaussian_target()
    q0 = np.random.default_rng(7).normal(size=(C, D))
    st = _compare(D, lg_j, lg_t, q0, 400.0, 7)
    assert st.diverging.all()


def test_popcount_matches_lax():
    x = np.arange(0, 5000, dtype=np.int32)
    expect = np.asarray(jax.lax.population_count(jnp.asarray(x)))
    np.testing.assert_array_equal(popcount(torch.as_tensor(x)).numpy(), expect)


def test_torch_draws_shapes_and_types():
    gen = torch.Generator().manual_seed(0)
    draws = TorchDraws(gen, 4, 3, torch.float64, torch.device("cpu"))
    depth = torch.zeros(4, dtype=torch.int32)
    assert draws.momentum().shape == (4, 3)
    assert draws.direction(depth).dtype == torch.bool
    u = draws.leaf_uniform(depth, depth)
    assert u.shape == (4,) and bool(((u >= 0) & (u < 1)).all())
    assert draws.accept_uniform(depth).dtype == torch.float64


# What a leaf may not change on a row that has stopped stepping: everything
# but q_half and p_half (dead once the row stops) and the counters
STOPPED_KEEPS = tuple(n for n in SubtreeState.BUFFERS if n not in ("q_half", "p_half", "count"))
SUBTREE_FIELDS = ("n", "q", "p", "grad", "logp", "prop_q", "prop_p", "prop_grad", "prop_logp",
                  "prop_energy", "log_size", "sum_accept", "max_eerr", "p_sum", "p_ckpt",
                  "psum_ckpt", "turning", "diverging")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_stopped_rows_keep_their_state_through_the_subtree(seed):
    """The invariant behind the leaf kernel's early exit: once a row stops
    stepping (turned, diverged, reached its 2**depth leaves, or never in
    the subtree), no later leaf changes its state. One subtree of depth <=
    4 built leaf by leaf with nuts_leaf_step_plain from the JAX package's
    leaf uniforms, checked after every leaf; the result equals
    `_build_subtree_b`'s to rtol 1e-10 (float64; integers and flags
    exactly)."""
    D, lg_j, lg_t = _gaussian_target()
    rng = np.random.default_rng(300 + seed)
    max_treedepth = 4
    q0, p0 = rng.normal(size=(C, D)), rng.normal(size=(C, D))
    inv_mass = rng.uniform(0.5, 1.5, size=(C, D))
    # one chain not in the subtree, one diverging, and depths 0 to 4
    eps = np.array(MIXED_STEPS) * rng.choice([-1.0, 1.0], C)
    depth = np.array([4, 4, 3, 4, 2, 4, 0, 4], dtype=np.int32)
    active0 = np.ones(C, dtype=bool)
    active0[5] = False
    logp0, grad0 = (np.array(x) for x in jax.vmap(lg_j)(jnp.asarray(q0)))
    h0 = -logp0 + 0.5 * np.sum(p0 * inv_mass * p0, axis=-1)
    keys = jax.random.split(jax.random.PRNGKey(seed), C)
    out_j, p_first_j = _build_subtree_b(
        jax.vmap(lg_j), keys, jnp.asarray(depth), jnp.asarray(active0), jnp.asarray(q0),
        jnp.asarray(p0), jnp.asarray(grad0), jnp.asarray(logp0), jnp.asarray(eps),
        jnp.asarray(inv_mass), jnp.asarray(h0), max_treedepth, 1000.0, False, False,
    )
    t = torch.as_tensor
    s = SubtreeState(t(q0), t(p0), t(grad0), t(logp0), t(h0), t(inv_mass), t(eps), t(active0),
                     t(depth), max_treedepth + 1)
    stopped_at = np.full(C, -1)
    leaf = 0
    while True:
        stopped = ~s.act.clone()
        before = {name: getattr(s, name).clone() for name in STOPPED_KEEPS}
        logp, grad = lg_t(s.q_half)
        u = torch.as_tensor(np.array(_uniform_b(keys, jnp.asarray(s.n.numpy()), jnp.float64)))
        count = int(nuts_leaf_step_plain(s, logp, grad, u))
        for name in STOPPED_KEEPS:
            torch.testing.assert_close(getattr(s, name)[stopped], before[name][stopped],
                                       rtol=0, atol=0, equal_nan=True, msg=name)
        stopped_at[(stopped.numpy()) & (stopped_at < 0)] = leaf
        leaf += 1
        if not count:
            break
    # rows stopped at different leaves, before the subtree's last
    assert stopped_at[5] == 0 and len(set(stopped_at[stopped_at < leaf - 1].tolist())) >= 2
    for name in SUBTREE_FIELDS:
        np.testing.assert_allclose(getattr(s, name).numpy(), np.asarray(getattr(out_j, name)),
                                   rtol=1e-10, atol=1e-12, err_msg=name)
    np.testing.assert_allclose(s.p_ckpt[:, 0].numpy(), np.asarray(p_first_j), rtol=1e-10)
