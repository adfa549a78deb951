"""One step of each step method of pymc_tpu_torch against pymc_tpu's, fed
the same random draws.

The port's steps ask a draw source for their normals, uniforms, Gumbels
and integers (`step_methods/compound.py::StepDraws`); here the source
replays the draws the JAX step makes from its key, remade with
`jax.random` from the same key splits. Float64, rtol 1e-10: the point, the
state and every stat after one step. Also the deterministic parts:
`_tune_scaling` at every band of its ladder and `metrop_select` for given
uniforms.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from pymc_tpu.step_methods import arraystep as arraystep_j
from pymc_tpu.step_methods import metropolis as metropolis_j
from pymc_tpu_torch.sampling.adaptation import da_init as da_init_t
from pymc_tpu_torch.step_methods import arraystep as arraystep_t
from pymc_tpu_torch.step_methods import metropolis as metropolis_t

C = 6
RTOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class ReplayDraws:
    """A draw source that hands out given draws in order, each checked for
    its kind and shape."""

    dtype = torch.float64
    device = torch.device("cpu")

    def __init__(self, draws):
        self.queue = [(kind, np.asarray(a)) for kind, a in draws]

    def _next(self, kind, shape):
        got, arr = self.queue.pop(0)
        assert got == kind and arr.shape == tuple(shape), (got, arr.shape, kind, tuple(shape))
        return torch.as_tensor(arr.copy())

    def normal(self, shape):
        return self._next("normal", shape)

    def uniform(self, shape):
        return self._next("uniform", shape)

    def exponential(self, shape):
        return self._next("exponential", shape)

    def gumbel(self, shape):
        return self._next("gumbel", shape)

    def poisson(self, lam):
        return self._next("poisson", lam.shape).to(lam.dtype)

    def randint(self, high, shape):
        return self._next("randint", shape)


def chain_keys(key, split=2):
    """The JAX steps' per-chain keys: split(key, C), each split again."""
    return jax.vmap(lambda k: jax.random.split(k, split))(jax.random.split(key, C))


def per_chain(fn, keys):
    return np.asarray(jax.vmap(fn)(keys))


def flags(tune_now=False, is_tune=True):
    return ({"step_i": jnp.asarray(99), "is_tune": jnp.asarray(is_tune),
             "tune_now": jnp.asarray(tune_now)},
            {"step_i": 99, "is_tune": is_tune, "tune_now": tune_now})


def to_torch(point):
    return {k: torch.as_tensor(np.asarray(v)) for k, v in point.items()}


def assert_tree_close(got, ref, label):
    assert set(got) == set(ref), (label, sorted(got), sorted(ref))
    for k in ref:
        r = ref[k]
        if isinstance(r, tuple):  # a NamedTuple state (dual averaging, Welford)
            for f in r._fields:
                assert_tree_close({f: getattr(got[k], f)}, {f: getattr(r, f)}, f"{label}.{k}")
            continue
        r = np.asarray(r)
        g = got[k].detach().cpu().numpy()
        assert g.shape == r.shape, (label, k, g.shape, r.shape)
        if r.dtype == bool or np.issubdtype(r.dtype, np.integer):
            np.testing.assert_array_equal(g, r, err_msg=f"{label}.{k}")
        else:
            np.testing.assert_allclose(g, r, rtol=RTOL, atol=1e-12, err_msg=f"{label}.{k}")


def without_cached_logp(state):
    """The JAX Metropolis-type steps keep their last draw's logp in their
    state; the port's evaluate the current point afresh and keep none."""
    return {k: v for k, v in state.items() if k != "logp"}


def run_both(step_j, step_t, point, state_j, state_t, draws, tune_now=False, is_tune=True,
             key=None):
    """One step of each; `draws` is a list for ReplayDraws or a draw
    source."""
    fj, ft = flags(tune_now, is_tune)
    out_j = step_j.step(key, {k: jnp.asarray(v) for k, v in point.items()}, state_j, fj)
    source = ReplayDraws(draws) if isinstance(draws, list) else draws
    out_t = step_t.step(source, to_torch(point), state_t, ft)
    assert not source.queue, "draws left over"
    point_j, new_j, stats_j = out_j
    for label, got, ref in zip(("point", "state", "stats"), out_t,
                               (point_j, without_cached_logp(new_j), stats_j)):
        assert_tree_close(got, ref, label)
    return out_t


def mixed_model(pm):
    """Two Normals, a Poisson count and a Bernoulli bit; y observed."""
    y = np.random.default_rng(3).normal(1.0, 1.0, 20)
    with pm.Model() as m:
        x = pm.Normal("x", 0.0, 1.0, shape=2)
        k = pm.Poisson("k", 3.0)
        b = pm.Bernoulli("b", 0.4, shape=3)
        s = pm.HalfNormal("s", 1.0)
        pm.Normal("y", x[0] + 0.5 * x[1] + 0.1 * k + 0.3 * (b[0] + b[1] + b[2]), s,
                  observed=y)
    return m


def mixed_point(seed):
    rng = np.random.default_rng(seed)
    return {
        "x": rng.normal(size=(C, 2)),
        "k": rng.integers(0, 7, size=C).astype(np.int64),
        "b": rng.integers(0, 2, size=(C, 3)).astype(np.int64),
        "s_log__": rng.normal(0.0, 0.3, size=C),
    }


@pytest.mark.parametrize("proposal, tune_now", [("normal", False), ("normal", True),
                                               ("uniform", True), ("poisson", False)])
def test_metropolis_step(proposal, tune_now):
    mj, mt = mixed_model(pmj), mixed_model(pmt)
    kw = {}
    if proposal != "normal":
        kw = {"uniform": dict(proposal_dist=metropolis_j.UniformProposal, S=0.7),
              "poisson": dict(proposal_dist=metropolis_j.PoissonProposal, S=1.5)}[proposal]
    kw_t = {k: (getattr(metropolis_t, v.__name__) if k == "proposal_dist" else v)
            for k, v in kw.items()}
    sj = pmj.Metropolis(vars=[mj["x"], mj["k"]], model=mj, scaling=0.8, **kw)
    st = pmt.Metropolis(vars=[mt["x"], mt["k"]], model=mt, scaling=0.8, **kw_t)
    point = mixed_point(1)
    key = jax.random.PRNGKey(11)
    state_j = sj.init_state({k: jnp.asarray(v) for k, v in point.items()}, C, key)
    state_t = st.init_state(to_torch(point), C, None)
    assert_tree_close(state_t, without_cached_logp(state_j), "init")
    keys = chain_keys(key)
    D = 3
    if proposal == "normal":
        raw = ("normal", per_chain(lambda k: jax.random.normal(k[0], (D,)), keys))
    elif proposal == "uniform":
        raw = ("uniform", per_chain(lambda k: jax.random.uniform(k[0], (D,)), keys))
    else:
        raw = ("poisson", per_chain(
            lambda k: jax.random.poisson(k[0], jnp.full((D,), 1.5), (D,)).astype(float), keys))
    u = per_chain(lambda k: jax.random.uniform(k[1]), keys)
    point_t, _, stats = run_both(sj, st, point, state_j, state_t, [raw, ("uniform", u)],
                                 tune_now=tune_now, key=key)
    assert point_t["k"].dtype == torch.int64
    assert 0 < int(stats["accepted"].sum()) < C or proposal == "poisson"


def test_binary_metropolis_step():
    mj, mt = mixed_model(pmj), mixed_model(pmt)
    sj = pmj.BinaryMetropolis(vars=[mj["b"]], model=mj, scaling=2.0)
    st = pmt.BinaryMetropolis(vars=[mt["b"]], model=mt, scaling=2.0)
    point = mixed_point(2)
    key = jax.random.PRNGKey(12)
    pj = {k: jnp.asarray(v) for k, v in point.items()}
    state_j, state_t = sj.init_state(pj, C, key), st.init_state(to_torch(point), C, None)
    keys = chain_keys(key)
    flips = per_chain(lambda k: jax.random.uniform(k[0], (3,)), keys)
    u = per_chain(lambda k: jax.random.uniform(k[1]), keys)
    run_both(sj, st, point, state_j, state_t, [("uniform", flips), ("uniform", u)], key=key)


def test_binary_gibbs_step():
    mj, mt = mixed_model(pmj), mixed_model(pmt)
    sj = pmj.BinaryGibbsMetropolis(vars=[mj["b"]], model=mj)
    st = pmt.BinaryGibbsMetropolis(vars=[mt["b"]], model=mt)
    point = mixed_point(3)
    key = jax.random.PRNGKey(13)
    draws = []
    k = jax.random.split(key, C)
    for _ in range(3):
        ks = jax.vmap(jax.random.split)(k)
        k, sub = ks[:, 0], ks[:, 1]
        draws.append(("uniform", per_chain(lambda s: jax.random.uniform(s, dtype=float), sub)))
    run_both(sj, st, point, {}, {}, draws, key=key)


def categorical_model(pm):
    with pm.Model() as m:
        c = pm.Categorical("c", p=np.array([0.2, 0.5, 0.3]), shape=2)
        d = pm.DiscreteUniform("d", 2, 5)
        pm.Normal("y", c[0] + 0.5 * c[1] - 0.3 * d, 1.0, observed=np.array([0.4, 1.1, -0.2]))
    return m


def test_categorical_gibbs_step():
    mj, mt = categorical_model(pmj), categorical_model(pmt)
    sj = pmj.CategoricalGibbsMetropolis(model=mj)
    st = pmt.CategoricalGibbsMetropolis(model=mt)
    assert st.K == sj.K == 4
    rng = np.random.default_rng(4)
    point = {"c": rng.integers(0, 3, size=(C, 2)).astype(np.int64),
             "d": rng.integers(2, 6, size=C).astype(np.int64)}
    key = jax.random.PRNGKey(14)
    draws = []
    k = jax.random.split(key, C)
    for _ in range(3):
        ks = jax.vmap(jax.random.split)(k)
        k, sub = ks[:, 0], ks[:, 1]
        draws.append(("gumbel", per_chain(lambda s: jax.random.gumbel(s, (4,), float), sub)))
    point_t, _, _ = run_both(sj, st, point, {}, {}, draws, key=key)
    assert point_t["d"].min() >= 2 and point_t["d"].max() <= 5


def normal_model(pm, shape=()):
    with pm.Model() as m:
        pm.Normal("x", 1.0, 2.0, shape=shape)
        pm.HalfNormal("s", 1.5)
    return m


def test_de_metropolis_step():
    mj, mt = normal_model(pmj, (2,)), normal_model(pmt, (2,))
    sj, st = pmj.DEMetropolis(model=mj, scaling=0.05), pmt.DEMetropolis(model=mt, scaling=0.05)
    rng = np.random.default_rng(5)
    point = {"x": rng.normal(size=(C, 2)), "s_log__": rng.normal(size=C)}
    key = jax.random.PRNGKey(15)
    pj = {k: jnp.asarray(v) for k, v in point.items()}
    state_j, state_t = sj.init_state(pj, C, key), st.init_state(to_torch(point), C, None)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    draws = [("randint", np.asarray(jax.random.randint(k1, (C,), 0, C - 1))),
             ("randint", np.asarray(jax.random.randint(k2, (C,), 0, C - 2))),
             ("normal", np.asarray(jax.random.normal(k3, (C, 3)))),
             ("uniform", np.asarray(jax.random.uniform(k4, (C,))))]
    run_both(sj, st, point, state_j, state_t, draws, tune_now=True, key=key)


def test_de_metropolis_z_step():
    mj, mt = normal_model(pmj, (2,)), normal_model(pmt, (2,))
    H = 10
    sj = pmj.DEMetropolisZ(model=mj, scaling=0.05, max_history=H)
    st = pmt.DEMetropolisZ(model=mt, scaling=0.05, max_history=H)
    rng = np.random.default_rng(6)
    point = {"x": rng.normal(size=(C, 2)), "s_log__": rng.normal(size=C)}
    key = jax.random.PRNGKey(16)
    pj = {k: jnp.asarray(v) for k, v in point.items()}
    state_j, state_t = sj.init_state(pj, C, key), st.init_state(to_torch(point), C, None)
    # a history already under way: 0, 1, 3 ... entries, one chain past the ring's end
    history = rng.normal(size=(C, H, 3))
    hist_len = np.array([0, 1, 3, 7, 10, 23])
    state_j = dict(state_j, history=jnp.asarray(history), hist_len=jnp.asarray(hist_len, jnp.int32))
    state_t = dict(state_t, history=torch.as_tensor(history), hist_len=torch.as_tensor(hist_len))
    keys = chain_keys(key, 4)
    cap = jnp.maximum(jnp.minimum(jnp.asarray(hist_len), H), 1)
    draws = [("normal", per_chain(lambda k: jax.random.normal(k[0], (3,)), keys)),
             ("randint", np.asarray(jax.vmap(
                 lambda k, c: jax.random.randint(k[1], (), 0, c))(keys, cap))),
             ("randint", np.asarray(jax.vmap(
                 lambda k, c: jax.random.randint(k[2], (), 0, c))(keys, cap))),
             ("uniform", per_chain(lambda k: jax.random.uniform(k[3]), keys))]
    _, state, _ = run_both(sj, st, point, state_j, state_t, draws, tune_now=True, key=key)
    assert state["hist_len"].tolist() == (hist_len + 1).tolist()


class SliceDraws:
    """The Slice step's draws, made as the step asks for them: per
    coordinate the height's exponential, the interval's uniform, then one
    uniform for each shrink iteration of the masked loop (chain c's n-th
    from the n-th split of its k3), so the draws follow the longest
    chain's shrinks on each coordinate."""

    queue = ()

    def __init__(self, key):
        self.k = jax.random.split(key, C)
        self.interval = False

    def exponential(self, shape):
        ks = jax.vmap(lambda kk: jax.random.split(kk, 5))(self.k)
        self.k, self.k_interval, self.k_shrink = ks[:, 0], ks[:, 2], ks[:, 3]
        self.interval = True
        return torch.as_tensor(per_chain(lambda s: jax.random.exponential(s, dtype=float),
                                         ks[:, 1]).copy())

    def uniform(self, shape):
        if self.interval:
            self.interval = False
            sub = self.k_interval
        else:
            pair = jax.vmap(jax.random.split)(self.k_shrink)
            self.k_shrink, sub = pair[:, 0], pair[:, 1]
        return torch.as_tensor(per_chain(lambda s: jax.random.uniform(s, dtype=float), sub).copy())


def slice_model(pm, shape):
    with pm.Model() as m:
        pm.Normal("x", 1.0, 2.0, shape=shape)
    return m


@pytest.mark.parametrize("shape", [(), (2,)])
def test_slice_step(shape):
    """One and two coordinates: the masked loops stop once no chain is
    searching, one host read an iteration."""
    mj, mt = slice_model(pmj, shape), slice_model(pmt, shape)
    sj = pmj.Slice(model=mj, w=1.5)
    st = pmt.Slice(model=mt, w=1.5)
    point = {"x": np.random.default_rng(7).normal(size=(C,) + shape)}
    key = jax.random.PRNGKey(17)
    pj = {k: jnp.asarray(v) for k, v in point.items()}
    state_j, state_t = sj.init_state(pj, C, key), st.init_state(to_torch(point), C, None)
    _, _, stats = run_both(sj, st, point, state_j, state_t, SliceDraws(key), key=key)
    n_coords = int(np.prod(shape))
    assert int(stats["nstep_in"].min()) >= n_coords
    # a coordinate reads once after each of 1 to 16 steps out and once
    # before each of 1 to 64 shrinks, and once more to end the shrinking
    assert 3 * n_coords <= st.host_reads <= 81 * n_coords


def hmc_model(pm):
    y = np.random.default_rng(8).normal(0.5, 1.0, 15)
    with pm.Model() as m:
        x = pm.Normal("x", 0.0, 1.0, shape=3)
        s = pm.HalfNormal("s", 1.0)
        pm.Normal("y", x[0] + x[1] + x[2], s, observed=y)
    return m


def test_hamiltonian_mc_step():
    mj, mt = hmc_model(pmj), hmc_model(pmt)
    sj = pmj.HamiltonianMC(model=mj, path_length=1.0, max_steps=64)
    st = pmt.HamiltonianMC(model=mt, path_length=1.0, max_steps=64)
    rng = np.random.default_rng(9)
    point = {"x": rng.normal(0.0, 0.5, size=(C, 3)), "s_log__": rng.normal(0.0, 0.3, size=C)}
    key = jax.random.PRNGKey(18)
    pj = {k: jnp.asarray(v) for k, v in point.items()}
    state_j, state_t = sj.init_state(pj, C, key), st.init_state(to_torch(point), C, None)
    # per-chain step sizes, away from whole ratios (exp(log eps) may differ
    # by an ulp between the packages): n_steps 1000 (clipped to 64), 21, 9,
    # 3, 2 and 1 (clipped up)
    eps = np.array([0.001, 0.047, 0.11, 0.3, 0.45, 1.5])
    from pymc_tpu.sampling.adaptation import da_init as da_init_j

    state_j = dict(state_j, da=jax.vmap(da_init_j)(jnp.asarray(eps)),
                   inv_mass=jnp.asarray(rng.uniform(0.5, 1.5, size=(C, 4))))
    state_t = dict(state_t, da=da_init_t(torch.as_tensor(eps)),
                   inv_mass=torch.as_tensor(np.array(state_j["inv_mass"])))
    keys = chain_keys(key)
    draws = [("normal", per_chain(lambda k: jax.random.normal(k[0], (4,), float), keys)),
             ("uniform", per_chain(lambda k: jax.random.uniform(k[1], dtype=float), keys))]
    run_both(sj, st, point, state_j, state_t, draws, tune_now=True, key=key)
    assert st.leapfrogs == 64 and st.host_reads == 1


def test_tune_scaling_every_band():
    acc = np.array([0.0, 0.0005, 0.001, 0.02, 0.0499, 0.05, 0.1, 0.1999, 0.2, 0.35, 0.5, 0.5001,
                    0.6, 0.75, 0.7501, 0.9, 0.95, 0.9501, 1.0])
    scaling = np.linspace(0.3, 2.0, acc.size)
    ref = np.asarray(metropolis_j._tune_scaling(jnp.asarray(scaling), jnp.asarray(acc)))
    got = metropolis_t._tune_scaling(torch.as_tensor(scaling), torch.as_tensor(acc)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert len(set(np.round(got / scaling, 6))) == 7  # every band of the ladder


def test_metrop_select_for_given_uniforms():
    key = jax.random.PRNGKey(19)
    mr = np.array([-0.1, -2.0, 0.3, -0.7, -5.0, 0.0])
    q = {"a": np.arange(12.0).reshape(6, 2), "b": np.arange(6.0)}
    q0 = {"a": -np.ones((6, 2)), "b": -np.ones(6)}
    sel_j, acc_j = arraystep_j.metrop_select(key, jnp.asarray(mr), {k: jnp.asarray(v) for k, v
                                                                    in q.items()},
                                             {k: jnp.asarray(v) for k, v in q0.items()})
    u = np.asarray(jax.random.uniform(key, mr.shape))
    sel_t, acc_t = arraystep_t.metrop_select(u, mr, to_torch(q), to_torch(q0))
    np.testing.assert_array_equal(acc_t.numpy(), np.asarray(acc_j))
    for k in q:
        np.testing.assert_array_equal(sel_t[k].numpy(), np.asarray(sel_j[k]))
    one, acc = arraystep_t.metrop_select(np.array([0.5]), np.array([-1.0]), torch.ones(1),
                                         torch.zeros(1))
    assert not bool(acc[0]) and float(one[0]) == 0.0


def test_step_methods_namespace():
    from pymc_tpu import step_methods as smj
    from pymc_tpu_torch import step_methods as smt

    assert [c.__name__ for c in smt.STEP_METHODS] == [c.__name__ for c in smj.STEP_METHODS]
    assert set(smj.__all__) <= set(dir(smt))
    for name in ("NUTS", "HamiltonianMC", "Metropolis", "Slice", "CompoundStep",
                 "BinaryGibbsMetropolis", "CategoricalGibbsMetropolis", "DEMetropolisZ"):
        assert getattr(pmt, name) is getattr(smt, name)
    qp = smt.quad_potential(np.array([2.0, 0.5]), is_cov=True)
    assert smt.isquadpotential(qp)
    p = torch.tensor([1.0, 2.0], dtype=torch.float64)
    assert float(qp.energy(p)) == pytest.approx(0.5 * (2.0 + 0.5 * 4.0))
    full = smt.quad_potential(np.array([[2.0, 0.3], [0.3, 1.0]]), is_cov=False)
    g = torch.Generator().manual_seed(0)
    draws = torch.stack([full.random(g) for _ in range(4000)])
    np.testing.assert_allclose(np.cov(draws.numpy().T), [[2.0, 0.3], [0.3, 1.0]], atol=0.15)
