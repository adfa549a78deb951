"""Tempered SMC of pymc_tpu_torch against pymc_tpu's, on BASELINE config #5.

The stage functions take their random draws from a draw source; here it
replays the ones the JAX stage draws from each chain's key (smc/kernels.py:
`k_res, k_mut = split(key)`, the resample's `uniform(k_res, ())`, and per
sweep `key, k = split(key)`, `k1, k2, k3 = split(k, 3)`, `normal(k1, (N,
D))`, `uniform(k2, (N,))`; with a fixed sweep count `split(k_mut, n)[i]`).
Float64 on the CPU. Held at rtol 1e-9: the beta bisection, one IMH stage
and two MH stages fed pymc_tpu's draws (particles, logps, beta, log
marginal, n_steps, acceptances, proposal scales), with a chain already at
beta = 1 passing through unchanged; the resample indices exactly. End to
end, `sample_smc(device="cpu")` on `case_smc`'s model at 300 draws x 4
chains agrees with pymc_tpu's in the posterior means of mu and w and the
mean log marginal likelihood, each within 5 combined standard errors
taken from the spread between chains.
"""

import logging

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from pymc_tpu.blocking import unravel_vector
from pymc_tpu.smc import kernels as kj
from pymc_tpu_torch.models import smc_chain_estimates, smc_mixture_model
from pymc_tpu_torch.sampling.chees import HostReads
from pymc_tpu_torch.smc import kernels as kt
from pymc_tpu_torch.smc.sampling import _apply_start, tempered_density

C, N = 4, 200
RTOL = 1e-9


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class JaxDraws:
    """The draws of pymc_tpu's vmapped `smc_stage` from per-chain keys."""

    def __init__(self, keys, n_steps=None):
        self.keys = [jax.random.split(k) for k in keys]
        self.n_steps = n_steps

    def resample_uniform(self, chains):
        assert chains == len(self.keys)
        return torch.tensor([float(jax.random.uniform(kr, ())) for kr, _ in self.keys],
                            dtype=torch.float64)

    def sweep(self, i, shape):
        _, n, d = shape
        eps, u = [], []
        for _, k_mut in self.keys:
            if self.n_steps is not None:
                k = jax.random.split(k_mut, self.n_steps)[i]
            else:
                key = k_mut
                for _ in range(i + 1):
                    key, k = jax.random.split(key)
            k1, k2, _ = jax.random.split(k, 3)
            eps.append(np.asarray(jax.random.normal(k1, (n, d))))
            u.append(np.asarray(jax.random.uniform(k2, (n,))))
        return torch.as_tensor(np.stack(eps)), torch.as_tensor(np.stack(u))


@pytest.fixture(scope="module")
def models():
    return smc_mixture_model(pmj), smc_mixture_model(pmt)


def _jax_density(mj):
    info = mj.raveled_info()
    split = mj.logp_fn(split=True)

    def fn(particles, key=None):
        vl, dl = jax.vmap(lambda q: split(unravel_vector(q, info)))(particles)
        return vl, jnp.where(jnp.isfinite(dl), dl, -jnp.inf)

    return fn


def _assert_states_match(st_t, st_j, label):
    for field in kt.SMCState._fields:
        got = getattr(st_t, field).numpy()
        ref = np.asarray(getattr(st_j, field))
        assert got.shape == ref.shape, (label, field)
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=1e-12, err_msg=f"{label} {field}")


def _initial_states(models, done_chain=None):
    mj, mt = models
    q = np.random.default_rng(0).normal(0.0, 1.5, size=(C, N, 3))
    fj, ft = _jax_density(mj), tempered_density(mt, "cpu")
    st_j = jax.vmap(lambda p: kj.smc_init(p, fj))(jnp.asarray(q))
    st_t = kt.smc_init(torch.as_tensor(q), ft)
    if done_chain is not None:
        st_j = st_j._replace(beta=st_j.beta.at[done_chain].set(1.0))
        st_t = st_t._replace(beta=st_t.beta.clone().index_fill_(0, torch.tensor(done_chain), 1.0))
    _assert_states_match(st_t, st_j, "init")
    return fj, ft, st_j, st_t


@pytest.mark.parametrize("kind, n_steps, stages", [("imh", None, 1), ("mh", None, 2),
                                                    ("imh", 3, 1)])
def test_stages_fed_the_jax_draws_match(models, kind, n_steps, stages):
    fj, ft, st_j, st_t = _initial_states(models, done_chain=2)
    ker_j = {"imh": kj.IMH, "mh": kj.MH}[kind](n_steps=n_steps)
    ker_t = {"imh": kt.IMH, "mh": kt.MH}[kind](n_steps=n_steps)
    stage_j = jax.jit(jax.vmap(kj.smc_stage(ker_j, fj, 0.5)))
    reads = HostReads()
    for s in range(stages):
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(5), s), C)
        before = st_t
        st_j = stage_j(keys, st_j)
        st_t = kt.smc_stage(ker_t, ft, st_t, JaxDraws(keys, n_steps), reads, 0.5)
        _assert_states_match(st_t, st_j, f"{kind} stage {s}")
        # the chain already at beta = 1 passed through the stage unchanged
        for field in kt.SMCState._fields:
            assert torch.equal(getattr(st_t, field)[2], getattr(before, field)[2]), field
    steps = st_t.n_steps.numpy()
    if n_steps is None:
        # the Pearson rule stopped the chains after different sweep counts,
        # and the loop read one flag a sweep but after the last possible one
        assert len(set(steps[[0, 1, 3]].tolist())) > 1 or kind == "mh"
        assert reads.count >= int(steps.max())
    else:
        assert reads.count == 0 and (steps[[0, 1, 3]] == n_steps).all()


def test_find_beta_matches():
    rng = np.random.default_rng(3)
    like = rng.normal(0.0, 1.0, size=(5, 300)) * np.array([50.0, 5.0, 0.01, 200.0, 1.0])[:, None]
    beta = np.array([0.0, 0.3, 0.2, 0.9, 0.999])
    ref = jax.vmap(kj._find_beta, in_axes=(0, 0, None))(jnp.asarray(beta), jnp.asarray(like), 0.5)
    got = kt._find_beta(torch.as_tensor(beta), torch.as_tensor(like), 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL)
    assert got[2] == 1.0  # nearly flat likelihood: straight to beta = 1


def test_systematic_resample_matches():
    rng = np.random.default_rng(4)
    lw = rng.normal(0.0, 3.0, size=(6, 250))
    lw[1, ::3] = -np.inf
    keys = jax.random.split(jax.random.PRNGKey(9), 6)
    ref = jax.vmap(lambda k, w: kj._systematic_resample(k, w, jnp.arange(250)))(keys, lw)
    u = torch.tensor([float(jax.random.uniform(k, ())) for k in keys], dtype=torch.float64)
    got = kt._systematic_resample(u, torch.as_tensor(lw))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert not np.isin(np.arange(0, 250, 3), got[1].numpy()).any()


SMC_CONFIG = dict(draws=300, chains=4, random_seed=0, progressbar=False)


def test_sample_smc_agrees_with_pymc_tpu(models):
    mj, mt = models
    idata_j = pmj.sample_smc(model=mj, **SMC_CONFIG)
    idata_t = pmt.sample_smc(model=mt, device="cpu", **SMC_CONFIG)
    assert list(idata_t.sample_stats.keys()) == list(idata_j.sample_stats.keys())
    assert set(idata_j.posterior.attrs) <= set(idata_t.posterior.attrs)
    assert sorted(idata_t.posterior.keys()) == ["mu", "w"]
    assert idata_t.posterior["mu"].shape == (4, 300, 2)
    assert (idata_t.sample_stats["beta"].values == 1.0).all()
    attrs = idata_t.posterior.attrs
    assert attrs["n_stages"] == len(attrs["beta_history"]) == len(attrs["n_steps_history"])
    # one read of the stage's stats, and one a sweep but the last possible
    assert attrs["sampling_host_syncs"] <= attrs["n_stages"] + np.max(
        attrs["n_steps_history"], axis=1).sum()
    pj, pt = smc_chain_estimates(idata_j), smc_chain_estimates(idata_t)
    for name in pj:
        se = np.hypot(pj[name].std(ddof=1), pt[name].std(ddof=1)) / np.sqrt(4)
        z = (pt[name].mean() - pj[name].mean()) / se
        assert abs(z) < 5.0, (name, pt[name], pj[name])


def test_sample_smc_mh_and_dict_return(models):
    _, mt = models
    post = pmt.sample_smc(model=mt, device="cpu", kernel="mh", draws=100, chains=2,
                          random_seed=1, progressbar=False, return_inferencedata=False,
                          compute_convergence_checks=False)
    assert post["mu"].shape == (2, 100, 2) and np.isfinite(post["mu"]).all()
    assert np.all(np.diff(post["mu"], axis=-1) > 0)
    np.testing.assert_allclose(post["w"].sum(-1), 1.0, rtol=1e-12)


def test_progressbar_logs_each_stage(models, caplog):
    _, mt = models
    with caplog.at_level(logging.INFO, logger="pymc_tpu_torch"):
        idata = pmt.sample_smc(model=mt, device="cpu", draws=60, chains=2, random_seed=2,
                               progressbar=True, compute_convergence_checks=False)
    lines = [r.getMessage() for r in caplog.records if r.getMessage().startswith("SMC stage")]
    assert len(lines) == idata.posterior.attrs["n_stages"]


def test_start_seeds_the_particles(models):
    _, mt = models
    parts = torch.zeros((2, 5, 3), dtype=torch.float64)
    mu = np.tile([[-1.0, 2.0]], (5, 1))
    out = _apply_start(mt, parts, [{"mu": mu}, {"w_simplex__": np.full((5, 1), 0.7)}])
    np.testing.assert_allclose(out[0, :, 1:].numpy(), np.tile([-1.0, np.log(3.0)], (5, 1)))
    assert (out[0, :, 0] == 0).all() and (out[1, :, 0] == 0.7).all() and (out[1, :, 1:] == 0).all()
    assert (parts == 0).all()
    with pytest.raises(ValueError, match="list of 2 dicts"):
        _apply_start(mt, parts, [{}])


def test_discrete_coordinates_are_rounded():
    def build(pm):
        with pm.Model() as m:
            z = pm.Bernoulli("z", 0.3)
            pm.Normal("y", 2.0 * z, 1.0, observed=np.array([1.8, 2.2, 1.1]))
        return m

    mj, mt = build(pmj), build(pmt)
    q = np.array([[-0.49], [0.51], [1.2], [-0.51]])
    prior, like = tempered_density(mt, "cpu")(torch.as_tensor(q))
    split = mj.logp_fn(split=True)
    for i, z in enumerate([0.0, 1.0, 1.0, -1.0]):
        vp, dl = split({"z": jnp.asarray(z)})
        np.testing.assert_allclose([float(prior[i]), float(like[i])],
                                   [float(vp), float(dl) if np.isfinite(dl) else -np.inf],
                                   rtol=1e-12)
    post = pmt.sample_smc(model=mt, device="cpu", draws=200, chains=2, random_seed=0,
                          progressbar=False, return_inferencedata=False,
                          compute_convergence_checks=False)
    assert post["z"].dtype == np.int64 and set(np.unique(post["z"])) <= {0, 1}


def test_sample_smc_refusals(models):
    _, mt = models
    with pytest.raises(NotImplementedError, match="one"):
        pmt.sample_smc(model=mt, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="Unknown SMC kernel"):
        pmt.sample_smc(model=mt, device="cpu", kernel="nuts")
    with pytest.raises(ValueError, match="correlation_threshold"):
        pmt.sample_smc(model=mt, device="cpu", correlation_threshold=2.0)


def test_sample_smc_default_device_is_the_card(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: the default would run there")
    _, mt = models
    with pytest.raises(RuntimeError, match="cuda"):
        pmt.sample_smc(model=mt, draws=10, chains=1)
