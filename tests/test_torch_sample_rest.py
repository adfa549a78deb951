"""The rest of pymc_tpu_torch.sample on the CPU, against pymc_tpu.sample.

A Normal with 30 observations, 2 chains, trees cut at depth 3. With
discard_tuned_samples=False and idata_kwargs={"log_likelihood": True} the
InferenceData must have pymc_tpu's groups, with its variables, dims and
shapes, on the NUTS and ChEES routes; on the compound route pymc_tpu drops
both (a reference fault for the warmup, ROADMAP.md §3), and the port keeps
PyMC's groups. The callback is called after each chunk and a
KeyboardInterrupt returns the completed draws (as
tests/sampling/test_mcmc.py holds pymc_tpu's); a run stopped and resumed
from its FileTrace gives bitwise the draws of the uninterrupted run, with
NUTS, ChEES, a full mass and the grad-based mass; return_inferencedata=False
gives a MultiTrace on every route. The radon GLM at depth 4 carries the
log_likelihood group of its 919 observations into loo and waic.
"""

import os

import numpy as np
import pytest
import torch

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from bench import build_model
from pymc_tpu_torch.backends.base import MultiTrace
from pymc_tpu_torch.sampling import mcmc, nuts

Y = np.random.default_rng(0).normal(1.0, 2.0, 30)
FAST = dict(draws=30, tune=20, chains=2, random_seed=3, compute_convergence_checks=False,
            nuts={"max_treedepth": 3})


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def normal_model(pm):
    with pm.Model(coords={"obs": np.arange(30)}) as m:
        mu = pm.Normal("mu", 0, 5)
        sigma = pm.HalfNormal("sigma", 3)
        pm.Deterministic("shifted", mu + 2.0 * sigma)
        pm.Normal("y", mu, sigma, observed=Y, dims="obs")
    return m


def mixed_model(pm):
    with pm.Model() as m:
        mu = pm.Normal("mu", 0, 5)
        k = pm.Poisson("k", 3.0)
        pm.Normal("y", mu + 0.1 * k, 2.0, observed=Y)
    return m


def sample_t(**kwargs):
    config = {**FAST, **kwargs}
    return pmt.sample(model=config.pop("model", None) or normal_model(pmt), device="cpu",
                      **config)


def layout(idata):
    return {g: {k: (v.dims, v.shape) for k, v in getattr(idata, g).items()}
            for g in idata.groups()}


@pytest.fixture(scope="module")
def jax_groups():
    return pmj.sample(model=normal_model(pmj), progressbar=False, discard_tuned_samples=False,
                      idata_kwargs={"log_likelihood": True}, **FAST)


@pytest.mark.parametrize("sampler", ["nuts", "chees"])
def test_warmup_and_log_likelihood_groups_match_pymc_tpu(jax_groups, sampler):
    idata = sample_t(sampler=sampler, discard_tuned_samples=False,
                     idata_kwargs={"log_likelihood": True})
    assert idata.groups() == jax_groups.groups()
    assert layout(idata) == layout(jax_groups)
    assert layout(idata)["warmup_posterior"]["mu"] == (("chain", "draw"), (2, 20))
    assert layout(idata)["log_likelihood"]["y"] == (("chain", "draw", "obs"), (2, 30, 30))
    ref = pmt.compute_log_likelihood(idata, model=normal_model(pmt), extend_inferencedata=False,
                                     device="cpu")
    np.testing.assert_array_equal(idata.log_likelihood["y"].values, ref["y"].values)
    # the warmup draws are those that precede the kept ones: the draws of an
    # unchanged run
    plain = sample_t(sampler=sampler)
    np.testing.assert_array_equal(idata.posterior["mu"].values, plain.posterior["mu"].values)
    ws = idata.warmup_sample_stats
    assert np.all(ws["step_size"].values > 0) and ws["diverging"].values.dtype == bool
    assert not np.array_equal(ws["step_size"].values[:, 0], ws["step_size"].values[:, -1])


def test_compound_warmup_and_log_likelihood_groups():
    """pymc_tpu's compound route ignores discard_tuned_samples and
    idata_kwargs (pymc_tpu/step_methods/compound.py:218-242): its result
    has neither group. The port keeps PyMC's: the warmup groups with every
    step's stats, and the log-likelihood."""
    config = dict(draws=20, tune=15, chains=2, random_seed=4, compute_convergence_checks=False,
                  discard_tuned_samples=False, idata_kwargs={"log_likelihood": True})
    ref = pmj.sample(model=mixed_model(pmj), progressbar=False, **config)
    assert "warmup_posterior" not in ref.groups() and "log_likelihood" not in ref.groups()
    idata = pmt.sample(model=mixed_model(pmt), device="cpu", **config)
    assert set(idata.groups()) - set(ref.groups()) == {
        "warmup_posterior", "warmup_sample_stats", "log_likelihood"}
    lay, ref_lay = layout(idata), layout(ref)
    for g in ref.groups():
        assert {k: v[0] for k, v in lay[g].items()} == {k: v[0] for k, v in ref_lay[g].items()}
    assert lay["warmup_posterior"]["k"] == (("chain", "draw"), (2, 15))
    assert set(idata.warmup_sample_stats.keys()) == set(idata.sample_stats.keys())
    assert lay["log_likelihood"]["y"] == (("chain", "draw", "y_dim_0"), (2, 20, 30))
    assert idata.warmup_posterior["k"].values.dtype == np.int64


def test_callback_is_called_after_every_chunk():
    calls = []

    def cb(draws_done, draws, chains, stats):
        calls.append((draws_done, draws, chains))
        assert isinstance(stats, nuts.NutsStats)
        assert stats.diverging.shape == (20, 2) and stats.diverging.dtype == bool
        assert stats.depth.dtype == np.int32

    idata = sample_t(draws=60, chunk_size=20, callback=cb)
    assert calls == [(20, 60, 2), (40, 60, 2), (60, 60, 2)]
    assert idata.posterior["mu"].shape == (2, 60)


def test_keyboard_interrupt_returns_the_completed_draws(monkeypatch):
    def stopper(draws_done, **kw):
        if draws_done >= 20:
            raise KeyboardInterrupt

    full = sample_t(draws=40)
    part = sample_t(draws=40, chunk_size=20, callback=stopper)
    assert part.posterior["mu"].shape == (2, 20)
    np.testing.assert_array_equal(part.posterior["mu"].values, full.posterior["mu"].values[:, :20])
    assert part.sample_stats["lp"].shape == (2, 20)
    # an interrupt before any sampling draw is raised again
    real, calls = nuts.nuts_transition, []

    def interrupted(*args, **kwargs):
        calls.append(1)
        if len(calls) == 5:
            raise KeyboardInterrupt
        return real(*args, **kwargs)

    monkeypatch.setattr(mcmc, "nuts_transition", interrupted)
    with pytest.raises(KeyboardInterrupt):
        sample_t()
    calls.clear()
    part = sample_t(tune=2)  # the interrupt lands in the third sampling draw
    assert part.posterior["mu"].shape == (2, 2)


RESUME_CASES = {
    "nuts": {},
    "chees": {"sampler": "chees"},
    "full_mass": {"init": "jitter+adapt_full"},
    "grad_mass": {"init": "jitter+adapt_diag_grad", "tune": 105},
    "pooled": {"mass_adapt": "pooled", "step_adapt": "pooled"},
}


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_resume_draws_what_the_uninterrupted_run_draws(tmp_path, case):
    kw = dict(RESUME_CASES[case], draws=30)
    full = sample_t(**kw)

    def stop(draws_done, **_):
        if draws_done >= 20:
            raise KeyboardInterrupt

    path = os.path.join(str(tmp_path), "trace")
    part = sample_t(chunk_size=10, callback=stop, trace=pmt.FileTrace(path), **kw)
    assert part.posterior["mu"].shape == (2, 20)
    tr = pmt.FileTrace(path)
    assert tr.read_meta() == {"draws_done": 20, "tune": kw.get("tune", FAST["tune"]),
                              "chains": 2, "D": 2}
    assert tr.read_draws()[0].shape == (20, 2, 2) and tr.n_chunks == 2
    resumed = sample_t(chunk_size=10, trace=tr, resume=True, **kw)
    for group in ("posterior", "sample_stats"):
        for k, v in getattr(full, group).items():
            np.testing.assert_array_equal(getattr(resumed, group)[k].values, v.values,
                                          err_msg=f"{group}.{k}")
    assert resumed.posterior.attrs["n_step_search"] == 0
    q, stats = tr.read_draws()
    assert q.shape == (30, 2, 2) and stats["lp"].shape == (30, 2)


def test_resume_skips_a_chunk_written_after_the_last_state(tmp_path):
    """A run stopped between a chunk's write and its state's leaves one
    chunk too many; resume drops it and draws it again."""
    full = sample_t(draws=30)
    path = os.path.join(str(tmp_path), "trace")
    sample_t(draws=20, chunk_size=10, trace=pmt.FileTrace(path))
    tr = pmt.FileTrace(path)
    q, stats = tr.read_draws()
    tr.write_chunk(q[:10] + 1.0, {k: v[:10] for k, v in stats.items()})
    resumed = sample_t(draws=30, chunk_size=10, trace=pmt.FileTrace(path), resume=True)
    np.testing.assert_array_equal(resumed.posterior["mu"].values, full.posterior["mu"].values)
    with pytest.raises(ValueError, match="chains=2"):
        sample_t(chains=3, trace=pmt.FileTrace(path), resume=True)


def test_resume_without_a_state_samples_afresh(tmp_path):
    path = os.path.join(str(tmp_path), "trace")
    idata = sample_t(trace=pmt.FileTrace(path), resume=True)
    np.testing.assert_array_equal(idata.posterior["mu"].values,
                                  sample_t().posterior["mu"].values)
    assert pmt.FileTrace(path).read_meta()["draws_done"] == 30


def test_chunk_rule_is_pymc_tpus():
    assert mcmc._chunk_rule(None, 1000, 4, 10, traced=True) == 200
    assert mcmc._chunk_rule(None, 5000, 4, 10, traced=False) == 1024
    assert mcmc._chunk_rule(None, 100, 4, 10, traced=False) == 100
    assert mcmc._chunk_rule(None, 1000, 1024, 10004, traced=False) == 36
    assert mcmc._chunk_rule(7, 1000, 4, 10, traced=True) == 7


@pytest.mark.parametrize("route", ["nuts", "chees", "compound"])
def test_return_inferencedata_false_gives_a_multitrace(route):
    kw = {"model": mixed_model(pmt)} if route == "compound" else {"sampler": route}
    idata = sample_t(**kw)
    trace = sample_t(return_inferencedata=False, **kw)
    assert isinstance(trace, MultiTrace) and trace.nchains == 2 and len(trace) == 30
    assert sorted(trace.varnames) == sorted(idata.posterior.keys())
    for name in trace.varnames:
        np.testing.assert_array_equal(
            trace.get_values(name), np.concatenate(list(idata.posterior[name].values)))


def test_compound_route_refuses_callback_and_trace(tmp_path):
    for kw in ({"callback": print}, {"trace": pmt.FileTrace(str(tmp_path))}):
        with pytest.raises(NotImplementedError, match="compound"):
            sample_t(model=mixed_model(pmt), **kw)


def test_radon_log_likelihood_feeds_loo_and_waic():
    config = dict(draws=20, tune=10, chains=2, random_seed=0, compute_convergence_checks=False,
                  nuts={"max_treedepth": 4}, device="cpu")
    idata = pmt.sample(model=build_model(pmt), idata_kwargs={"log_likelihood": True}, **config)
    ll = idata.log_likelihood["y"].values
    assert ll.shape == (2, 20, 919) and np.isfinite(ll).all()
    ref = pmt.compute_log_likelihood(idata, model=build_model(pmt), extend_inferencedata=False,
                                     device="cpu")
    np.testing.assert_array_equal(ll, ref["y"].values)
    loo, waic = pmt.loo(idata), pmt.waic(idata)
    assert loo.n_data_points == waic.n_data_points == 919 and loo.n_samples == 40
    assert np.isfinite([loo.elpd, loo.se, loo.p, waic.elpd, waic.se, waic.p]).all()
    assert loo.pareto_k.shape == (919,)
