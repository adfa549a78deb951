"""The port's results layer against pymc_tpu on the CPU, in float64.

On identical arrays (rtol 1e-10): `summary`, `hdi`, `loo`, `waic`,
`compare` and `multitrace_from_idata`, `ChainRecordAdapter` and
`SamplerReport`. On the same
posterior of the same model built in both packages (rtol 1e-10):
`compute_log_likelihood`, `compute_log_prior` (a Normal with 30
observations, and the marginal GP at n = 12, whose MvNormal factors every
draw's covariance under vmap), `compute_deterministics` and
`vectorize_over_posterior`; `pm.logp`, `pm.logcdf` and `pm.logccdf` at rtol
1e-12 (atol 1e-15 besides, as tests/test_torch_continuous.py holds
log-cdfs within a few ulp of 1). `pm.draw` and `compile_forward_sampling_function` are held to
pymc_tpu's moments within 5 combined MCSE (the packages draw different
random numbers). FileTrace round trips as
tests/backends/test_trace_contract.py describes for pymc_tpu's.
"""

import os

import numpy as np
import pytest
import torch

import jax

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from pymc_tpu.backends import inference_data as idj
from pymc_tpu.backends.base import multitrace_from_idata as mt_j
from pymc_tpu.backends.report import SamplerReport as ReportJ
from pymc_tpu.stats.convergence import SamplerWarning as WarningJ
from pymc_tpu_torch.backends import inference_data as idt
from pymc_tpu_torch.backends.base import multitrace_from_idata as mt_t
from pymc_tpu_torch.backends.checkpoint import FileTrace
from pymc_tpu_torch.models import gp_marginal_model
from pymc_tpu_torch.stats.convergence import SamplerWarning as WarningT

RTOL = 1e-10
Y = np.random.default_rng(0).normal(1.0, 2.0, 30)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.detach().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def normal_model(pm):
    with pm.Model(coords={"obs": np.arange(30)}) as m:
        mu = pm.Normal("mu", 0, 5)
        sigma = pm.HalfNormal("sigma", 3)
        pm.Deterministic("shifted", mu + 2.0 * sigma)
        pm.Normal("y", mu, sigma, observed=Y, dims="obs")
    return m


def _idata(mod, groups):
    """An InferenceData of package `mod` (its inference_data module) whose
    groups are {group: {name: (chain, draw, ...) array}}."""
    out = mod.InferenceData()
    for g, draws in groups.items():
        out.add_group(g, mod.Dataset({
            k: mod.DataVar(k, np.array(v), ("chain", "draw") + tuple(
                f"{k}_dim_{i}" for i in range(v.ndim - 2)))
            for k, v in draws.items()
        }))
    return out


def _arrays(seed, n_obs=30, shift=0.0):
    """Draws of 3 chains of 101: an odd count, so that no folded draw ties
    with another (the port's R-hat ranks ties at their mean rank, pymc_tpu's
    by position; ROADMAP.md §3)."""
    rng = np.random.default_rng(seed)
    return {
        "posterior": {"a": rng.normal(size=(3, 101)), "b": rng.normal(size=(3, 101, 3))},
        "log_likelihood": {"y": rng.normal(-1.5 + shift, 0.4, size=(3, 101, n_obs))},
        "sample_stats": {"lp": rng.normal(size=(3, 101))},
    }


@pytest.fixture(scope="module")
def arrays():
    groups = _arrays(1)
    return _idata(idj, groups), _idata(idt, groups)


def test_hdi_on_identical_arrays(arrays):
    ij, it = arrays
    for name in ("a", "b"):
        for prob in (0.94, 0.5):
            for got, ref in zip(pmt.hdi(it.posterior[name].values, prob),
                                pmj.hdi(ij.posterior[name].values, prob)):
                np.testing.assert_allclose(got, ref, rtol=RTOL)


def test_summary_on_identical_arrays():
    """pymc_tpu's summary of a scalar variable is wrong: its rhat ranks the
    draws in place (ROADMAP.md §3), and the mean, sd, hdi and MCSEs are
    then taken of the ranks. The port is held to pymc_tpu's table with the
    diagnostics taken on copies, and pymc_tpu's own table is shown to
    differ for the scalar `a` and to agree for the vector `b`."""
    groups = _arrays(1)
    it = _idata(idt, groups)
    stats = pmj.summary(_idata(idj, groups), kind="stats", round_to=None)
    got = pmt.summary(it, kind="stats", round_to=None)
    assert list(got.index) == list(stats.index) == ["a", "b[0]", "b[1]", "b[2]"]
    assert list(got.columns) == list(stats.columns)
    np.testing.assert_allclose(got.to_numpy(float), stats.to_numpy(float), rtol=RTOL)

    got = pmt.summary(it, round_to=None)
    diagnostics = {
        "mcse_mean": pmj.stats.mcse_mean, "mcse_sd": pmj.stats.mcse_sd,
        "ess_bulk": lambda x: pmj.stats.ess(x, "bulk"),
        "ess_tail": lambda x: pmj.stats.ess(x, "tail"), "r_hat": pmj.stats.rhat,
    }
    for col, fn in diagnostics.items():
        ref = np.concatenate([np.atleast_1d(fn(np.array(groups["posterior"][n])))
                              for n in ("a", "b")])
        np.testing.assert_allclose(got[col].to_numpy(float), ref, rtol=RTOL)
    np.testing.assert_allclose(got[stats.columns].to_numpy(float), stats.to_numpy(float),
                               rtol=RTOL)
    faulty = pmj.summary(_idata(idj, groups), round_to=None)
    np.testing.assert_allclose(faulty.loc[["b[0]", "b[1]", "b[2]"]].to_numpy(float),
                               got.loc[["b[0]", "b[1]", "b[2]"]].to_numpy(float), rtol=RTOL)
    assert abs(faulty.loc["a", "mean"] - got.loc["a", "mean"]) > 1e-3
    assert list(pmt.summary(it, var_names=["a"]).index) == ["a"]


@pytest.mark.parametrize("ic", ["loo", "waic"])
def test_information_criteria_on_identical_arrays(arrays, ic):
    ij, it = arrays
    got, ref = getattr(pmt, ic)(it), getattr(pmj, ic)(ij)
    for attr in ("elpd", "se", "p", "n_samples", "n_data_points", "warning"):
        np.testing.assert_allclose(getattr(got, attr), getattr(ref, attr), rtol=RTOL)
    np.testing.assert_allclose(got.pointwise, ref.pointwise, rtol=RTOL)
    assert getattr(got, f"elpd_{ic}") == got.elpd
    if ic == "loo":
        np.testing.assert_allclose(got.pareto_k, ref.pareto_k, rtol=RTOL)
    assert repr(got) == repr(ref)


@pytest.mark.parametrize("method", ["stacking", "BB-pseudo-BMA"])
def test_compare_on_identical_arrays(method):
    models = {"m0": _arrays(2), "m1": _arrays(3, shift=0.05), "m2": _arrays(4, shift=-0.1)}
    got = pmt.compare({k: _idata(idt, v) for k, v in models.items()}, method=method)
    ref = pmj.compare({k: _idata(idj, v) for k, v in models.items()}, method=method)
    assert list(got.index) == list(ref.index) and list(got.columns) == list(ref.columns)
    np.testing.assert_allclose(got.to_numpy(float), ref.to_numpy(float), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(got["weight"].sum(), 1.0, rtol=1e-12)


def test_multitrace_from_identical_idata(arrays):
    ij, it = arrays
    got, ref = mt_t(it), mt_j(ij)
    assert (got.nchains, got.chains, got.varnames, len(got)) == (
        ref.nchains, ref.chains, ref.varnames, len(ref))
    for name in ("a", "b"):
        np.testing.assert_array_equal(got.get_values(name), ref.get_values(name))
        np.testing.assert_array_equal(got[name], ref[name])
        for g, r in zip(got.get_values(name, burn=10, thin=3, combine=False),
                        ref.get_values(name, burn=10, thin=3, combine=False)):
            np.testing.assert_array_equal(g, r)
    for k, v in ref.point(7, chain=0).items():
        np.testing.assert_array_equal(got.point(7, chain=0)[k], v)


def test_chain_record_adapter_matches_pymc_tpus(tmp_path):
    """Points recorded through the adapter into each package's FileTrace,
    in chunks of 4, read back the same, also after reopening the store."""
    from pymc_tpu.backends.base import ChainRecordAdapter as AdapterJ
    from pymc_tpu.backends.checkpoint import FileTrace as FileTraceJ
    from pymc_tpu_torch.backends.base import ChainRecordAdapter as AdapterT

    rng = np.random.default_rng(11)
    points = [{"a": rng.normal(), "b": rng.normal(size=(2, 3))} for _ in range(10)]
    out = []
    for adapter, store in ((AdapterJ, FileTraceJ), (AdapterT, FileTrace)):
        path = str(tmp_path / adapter.__module__)
        rec = adapter(store(path, use_native_writer=False), chunk_size=4)
        for i, pt in enumerate(points):
            rec.record(pt, {"lp": -float(i), "tree_depth": i % 3})
        assert len(rec) == 10 and rec.varnames == ["a", "b"]
        rec.close()
        again = adapter(store(path, use_native_writer=False))
        out.append((again.get_values("b", burn=2, thin=3), again.get_sampler_stats("lp"),
                    again.point(5)["b"], len(again)))
    for got, ref in zip(out[1], out[0]):
        np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(out[1][2], points[5]["b"])


def test_sampler_report_is_pymc_tpus():
    for level in ("info", "warn", "error"):
        got = pmt.SamplerReport([WarningT("kind", "message", level)])
        ref = ReportJ([WarningJ("kind", "message", level)])
        assert (got.ok, got._log_summary, repr(got)) == (ref.ok, ref._log_summary, repr(ref))


def _posterior(seed, C=2, S=40):
    rng = np.random.default_rng(seed)
    return {"mu": rng.normal(1.0, 0.3, (C, S)), "sigma": rng.gamma(9.0, 0.2, (C, S))}


def _both_idata(build, posterior):
    return (pmj.backends.arviz.to_inference_data(build(pmj), posterior=posterior),
            pmt.to_inference_data(build(pmt), posterior=posterior))


@pytest.mark.parametrize("fn", ["compute_log_likelihood", "compute_log_prior"])
def test_log_densities_on_the_same_posterior(fn):
    post = _posterior(5)
    ij, it = _both_idata(normal_model, post)
    ref = getattr(pmj, fn)(ij, model=normal_model(pmj), extend_inferencedata=False)
    got = getattr(pmt, fn)(it, model=normal_model(pmt), extend_inferencedata=False,
                           device="cpu")
    assert sorted(got.keys()) == sorted(ref.keys())
    for k in ref.keys():
        assert got[k].dims == ref[k].dims and got[k].shape == ref[k].shape
        np.testing.assert_allclose(got[k].values, ref[k].values, rtol=RTOL)
    group = "log_likelihood" if fn == "compute_log_likelihood" else "log_prior"
    out = getattr(pmt, fn)(it, model=normal_model(pmt), device="cpu")
    assert out is it and group in it.groups()


def test_log_likelihood_var_names_must_be_observed():
    _, it = _both_idata(normal_model, _posterior(5))
    with pytest.raises(ValueError, match="observed_RVs"):
        pmt.compute_log_likelihood(it, model=normal_model(pmt), var_names=["mu"], device="cpu")


def test_gp_log_likelihood_factors_each_draw_under_vmap(monkeypatch):
    """The MvNormal likelihood of the marginal GP over 150 draws in chunks
    of 64: three chunks, each one batched Cholesky call, and the values
    pymc_tpu's."""
    from pymc_tpu_torch.distributions import multivariate
    from pymc_tpu_torch.gp import gp
    from pymc_tpu_torch.ops.linalg import cholesky_batched
    from pymc_tpu_torch.sampling import forward

    rng = np.random.default_rng(6)
    post = {"ls": rng.gamma(20.0, 0.1, (3, 50)), "eta": rng.gamma(20.0, 0.1, (3, 50)),
            "sigma": rng.gamma(20.0, 0.02, (3, 50))}
    ij, it = _both_idata(lambda pm: gp_marginal_model(12, pm=pm), post)
    ref = pmj.compute_log_likelihood(ij, model=gp_marginal_model(12, pm=pmj),
                                     extend_inferencedata=False)
    monkeypatch.setattr(forward, "POSTERIOR_CHUNK", 64)
    calls = []

    def counting(a):
        if a.device.type != "meta":  # a node's shape inference runs it on meta
            calls.append(tuple(a.shape))
        return cholesky_batched(a)

    for module in (gp, multivariate):
        monkeypatch.setattr(module, "cholesky_batched", counting)
    got = pmt.compute_log_likelihood(it, model=gp_marginal_model(12), extend_inferencedata=False,
                                     device="cpu")
    assert got["y"].shape == ref["y"].shape == (3, 50)
    np.testing.assert_allclose(got["y"].values, ref["y"].values, rtol=RTOL)
    assert len(calls) == 3, calls


def test_compute_deterministics_on_the_same_posterior():
    post = _posterior(7)
    ij, it = _both_idata(normal_model, post)
    ref = pmj.compute_deterministics(ij, model=normal_model(pmj))
    got = pmt.compute_deterministics(it, model=normal_model(pmt), device="cpu")
    np.testing.assert_allclose(got["shifted"].values, ref["shifted"].values, rtol=RTOL)
    assert got["shifted"].dims == ref["shifted"].dims
    merged = pmt.compute_deterministics(it, model=normal_model(pmt), merge_dataset=True,
                                        device="cpu")
    assert "shifted" in merged and merged is it.posterior


def test_vectorize_over_posterior_on_the_same_posterior():
    post = _posterior(8)
    ij, it = _both_idata(normal_model, post)

    def fn(stack):
        def f(env):
            return {"ratio": env["mu"] / env["sigma"], "pair": stack([env["mu"], env["sigma"]])}
        return f

    ref = pmj.sampling.forward.vectorize_over_posterior(fn(jax.numpy.stack), ij,
                                                        model=normal_model(pmj))
    got = pmt.vectorize_over_posterior(fn(torch.stack), it, model=normal_model(pmt),
                                       device="cpu")
    for k in ("ratio", "pair"):
        assert got[k].shape == np.asarray(ref[k]).shape
        np.testing.assert_allclose(got[k], ref[k], rtol=RTOL)
    # the reference form: outputs of the input RVs only are deterministic
    mj, mt = normal_model(pmj), normal_model(pmt)
    ref = pmj.sampling.forward.vectorize_over_posterior(
        outputs=[mj["shifted"]], posterior=ij.posterior, input_rvs=[mj["mu"], mj["sigma"]])
    got = pmt.vectorize_over_posterior(
        outputs=[mt["shifted"]], posterior=it.posterior, input_rvs=[mt["mu"], mt["sigma"]],
        device="cpu")
    np.testing.assert_allclose(got[0], ref[0], rtol=RTOL)
    with pytest.raises(RuntimeError, match="resampled"):
        pmt.vectorize_over_posterior(outputs=[mt["shifted"]], posterior=it.posterior,
                                     input_rvs=[mt["mu"]], allow_rvs_in_graph=False,
                                     device="cpu")


def test_vectorize_outputs_resamples_the_other_rvs():
    """sigma is drawn anew at each draw from its HalfNormal(3) prior: the
    mean of shifted - mu = 2 sigma is 2 * 3 sqrt(2 / pi)."""
    mt = normal_model(pmt)
    it = pmt.to_inference_data(mt, posterior={"mu": np.zeros((4, 1000))})
    out = pmt.vectorize_over_posterior(outputs=[mt["shifted"]], posterior=it.posterior,
                                       input_rvs=[mt["mu"]], random_seed=1, device="cpu")[0]
    assert out.shape == (4, 1000)
    expected, sd = 6.0 * np.sqrt(2.0 / np.pi), 6.0 * np.sqrt(1.0 - 2.0 / np.pi)
    assert abs(out.mean() - expected) < 5 * sd / np.sqrt(out.size)


DENSITY_CASES = {
    "normal": (lambda pm: pm.Normal.dist(1.0, 2.0), [-3.0, 0.5, 1.0, 9.0, 40.0]),
    "exponential": (lambda pm: pm.Exponential.dist(1.5), [0.0, 0.2, 3.0, 30.0]),
    "weibull": (lambda pm: pm.Weibull.dist(1.7, 2.0), [0.1, 1.0, 4.0, 12.0]),
    "gamma": (lambda pm: pm.Gamma.dist(2.0, 1.5), [0.1, 1.0, 4.0]),
    "poisson": (lambda pm: pm.Poisson.dist(3.5), [0, 1, 4, 12]),
}


@pytest.mark.parametrize("fn", ["logp", "logcdf", "logccdf"])
@pytest.mark.parametrize("case", sorted(DENSITY_CASES))
def test_functional_densities_match(case, fn):
    build, values = DENSITY_CASES[case]
    values = np.asarray(values)
    ref = _np(getattr(pmj, fn)(build(pmj), values))
    got = _np(getattr(pmt, fn)(build(pmt), values))
    np.testing.assert_allclose(got, ref, rtol=1e-12, atol=1e-15)


def test_functional_densities_of_model_variables():
    """y's distribution reads mu and sigma: they come from `env`."""
    mj, mt = normal_model(pmj), normal_model(pmt)
    env_j = {"mu": jax.numpy.float64(1.5), "sigma": jax.numpy.float64(0.7)}
    env_t = {"mu": torch.tensor(1.5, dtype=torch.float64),
             "sigma": torch.tensor(0.7, dtype=torch.float64)}
    for name in ("mu", "y"):
        for fn in ("logp", "logcdf", "logccdf"):
            np.testing.assert_allclose(_np(getattr(pmt, fn)(mt[name], Y, env=env_t)),
                                       _np(getattr(pmj, fn)(mj[name], Y, env=env_j)),
                                       rtol=1e-12, atol=1e-15)


def test_icdf_and_derived_densities_raise():
    # named when pm.icdf raised too; now its quantiles match pymc_tpu's,
    # and only a derived expression's density or quantile raises
    mt, mj = normal_model(pmt), normal_model(pmj)
    q = np.array([0.1, 0.5, 0.9])
    np.testing.assert_allclose(_np(pmt.icdf(pmt.Normal.dist(0.0, 1.0), q)),
                               np.asarray(pmj.icdf(pmj.Normal.dist(0.0, 1.0), q)), rtol=1e-12)
    np.testing.assert_allclose(_np(pmt.icdf(mt["sigma"], q)), np.asarray(pmj.icdf(mj["sigma"], q)),
                               rtol=1e-12)
    with pytest.raises(NotImplementedError, match="logprob engine"):
        pmt.logp(mt["shifted"], np.array([1.0]))
    with pytest.raises(NotImplementedError, match="logprob engine"):
        pmt.icdf(mt["shifted"], q)


def _z(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    se = np.hypot(got.std(axis=0) / np.sqrt(len(got)), ref.std(axis=0) / np.sqrt(len(ref)))
    return np.abs(got.mean(axis=0) - ref.mean(axis=0)) / se


def test_draw_moments_match():
    n = 4000
    assert _z(pmt.draw(pmt.Normal.dist(2.0, 3.0, shape=3), n, random_seed=1, device="cpu"),
              pmj.draw(pmj.Normal.dist(2.0, 3.0, shape=3), n, random_seed=1)).max() < 5
    mj, mt = normal_model(pmj), normal_model(pmt)
    for name in ("mu", "sigma", "shifted"):
        got = pmt.draw(mt[name], n, random_seed=2, device="cpu")
        ref = pmj.draw(mj[name], n, random_seed=2)
        assert got.shape == ref.shape
        assert _z(got, ref).max() < 5, name
        assert _z(got ** 2, np.asarray(ref) ** 2).max() < 5, name
    # pymc_tpu's draw raises for y, whose distribution reads mu and sigma;
    # the port draws them with it: y = mu + sigma e, mean 0, variance 25 + 9
    with pytest.raises(KeyError):
        pmj.draw(mj["y"], 5, random_seed=2)
    y = _np(pmt.draw(mt["y"], n, random_seed=2, device="cpu"))
    assert y.shape == (n, 30)
    assert np.abs(y.mean(axis=0)).max() < 5 * np.sqrt(34.0 / n)
    assert abs((y ** 2).mean() - 34.0) < 5 * np.sqrt(2 * 34.0 ** 2 / n)
    pair = pmt.draw([mt["mu"], mt["sigma"]], 5, random_seed=3, device="cpu")
    assert [p.shape for p in pair] == [(5,), (5,)]
    assert pmt.draw(mt["mu"], random_seed=4, device="cpu").shape == ()


def test_compile_forward_sampling_function_moments_match():
    mj, mt = normal_model(pmj), normal_model(pmt)
    given = {"mu": 1.5, "sigma": 0.5}
    fj, vol_j = pmj.compile_forward_sampling_function(outputs=[mj["y"], mj["shifted"]],
                                                      vars_in_trace=[mj["mu"], mj["sigma"]],
                                                      model=mj)
    ft, vol_t = pmt.compile_forward_sampling_function(outputs=[mt["y"], mt["shifted"]],
                                                      vars_in_trace=[mt["mu"], mt["sigma"]],
                                                      model=mt, device="cpu")
    assert vol_t == vol_j == ["y"]
    n = 2000
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    ref = jax.vmap(lambda k: fj(k, {k2: np.float64(v) for k2, v in given.items()}))(keys)
    gen = torch.Generator().manual_seed(0)
    got = torch.func.vmap(lambda _: ft(gen, given), randomness="different")(torch.empty(n))
    assert sorted(got) == sorted(ref) == ["shifted", "y"]
    np.testing.assert_allclose(_np(got["shifted"]), 2.5, rtol=1e-12)
    assert _z(_np(got["y"]), np.asarray(ref["y"])).max() < 5
    assert _z(_np(got["y"]) ** 2, np.asarray(ref["y"]) ** 2).max() < 5
    prior = pmt.compile_forward_sampling_function(model=mt, device="cpu")[0](gen)
    assert sorted(prior) == ["mu", "shifted", "sigma", "y"] and prior["y"].shape == (30,)


class TestFileTraceContract:
    def _mk(self, tmp_path, use_native):
        return FileTrace(os.path.join(tmp_path, f"tr_{use_native}"), overwrite=True,
                         use_native_writer=use_native)

    @pytest.mark.parametrize("use_native", [False, True])
    def test_chunk_roundtrip(self, tmp_path, use_native):
        tr = self._mk(str(tmp_path), use_native)
        rng = np.random.default_rng(0)
        chunks = [rng.normal(size=(5, 3, 4)).astype(np.float32) for _ in range(3)]
        for i, c in enumerate(chunks):
            tr.write_chunk(torch.as_tensor(c) if i else c, {"lp": np.full((5, 3), float(i))})
            tr.write_meta({"draws_done": (i + 1) * 5, "chains": 3, "D": 4})
        tr.close()
        q, stats = tr.read_draws()
        np.testing.assert_array_equal(q, np.concatenate(chunks, axis=0))
        assert q.dtype == np.float32 and stats["lp"].shape == (15, 3)
        np.testing.assert_allclose(stats["lp"][5:10], 1.0)
        assert tr.read_meta()["draws_done"] == 15

    @pytest.mark.parametrize("use_native", [False, True])
    def test_state_snapshot_roundtrip(self, tmp_path, use_native):
        tr = self._mk(str(tmp_path), use_native)
        gen = torch.Generator().manual_seed(3)
        state = {"q": torch.arange(6.0).reshape(2, 3), "eps": torch.tensor(0.5, dtype=torch.float32),
                 "count": torch.tensor([1, 2], dtype=torch.int32), "rng": gen.get_state()}
        expected = torch.rand(4, generator=gen)
        tr.save_state(state)
        tr.close()
        back = tr.load_state()
        assert torch.equal(back["q"], state["q"]) and float(back["eps"]) == 0.5
        assert back["eps"].dtype == torch.float32 and back["count"].dtype == torch.int32
        gen2 = torch.Generator().set_state(back["rng"])
        assert torch.equal(torch.rand(4, generator=gen2), expected)
        assert not any(f.startswith(".") for f in os.listdir(tr.path))
        assert FileTrace(os.path.join(str(tmp_path), "empty")).load_state() is None

    @pytest.mark.parametrize("use_native", [False, True])
    def test_orphaned_tmp_files_ignored(self, tmp_path, use_native):
        tr = self._mk(str(tmp_path), use_native)
        tr.write_chunk(np.ones((2, 1, 1), np.float32), {"lp": np.zeros((2, 1))})
        tr.close()
        with open(os.path.join(tr.path, ".chunk_00001.npz.tmp"), "wb") as f:
            f.write(b"torn partial write")
        assert tr.n_chunks == 1
        q, _ = tr.read_draws()
        assert q.shape == (2, 1, 1)
        tr2 = FileTrace(tr.path, use_native_writer=use_native)
        tr2.write_chunk(np.full((2, 1, 1), 2.0, np.float32), {"lp": np.zeros((2, 1))})
        tr2.close()
        q, _ = tr2.read_draws()
        assert q.shape == (4, 1, 1)
        np.testing.assert_allclose(q[2:], 2.0)

    def test_monotonic_chunk_numbering(self, tmp_path):
        tr = self._mk(str(tmp_path), False)
        for _ in range(4):
            tr.write_chunk(np.zeros((1, 1, 1), np.float32), {"lp": np.zeros((1, 1))})
        tr.close()
        names = sorted(f for f in os.listdir(tr.path) if f.startswith("chunk_"))
        assert names == [f"chunk_{i:05d}.npz" for i in range(4)]

    def test_overwrite_semantics(self, tmp_path):
        path = os.path.join(str(tmp_path), "tr")
        tr = FileTrace(path, overwrite=True, use_native_writer=False)
        tr.write_chunk(np.zeros((2, 1, 1), np.float32), {"lp": np.zeros((2, 1))})
        tr.close()
        tr2 = FileTrace(path, overwrite=True, use_native_writer=False)
        tr2.close()
        q, stats = tr2.read_draws()
        assert q is None and stats == {}

    def test_truncate_drops_a_chunk_written_after_the_state(self, tmp_path):
        tr = self._mk(str(tmp_path), False)
        for i in range(3):
            tr.write_chunk(np.full((2, 1, 1), float(i), np.float32), {"lp": np.zeros((2, 1))})
        tr.truncate(4)
        q, _ = tr.read_draws()
        assert q.shape == (4, 1, 1) and tr.n_chunks == 2
        tr.write_chunk(np.full((2, 1, 1), 9.0, np.float32), {"lp": np.zeros((2, 1))})
        q, _ = tr.read_draws()
        np.testing.assert_array_equal(q[:, 0, 0], [0, 0, 1, 1, 9, 9])
        with pytest.raises(ValueError, match="holds 6 draws"):
            tr.truncate(5)
