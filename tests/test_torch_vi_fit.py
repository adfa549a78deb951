"""`fit` of pymc_tpu_torch against pymc_tpu, fed the same draws
(`test_torch_vi.JaxVIDraws`), in float64 on the CPU: ADVI, FullRankADVI,
SVGD and a Blocked KLqp for 50 steps at rtol 1e-8, on Eight Schools and a
correlated 3-D Gaussian; CheckParametersConvergence stops at the same
step; the NaN guard, one host read a chunk; the fitted approximation's
draws, views and sample_node; Empirical from a trace; ASVGD.
"""

import numpy as np
import pytest
import torch


import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from test_torch_vi import MODELS, MU, JaxVIDraws, _blocked, _t, eight_schools, gaussian


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FITS = [("advi", "eight_schools"), ("fullrank_advi", "eight_schools"), ("advi", "gaussian"),
        ("fullrank_advi", "gaussian")]


@pytest.mark.parametrize("method, model", FITS)
def test_fit_matches_jax(method, model):
    N = 50
    aj = pmj.fit(n=N, method=method, model=MODELS[model](pmj), random_seed=3, progressbar=False,
                 obj_optimizer=pmj.adam(0.05) if model == "gaussian" else None)
    at = pmt.fit(n=N, method=method, model=MODELS[model](pmt), random_seed=3, device="cpu",
                 obj_optimizer=pmt.adam(0.05) if model == "gaussian" else None,
                 draws=JaxVIDraws(3, N))
    for k in aj.params:
        np.testing.assert_allclose(at.params[k].numpy(), np.asarray(aj.params[k]), rtol=1e-8,
                                   atol=1e-12)
    np.testing.assert_allclose(at.hist, aj.hist, rtol=1e-8)
    assert at.hist.shape == (N,)


@pytest.mark.parametrize("model", ["eight_schools", "gaussian"])
def test_svgd_fit_matches_jax(model):
    sj = pmj.SVGD(n_particles=8, model=MODELS[model](pmj), random_seed=1)
    st = pmt.SVGD(n_particles=8, model=MODELS[model](pmt), random_seed=1, device="cpu")
    assert st.params["particles"].shape == sj.params["particles"].shape
    st.params = {"particles": _t(sj.params["particles"])}
    aj, at = sj.fit(50, chunk=25), st.fit(50, chunk=25)
    np.testing.assert_allclose(at.params["particles"].numpy(),
                               np.asarray(aj.params["particles"]), rtol=1e-8, atol=1e-12)
    np.testing.assert_allclose(at.hist, aj.hist, rtol=1e-8)
    assert st.host_reads.count == 2  # one read a chunk


def test_blocked_klqp_fit_matches_jax():
    aj, at = _blocked(pmj, eight_schools(pmj)), _blocked(pmt, eight_schools(pmt))
    N = 50
    fj = pmj.KLqp(aj, random_seed=2).fit(N, progressbar=False)
    ft = pmt.KLqp(at, random_seed=2).fit(N, draws=JaxVIDraws(2, N))
    for g, d in fj.params.items():
        for k, v in d.items():
            np.testing.assert_allclose(ft.params[g][k].numpy(), np.asarray(v), rtol=1e-8,
                                       atol=1e-12)


def test_convergence_callback_stops_at_the_same_step():
    N, every = 1000, 50
    kw = dict(every=every, tolerance=0.2, diff="absolute")
    cb_j = pmj.variational.CheckParametersConvergence(**kw)
    cb_t = pmt.variational.CheckParametersConvergence(**kw)
    tr = pmt.variational.Tracker(mu0=lambda approx, hist, i: approx.params["mu"][0])
    aj = pmj.fit(n=N, model=gaussian(pmj), random_seed=4, progressbar=False, callbacks=[cb_j],
                 obj_optimizer=pmj.adam(0.05), chunk=every)
    at = pmt.fit(n=N, model=gaussian(pmt), random_seed=4, device="cpu", callbacks=[cb_t, tr],
                 obj_optimizer=pmt.adam(0.05), chunk=every, draws=JaxVIDraws(4, N, every))
    assert every <= at.hist.size == aj.hist.size < N
    assert len(tr["mu0"]) == at.hist.size // every
    np.testing.assert_allclose(at.params["mu"].numpy(), np.asarray(aj.params["mu"]), rtol=1e-8)


def test_nan_guard_and_floating_point_error():
    it = pmt.ADVI(model=gaussian(pmt), random_seed=0, device="cpu")
    with pytest.raises(FloatingPointError):
        it.fit(20, obj_optimizer=pmt.sgd(float("nan")), chunk=10)
    # one non-finite update (the 3rd) is skipped; the others apply
    calls = []

    def update(g, state, params=None):
        calls.append(1)
        bad = float("nan") if len(calls) == 3 else -0.01
        return {k: bad * v for k, v in g.items()}, state

    opt = pmt.variational.updates.GradientTransformation(lambda p: (), update)
    it = pmt.ADVI(model=gaussian(pmt), random_seed=0, device="cpu")
    approx = it.fit(10, obj_optimizer=opt, chunk=5)
    assert torch.isfinite(approx.params["mu"]).all() and len(calls) == 10
    assert it.host_reads.count == 2
    assert not torch.equal(approx.params["mu"], torch.zeros(3))


def test_approximation_views():
    approx = pmt.fit(n=300, model=eight_schools(pmt), random_seed=0, device="cpu")
    idata = approx.sample(draws=50, random_seed=1)
    assert idata.posterior["theta"].shape == (1, 50, 8)
    assert idata.posterior["tau"].values.min() > 0
    state = approx.state
    assert set(state.mean) == {"mu", "tau", "theta_t"} and state.std is not None
    assert approx.mean_data["tau_log__"].values.shape == ()
    assert approx.std_data["theta_t"].dims == ("school",)
    model = approx.model
    node = model["mu"] + model["tau"]
    draws = approx.sample_node(node, size=20, random_seed=2)
    assert draws.shape == (20,)
    mean = approx.sample_node(node, deterministic=True)
    torch.testing.assert_close(mean, approx.params["mu"][0] + torch.exp(approx.params["mu"][1]))
    assert approx.sample_node(node, more_replacements={model["mu"]: 100.0},
                              deterministic=True) > 99
    post = pmt.sample_approx(approx, draws=10, random_seed=0)
    assert post.posterior["mu"].shape == (1, 10)
    fr = pmt.fit(n=50, method="fullrank_advi", model=gaussian(pmt), random_seed=0, device="cpu")
    assert fr.cov.shape == (3, 3)


def test_empirical_from_trace_and_asvgd():
    idata = pmt.sample(draws=20, tune=20, chains=2, model=eight_schools(pmt), random_seed=0,
                       device="cpu", compute_convergence_checks=False)
    emp = pmt.Empirical(idata, model=eight_schools(pmt), device="cpu")
    assert emp.params["particles"].shape == (40, 10)
    np.testing.assert_allclose(emp.mean["mu"].numpy(), idata.posterior["mu"].values.mean(),
                               rtol=1e-10)
    assert pmt.Empirical(idata, model=eight_schools(pmt), size=7, device="cpu").params[
        "particles"].shape == (7, 10)
    with pytest.warns(UserWarning, match="experimental"):
        with pytest.raises(TypeError):
            pmt.ASVGD(model=gaussian(pmt), start={"x": MU}, device="cpu")
    with pytest.raises(KeyError):
        pmt.fit(n=1, method="nope", model=gaussian(pmt), device="cpu")
