"""The init family of pymc_tpu_torch.sample on the CPU.

Every init of pymc_tpu's SUPPORTED_INITS samples a correlated 3-D
Gaussian, with its means and variances within 5 MCSE of the analytic ones
(8 chains, tune and draws 30, trees cut at depth 3, ADVI cut to 300
steps, for time). advi+adapt_diag on Eight Schools is held to pymc_tpu's
same init within 4 combined MCSE. The unknown init raises the JAX
package's ValueError; mesh and chain_method, which the port has not ported,
raise NotImplementedError, and each other argument of pymc_tpu.sample acts;
the ones that do nothing on one device are accepted; `nuts=` and
`mass_matrix=` act. `init_nuts` gives the
starting points of each init.
"""

import numpy as np
import pytest
import torch

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from pymc_tpu.sampling.mcmc import SUPPORTED_INITS as JAX_INITS
from pymc_tpu_torch.sampling.mcmc import SUPPORTED_INITS
from pymc_tpu_torch.stats.convergence import mcse_mean
from test_torch_vi import COV, MU, eight_schools, gaussian


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


FAST = dict(draws=30, tune=30, chains=8, random_seed=1, device="cpu",
            compute_convergence_checks=False, n_init=300, nuts={"max_treedepth": 3})


def test_the_init_family_is_the_jax_packages():
    assert SUPPORTED_INITS == JAX_INITS


@pytest.mark.parametrize("init", sorted(SUPPORTED_INITS))
def test_every_init_samples_a_correlated_gaussian(init):
    idata = pmt.sample(model=gaussian(pmt), init=init, **FAST)
    a = idata.posterior.attrs
    assert a["init"] == init
    assert a["mass_matrix"] == ("full" if "adapt_full" in init or init == "map" else "diag")
    x = idata.posterior["x"].values
    assert x.shape == (8, 30, 3) and np.isfinite(x).all()
    for k in range(3):
        z_mean = (x[..., k].mean() - MU[k]) / mcse_mean(x[..., k])
        sq = (x[..., k] - MU[k]) ** 2
        z_var = (sq.mean() - COV[k, k]) / mcse_mean(sq)
        assert abs(z_mean) < 5 and abs(z_var) < 5, (k, z_mean, z_var)
    if a["mass_matrix"] == "full":
        assert a["inv_mass"].shape == (3, 3)
        np.testing.assert_allclose(a["inv_mass"], a["inv_mass"].T, rtol=1e-12)
    if "advi" in init:
        assert a["init_loss"].shape == (300,) and a["init_host_reads"] == 3
    if init == "map":
        assert a["init_evaluations"] > 0


def test_advi_init_on_eight_schools_matches_jax():
    config = dict(draws=60, tune=60, chains=4, random_seed=3, compute_convergence_checks=False,
                  init="advi+adapt_diag", n_init=300)
    idata_j = pmj.sample(model=eight_schools(pmj), progressbar=False, **config)
    idata_t = pmt.sample(model=eight_schools(pmt), device="cpu", **config)
    for name in ("mu", "tau", "theta_t", "theta"):
        xj = idata_j.posterior[name].values.reshape(4, 60, -1)
        xt = idata_t.posterior[name].values.reshape(4, 60, -1)
        for k in range(xj.shape[-1]):
            se = np.hypot(mcse_mean(xj[..., k]), mcse_mean(xt[..., k]))
            z = (xt[..., k].mean() - xj[..., k].mean()) / se
            assert abs(z) < 4, (name, k, z)


def test_unknown_init_raises_the_jax_packages_error():
    for pm, kw in ((pmj, {}), (pmt, {"device": "cpu"})):
        with pytest.raises(ValueError) as err:
            pm.sample(draws=2, tune=2, chains=1, model=gaussian(pm), init="nope", **kw)
        messages = getattr(test_unknown_init_raises_the_jax_packages_error, "m", [])
        messages.append(str(err.value))
        test_unknown_init_raises_the_jax_packages_error.m = messages
    assert messages[0] == messages[1]
    with pytest.raises(ValueError, match="Unknown initializer"):
        pmt.init_nuts(init="adapt_fuller", model=gaussian(pmt), device="cpu")


def _callback_calls(calls):
    def cb(draws_done, draws, chains, stats):
        calls.append(draws_done)

    return cb


@pytest.mark.parametrize("kwargs", [
    {"discard_tuned_samples": False}, {"callback": None},
    {"trace": None}, {"resume": True}, {"chunk_size": 10}, {"postprocessing_chunks": 4},
    {"mesh": object()}, {"keep_warning_stat": True}, {"chain_method": "parallel"},
    {"idata_kwargs": {"log_likelihood": True}},
], ids=lambda kw: next(iter(kw)))
def test_arguments_not_ported_raise(kwargs, tmp_path):
    """mesh and another chain_method wait for parallel/mesh.py and raise;
    every other argument of pymc_tpu.sample acts as it does there
    (tests/test_torch_sample_rest.py holds each one to pymc_tpu)."""
    name = next(iter(kwargs))
    run = dict(draws=4, tune=2, chains=1, model=gaussian(pmt), device="cpu",
               compute_convergence_checks=False, random_seed=0)
    if name in ("mesh", "chain_method"):
        with pytest.raises(NotImplementedError, match=name):
            pmt.sample(**run, **kwargs)
        return
    calls, path = [], str(tmp_path / "trace")
    if name == "callback":
        kwargs = {"callback": _callback_calls(calls), "chunk_size": 3}
    if name == "trace":
        kwargs = {"trace": pmt.FileTrace(path)}
    if name == "resume":
        pmt.sample(**run, trace=pmt.FileTrace(path))
        kwargs = {"resume": True, "trace": pmt.FileTrace(path)}
    if name == "chunk_size":
        kwargs = {"chunk_size": 3, "callback": _callback_calls(calls)}
    var = "x"
    if name == "idata_kwargs":
        run["model"], var = eight_schools(pmt), "theta"
    idata = pmt.sample(**run, **kwargs)
    plain = pmt.sample(**run)
    x = idata.posterior[var].values
    if name == "discard_tuned_samples":
        assert idata.warmup_posterior["x"].shape == (1, 2, 3)
        assert idata.warmup_sample_stats["step_size"].shape == (1, 2)
    elif name == "idata_kwargs":
        assert idata.log_likelihood["obs"].shape == (1, 4, 8)
    elif name in ("callback", "chunk_size"):
        assert calls == [3, 4]
    elif name == "trace":
        q, stats = pmt.FileTrace(path).read_draws()
        assert q.shape == (4, 1, 3) and stats["lp"].shape == (4, 1)
    elif name == "resume":
        assert x.shape == (1, 4, 3)  # every persisted draw, none drawn anew
    np.testing.assert_array_equal(x, plain.posterior[var].values)


def test_step_samples():
    """step= is ported: it goes to compound sampling (step_methods/)."""
    model = gaussian(pmt)
    idata = pmt.sample(draws=30, tune=30, chains=3, model=model, device="cpu", random_seed=0,
                       step=pmt.Metropolis(model=model), compute_convergence_checks=False)
    assert idata.posterior.attrs["stepper"].startswith("CompoundStep([Metropolis(")
    assert set(idata.sample_stats.keys()) == {"accept_rate", "scaling", "accepted"}
    for name in idata.posterior.keys():
        assert idata.posterior[name].shape[:2] == (3, 30)


def test_unknown_keyword_raises():
    with pytest.raises(TypeError):
        pmt.sample(draws=2, tune=2, chains=1, model=gaussian(pmt), device="cpu", nonsense=1)
    with pytest.raises(ValueError, match="mass_matrix"):
        pmt.sample(draws=2, tune=2, chains=1, model=gaussian(pmt), device="cpu",
                   mass_matrix="dense")


def test_arguments_that_act():
    base = dict(draws=5, tune=5, chains=2, model=gaussian(pmt), device="cpu", random_seed=0,
                compute_convergence_checks=False)
    idata = pmt.sample(nuts={"max_treedepth": 1, "target_accept": 0.9, "use_pallas": True},
                       **base)
    assert idata.sample_stats["tree_depth"].values.max() <= 1
    assert idata.posterior.attrs["max_treedepth"] == 1
    full = pmt.sample(mass_matrix="full", **base)
    assert full.posterior.attrs["mass_matrix"] == "full"
    # initvals move the start: with jitter 0 every chain starts there
    start = pmt.init_nuts(init="adapt_diag", chains=3, model=gaussian(pmt), device="cpu",
                          initvals={"x": np.array([5.0, 5.0, 5.0])}, random_seed=0)[0]
    torch.testing.assert_close(start["x"], torch.full((3, 3), 5.0, dtype=torch.float64))


def test_init_nuts():
    model = gaussian(pmt)
    for init, spread in (("adapt_diag", False), ("jitter+adapt_diag", True),
                         ("advi", True), ("map", False)):
        pts, name = pmt.init_nuts(init=init, chains=4, model=model, random_seed=2,
                                  device="cpu", n_init=300)
        assert name == init and pts["x"].shape == (4, 3)
        assert bool((pts["x"].std(dim=0) > 0).all()) == spread
    pts, _ = pmt.init_nuts(init="map", chains=2, model=model, device="cpu")
    torch.testing.assert_close(pts["x"][0], torch.as_tensor(MU), rtol=1e-5, atol=1e-5)
    assert pmt.init_nuts(init="auto", model=model, device="cpu")[1] == "jitter+adapt_diag"


def test_graphed_logp_grad_on_the_cpu_is_the_eager_call():
    """On the card the logp+grad replays a CUDA graph; CPU tensors pass
    straight through to the eager function (the capture and replay are held
    to the eager call on the card by chip_smoke.py phase 4)."""
    model = eight_schools(pmt)
    q = torch.as_tensor(np.random.default_rng(0).normal(size=(3, 10)))
    graphed = model.logp_dlogp_fn(device="cpu")
    eager = graphed.fn
    for _ in range(3):
        for a, b in zip(graphed(q), eager(q)):
            assert torch.equal(a, b)
    assert graphed.graphs == {}
