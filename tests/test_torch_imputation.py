"""Imputation of missing observed values in pymc_tpu_torch against
pymc_tpu: the variables each package makes (`{name}_unobserved`,
`{name}_observed`, the deterministic `{name}`), the ImputationWarning, and
the joint logp at random points (rtol 1e-10) for the univariate, separable
and joint forms; then the change-point model sampled end to end (4 chains,
100 + 100 draws, NUTS trees cut at depth 4), held to its exact posterior
and to pymc_tpu's within 5 MCSE, with its observed counts fixed in every
draw.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from pymc_tpu.exceptions import ImputationWarning as ImputationWarningJ
from pymc_tpu_torch.exceptions import ImputationWarning
from pymc_tpu_torch.models import (
    CHANGEPOINT_SCALARS, changepoint_data, changepoint_model, changepoint_posterior,
)
from pymc_tpu_torch.stats.convergence import mcse_mean

NAN = np.nan
DATA = {
    "univariate": np.array([0.3, NAN, 1.2, -0.4, NAN, 0.8]),
    "counts": np.array([2.0, 0.0, NAN, 5.0, NAN, 1.0]),
    "joint": np.array([[0.2, NAN, 0.4], [0.1, 0.3, -0.2], [NAN, 0.5, NAN]]),
}
COV = np.array([[1.0, 0.3, 0.1], [0.3, 2.0, -0.2], [0.1, -0.2, 1.5]])


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def univariate(pm):
    with pm.Model() as m:
        mu = pm.Normal("mu", 0.0, 2.0)
        s = pm.HalfNormal("s", 1.0)
        pm.Normal("y", mu, s, observed=DATA["univariate"])
    return m


def positive(pm):
    """A positive likelihood: the missing entries take its log transform."""
    with pm.Model() as m:
        a = pm.HalfNormal("a", 2.0)
        pm.Gamma("y", a, 1.5, observed=np.array([[0.5, NAN], [2.0, 1.1], [NAN, NAN]]))
    return m


def counts(pm):
    with pm.Model() as m:
        lam = pm.Exponential("lam", 0.5)
        pm.Poisson("y", lam, observed=DATA["counts"])
    return m


def separable(pm):
    """Whole event rows missing: the missing rows are an MvNormal of their
    own."""
    data = np.array([[0.2, -0.1, 0.4], [NAN, NAN, NAN], [1.0, 0.5, -0.3], [NAN, NAN, NAN]])
    with pm.Model() as m:
        mu = pm.Normal("mu", 0.0, 1.0, shape=3)
        pm.MvNormal("y", mu, cov=COV, observed=data)
    return m


def joint(pm):
    """Entries missing inside event rows: zero-density slots and the joint
    density of the completed value."""
    with pm.Model() as m:
        mu = pm.Normal("mu", 0.0, 1.0, shape=3)
        pm.MvNormal("y", mu, cov=COV, observed=DATA["joint"])
    return m


def _build(build, pm, warning):
    with pytest.warns(warning, match="missing values"):
        return build(pm)


@pytest.mark.parametrize("build", [univariate, positive, counts, separable, joint],
                         ids=lambda f: f.__name__)
def test_imputed_model_matches_pymc_tpu(build):
    mj = _build(build, pmj, ImputationWarningJ)
    mt = _build(build, pmt, ImputationWarning)
    for attr in ("free_RVs", "observed_RVs", "deterministics"):
        assert [v.name for v in getattr(mt, attr)] == [v.name for v in getattr(mj, attr)], attr
    assert [rv.value_name for rv in mt.free_RVs] == [rv.value_name for rv in mj.free_RVs]
    assert [tuple(rv.shape) for rv in mt.free_RVs] == [tuple(rv.shape) for rv in mj.free_RVs]
    info = mt.raveled_info()
    rng = np.random.default_rng(0)
    lj, lt = mj.logp_fn(), mt.logp_fn(device="cpu")
    for _ in range(3):
        vals = {}
        for name, shape, rv in zip(info.names, info.shapes, mt.free_RVs):
            if rv.dist.is_discrete:
                vals[name] = rng.integers(0, 6, size=shape).astype(np.int64)
            else:
                vals[name] = rng.normal(0.0, 0.7, size=shape)
        ref = float(lj({k: jnp.asarray(v) for k, v in vals.items()}))
        got = float(lt({k: torch.as_tensor(v) for k, v in vals.items()}))
        assert np.isfinite(ref)
        np.testing.assert_allclose(got, ref, rtol=1e-10)


@pytest.mark.parametrize("build", [univariate, counts, joint], ids=lambda f: f.__name__)
def test_combined_value_keeps_the_data(build):
    """The deterministic y holds the data where it was observed and the
    imputed values where it was missing, in every postprocessed draw."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        m = build(pmt)
    data = DATA[build.__name__]
    mask = np.isnan(data)
    q = torch.as_tensor(np.random.default_rng(1).normal(1.0, 0.5,
                                                        (5, m.raveled_info().total_size)))
    out = m.postprocess_fn(device="cpu")(q)
    combined = out["y"].numpy()
    np.testing.assert_array_equal(combined[:, ~mask], np.broadcast_to(data[~mask], (5, (~mask).sum())))
    np.testing.assert_array_equal(combined[:, mask], out["y_unobserved"].numpy().reshape(5, -1))


def test_changepoint_samples_against_the_exact_posterior():
    """NUTS (depth 4) + Metropolis on the change-point model in both
    packages. The port is held to the exact posterior within 5 MCSE and to
    pymc_tpu within 5 combined MCSE; pymc_tpu's Metropolis uses a stale
    logp in a compound (ROADMAP.md §3), a bias of ~2.7 of its MCSE at 64 x
    1000 draws, far inside this run's."""
    config = dict(draws=100, tune=100, chains=4, random_seed=3, compute_convergence_checks=False)
    out = {}
    for name, pm in (("jax", pmj), ("torch", pmt)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            m = changepoint_model(pm)
        step = [pm.NUTS(vars=[m["early_rate"], m["late_rate"]], model=m, max_treedepth=4)]
        kw = {"progressbar": False} if pm is pmj else {"device": "cpu"}
        out[name] = pm.sample(model=m, step=step, **config, **kw).posterior
    post = out["torch"]
    unobserved = post["disasters_unobserved"].values
    assert unobserved.dtype == np.int64 and unobserved.min() >= 0
    assert post["switchpoint"].values.dtype == np.int64
    _, data = changepoint_data()
    seen = ~np.isnan(data)
    disasters = post["disasters"].values
    assert (disasters[..., seen] == data[seen]).all()
    assert (disasters[..., ~seen] == unobserved).all()
    exact = changepoint_posterior()
    for name in CHANGEPOINT_SCALARS + ("disasters_unobserved[0]", "disasters_unobserved[1]"):
        if name.startswith("disasters"):
            i = int(name[-2])
            xt = unobserved[..., i].astype(float)
            xj = out["jax"]["disasters_unobserved"].values[..., i].astype(float)
        else:
            xt, xj = post[name].values.astype(float), out["jax"][name].values.astype(float)
        z_exact = (xt.mean() - exact[name]) / mcse_mean(xt)
        z_ref = (xt.mean() - xj.mean()) / np.hypot(mcse_mean(xt), mcse_mean(xj))
        assert abs(z_exact) < 5 and abs(z_ref) < 5, (name, z_exact, z_ref)
