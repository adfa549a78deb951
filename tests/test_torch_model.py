"""Models built in both packages: layout, logp and gradient, support point,
and deterministics recomputed from flat draws.

The radon GLM of bench.build_model and Eight Schools are built through
pymc_tpu and pymc_tpu_torch from the same numpy data. Tolerances in
float64: logp and grad rtol 1e-10 (grad atol 1e-10 for entries near 0),
support point and deterministics rtol 1e-12.
"""

import numpy as np
import pytest
import torch

import jax

from bench import build_model
import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from pymc_tpu.blocking import unravel_vector
from pymc_tpu.initial_point import make_initial_point
from pymc_tpu.sampling.mcmc import _make_postprocess_fn
from pymc_tpu_torch.blocking import ravel_point
from pymc_tpu_torch.blocking import unravel_vector as unravel_t
from pymc_tpu_torch.convert import point_from_numpy
from pymc_tpu_torch.initial_point import support_point_values


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def eight_schools(pm):
    y = np.array([28.0, 8.0, -3.0, 7.0, -1.0, 1.0, 18.0, 12.0])
    sigma = np.array([15.0, 10.0, 16.0, 11.0, 9.0, 11.0, 10.0, 18.0])
    with pm.Model(coords={"school": np.arange(8)}) as m:
        mu = pm.Normal("mu", 0, 5)
        tau = pm.HalfCauchy("tau", 5)
        theta_t = pm.Normal("theta_t", 0, 1, dims="school")
        theta = pm.Deterministic("theta", mu + tau * theta_t, dims="school")
        pm.Normal("obs", theta, sigma, observed=y, dims="school")
    return m


MODELS = {"radon": build_model, "eight_schools": eight_schools}


@pytest.fixture(scope="module", params=sorted(MODELS))
def pair(request):
    build = MODELS[request.param]
    return build(pmj), build(pmt)


def test_raveled_layout_matches(pair):
    mj, mt = pair
    ij, it = mj.raveled_info(), mt.raveled_info()
    assert it.names == ij.names
    assert it.shapes == ij.shapes
    assert it.sizes == ij.sizes
    assert mt.value_vars == mj.value_vars


def test_logp_and_grad_match(pair):
    mj, mt = pair
    info = mj.raveled_info()
    q = np.random.default_rng(0).normal(0.0, 0.7, size=(16, info.total_size))
    lf = mj.logp_fn()
    lj, gj = jax.vmap(jax.value_and_grad(lambda x: lf(unravel_vector(x, info))))(q)
    lt, gt = mt.logp_dlogp_fn(device="cpu")(torch.as_tensor(q))
    assert lt.shape == (16,) and gt.shape == q.shape
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-10)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-10, atol=1e-10)


def test_point_logp_matches(pair):
    mj, mt = pair
    point = make_initial_point(mj, jax.random.PRNGKey(3), jitter=1.0)
    ref = float(mj.logp_fn()(point))
    np_point = {k: np.asarray(v) for k, v in point.items()}
    got = float(mt.logp_fn(device="cpu")(point_from_numpy(np_point)))
    np.testing.assert_allclose(got, ref, rtol=1e-12)


def test_support_point_matches(pair):
    mj, mt = pair
    ref = make_initial_point(mj, jax.random.PRNGKey(0), jitter=0.0)
    got = support_point_values(mt)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-12)


def test_deterministics_from_flat_draws_match(pair):
    mj, mt = pair
    info = mj.raveled_info()
    q = np.random.default_rng(1).normal(size=(5, info.total_size))
    ref = jax.vmap(_make_postprocess_fn(mj, info))(q)
    got = mt.postprocess_fn(device="cpu")(torch.as_tensor(q))
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-12)


def test_ravel_roundtrip(pair):
    _, mt = pair
    info = mt.raveled_info()
    q = torch.randn(3, info.total_size, dtype=torch.float64)
    torch.testing.assert_close(ravel_point(unravel_t(q, info), info), q, rtol=0, atol=0)


@pytest.mark.parametrize(
    "build, value",
    [
        (lambda pm: pm.Normal("x", 0.0, -1.0), 0.3),
        (lambda pm: pm.HalfCauchy("x", -2.0), 0.3),
    ],
)
def test_invalid_parameters_give_minus_inf(build, value):
    with pmt.Model():
        rv = build(pmt)
    lp = rv.dist.logp(torch.tensor(value, dtype=torch.float64))
    assert lp.item() == -np.inf


def test_halfcauchy_negative_value_is_minus_inf_with_finite_grad():
    with pmt.Model():
        rv = pmt.HalfCauchy("x", 5.0)
    v = torch.tensor([-1.0, 2.0], dtype=torch.float64, requires_grad=True)
    lp = rv.dist.logp(v)
    assert lp[0].item() == -np.inf and np.isfinite(lp[1].item())
    (g,) = torch.autograd.grad(lp[1], v)
    assert torch.isfinite(g).all()


def test_model_surface_errors():
    with pytest.raises(TypeError, match="No model on context stack"):
        pmt.Normal("x", 0.0, 1.0)
    with pmt.Model(coords={"g": [0, 1]}):
        pmt.Normal("x", 0.0, 1.0, dims="g")
        with pytest.raises(ValueError, match="already exists"):
            pmt.Normal("x", 0.0, 1.0)
        with pytest.raises(KeyError, match="Unknown dimension"):
            pmt.Normal("y", 0.0, 1.0, dims="h")

