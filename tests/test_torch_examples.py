"""The two examples that `chip_smoke.py` phase 15 samples, at full size, in
both packages, float64 on the CPU: `examples/survival_analysis.py` (a
Weibull regression on 500 subjects, right-censored at t = 4 through
Censored; 3 free values) and `examples/stochastic_volatility.py` (a
200-step GaussianRandomWalk log-volatility under StudentT returns; 202
free values), each built by `pymc_tpu_torch.models` from the example's
own data in each package. Layout, the data, and logp and gradient at
pymc_tpu's initial point carried across with `point_from_numpy` and at
random points (rtol 1e-10). No NUTS here: the posteriors are checked on
the card.
"""

import numpy as np
import pytest
import torch

import jax

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from pymc_tpu.blocking import unravel_vector
from pymc_tpu_torch.convert import point_from_numpy
from pymc_tpu_torch.models import (
    SURVIVAL_SCALARS, SV_SCALARS, stochastic_volatility_data, stochastic_volatility_model,
    survival_data, survival_model,
)

LAYOUT = {
    "survival": (survival_model, ["alpha_log__", "b0", "b1"], 3),
    "stochastic volatility": (stochastic_volatility_model,
                              ["step_sigma_log__", "nu_log__", "h"], 202),
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(LAYOUT))
def pair(request):
    build, names, size = LAYOUT[request.param]
    return build(pmj), build(pmt), names, size


def test_layout_and_data_match(pair):
    mj, mt, names, size = pair
    ij, it = mj.raveled_info(), mt.raveled_info()
    assert list(it.names) == list(ij.names) == names
    assert it.shapes == ij.shapes and it.total_size == size
    for oj, ot in zip(mj.observed_RVs, mt.observed_RVs):
        np.testing.assert_array_equal(ot.observed.value.numpy(), np.asarray(oj.observed))


def test_logp_and_grad_at_the_initial_point_match(pair):
    mj, mt, _, _ = pair
    point = mj.initial_point()
    lf = mj.logp_fn()
    lj = float(jax.jit(lf)(point))
    lt = float(mt.logp_fn(device="cpu")(point_from_numpy(point)))
    np.testing.assert_allclose(lt, lj, rtol=1e-10)
    info = mj.raveled_info()
    flat = np.concatenate([np.ravel(np.asarray(point[n])) for n in info.names])
    q = np.concatenate([flat[None], flat + np.random.default_rng(0).normal(
        0.0, 0.2, size=(3, info.total_size))])
    lj, gj = jax.jit(jax.vmap(jax.value_and_grad(lambda x: lf(unravel_vector(x, info)))))(q)
    lt, gt = mt.logp_dlogp_fn(device="cpu")(torch.as_tensor(q))
    assert np.isfinite(lt.numpy()).all()
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-10)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-10, atol=1e-10)


def test_the_examples_data():
    x, t, censored, t_end = survival_data()
    assert x.shape == t.shape == (500,) and (t <= t_end).all()
    # censored subjects sit at t_end exactly, which float32 holds
    assert (t[censored] == t_end).all() and (np.float32(t[censored]) == np.float32(t_end)).all()
    assert 0.05 < censored.mean() < 0.5
    returns, true_h = stochastic_volatility_data()
    assert returns.shape == true_h.shape == (200,)
    assert set(SURVIVAL_SCALARS) <= set(survival_model().named_vars)
    assert set(SV_SCALARS) | {"vol", "h"} <= set(stochastic_volatility_model().named_vars)
