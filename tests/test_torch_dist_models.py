"""The two models of `chip_smoke.py` phase 11 in both packages, float64 on
the CPU: BEST (`benchmarks/suite.py::case_best`: StudentT with lam=,
Uniform, Exponential) and the hierarchical binomial
(`examples/hierarchical_binomial.py`: Beta, Binomial, Uniform,
Exponential, `pm.math.exp`), built by `pymc_tpu_torch.models` from the
same data in each package. Layout (value names, transforms, sizes), the
initial point (rtol 1e-12), and logp and gradient at 8 points (rtol
1e-10). Then NUTS on BEST in the port at 4 chains, trees cut at depth 4,
80 tuning and 80 kept draws (about 15 s): every mean within 4 combined
MCSE of pymc_tpu's float64 posterior in tests/data/torch_best_reference.json
(scripts/make_torch_best_fixture.py; running pymc_tpu's NUTS here would
add its 13 s of compilation), and `difference of means` recomputed from
its parts.
"""

import json
import os


import numpy as np
import pytest
import torch

import jax

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from pymc_tpu.blocking import unravel_vector
from pymc_tpu.initial_point import make_initial_point
from pymc_tpu_torch.initial_point import support_point_values
from pymc_tpu_torch.models import (
    BEST_SCALARS, BINOMIAL_SCALARS, best_model, hierarchical_binomial_model,
)
from pymc_tpu_torch.stats.convergence import mcse_mean

LAYOUT = {
    "best": (best_model, ["group1_mean", "group2_mean", "group1_std_interval__",
                          "group2_std_interval__", "nu_minus_one_log__"], 5),
    "binomial": (hierarchical_binomial_model, ["phi_interval__", "kappa_log_log__",
                                               "theta_logodds__"], 20),
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


def test_layout_matches(pair):
    mj, mt, names, size = pair
    ij, it = mj.raveled_info(), mt.raveled_info()
    assert list(it.names) == list(ij.names) == names
    assert it.shapes == ij.shapes and it.total_size == size
    for oj, ot in zip(mj.observed_RVs, mt.observed_RVs):
        np.testing.assert_array_equal(ot.observed.value.numpy(), np.asarray(oj.observed))
        assert ot.observed.value.dtype == (torch.int64 if ot.dist.is_discrete else torch.float64)


def test_initial_point_matches(pair):
    mj, mt, _, _ = pair
    ref = make_initial_point(mj, jax.random.PRNGKey(0), jitter=0.0)
    got = support_point_values(mt)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-12)


def test_logp_and_grad_match(pair):
    mj, mt, _, size = pair
    info = mj.raveled_info()
    q = np.random.default_rng(1).normal(0.0, 0.7, size=(8, size))
    lf = mj.logp_fn()
    lj, gj = jax.vmap(jax.value_and_grad(lambda x: lf(unravel_vector(x, info))))(q)
    lt, gt = mt.logp_dlogp_fn(device="cpu")(torch.as_tensor(q))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-10)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-10, atol=1e-10)


def test_the_scalars_are_named_in_the_models():
    assert set(BEST_SCALARS) <= set(best_model().named_vars)
    assert set(BINOMIAL_SCALARS) <= set(hierarchical_binomial_model().named_vars)


BEST_CONFIG = dict(draws=80, tune=80, chains=4, random_seed=2,
                   compute_convergence_checks=False, nuts={"max_treedepth": 4})


BEST_REFERENCE = os.path.join(os.path.dirname(__file__), "data", "torch_best_reference.json")


def test_nuts_on_best_agrees():
    with open(BEST_REFERENCE) as f:
        ref = json.load(f)["params"]
    pt = pmt.sample(model=best_model(), device="cpu", **BEST_CONFIG).posterior
    for name in BEST_SCALARS:
        xt = pt[name].values
        assert xt.shape == (4, 80) and np.isfinite(xt).all()
        z = abs(xt.mean() - ref[name]["mean"]) / np.hypot(ref[name]["mcse"], mcse_mean(xt))
        assert z < 4.0, (name, z)
    np.testing.assert_allclose(pt["difference of means"].values,
                               pt["group1_mean"].values - pt["group2_mean"].values, rtol=1e-12)
