"""MAP, the Hessian, the constrained-space density and find_constrained_prior
of pymc_tpu_torch against pymc_tpu, in float64 on the CPU.

find_MAP's point at atol 1e-6 (scipy's L-BFGS-B on each package's logp and
gradient), find_hessian and guess_scaling at the same point at rtol 1e-8 —
on Eight Schools and on the marginal GP at n = 40, whose Hessian runs
forward mode over reverse mode through the Cholesky's `jvp` and backward
rules; `logp_fn(jacobian=False)` at rtol 1e-12; find_constrained_prior at
rtol 1e-6; the logcdfs it needs at rtol 1e-9 (the two libraries' log_ndtr
differ by ~1e-10 relative in the far tail).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from pymc_tpu.blocking import unravel_vector as unravel_j
from pymc_tpu_torch.blocking import unravel_vector as unravel_t
from pymc_tpu_torch.distributions.dist_math import gammainc
from pymc_tpu_torch.models import gp_marginal_model
from test_torch_vi import eight_schools


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gp40(pm):
    return gp_marginal_model(40, pm=pm)


MODELS = {"eight_schools": eight_schools, "gp40": gp40}


@pytest.fixture(scope="module", params=sorted(MODELS))
def maps(request):
    mk = MODELS[request.param]
    pj = pmj.find_MAP(model=mk(pmj), progressbar=False)
    pt, res = pmt.find_MAP(model=mk(pmt), device="cpu", return_raw=True)
    return mk, pj, pt, res


def test_find_map_matches_jax(maps):
    mk, pj, pt, res = maps
    assert res.success and sorted(pt) == sorted(pj)
    for k in pj:
        np.testing.assert_allclose(pt[k], np.asarray(pj[k]), atol=1e-6, err_msg=k)
    only = pmt.find_MAP(model=mk(pmt), device="cpu", include_transformed=False)
    assert sorted(only) == sorted(pmj.find_MAP(model=mk(pmj), progressbar=False,
                                               include_transformed=False))


def test_find_hessian_and_guess_scaling_match_jax(maps):
    mk, pj, _, _ = maps
    hj = pmj.find_hessian(point=pj, model=mk(pmj))
    ht = pmt.find_hessian(point={k: np.asarray(v) for k, v in pj.items()}, model=mk(pmt),
                          device="cpu")
    np.testing.assert_allclose(ht, hj, rtol=1e-8, atol=1e-8 * np.abs(hj).max())
    np.testing.assert_allclose(ht, ht.T, rtol=1e-12, atol=1e-12 * np.abs(ht).max())
    gj = pmj.tuning.guess_scaling(pj, model=mk(pmj))
    gt = pmt.tuning.guess_scaling({k: np.asarray(v) for k, v in pj.items()}, model=mk(pmt),
                                  device="cpu")
    np.testing.assert_allclose(gt, gj, rtol=1e-8)
    # a point keyed by rv names only (a name that is also a value name
    # makes it a value point, the rest from the initial point, in both
    # packages) and no point (the initial point)
    rvs = {rv.name: pj[rv.name] for rv in mk(pmt).free_RVs}
    np.testing.assert_allclose(
        pmt.find_hessian(point={k: np.asarray(v) for k, v in rvs.items()}, model=mk(pmt),
                         device="cpu"),
        pmj.find_hessian(point=rvs, model=mk(pmj)), rtol=1e-8, atol=1e-8 * np.abs(hj).max())
    np.testing.assert_allclose(pmt.find_hessian(model=mk(pmt), device="cpu", negate_output=False),
                               -pmj.find_hessian(model=mk(pmj)), rtol=1e-8, atol=1e-10)


def test_find_map_from_a_start():
    start = {"mu": 3.0, "tau": 2.0}
    pj = pmj.find_MAP(start=start, model=eight_schools(pmj), progressbar=False, maxeval=5)
    pt = pmt.find_MAP(start=start, model=eight_schools(pmt), device="cpu", maxeval=5)
    for k in pj:
        np.testing.assert_allclose(pt[k], np.asarray(pj[k]), rtol=1e-8, atol=1e-10, err_msg=k)


@pytest.mark.parametrize("mk", [eight_schools, gp40])
def test_logp_without_jacobian_matches_jax(mk):
    mj, mt = mk(pmj), mk(pmt)
    D = mj.raveled_info().total_size
    q = np.random.default_rng(0).normal(0.0, 0.5, size=(4, D))
    for jac in (False, True):
        fj = mj.logp_fn(jacobian=jac)
        ref = np.array([float(fj(unravel_j(jnp.asarray(x), mj.raveled_info()))) for x in q])
        got = pmt.sampling.mcmc.torch.func.vmap(
            lambda x: mt.logp_fn(device="cpu", jacobian=jac)(unravel_t(x, mt.raveled_info()))
        )(torch.as_tensor(q)).numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-12)
        lp, g = mt.logp_dlogp_fn(device="cpu", jacobian=jac)(torch.as_tensor(q))
        np.testing.assert_allclose(lp.numpy(), ref, rtol=1e-12)
    jac_terms = mt.logp_fn(device="cpu")(unravel_t(torch.as_tensor(q[0]), mt.raveled_info()))
    no_jac = mt.logp_fn(device="cpu", jacobian=False)(unravel_t(torch.as_tensor(q[0]),
                                                                mt.raveled_info()))
    assert float(jac_terms) != float(no_jac)


CONSTRAINED = [
    ("Gamma", dict(lower=0.5, upper=5.0, init_guess={"alpha": 2, "beta": 1})),
    ("Normal", dict(lower=-1.0, upper=1.0, mass=0.9, init_guess={"mu": 0.5, "sigma": 1.0})),
    ("Gamma", dict(lower=1.0, upper=4.0, mass=0.8, init_guess={"alpha": 3.0, "beta": 1.0})),
]


@pytest.mark.parametrize("dist, kwargs", CONSTRAINED)
def test_find_constrained_prior_matches_jax(dist, kwargs):
    got = pmt.find_constrained_prior(getattr(pmt, dist), **kwargs)
    ref = pmj.find_constrained_prior(getattr(pmj, dist), **kwargs)
    assert list(got) == list(ref)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], rtol=1e-6, atol=1e-7, err_msg=k)
    d = getattr(pmt, dist).dist(**got)
    mass = torch.exp(d.logcdf(torch.tensor([kwargs["lower"], kwargs["upper"]]))).diff()
    assert float(mass) == pytest.approx(kwargs.get("mass", 0.95), abs=1e-3)


@pytest.mark.parametrize("dist, params", [
    ("Normal", {"mu": 0.3, "sigma": 1.7}), ("HalfNormal", {"sigma": 2.0}),
    ("Gamma", {"alpha": 2.5, "beta": 0.7}), ("Gamma", {"alpha": 0.4, "beta": 3.0}),
])
def test_logcdf_matches_jax(dist, params):
    x = np.array([-1.0, 0.0, 0.05, 0.7, 2.0, 9.0])
    ref = np.asarray(pmj.logcdf(getattr(pmj, dist).dist(**params), jnp.asarray(x)))
    got = getattr(pmt, dist).dist(**params).logcdf(torch.as_tensor(x)).numpy()
    # torch's and JAX's log_ndtr differ by ~1e-10 relative in the far tail
    np.testing.assert_allclose(got, ref, rtol=1e-9)
    # a class without a logcdf in either package still raises
    with pytest.raises(NotImplementedError, match="logcdf"):
        pmt.VonMises.dist(mu=0.0, kappa=1.0).logcdf(torch.tensor(1.0))


def test_gammainc_gradient():
    a = torch.tensor([0.4, 2.5, 7.0], dtype=torch.float64, requires_grad=True)
    x = torch.tensor([0.3, 1.7, 9.0], dtype=torch.float64, requires_grad=True)
    ga, gx = torch.autograd.grad(gammainc(a, x).sum(), (a, x))
    h = 1e-6
    fd_a = (torch.special.gammainc(a + h, x) - torch.special.gammainc(a - h, x)) / (2 * h)
    fd_x = (torch.special.gammainc(a, x + h) - torch.special.gammainc(a, x - h)) / (2 * h)
    torch.testing.assert_close(ga, fd_a.detach(), rtol=1e-7, atol=1e-10)
    torch.testing.assert_close(gx, fd_x.detach(), rtol=1e-7, atol=1e-10)


def test_trace_cov_matches_jax():
    rng = np.random.default_rng(0)
    post = {"a": rng.normal(size=(2, 30)), "b": rng.normal(size=(2, 30, 3))}
    idata_t = pmt.backends.inference_data.InferenceData()
    from pymc_tpu_torch.backends.inference_data import DataVar, Dataset
    idata_t.add_group("posterior", Dataset({k: DataVar(k, v) for k, v in post.items()}))
    got = pmt.tuning.trace_cov(idata_t)
    ref = np.cov(np.concatenate([post["a"].reshape(-1, 1), post["b"].reshape(-1, 3)], 1),
                 rowvar=False)
    np.testing.assert_allclose(got, ref, rtol=1e-12)
