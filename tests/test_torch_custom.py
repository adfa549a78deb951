"""CustomDist / DensityDist in the port against pymc_tpu, float64 on the
CPU. The specification is `tests/distributions/test_custom_depth.py` and
the forms of `test_custom_symbolic.py` that need no logprob engine:
logp=, logcdf=, random= (a torch.Generator where pymc_tpu passes a key),
support_point= and moment=, signature=, ndim_supp/ndims_params, dtype and
transform=, and dist= returning a distribution, a random variable or a
derived expression (the logprob engine's; tests/test_torch_transformed.py
holds its forms). The densities are held to pymc_tpu's at rtol 1e-12 (one
jitted call for all of pymc_tpu's values); draws by their shapes and
moments.
"""

import functools

import numpy as np
import pytest
import scipy.stats as st
import torch

import jax

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from pymc_tpu.blocking import unravel_vector


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


OBS = np.random.default_rng(0).normal(0.3, 1.2, size=12)
MV_OBS = np.random.default_rng(2).normal(size=(3, 5))


def _normal_logp(pm):
    def logp(value, mu, sigma):
        return -0.5 * ((value - mu) / sigma) ** 2 - pm.math.log(sigma) - 0.5 * np.log(2 * np.pi)

    return logp


def _logp_model(pm):
    """logp= and logcdf= with two parameters, observed, beside a latent
    CustomDist with transform= and support_point=."""
    with pm.Model() as m:
        mu = pm.Normal("mu", 0.0, 1.0)
        sigma = pm.HalfNormal("sigma", 1.0)
        pm.CustomDist("scale", 2.0, logp=lambda v, lam: pm.math.log(lam) - lam * v,
                      support_point=lambda lam: 1.0 / lam,
                      transform=pm.distributions.transforms.log)
        pm.CustomDist("y", mu, sigma, logp=_normal_logp(pm), observed=OBS)
    return m


def _signature_model(pm):
    """signature="(n)->(n)": one MvNormal(mu, I) row a batch entry."""
    with pm.Model() as m:
        mu = pm.Normal("mu", 0.0, 1.0, size=5)
        pm.CustomDist("a", mu, logp=lambda v, mu: pm.MvNormal.dist(mu, cov=np.eye(5)).logp(v),
                      signature="(n)->(n)", observed=MV_OBS)
    return m


def _dist_model(pm):
    """dist= returning a distribution: a latent LogNormal (its log transform
    derived) and an observed Gamma with an explicit logcdf= beside it."""
    with pm.Model() as m:
        mu = pm.Normal("mu", 0.0, 1.0)
        pm.CustomDist("z", mu, dist=lambda mu, size: pm.LogNormal.dist(mu, 0.5, size=size),
                      shape=(2,))
        pm.CustomDist("y", mu, dist=lambda mu, size: pm.Gamma.dist(2.0, pm.math.exp(-mu),
                                                                 size=size),
                      observed=np.abs(OBS) + 0.1)
    return m


MODELS = {"logp": _logp_model, "signature": _signature_model, "dist": _dist_model}


def _points(D, n=4):
    return np.random.default_rng(D).normal(0.0, 0.4, size=(n, D))


@functools.lru_cache(maxsize=None)
def _references():
    """pymc_tpu's logp and gradient of each model at `_points`, and the
    elementwise terms of the signature model, in one jitted call."""
    fns, args = {}, {}
    for name, build in MODELS.items():
        mj = build(pmj)
        info, lf = mj.raveled_info(), mj.logp_fn()
        fns[name] = jax.vmap(jax.value_and_grad(
            lambda x, lf=lf, info=info: lf(unravel_vector(x, info))))
        args[name] = _points(info.total_size)
    sig = _signature_model(pmj).compile_logp(sum=False)

    @jax.jit
    def run(args, mu):
        out = {k: fns[k](args[k]) for k in fns}
        out["terms"] = sig({"mu": mu})["a"]
        return out

    mu = np.linspace(-0.5, 0.5, 5)
    return jax.tree.map(np.asarray, run(args, mu)), mu


@pytest.mark.parametrize("name", list(MODELS))
def test_model_logp_and_grad_match(name):
    ref, _ = _references()
    mt = MODELS[name](pmt)
    q = _points(mt.raveled_info().total_size)
    lp, g = mt.logp_dlogp_fn(device="cpu")(torch.tensor(q))
    np.testing.assert_allclose(lp.numpy(), ref[name][0], rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), ref[name][1], rtol=1e-12, atol=1e-12)


def test_value_names_and_transforms_match():
    for build in MODELS.values():
        assert build(pmt).value_vars == build(pmj).value_vars
    assert _dist_model(pmt).value_vars == ["mu", "z_log__"]


def test_signature_logp_keeps_the_batch_shape():
    ref, mu = _references()
    terms = _signature_model(pmt).compile_logp(sum=False, device="cpu")({"mu": mu})
    assert terms["a"].shape == (3,)
    np.testing.assert_allclose(terms["a"].numpy(), ref["terms"], rtol=1e-12)
    np.testing.assert_allclose(terms["a"].numpy(),
                               st.multivariate_normal.logpdf(MV_OBS, mu, np.eye(5)), rtol=1e-10)


@pytest.mark.parametrize("size", [(), (3,), (3, 2)], ids=str)
def test_random_draw_shapes_and_moments(size):
    def random(mu, rng=None, size=None):
        return mu + torch.randn(size, generator=rng, dtype=mu.dtype, device=mu.device)

    obs = np.random.default_rng(0).normal(size=(10, *size))
    with pmt.Model() as model:
        mu = pmt.Normal("mu", 0.0, 1.0)
        pmt.CustomDist("c", mu, logp=_normal_logp(pmt), random=random, observed=obs)
    idata = pmt.sample_prior_predictive(draws=400, model=model, random_seed=1, device="cpu")
    draws = idata.prior_predictive["c"].values
    assert draws.shape == (1, 400, 10, *size)
    # c = mu + e: mean 0 and variance 2 over the draws
    assert abs(draws.mean()) < 5 * np.sqrt(2.0 / 400)
    np.testing.assert_allclose(draws[0, :, 0].reshape(400, -1)[:, 0].var(), 2.0, rtol=0.3)


@pytest.mark.parametrize("size", [(), (3,)], ids=str)
def test_multivariate_random_signature_shape(size):
    d = pmt.CustomDist.dist(
        np.zeros(5), logp=lambda v, mu: -(v - mu) ** 2,
        random=lambda mu, rng=None, size=None: mu + torch.randn(size, generator=rng,
                                                                dtype=mu.dtype),
        signature="(n)->(n)", size=size)
    assert d.event_ndim == 1 and d.shape == (*size, 5)
    draw = d.sample(torch.Generator().manual_seed(0), (4,))
    assert draw.shape == (4, *size, 5)


@pytest.mark.parametrize(
    "support_point, size, expected",
    [(None, None, 0.0), (None, (5,), np.zeros(5)), ("custom", (), 5.0),
     ("custom", (2, 5), np.full((2, 5), 5.0)), ("params", (2,), np.full(2, 2.37))],
)
def test_support_points(support_point, size, expected):
    kw = {"size": size} if size is not None else {}
    params = (2.37,) if support_point == "params" else ()
    sp_fn = {None: None, "custom": lambda *p: 5.0, "params": lambda mu: mu}[support_point]
    args = dict(logp=lambda v, *p: -(v**2), support_point=sp_fn, **kw)
    got = pmt.CustomDist.dist(*params, **args).support_point().numpy()
    want = np.asarray(pmj.CustomDist.dist(*params, **args).support_point())
    np.testing.assert_allclose(got, expected)
    np.testing.assert_allclose(got, want)
    moment = pmt.CustomDist.dist(1.0, logp=lambda v, mu: -(v**2), moment=lambda mu: mu + 1.0)
    assert float(moment.support_point()) == 2.0


def test_logcdf_dtype_and_aliases():
    d = pmt.CustomDist.dist(2.0, logp=lambda v, lam: torch.log(lam) - lam * v,
                            logcdf=lambda v, lam: torch.log1p(-torch.exp(-lam * v)))
    np.testing.assert_allclose(pmt.logcdf(d, 0.7).numpy(), st.expon(scale=0.5).logcdf(0.7),
                               rtol=1e-12)
    k = pmt.CustomDist.dist(3.0, logp=lambda v, mu: v * torch.log(mu) - mu - torch.lgamma(v + 1.0),
                            dtype="int64")
    assert k.is_discrete and k.dtype == torch.int64 and k.default_transform() is None
    assert pmt.DensityDist is pmt.CustomDist
    with pytest.raises(NotImplementedError, match="no logcdf"):
        pmt.logcdf(k, 1)


def test_dist_forms():
    """dist= returning a distribution, a random variable or a derived
    expression serves logp, logcdf and draws; explicit callables win."""
    ref = pmj.CustomDist.dist(0.5, dist=lambda mu, size: pmj.Normal.dist(mu, 2.0, size=size),
                              size=(3,))
    got = pmt.CustomDist.dist(0.5, dist=lambda mu, size: pmt.Normal.dist(mu, 2.0, size=size),
                              size=(3,))
    x = np.array([-1.0, 0.2, 3.0])
    assert got.shape == (3,)
    np.testing.assert_allclose(got.logp(torch.tensor(x)).numpy(), np.asarray(ref.logp(x)),
                               rtol=1e-12)
    np.testing.assert_allclose(got.logcdf(torch.tensor(x)).numpy(), np.asarray(ref.logcdf(x)),
                               rtol=1e-12)
    assert got.sample(torch.Generator().manual_seed(0), (5,)).shape == (5, 3)
    over = pmt.CustomDist.dist(0.5, dist=lambda mu, size: pmt.Normal.dist(mu, 2.0, size=size),
                               logp=lambda v, mu: -v * 0.0 - 1.0)
    assert float(over.logp(torch.tensor(0.3))) == -1.0
    with pmt.Model():
        rv = pmt.Normal("base", 1.0, 1.0)
        from_rv = pmt.CustomDist.dist(dist=lambda size: rv)
    assert from_rv.logp(torch.tensor(1.0)).item() == pytest.approx(st.norm.logpdf(0.0))
    # exp of the model's mu: its density derived by the logprob engine, as
    # pymc_tpu's is
    def exp_of_mu(pm):
        with pm.Model() as m:
            mu = pm.Normal("mu", 0.0, 1.0)
            pm.CustomDist("e", mu, dist=lambda mu, size: pm.math.exp(mu))
        return m["e"].dist

    v = np.array([0.3, 1.0, 4.0])
    for fn in ("logp", "logcdf"):
        np.testing.assert_allclose(getattr(exp_of_mu(pmt), fn)(torch.tensor(v)).numpy(),
                                   np.asarray(getattr(exp_of_mu(pmj), fn)(v)), rtol=1e-12)
    with pytest.raises(TypeError, match="must return a distribution"):
        pmt.CustomDist.dist(1.0, dist=lambda mu, size: 3.0)
    with pytest.raises(TypeError, match="requires logp="):
        pmt.CustomDist.dist(1.0)


def test_signature_validation():
    with pytest.raises(ValueError, match="declares 2 inputs"):
        pmt.CustomDist.dist(1.0, logp=lambda v, mu: -(v**2), signature="(n),(m)->(n)")
    with pytest.raises(ValueError, match="missing '->'"):
        pmt.CustomDist.dist(1.0, logp=lambda v, mu: -(v**2), signature="(n)")


def test_logp_only_samples_but_rejects_ppc():
    with pmt.Model() as model:
        mu = pmt.Normal("mu", 0.0, 1.0)
        pmt.CustomDist("y", mu, logp=lambda v, mu: -0.5 * (v - mu) ** 2, observed=OBS)
    idata = pmt.sample(model=model, chains=2, tune=30, draws=20, random_seed=4, device="cpu",
                       progressbar=False, compute_convergence_checks=False,
                       nuts={"max_treedepth": 4})
    assert np.isfinite(idata.posterior["mu"].values).all()
    with pytest.raises(NotImplementedError):
        pmt.sample_posterior_predictive(idata, model=model, device="cpu")
