"""The model side of BASELINE config #5 in pymc_tpu_torch against pymc_tpu.

The simplex, ordered and chained transforms, Dirichlet, Mixture (list and
single-distribution forms) and NormalMixture, `transform=` and `initval=`
on a named RV, and the two suite models that use them: `case_smc`'s
bimodal mixture and `case_mixture`'s three components
(`pymc_tpu_torch.models`). Float64 on the CPU. Tolerances: transforms rtol
1e-12; densities and support points rtol 1e-10; the suite models' logp and
gradient rtol 1e-10 (grad atol 1e-10 near 0). The prior draws of every
ported distribution pass a one-sample KS test against scipy's cdf (a
binomial test for Bernoulli), p > 1e-3 at a fixed seed, and a two-sample
KS test against pymc_tpu's draws. NUTS on `case_mixture`'s model agrees
with pymc_tpu's within 5 combined MCSE. The zero-inflated and hurdle
classes: logp (and the zero-inflated logcdf) on values below 0, at 0 and
above, for valid and invalid psi, rtol 1e-12 (1e-10 for logcdfs through
the incomplete beta); support points (rtol 1e-12); 20,000 draws whose share of zeros
and mean are within 5 standard errors of the exact ones. Mixture's default
transform compares interval components' bounds as the JAX package does.
"""

import functools
import warnings

import numpy as np
import pytest
import scipy.stats as st
import torch

import jax
import jax.numpy as jnp

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from pymc_tpu.blocking import unravel_vector
from pymc_tpu.distributions import transforms as trj
from pymc_tpu.initial_point import make_initial_point
from pymc_tpu_torch.blocking import unravel_vector as unravel_t
from pymc_tpu_torch.distributions import transforms as trt
from pymc_tpu_torch.distributions.mixture import MixtureTransformWarning
from pymc_tpu_torch.initial_point import support_point_values
from pymc_tpu_torch.models import mixture_model, smc_mixture_model
from pymc_tpu_torch.stats.convergence import mcse_mean


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.as_tensor(np.array(x, dtype=np.float64))


# --------------------------------------------------------------- transforms

TRANSFORMS = {
    "simplex": lambda tr: tr.simplex,
    "ordered": lambda tr: tr.ordered,
    "ordered_positive_descending": lambda tr: tr.OrderedTransform(positive=True, ascending=False),
    "chain_simplex_ordered": lambda tr: tr.ChainedTransform([tr.simplex, tr.ordered]),
    "chain_log_ordered": lambda tr: tr.ChainedTransform([tr.log, tr.ordered]),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
@pytest.mark.parametrize("shape", [(3,), (4, 5), (2, 2)])
def test_transform_matches(name, shape):
    tj, tt = TRANSFORMS[name](trj), TRANSFORMS[name](trt)
    assert tt.name == tj.name and tt.event_ndim == tj.event_ndim
    assert tt.value_shape(shape) == tj.value_shape(shape)
    assert tt.constrained_shape(tj.value_shape(shape)) == shape
    rng = np.random.default_rng(sum(shape))
    v = rng.normal(0.0, 1.5, size=tj.value_shape(shape))
    x_ref = np.asarray(tj.backward(jnp.asarray(v)))
    np.testing.assert_allclose(tt.backward(_t(v)).numpy(), x_ref, rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(
        tt.log_jac_det(_t(v)).numpy(), np.asarray(tj.log_jac_det(jnp.asarray(v))),
        rtol=1e-12, atol=1e-14,
    )
    points = [x_ref]
    if name == "simplex":
        points.append(rng.dirichlet(np.ones(shape[-1]), size=shape[:-1]))
    for x in points:
        fwd = tt.forward(_t(x))
        np.testing.assert_allclose(fwd.numpy(), np.asarray(tj.forward(jnp.asarray(x))),
                                   rtol=1e-12, atol=1e-12)
        # forward inverts backward, where the stick-breaking keeps enough
        # digits of the last remainder (a stick of 1e-16 leaves none)
        ok = torch.isfinite(fwd).all(dim=-1).numpy()
        assert ok.mean() > 0.5
        np.testing.assert_allclose(tt.backward(fwd).numpy()[ok], x[ok], rtol=1e-12, atol=1e-14)


def test_log_jac_det_is_the_jacobian_of_backward():
    v = torch.tensor([0.3, -1.2, 0.7], dtype=torch.float64)
    for t in (trt.simplex, trt.ordered, trt.ChainedTransform([trt.simplex, trt.ordered])):
        J = torch.autograd.functional.jacobian(t.backward, v)
        if J.shape[0] != J.shape[1]:
            # the simplex adds a coordinate: its density lives on the first K-1
            J = J[:-1]
        expect = torch.logdet(J) if torch.det(J) > 0 else torch.log(torch.abs(torch.det(J)))
        np.testing.assert_allclose(float(t.log_jac_det(v)), float(expect), rtol=1e-12)


# ------------------------------------------------------------ named-RV path

def _value_layout(build):
    out = []
    for pm in (pmj, pmt):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with pm.Model() as m:
                build(pm)
        out.append((m.value_vars, m.raveled_info().shapes))
    return out


@pytest.mark.parametrize("build, names", [
    (lambda pm: pm.Dirichlet("w", np.ones(3)), ["w_simplex__"]),
    (lambda pm: pm.Normal("mu", 0, 1, shape=3, transform=pm.distributions.transforms.ordered),
     ["mu_ordered__"]),
    (lambda pm: pm.Dirichlet("x", np.ones(4), transform=pm.distributions.transforms.ordered),
     ["x_chain_simplex_ordered__"]),
    (lambda pm: pm.HalfNormal("s", 1, shape=2, transform=pm.distributions.transforms.ordered),
     ["s_chain_log_ordered__"]),
    (lambda pm: pm.HalfNormal("s", 1, default_transform=None), ["s"]),
    (lambda pm: pm.HalfNormal("s", 1, transform=None), ["s"]),
])
def test_value_names_and_shapes_match(build, names):
    (nj, sj), (nt, st_) = _value_layout(build)
    assert nj == nt == names
    assert st_ == sj


def test_transform_none_warns_in_both():
    for pm in (pmj, pmt):
        with pm.Model(), pytest.warns(UserWarning, match="default_transform=None"):
            pm.HalfNormal("s", 1, transform=None)


def test_transform_errors_match():
    for pm in (pmj, pmt):
        with pm.Model():
            with pytest.raises(ValueError, match="discrete"):
                pm.Bernoulli("b", 0.5, transform=pm.distributions.transforms.log)
            with pytest.raises(NotImplementedError, match="Univariate transform"):
                pm.Dirichlet("w", np.ones(3), default_transform=pm.distributions.transforms.log)


def test_transforms_chain_once():
    init = np.array([0.5, 1.0, 2.0])
    models = []
    for pm in (pmj, pmt):
        with pm.Model() as m:
            pm.HalfNormal("s", 1, shape=3, transform=pm.distributions.transforms.ordered,
                          initval=init)
        models.append(m)
    (rv,) = models[1].free_RVs
    assert [t.name for t in rv.transform.transforms] == ["log", "ordered"]
    got = support_point_values(models[1])["s_chain_log_ordered__"]
    ref = make_initial_point(models[0], jax.random.PRNGKey(0), jitter=0.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref["s_chain_log_ordered__"]), rtol=1e-12)
    np.testing.assert_allclose(got.numpy(), trt.ordered.forward(torch.log(_t(init))).numpy(),
                               rtol=1e-12)


# ---------------------------------------------------------------- densities

DISTS = {
    "dirichlet": lambda pm: pm.Dirichlet.dist(np.array([0.7, 2.0, 3.5])),
    "dirichlet_batch": lambda pm: pm.Dirichlet.dist(np.array([[1.0, 1.0], [0.5, 4.0]])),
    "mixture_list": lambda pm: pm.Mixture.dist(
        np.array([0.2, 0.5, 0.3]),
        [pm.Normal.dist(-1.0, 1.0), pm.Normal.dist(2.0, 0.5), pm.HalfNormal.dist(3.0)]),
    "mixture_single": lambda pm: pm.Mixture.dist(
        np.array([0.3, 0.7]), pm.Normal.dist(np.array([-2.0, 2.0]), 0.5)),
    "mixture_batched_w": lambda pm: pm.Mixture.dist(
        np.array([[0.1, 0.9], [0.6, 0.4], [0.5, 0.5]]),
        pm.Normal.dist(np.array([-1.0, 1.5]), np.array([0.7, 1.3]))),
    "mixture_mv": lambda pm: pm.Mixture.dist(
        np.array([0.4, 0.6]), [pm.Dirichlet.dist(np.ones(3)), pm.Dirichlet.dist(np.arange(1.0, 4.0))]),
    "normal_mixture": lambda pm: pm.NormalMixture.dist(
        np.array([0.25, 0.75]), np.array([0.0, 3.0]), sigma=np.array([1.0, 0.4])),
    "normal_mixture_tau": lambda pm: pm.NormalMixture.dist(
        np.array([0.5, 0.5]), np.array([-1.0, 1.0]), tau=np.array([4.0, 0.25])),
}


def _values(name, shape, rng):
    if name.startswith("dirichlet") or name == "mixture_mv":
        return np.concatenate([
            rng.dirichlet(np.ones(shape[-1]), size=(5,) + shape[:-1]),
            # off the simplex: a negative entry, a sum of 1.1
            np.broadcast_to(np.eye(shape[-1])[0] * -0.1 + 1.0 / shape[-1], (1,) + shape),
            np.broadcast_to(np.full(shape[-1], 1.1 / shape[-1]), (1,) + shape),
        ])
    return rng.normal(0.5, 2.0, size=(7,) + shape)


@functools.lru_cache(maxsize=None)
def _dist_references():
    """Every pymc_tpu value of the zero-inflated and hurdle cases at each
    psi, traced and compiled as one jitted function: an eager dispatch of
    every op a case took most of their time. (The DISTS cases stay eager:
    under jit XLA's fusion moves the Dirichlet's logp at the uniform
    simplex from 0 to 8.9e-16, which rtol cannot hold.)"""

    def run():
        out = {}
        for name, (params, _, _, values) in ZERO_CLASSES.items():
            values = jnp.asarray(np.asarray(values, dtype=_zero_dtype(name)))
            for psi in ZERO_PSI:
                dj = getattr(pmj, name).dist(psi=psi, **params)
                for method in _zero_methods(name):
                    out[f"{method} {name} {psi}"] = getattr(dj, method)(values)
                if psi <= 1.0:
                    out[f"support_point {name} {psi}"] = jnp.asarray(dj.support_point())
        return out

    return jax.tree.map(np.asarray, jax.jit(run)())


@pytest.mark.parametrize("name", sorted(DISTS))
def test_logp_and_support_point_match(name):
    dj, dt = DISTS[name](pmj), DISTS[name](pmt)
    assert tuple(dt.shape) == tuple(dj.shape)
    values = _values(name, tuple(dt.shape), np.random.default_rng(len(name)))
    ref = np.asarray(dj.logp(jnp.asarray(values)))
    got = dt.logp(_t(values)).numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-10)
    assert np.isfinite(ref).any()
    np.testing.assert_allclose(dt.support_point().numpy(), np.asarray(dj.support_point()),
                               rtol=1e-10)


@pytest.mark.parametrize("a", [np.array([1.0, -1.0, 2.0]), np.array([0.0, 1.0])])
def test_dirichlet_invalid_concentration_is_minus_inf(a):
    d = pmt.Dirichlet.dist(a)
    x = np.full(a.shape, 1.0 / a.shape[0])
    assert float(d.logp(_t(x))) == -np.inf == float(pmj.Dirichlet.dist(a).logp(jnp.asarray(x)))


@pytest.mark.parametrize("w", [np.array([0.5, 0.6]), np.array([-0.1, 1.1])])
def test_mixture_invalid_weights_are_minus_inf(w):
    for pm, to in ((pmt, _t), (pmj, jnp.asarray)):
        d = pm.Mixture.dist(w, pm.Normal.dist(np.array([0.0, 1.0]), 1.0))
        assert float(d.logp(to(np.array(0.3)))) == -np.inf


def test_mixture_errors_and_warnings_match():
    for pm in (pmj, pmt):
        with pytest.raises(ValueError, match="number of components"):
            pm.Mixture.dist(np.ones(3) / 3, pm.Normal.dist(np.zeros(2), 1.0))
        with pytest.raises(ValueError, match="either discrete"):
            pm.Mixture.dist(np.ones(2) / 2, [pm.Normal.dist(), pm.Bernoulli.dist(0.5)])
        with pytest.raises(ValueError, match="same support"):
            pm.Mixture.dist(np.ones(2) / 2, [pm.Normal.dist(), pm.Dirichlet.dist(np.ones(2))])
        with pytest.warns(UserWarning, match="Single component"):
            pm.Mixture.dist(np.ones(2) / 2, [pm.Normal.dist(np.zeros(2), 1.0)])
    with pmt.Model() as m, pytest.warns(MixtureTransformWarning):
        pmt.Mixture("x", np.ones(2) / 2, [pmt.Normal.dist(), pmt.HalfNormal.dist(1.0)])
    assert m.free_RVs[0].transform is None


def test_mixture_reaches_its_components_in_the_graph():
    m = smc_mixture_model()
    (y,) = m.observed_RVs
    from pymc_tpu_torch.graph import ancestors

    names = {a.name for a in ancestors([y])}
    assert {"w", "mu"} <= names
    # the components' sigma = 0.5 is placed with the other constants
    placed = m.placed_constants("cpu", torch.float32)
    assert any(float(v.reshape(-1)[0]) == 0.5 and v.dtype == torch.float32
               for v in placed.values())


# ------------------------------------------------------------- suite models

SUITE = {"smc": smc_mixture_model, "mixture": mixture_model}


@pytest.fixture(scope="module", params=sorted(SUITE))
def suite_pair(request):
    build = SUITE[request.param]
    return build(pmj), build(pmt)


def test_suite_layout_and_initial_point_match(suite_pair):
    mj, mt = suite_pair
    ij, it = mj.raveled_info(), mt.raveled_info()
    assert mt.value_vars == mj.value_vars == ["w_simplex__", "mu_ordered__"]
    assert (it.names, it.shapes, it.sizes) == (ij.names, ij.shapes, ij.sizes)
    ref = make_initial_point(mj, jax.random.PRNGKey(0), jitter=0.0)
    got = support_point_values(mt)
    assert list(got) == list(ref)
    for k in ref:
        # atol for w's stick-breaking coordinates at the uniform simplex, ~1e-16
        np.testing.assert_allclose(got[k].numpy(), np.asarray(ref[k]), rtol=1e-12, atol=1e-15)
    # the initval of mu, through the ordered transform
    mu0 = mt.free_RVs[1].transform.backward(got["mu_ordered__"])
    np.testing.assert_allclose(mu0.numpy(), mt.rvs_to_initial_values["mu"], rtol=1e-12)


def test_suite_logp_and_grad_match(suite_pair):
    mj, mt = suite_pair
    info = mj.raveled_info()
    q = np.random.default_rng(0).normal(0.0, 1.0, size=(16, info.total_size))
    lf = mj.logp_fn()
    lj, gj = jax.jit(jax.vmap(jax.value_and_grad(lambda x: lf(unravel_vector(x, info)))))(q)
    lt, gt = mt.logp_dlogp_fn(device="cpu")(_t(q))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-10)
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-10, atol=1e-10)


def test_suite_split_logp_and_unconstrain_match(suite_pair):
    mj, mt = suite_pair
    info = mj.raveled_info()
    q = np.random.default_rng(1).normal(0.0, 1.0, size=info.total_size)
    vj = unravel_vector(jnp.asarray(q), info)
    ref = jax.jit(mj.logp_fn(split=True))(vj)
    got = mt.logp_fn(device="cpu", split=True)(unravel_t(_t(q), mt.raveled_info()))
    np.testing.assert_allclose([float(g) for g in got], [float(r) for r in ref], rtol=1e-12)
    point = {rv.name: rv.transform.backward(vj[rv.value_name]) for rv in mj.free_RVs}
    got = mt.unconstrain({k: _t(v) for k, v in point.items()})
    for k, v in mj.unconstrain(point).items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), rtol=1e-12)


# ------------------------------------------------------------- prior draws

N_DRAWS = 4000


def _draws(dist_t, dist_j, seed):
    g = torch.Generator().manual_seed(seed)
    xt = dist_t.sample(g, (N_DRAWS,)).numpy()
    xj = np.asarray(dist_j.sample(jax.random.PRNGKey(seed), (N_DRAWS,)))
    assert xt.shape == xj.shape and xt.dtype == xj.dtype
    return xt, xj


def _mixture_cdf(w, mus, sigmas):
    return lambda x: sum(wk * st.norm.cdf(x, m, s) for wk, m, s in zip(w, mus, sigmas))


CONTINUOUS = {
    "normal": (lambda pm: pm.Normal.dist(1.5, 2.0), st.norm(1.5, 2.0).cdf),
    "halfnormal": (lambda pm: pm.HalfNormal.dist(2.0), st.halfnorm(scale=2.0).cdf),
    "halfcauchy": (lambda pm: pm.HalfCauchy.dist(1.5), st.halfcauchy(scale=1.5).cdf),
    "gamma": (lambda pm: pm.Gamma.dist(2.5, 0.5), st.gamma(2.5, scale=2.0).cdf),
    "gamma_small_alpha": (lambda pm: pm.Gamma.dist(0.3, 2.0), st.gamma(0.3, scale=0.5).cdf),
    "mixture": (lambda pm: pm.Mixture.dist(np.array([0.3, 0.7]),
                                           pm.Normal.dist(np.array([-2.0, 2.0]), 0.5)),
                _mixture_cdf([0.3, 0.7], [-2.0, 2.0], [0.5, 0.5])),
    "mixture_list": (lambda pm: pm.Mixture.dist(np.array([0.6, 0.4]),
                                                [pm.Normal.dist(0.0, 1.0), pm.Normal.dist(3.0, 0.3)]),
                     _mixture_cdf([0.6, 0.4], [0.0, 3.0], [1.0, 0.3])),
}


@pytest.mark.parametrize("name", sorted(CONTINUOUS))
def test_prior_draws_follow_the_distribution(name):
    make, cdf = CONTINUOUS[name]
    xt, xj = _draws(make(pmt), make(pmj), seed=11)
    assert st.kstest(xt, cdf).pvalue > 1e-3
    assert st.ks_2samp(xt, xj).pvalue > 1e-3


def test_bernoulli_draws_follow_the_distribution():
    for make in (lambda pm: pm.Bernoulli.dist(0.3), lambda pm: pm.Bernoulli.dist(logit_p=-0.8473)):
        xt, xj = _draws(make(pmt), make(pmj), seed=5)
        assert set(np.unique(xt)) <= {0, 1}
        assert st.binomtest(int(xt.sum()), xt.size, 0.3).pvalue > 1e-3
        assert st.ks_2samp(xt, xj).pvalue > 1e-3


def test_multivariate_draws_follow_the_distribution():
    a = np.array([0.8, 2.0, 4.0])
    xt, xj = _draws(pmt.Dirichlet.dist(a), pmj.Dirichlet.dist(a), seed=7)
    np.testing.assert_allclose(xt.sum(-1), 1.0, rtol=1e-12)
    for k in range(3):
        assert st.kstest(xt[:, k], st.beta(a[k], a.sum() - a[k]).cdf).pvalue > 1e-3
        assert st.ks_2samp(xt[:, k], xj[:, k]).pvalue > 1e-3
    cov = np.array([[2.0, 0.6], [0.6, 0.5]])
    mu = np.array([1.0, -1.0])
    xt, xj = _draws(pmt.MvNormal.dist(mu, cov=cov), pmj.MvNormal.dist(mu, cov=cov), seed=8)
    for proj in (np.array([1.0, 0.0]), np.array([0.0, 1.0]), np.array([1.0, -2.0])):
        sd = np.sqrt(proj @ cov @ proj)
        assert st.kstest(xt @ proj, st.norm(proj @ mu, sd).cdf).pvalue > 1e-3
        assert st.ks_2samp(xt @ proj, xj @ proj).pvalue > 1e-3


def test_mixture_draws_take_each_component_at_its_weight():
    d = pmt.Mixture.dist(np.array([0.2, 0.8]), [pmt.Normal.dist(-50.0, 1.0),
                                                pmt.Normal.dist(50.0, 1.0)], shape=(3,))
    x = d.sample(torch.Generator().manual_seed(2), (2000,)).numpy()
    assert x.shape == (2000, 3)
    assert st.binomtest(int((x < 0).sum()), x.size, 0.2).pvalue > 1e-3


# --------------------------------------------------------------------- NUTS

# trees cut at depth 4 in both packages: at the default depth the port's
# lock-step batched trees take ~150 leapfrogs a draw here, ~80 s on one CPU
# thread for 50 + 50 draws
NUTS_CONFIG = dict(draws=100, tune=100, chains=4, random_seed=1, max_treedepth=4,
                   compute_convergence_checks=False)


def test_nuts_on_the_mixture_model_agrees():
    idata_j = pmj.sample(model=mixture_model(pmj), progressbar=False, **NUTS_CONFIG)
    idata_t = pmt.sample(model=mixture_model(pmt), device="cpu", **NUTS_CONFIG)
    for name in ("mu", "w"):
        xj = idata_j.posterior[name].values
        xt = idata_t.posterior[name].values
        assert xt.shape == xj.shape == (4, 100, 3)
        for k in range(3):
            se = np.hypot(mcse_mean(xj[..., k]), mcse_mean(xt[..., k]))
            z = (xt[..., k].mean() - xj[..., k].mean()) / se
            assert abs(z) < 5.0, (name, k, z)
    assert np.all(np.diff(idata_t.posterior["mu"].values, axis=-1) > 0)


# class -> (base parameters, the base's mean and P(base = 0), values)
ZERO_CLASSES = {
    "ZeroInflatedPoisson": (dict(mu=2.5), 2.5, np.exp(-2.5), [-1, 0, 1, 4, 9]),
    "ZeroInflatedBinomial": (dict(n=8, p=0.3), 2.4, 0.7**8, [-1, 0, 1, 4, 8, 9]),
    "ZeroInflatedNegativeBinomial": (dict(mu=3.0, alpha=2.0), 3.0, 0.4**2, [-1, 0, 2, 7]),
    "HurdlePoisson": (dict(mu=2.5), 2.5, np.exp(-2.5), [-1, 0, 1, 4, 9]),
    "HurdleNegativeBinomial": (dict(mu=3.0, alpha=2.0), 3.0, 0.4**2, [-1, 0, 2, 7]),
    "HurdleGamma": (dict(alpha=2.0, beta=1.5), 2.0 / 1.5, 0.0, [-1.0, 0.0, 0.3, 2.0]),
    "HurdleLogNormal": (dict(mu=0.2, sigma=0.5), np.exp(0.2 + 0.125), 0.0,
                        [-1.0, 0.0, 0.3, 2.0]),
}


ZERO_PSI = (0.7, 0.0, 1.0, 1.3)


def _zero_dtype(name):
    return np.float64 if "Gamma" in name or "LogNormal" in name else np.int64


def _zero_methods(name):
    return ["logp"] + (["logcdf"] if name.startswith("Zero") else [])


@pytest.mark.parametrize("name", sorted(ZERO_CLASSES))
def test_zero_inflated_and_hurdle_match(name):
    params, _, _, values = ZERO_CLASSES[name]
    values = np.asarray(values, dtype=_zero_dtype(name))
    for psi in ZERO_PSI:
        dj, dt = getattr(pmj, name).dist(psi=psi, **params), getattr(pmt, name).dist(psi=psi,
                                                                                  **params)
        for method in _zero_methods(name):
            ref = _dist_references()[f"{method} {name} {psi}"]
            got = getattr(dt, method)(torch.as_tensor(values)).numpy()
            np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
            rtol = 1e-10 if method == "logcdf" and "Poisson" not in name else 1e-12
            np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-15)
        if psi <= 1.0:
            np.testing.assert_allclose(dt.support_point().numpy(),
                                       _dist_references()[f"support_point {name} {psi}"],
                                       rtol=1e-12)
    assert dt.is_discrete == dj.is_discrete and dt.default_transform() is None


@pytest.mark.parametrize("name", sorted(ZERO_CLASSES))
def test_zero_inflated_and_hurdle_draws(name):
    params, base_mean, base_p0, _ = ZERO_CLASSES[name]
    psi, n = 0.7, 20_000
    x = getattr(pmt, name).dist(psi=psi, **params).sample(torch.Generator().manual_seed(3), n)
    x = x.numpy().astype(np.float64)
    if name.startswith("Zero"):
        p0, mean = 1 - psi + psi * base_p0, psi * base_mean
    else:  # the hurdle's positive part is the base truncated at 0
        p0, mean = 1 - psi, psi * base_mean / (1 - base_p0)
    assert abs(np.mean(x == 0) - p0) < 5 * np.sqrt(p0 * (1 - p0) / n)
    assert abs(x.mean() - mean) < 5 * x.std() / np.sqrt(n)
    assert (x >= 0).all()


def test_mixture_of_intervals_compares_their_bounds():
    same = [pmt.Uniform.dist(0.0, 1.0), pmt.Uniform.dist(0.0, 1.0)]
    assert pmt.Mixture.dist(np.ones(2) / 2, same).default_transform().name == "interval"
    lo = np.zeros(2)
    shared = pmt.Uniform.dist(lo, 2.0)
    assert pmt.Mixture.dist(np.ones(2) / 2, [shared, shared]).default_transform() is not None
    for pm in (pmj, pmt):
        with pytest.warns(UserWarning, match="No safe default transform"):
            t = pm.Mixture.dist(np.ones(2) / 2, [pm.Uniform.dist(0.0, 1.0),
                                                 pm.Uniform.dist(0.0, 2.0)]).default_transform()
        assert t is None
