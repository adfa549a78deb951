"""The discrete distributions of pymc_tpu_torch against pymc_tpu's.

One case per class and method, float64 on the CPU, the same parameters
and int64 values through both packages:
- `logp` (and `logcdf` where the JAX class has one) on values outside the
  support, at its edges and inside, for each parametrisation and a set of
  invalid parameters (-inf there): rtol 1e-12, or 1e-10 for the logcdfs
  that go through the port's continued fraction for the incomplete beta
  (Binomial, NegativeBinomial); atol 1e-15 besides, for log-cdfs a few ulp
  of 1 below 0;
- the gradient of logp in the float parameters against `jax.grad`, rtol
  1e-10 (HyperGeometric and DiscreteUniform have integer parameters only);
- `support_point`, exactly;
- 20,000 draws from a seeded `torch.Generator`: mean and variance within 5
  standard errors of scipy's (or of the sums named).
Then the stable forms of a probability given as `pm.math.sigmoid(z)`
(Binomial, Bernoulli, NegativeBinomial, Geometric) on a model at z down to
-800, where p underflows to 0 and the forms in z stay finite; the
Categorical's checks of a constant `p`; `compute_p` of the ordered classes.
"""

import functools
import math

import numpy as np
import pytest
import scipy.stats as st
import torch

import jax
import jax.numpy as jnp

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from pymc_tpu.blocking import unravel_vector
from pymc_tpu_torch.graph import evaluate

RTOL = 1e-12
RTOL_BETAINC = 1e-10
N_DRAWS = 20_000


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pmf_mv(pmf, kmax):
    k = np.arange(kmax + 1, dtype=np.float64)
    p = pmf(k)
    mean = float((k * p).sum())
    return mean, float((k**2 * p).sum() - mean**2)


def _discrete_weibull_pmf(q, beta):
    return lambda k: q ** (k**beta) - q ** ((k + 1) ** beta)


CAT_P = [0.2, 0.5, 0.3]
CUTS = [-1.0, 0.5, 2.0]


def _ordered_mv(cdf):
    z = np.concatenate([[0.0], cdf, [1.0]])
    return _pmf_mv(lambda k: np.diff(z)[k.astype(int)], 3)


# name -> params (valid sets first, then an invalid set), values, the
# float parameters of the grad set (`grad`, default the first set), and the
# moments of the first set: a frozen scipy distribution or (mean, var)
SPECS = {
    "Binomial": dict(
        params=[dict(n=10, p=0.3), dict(n=5, logit_p=-1.2), dict(n=10, p=1.2)],
        values=[-1, 0, 3, 10, 11], grad_params=("p",), moments=st.binom(10, 0.3),
        special=("logcdf",)),
    "BetaBinomial": dict(
        params=[dict(alpha=2.0, beta=3.0, n=10), dict(alpha=-1.0, beta=3.0, n=10)],
        values=[-1, 0, 4, 10, 11], grad_params=("alpha", "beta"), moments=st.betabinom(10, 2, 3)),
    "Bernoulli": dict(
        params=[dict(p=0.3), dict(logit_p=1.5), dict(p=1.5)],
        values=[-1, 0, 1, 2], grad_params=("p",), moments=st.bernoulli(0.3)),
    "DiscreteWeibull": dict(
        params=[dict(q=0.6, beta=1.3), dict(q=1.5, beta=1.0)],
        values=[-1, 0, 1, 5], grad_params=("q", "beta"),
        moments=_pmf_mv(_discrete_weibull_pmf(0.6, 1.3), 400)),
    "Poisson": dict(
        params=[dict(mu=3.5), dict(mu=0.0), dict(mu=-1.0)],
        values=[-1, 0, 2, 10], grad_params=("mu",), moments=st.poisson(3.5)),
    "NegativeBinomial": dict(
        params=[dict(mu=3.0, alpha=2.0), dict(p=0.4, n=5.0), dict(mu=2.0, n=1e12),
                dict(mu=3.0, alpha=-1.0)],
        values=[-1, 0, 3, 12], grad_params=("mu", "alpha"), moments=st.nbinom(2.0, 0.4),
        special=("logcdf",)),
    "Geometric": dict(
        params=[dict(p=0.3), dict(p=1.5)],
        values=[0, 1, 2, 8], grad_params=("p",), moments=st.geom(0.3)),
    "HyperGeometric": dict(
        params=[dict(N=20, k=7, n=5), dict(N=20, k=25, n=5)],
        values=[-1, 0, 2, 5, 6], grad_params=(), moments=st.hypergeom(20, 7, 5)),
    "DiscreteUniform": dict(
        params=[dict(lower=-2, upper=5), dict(lower=3, upper=1)],
        values=[-3, -2, 0, 5, 6], grad_params=(), moments=st.randint(-2, 6)),
    "Categorical": dict(
        params=[dict(p=CAT_P), dict(logit_p=[0.1, -0.5, 1.0])],
        values=[-1, 0, 1, 2, 3], grad=1, grad_params=("logit_p",),
        moments=_pmf_mv(lambda k: np.asarray(CAT_P)[k.astype(int)], 2)),
    "OrderedLogistic": dict(
        params=[dict(eta=0.5, cutpoints=CUTS), dict(eta=-1.0, cutpoints=[0.0, 1.0])],
        values=[-1, 0, 1, 2, 3, 4], grad_params=("eta", "cutpoints"),
        moments=_ordered_mv(1 / (1 + np.exp(-(np.asarray(CUTS) - 0.5))))),
    "OrderedProbit": dict(
        params=[dict(eta=0.3, cutpoints=CUTS, sigma=1.5),
                dict(eta=-1.0, cutpoints=[0.0, 1.0], sigma=-1.0)],
        values=[-1, 0, 1, 2, 3, 4], grad_params=("eta", "cutpoints", "sigma"),
        moments=_ordered_mv(st.norm.cdf((np.asarray(CUTS) - 0.3) / 1.5))),
}
assert sorted(SPECS) == sorted(pmj.distributions.discrete.__all__)
LOGCDF = sorted(n for n in SPECS if "_logcdf" in vars(getattr(pmj, n))
                or n in ("OrderedLogistic", "OrderedProbit"))


def compare(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=1e-15)


def _values(name):
    return np.asarray(SPECS[name]["values"], dtype=np.int64)


def _grad_args(name):
    """(the parameter set, the parameters held fixed, those differentiated,
    their values)."""
    spec = SPECS[name]
    params = spec["params"][spec.get("grad", 0)]
    keys = list(spec["grad_params"])
    fixed = {k: v for k, v in params.items() if k not in keys}
    return fixed, keys, [np.asarray(params[k], dtype=np.float64) for k in keys]


@functools.lru_cache(maxsize=None)
def _references():
    """Every pymc_tpu value of this module's tests, traced and compiled as
    one jitted function (an eager dispatch of every op a case took most of
    the module's time): each parameter set's logp and logcdf at the values,
    the support points and the gradients of logp."""

    def run():
        out = {}
        for name, spec in SPECS.items():
            v = jnp.asarray(_values(name))
            for i, params in enumerate(spec["params"]):
                d = getattr(pmj, name).dist(**params)
                out[f"logp {name} {i}"] = d.logp(v)
                if name in LOGCDF and params.get("n") != 1e12:
                    out[f"logcdf {name} {i}"] = d.logcdf(v)
                out[f"support_point {name} {i}"] = jnp.asarray(d.support_point())
            if spec["grad_params"]:
                fixed, keys, x0 = _grad_args(name)

                def f_jax(*xs, name=name, fixed=fixed, keys=keys, v=v):
                    lp = getattr(pmj, name).dist(**fixed, **dict(zip(keys, xs))).logp(v)
                    return jnp.sum(jnp.where(jnp.isfinite(lp), lp, 0.0))

                out[f"grad {name}"] = jax.grad(f_jax, argnums=tuple(range(len(keys))))(
                    *[jnp.asarray(x) for x in x0])
        return out

    return jax.tree.map(np.asarray, jax.jit(run)())


def both(name, method, i):
    """(port's, JAX package's) `method` of `.dist(**params)`, the i-th
    parameter set, at the values."""
    d = getattr(pmt, name).dist(**SPECS[name]["params"][i])
    got = getattr(d, method)(torch.as_tensor(_values(name)))
    return got.detach().numpy(), _references()[f"{method} {name} {i}"]


@pytest.mark.parametrize("name", sorted(SPECS))
def test_logp_matches(name):
    params = SPECS[name]["params"]
    for i in range(len(params)):
        compare(*both(name, "logp", i), RTOL)
    # the last set's parameters are invalid (the ordered classes check none)
    if name not in ("Categorical", "OrderedLogistic", "OrderedProbit"):
        assert np.isneginf(both(name, "logp", len(params) - 1)[0]).all()


@pytest.mark.parametrize("name", LOGCDF)
def test_logcdf_matches(name):
    rtol = RTOL_BETAINC if "logcdf" in SPECS[name].get("special", ()) else RTOL
    for i, p in enumerate(SPECS[name]["params"]):
        # at n = 1e12 p = n / (mu + n) keeps ~4 digits of 1 - p: a case of
        # the logp's Poisson limit, where neither package's logcdf is exact
        if p.get("n") != 1e12:
            compare(*both(name, "logcdf", i), rtol)


@pytest.mark.parametrize("name", sorted(n for n in SPECS if SPECS[n]["grad_params"]))
def test_logp_gradient_matches(name):
    fixed, keys, x0 = _grad_args(name)
    ref = _references()[f"grad {name}"]
    xs = [torch.tensor(x, requires_grad=True) for x in x0]
    lp = getattr(pmt, name).dist(**fixed, **dict(zip(keys, xs))).logp(
        torch.as_tensor(_values(name)))
    got = torch.autograd.grad(torch.where(torch.isfinite(lp), lp, 0.0).sum(), xs)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_support_point_matches(name):
    n = len(SPECS[name]["params"])
    for i in range(n - 1 if n > 1 else 1):
        ref = _references()[f"support_point {name} {i}"]
        got = getattr(pmt, name).dist(**SPECS[name]["params"][i]).support_point()
        assert got.dtype == torch.int64
        np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("name", sorted(SPECS))
def test_draws_match_moments(name):
    spec = SPECS[name]
    d = getattr(pmt, name).dist(**spec["params"][0])
    gen = torch.Generator().manual_seed(sum(map(ord, name)))
    x = d.sample(gen, N_DRAWS)
    assert x.shape == (N_DRAWS,) and x.dtype == torch.int64
    x = x.numpy().astype(np.float64)
    m = spec["moments"]
    mean, var = (m.mean(), m.var()) if hasattr(m, "mean") else m
    c = x - x.mean()
    se_var = math.sqrt(max(np.mean(c**4) - np.mean(c**2) ** 2, 0.0) / N_DRAWS)
    assert abs(x.mean() - mean) < 5 * math.sqrt(var / N_DRAWS), (x.mean(), mean)
    assert abs(x.var() - var) < 5 * se_var, (x.var(), var, se_var)


def _sigmoid_model(pm, name):
    y = {"Binomial": 3, "Bernoulli": 1, "NegativeBinomial": 4, "Geometric": 2}[name]
    with pm.Model() as m:
        z = pm.Normal("z", 0.0, 1.0)
        p = pm.math.sigmoid(z)
        if name == "Binomial":
            pm.Binomial("y", n=10, p=p, observed=y)
        elif name == "NegativeBinomial":
            pm.NegativeBinomial("y", n=3.0, p=p, observed=y)
        else:
            getattr(pm, name)("y", p=p, observed=y)
    return m


@pytest.mark.parametrize("name", ["Binomial", "Bernoulli", "NegativeBinomial", "Geometric"])
def test_sigmoid_probability_takes_the_stable_forms(name):
    mj, mt = _sigmoid_model(pmj, name), _sigmoid_model(pmt, name)
    assert mt["y"].dist.logit_p is not None
    z = np.array([-800.0, -30.0, 0.0, 2.5, 30.0])[:, None]
    lp, grad = mt.logp_dlogp_fn(device="cpu")(torch.as_tensor(z))
    info = mj.raveled_info()
    ref = np.asarray(jax.jit(jax.vmap(lambda q: mj.logp_fn()(unravel_vector(q, info))))(z))
    assert np.isfinite(lp.numpy()).all() and np.isfinite(grad.numpy()).all()
    np.testing.assert_allclose(lp.numpy(), ref, rtol=RTOL)


def test_categorical_checks_a_constant_p():
    with pytest.raises(ValueError, match="Negative `p`"):
        pmt.Categorical.dist(p=[-1.0, -1.0, 0.0, 0.0])
    with pytest.warns(UserWarning, match="automatically rescaled"):
        d = pmt.Categorical.dist(p=[2.0, 6.0])
    np.testing.assert_allclose(d.p.value.numpy(), [0.25, 0.75])


@pytest.mark.parametrize("name", ["OrderedLogistic", "OrderedProbit"])
def test_ordered_compute_p_registers_probs(name):
    params = dict(SPECS[name]["params"][0])

    def build(pm, compute_p):
        with pm.Model() as m:
            getattr(pm, name)("y", **params, observed=np.array([0, 2, 3]), compute_p=compute_p)
        return m

    mt = build(pmt, True)
    assert [d.name for d in mt.deterministics] == ["y_probs"]
    assert not build(pmt, False).deterministics
    probs = evaluate(mt["y_probs"])
    ref = np.asarray(getattr(pmj, name).compute_p(**params))
    np.testing.assert_allclose(probs.numpy(), ref, rtol=RTOL)
