"""The derived densities (Discretized, OrderStatistic/Max/Min, CumSum,
Compared), `Mixture.logcdf`, `moments.mean` and `shape_utils` of the port
against pymc_tpu, float64 on the CPU. The specification is
`tests/distributions/test_derived.py` (TestDiscretized,
TestOrderStatistic, TestCumSum, TestCompared, TestMixture::test_logcdf),
`tests/test_api_shims.py::TestMoments` and
`tests/distributions/test_shape_contract.py`.

Every pymc_tpu value of the module comes from one jitted call
(`_references`): each class's logp and logcdf at the same numpy inputs,
and the logp and gradient of seven of `models.SLICE_MODELS` and of
`models.derived_model`, held at rtol 1e-12 (1e-10 through the discrete
classes' incomplete gamma). Where the port does not copy the reference:
above the base's median Discretized takes its cell's mass as a survival
difference, exact where pymc_tpu's cdf difference cancels (at a cell 9 sds
out its logp is 1e-5 off and its gradient 1e-3, or NaN where both cdfs
round to 1), so those cells and models are held to scipy, and to pymc_tpu
only within 5 sds (ROADMAP.md §3).
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
from pymc_tpu.distributions import moments as moments_j
from pymc_tpu_torch.distributions import moments as moments_t
from pymc_tpu_torch.distributions.shape_utils import change_dist_size, to_tuple
from pymc_tpu_torch.exceptions import UndefinedMomentException
from pymc_tpu_torch.models import SLICE_MODELS, derived_model, slice_model


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


VALUES = np.array([-3.0, -1.0, 0.0, 0.3, 1.7, 2.0, 5.0])
COUNTS = np.array([0, 1, 2, 3, 5, 8])
MU, SIGMA = 0.4, 1.3
# the observations of the Discretized slice models (models._slice_discretized)
SLICE_Y = np.array([-2.0, -1.0, 0.0, 0.0, 1.0, 2.0, 3.0])


def _dists(pm):
    """{label: (distribution, values)}: every class and form of the module."""
    out = {}
    for m in ("round", "floor", "ceil", "trunc"):
        out[f"Discretized {m}"] = (pm.Discretized.dist(pm.Normal.dist(MU, SIGMA), m), VALUES)
    for n, k in ((5, 5), (5, 1), (5, 3)):
        out[f"OrderStatistic {k} of {n}"] = (
            pm.OrderStatistic.dist(pm.Normal.dist(MU, SIGMA), n, k), VALUES)
    out["Max Poisson"] = (pm.Max.dist(pm.Poisson.dist(2.5), 4), COUNTS)
    out["Min Poisson"] = (pm.Min.dist(pm.Poisson.dist(2.5), 4), COUNTS)
    for op in (">", ">=", "<", "<="):
        out[f"Compared Normal {op}"] = (pm.Compared.dist(pm.Normal.dist(MU, SIGMA), 0.5, op),
                                        np.array([0, 1, 2]))
        out[f"Compared Poisson {op}"] = (pm.Compared.dist(pm.Poisson.dist(2.5), 2, op),
                                         np.array([0, 1, 2]))
    w = np.array([0.3, 0.7])
    out["Mixture list"] = (pm.Mixture.dist(w, [pm.Normal.dist(-1.0, 1.0),
                                               pm.Normal.dist(2.0, 0.5)]), VALUES)
    out["Mixture batched"] = (pm.Mixture.dist(w, pm.Normal.dist(np.array([-1.0, 2.0]),
                                                                np.array([1.0, 0.5]))),
                              VALUES[:, None])
    return out


CDFS = [k for k in _dists(pmt) if k.startswith(("Discretized", "Mixture", "Max", "Min"))
        or k in ("OrderStatistic 5 of 5", "OrderStatistic 1 of 5")]


def _model_points(D, name=""):
    """4 flat points; the derived model's around its posterior (mu 2.1,
    log sigma 0.3)."""
    if name == "derived":
        return np.array([2.1, 0.3]) + np.random.default_rng(D).normal(0.0, 0.1, size=(4, D))
    return np.random.default_rng(D).normal(0.0, 0.5, size=(4, D))


# the models held to pymc_tpu's logp and gradient; the other SLICE_MODELS
# are held to scipy (the Discretized ones) or to their classes' densities
# above and their own finite differences (pymc_tpu's compile of every model
# would take most of the module's time)
JAX_MODELS = ("Discretized round", "OrderStatistic rank 2 of 5", "Max and Min of Poisson",
              "CumSum", "Mixture.logcdf", "CustomDist signature", "CustomDist dist=")


def _models():
    return {**{name: functools.partial(slice_model, name) for name in JAX_MODELS},
            "derived": derived_model}


@functools.lru_cache(maxsize=None)
def _references():
    """pymc_tpu's logp and logcdf of every case and logp and gradient of
    every model, in one jitted call."""
    dists = _dists(pmj)
    fns, args = {}, {}
    for name, build in _models().items():
        mj = build(pm=pmj)
        info, lf = mj.raveled_info(), mj.logp_fn()
        fns[name] = jax.vmap(jax.value_and_grad(
            lambda x, lf=lf, info=info: lf(unravel_vector(x, info))))
        args[name] = _model_points(info.total_size, name)

    @jax.jit
    def run(args):
        out = {f"logp {k}": d.logp(v) for k, (d, v) in dists.items()}
        out.update({f"logcdf {k}": dists[k][0].logcdf(dists[k][1]) for k in CDFS})
        out.update({f"model {k}": fns[k](args[k]) for k in fns})
        return out

    return jax.tree.map(np.asarray, run(args))


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("name", list(_dists(pmt)))
def test_logp_matches(name):
    d, v = _dists(pmt)[name]
    got = d.logp(_t(v)).numpy()
    ref = _references()[f"logp {name}"]
    if name.startswith("Discretized"):
        # above the median the port's survival difference is exact where
        # pymc_tpu's cdf difference cancels: hold those cells to scipy
        base = st.norm(MU, SIGMA)
        _, lo, hi = d._cell_bounds(_t(v).double())
        upper = base.cdf(lo.numpy()) > 0.5
        exact = np.log(base.sf(lo.numpy()) - base.sf(hi.numpy()))
        np.testing.assert_allclose(got[upper], exact[upper], rtol=1e-10)
        np.testing.assert_allclose(got[~upper], ref[~upper], rtol=1e-10)
    else:
        np.testing.assert_allclose(got, ref, rtol=1e-10)


@pytest.mark.parametrize("name", CDFS)
def test_logcdf_matches(name):
    d, v = _dists(pmt)[name]
    np.testing.assert_allclose(d.logcdf(_t(v)).numpy(), _references()[f"logcdf {name}"],
                               rtol=1e-10, atol=1e-15)


def _exact_discretized_logp(name, q):
    """The logp of the Discretized slice model at flat points q, from
    scipy: the priors, the log jacobian of sigma, and each cell's mass as a
    cdf difference below the median and a survival difference above it."""
    method = name.split()[-1]
    y = SLICE_Y
    out = []
    for mu, log_sigma in q:
        sigma = np.exp(log_sigma)
        k = {"round": np.round, "floor": np.floor, "ceil": np.ceil, "trunc": np.trunc}[method](y)
        lo, hi = {"round": (k - 0.5, k + 0.5), "floor": (k, k + 1.0), "ceil": (k - 1.0, k),
                  "trunc": (k - (k <= 0), k + (k >= 0))}[method]
        base = st.norm(mu, sigma)
        upper = base.cdf(lo) > 0.5
        mass = np.where(upper, base.sf(lo) - base.sf(hi), base.cdf(hi) - base.cdf(lo))
        out.append(st.norm.logpdf(mu) + st.halfnorm.logpdf(sigma) + log_sigma
                   + np.log(mass).sum())
    return np.array(out)


@pytest.mark.parametrize("name", list(_models()))
def test_model_logp_and_grad_match(name):
    mt = _models()[name]()
    q = _model_points(mt.raveled_info().total_size, name)
    lp, g = mt.logp_dlogp_fn(device="cpu")(torch.tensor(q))
    lp_j, g_j = _references()[f"model {name}"]
    assert torch.isfinite(g).all()
    rtol = 1e-10 if name.startswith(("Max and Min", "Compared", "derived")) else 1e-12
    keep = np.ones(len(q), bool)
    if name.startswith("Discretized"):
        # pymc_tpu's cdf difference cancels in the upper tail (a NaN
        # gradient where both cdfs round to 1); the port's survival
        # difference is exact there: hold the port to scipy everywhere and
        # to pymc_tpu where every cell's upper edge is within 5 sds
        np.testing.assert_allclose(lp.numpy(), _exact_discretized_logp(name, q), rtol=1e-10)
        keep = (SLICE_Y.max() + 1.0 - q[:, 0]) / np.exp(q[:, 1]) < 5.0
        rtol = 1e-7
        assert keep.any()
    np.testing.assert_allclose(lp.numpy()[keep], lp_j[keep], rtol=rtol)
    np.testing.assert_allclose(g.numpy()[keep], g_j[keep], rtol=rtol, atol=1e-10)


@pytest.mark.parametrize("name", [f"Discretized {m}" for m in ("floor", "ceil", "trunc")])
def test_discretized_models_match_scipy(name):
    mt = slice_model(name)
    q = _model_points(mt.raveled_info().total_size)
    lp, g = mt.logp_dlogp_fn(device="cpu")(torch.tensor(q))
    np.testing.assert_allclose(lp.numpy(), _exact_discretized_logp(name, q), rtol=1e-10)
    assert torch.isfinite(g).all()


@pytest.mark.parametrize("name", list(SLICE_MODELS))
def test_slice_model_gradients_are_their_finite_differences(name):
    mt = slice_model(name)
    D = mt.raveled_info().total_size
    q = torch.tensor(_model_points(D))
    fn = mt.logp_dlogp_fn(device="cpu")
    _, g = fn(q)
    h = 1e-6
    for i in range(D):
        step = torch.zeros(D, dtype=torch.float64)
        step[i] = h
        fd = (fn(q + step)[0] - fn(q - step)[0]) / (2 * h)
        np.testing.assert_allclose(g[:, i].numpy(), fd.numpy(), rtol=1e-5, atol=1e-6)


def test_discretized_pmf_sums_to_one_and_draws_match():
    for m in ("round", "floor", "ceil", "trunc"):
        d = pmt.Discretized.dist(pmt.Normal.dist(MU, SIGMA), m)
        k = torch.arange(-30, 31)
        np.testing.assert_allclose(float(torch.exp(d.logp(k)).sum()), 1.0, rtol=1e-10)
    d = pmt.Discretized.dist(pmt.Normal.dist(MU, SIGMA, shape=(3,)), "round")
    draws = d.sample(torch.Generator().manual_seed(0), (20_000,))
    assert draws.dtype == torch.int64 and draws.shape == (20_000, 3)
    freq = float((draws == 0).double().mean())
    p0 = float(torch.exp(d.logp(torch.zeros(3, dtype=torch.int64)))[0])
    assert abs(freq - p0) < 5 * np.sqrt(p0 * (1 - p0) / 60_000)
    assert int(d.support_point()[0]) == 0
    with pytest.raises(ValueError, match="continuous base"):
        pmt.Discretized.dist(pmt.Poisson.dist(2.0))


def test_order_statistics_integrate_draw_and_check():
    d = pmt.OrderStatistic.dist(pmt.Normal.dist(MU, SIGMA), 5, 3)
    x = torch.linspace(-8.0, 8.0, 4001, dtype=torch.float64)
    np.testing.assert_allclose(float(torch.trapezoid(torch.exp(d.logp(x)), x)), 1.0, rtol=1e-6)
    mx = pmt.Max.dist(pmt.Normal.dist(MU, SIGMA), 4)
    draws = mx.sample(torch.Generator().manual_seed(1), (20_000,))
    exact = float(torch.trapezoid(x * torch.exp(mx.logp(x)), x))
    assert abs(float(draws.mean()) - exact) < 5 * float(draws.std()) / np.sqrt(20_000)
    np.testing.assert_allclose(float(mx.support_point()),
                               float(np.asarray(pmj.Max.dist(pmj.Normal.dist(MU, SIGMA), 4)
                                                .support_point())), rtol=1e-12)
    with pytest.raises(NotImplementedError, match="minimum"):
        pmt.OrderStatistic.dist(pmt.Poisson.dist(2.0), 4, 2)
    with pytest.raises(ValueError, match="scalar"):
        pmt.Max.dist(pmt.Normal.dist(np.zeros(3), 1.0), 4)


def test_cumsum_is_a_random_walk():
    base = pmt.Normal.dist(0.2, 1.0, shape=(3, 4))
    c = pmt.CumSum.dist(base, axis=0)
    x = torch.tensor(np.random.default_rng(3).normal(size=(3, 4)))
    np.testing.assert_allclose(c.logp(x).numpy(),
                               base.logp(torch.diff(x, dim=0, prepend=torch.zeros(1, 4))).numpy())
    ref = pmj.CumSum.dist(pmj.Normal.dist(0.2, 1.0, shape=(3, 4)), axis=0)
    np.testing.assert_allclose(c.logp(x).numpy(), np.asarray(ref.logp(x.numpy())), rtol=1e-12)
    draws = c.sample(torch.Generator().manual_seed(2), (5,))
    assert draws.shape == (5, 3, 4)
    np.testing.assert_allclose(c.support_point().numpy(), np.cumsum(np.full((3, 4), 0.2), 0))
    with pytest.raises(ValueError, match="base shape"):
        pmt.CumSum.dist(base, shape=(5,))


def test_compared_draws():
    d = pmt.Compared.dist(pmt.Normal.dist(MU, SIGMA, shape=(2,)), 0.5, ">")
    draws = d.sample(torch.Generator().manual_seed(4), (20_000,))
    p = st.norm(MU, SIGMA).sf(0.5)
    assert draws.dtype == torch.int64
    assert abs(float(draws.double().mean()) - p) < 5 * np.sqrt(p * (1 - p) / 40_000)
    assert d.support_point().tolist() == [int(p > 0.5)] * 2


@pytest.mark.parametrize("form", ["Mixture list", "Mixture batched"])
def test_mixture_logcdf_of_a_python_list_value(form):
    """A list value is cast as a float64 one (not torch's default float32)
    and gives pymc_tpu's log-cdf."""
    d, v = _dists(pmt)[form]
    got = d.logcdf(v.tolist())
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), _references()[f"logcdf {form}"], rtol=1e-10,
                               atol=1e-15)


def test_mixture_logcdf_of_a_multivariate_mixture_raises():
    mix = pmt.Mixture.dist(np.array([0.5, 0.5]),
                           [pmt.MvNormal.dist(np.zeros(2), np.eye(2))] * 2)
    with pytest.raises(NotImplementedError, match="multivariate"):
        mix.logcdf(torch.zeros(2, dtype=torch.float64))


MEANS = {
    "Gamma": dict(alpha=3.0, beta=2.0), "Weibull": dict(alpha=2.0, beta=3.0),
    "LogNormal": dict(mu=0.5, sigma=0.8), "SkewNormal": dict(mu=1.0, sigma=2.0, alpha=3.0),
    "BetaBinomial": dict(alpha=2.0, beta=3.0, n=10), "HalfNormal": dict(sigma=2.0),
    "Poisson": dict(mu=4.5), "Rice": dict(nu=1.0, sigma=2.0), "Beta": dict(alpha=2.0, beta=5.0),
    "Pareto": dict(alpha=3.0, m=1.5), "Kumaraswamy": dict(a=2.0, b=3.0),
    "HalfStudentT": dict(nu=4.0, sigma=1.5), "Dirichlet": dict(a=np.array([1.0, 2.0, 3.0])),
}


def test_means_match_pymc_tpu_and_scipy():
    for name, kw in MEANS.items():
        got = moments_t.mean(getattr(pmt, name).dist(**kw), device="cpu").numpy()
        np.testing.assert_allclose(got, np.asarray(moments_j.mean(getattr(pmj, name).dist(**kw))),
                                   rtol=1e-12, err_msg=name)
    np.testing.assert_allclose(float(moments_t.mean(pmt.Weibull.dist(2.0, 3.0), device="cpu")),
                               st.weibull_min(2, scale=3).mean(), rtol=1e-10)
    rice = pmt.Rice.dist(nu=1.0, sigma=2.0)
    np.testing.assert_allclose(float(moments_t.mean(rice, device="cpu")),
                               st.rice(0.5, scale=2.0).mean(), rtol=1e-10)
    mix = pmt.Mixture.dist(np.array([0.25, 0.75]), [pmt.Normal.dist(-1.0, 1.0),
                                                    pmt.Normal.dist(3.0, 1.0)])
    assert float(moments_t.mean(mix, device="cpu")) == 2.0
    zip_ = pmt.ZeroInflatedPoisson.dist(psi=0.6, mu=5.0, shape=(3,))
    np.testing.assert_allclose(moments_t.mean(zip_, device="cpu").numpy(), np.full(3, 3.0))
    assert moments_t.mean(pmt.Normal.dist(1.0, 2.0, shape=(2, 3)), device="cpu").shape == (2, 3)
    with pytest.raises(UndefinedMomentException):
        moments_t.mean(pmt.Cauchy.dist(0.0, 1.0), device="cpu")
    with pytest.raises(NotImplementedError, match="No analytic mean"):
        moments_t.mean(pmt.Interpolated.dist(np.linspace(0, 1, 5), np.ones(5)), device="cpu")


def test_means_on_an_explicit_device():
    """The mean is computed on the device asked for, in its float type, also
    for integer parameters (a CPU run has no card: the default raises)."""
    for dist, want in ((pmt.HyperGeometric.dist(N=7, k=3, n=2), 6.0 / 7.0),
                       (pmt.DiscreteUniform.dist(lower=1, upper=4, shape=(2,)), 2.5),
                       (pmt.Binomial.dist(n=np.array([3, 5]), p=0.3), [0.9, 1.5])):
        got = moments_t.mean(dist, device="cpu")
        assert got.device.type == "cpu" and got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), np.broadcast_to(want, got.shape), rtol=1e-15)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            moments_t.mean(pmt.Normal.dist(0.0, 1.0))


def test_shape_utils_match():
    assert [to_tuple(s) for s in (None, 3, (2, 3), [4], np.int64(5))] == \
        [(), (3,), (2, 3), (4,), (5,)]
    d = pmt.Normal.dist(mu=1.5, sigma=2.0, size=(3,))
    assert d.shape == (3,)
    resized = change_dist_size(d, (5, 3))
    assert resized.shape == (5, 3) and float(resized.logp(torch.zeros(5, 3))[0, 0]) == float(
        d.logp(torch.zeros(3))[0])
    assert change_dist_size(d, (2,), expand=True).shape == (2, 3)
    assert change_dist_size(pmt.MvNormal.dist(np.zeros(3), np.eye(3)), (4,)).shape == (4, 3)
    assert change_dist_size(pmt.Poisson.dist(3.0, size=(7,)), 2).shape == (2,)
    with pytest.raises(ValueError, match="both shape and size"):
        pmt.Normal.dist(0.0, 1.0, shape=(3,), size=(3,))
    assert pmt.MvNormal.dist(np.zeros(3), np.eye(3), size=(2,)).shape == (2, 3)
