"""The multivariate distributions of pymc_tpu_torch beyond MvNormal,
MvStudentT, Dirichlet and KroneckerNormal (the LKJ family, Wishart,
ZeroSumNormal, the multinomials, MatrixNormal, CAR, ICAR,
StickBreakingWeights) against pymc_tpu's, float64
on the CPU, the same parameters and values through both packages
(tests/distributions/test_multivariate*.py are the specification):
- `logp` on a batch of seeded values, values outside the support and
  invalid parameters (-inf there, in the same places): rtol 1e-10;
- the joint logp and gradient of a small model that holds the class as a
  free variable through its default transform (or, for the discrete
  classes, as a likelihood whose parameters are free;
  `models.multivariate_model`, which `chip_smoke.py` phase 14c runs on the
  card), at 8 points:
  logp rtol 1e-10, gradient rtol 1e-9 (atol 1e-9 of the largest entry);
- `support_point` (of the first parameter set): rtol 1e-12;
- 20,000 draws from a seeded `torch.Generator`: the mean and variance of
  each entry within 5 standard errors of the exact moments (the two
  packages cannot draw the same numbers); ICAR cannot be drawn from.
Where the port keeps PyMC's semantics and the JAX package does not (a
Wishart value that is symmetric with a positive determinant but is not
positive definite), the test says so.
"""

import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from pymc_tpu.blocking import unravel_vector
from pymc_tpu_torch.models import (
    MULTIVARIATE_MODELS, MV_COLCOV, MV_RING, MV_ROWCOV, multivariate_model,
)

RTOL = 1e-10
GRAD_RTOL = 1e-9
N_DRAWS = 20_000


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rng(name):
    return np.random.default_rng(sum(map(ord, name)))


def _spd(rng, p, k=()):
    A = rng.normal(size=k + (p, p))
    return A @ np.swapaxes(A, -1, -2) + p * np.eye(p)


def _corr(rng, n, k):
    S = _spd(rng, n, (k,))
    s = np.sqrt(np.diagonal(S, axis1=-2, axis2=-1))
    return S / (s[..., :, None] * s[..., None, :])


def _packed(M, offset):
    r, c = np.tril_indices(M.shape[-1], offset)
    return M[..., r, c]


RING, U3, V2 = MV_RING, MV_ROWCOV, MV_COLCOV


def _lkj_corr_values(rng):
    good = _packed(_corr(rng, 3, 5), -1)
    # r12 = r13 = 0.9, r23 = -0.9: not positive definite
    return np.concatenate([good, [[0.9, 0.9, -0.9]]])


def _lkj_cov_values(rng):
    good = _packed(np.linalg.cholesky(_spd(rng, 3, (5,))), 0)
    bad = good[0].copy()
    bad[2] = -bad[2]  # a negative diagonal entry
    return np.concatenate([good, bad[None]])


def _multinomial_values(rng, n, k):
    good = rng.multinomial(n, np.full(k, 1.0 / k), size=6)
    wrong_total = good[0] + np.eye(k, dtype=int)[0]
    negative = good[1] - 2 * good[1].max() * np.eye(k, dtype=int)[1] + good[1].max() * 2 * np.eye(
        k, dtype=int)[0]
    return np.concatenate([good, wrong_total[None], negative[None]])


def _zero_sum(rng, shape, axes):
    x = rng.normal(size=shape)
    for ax in axes:
        x = x - x.mean(axis=ax, keepdims=True)
    off = x[:1] + 0.1  # off the support
    return np.concatenate([x, off])


def _stick_values(rng, K):
    good = rng.dirichlet(np.ones(K + 1), size=5)
    return np.concatenate([good, [np.full(K + 1, 0.3)]])


# name -> (class name, [params (valid sets first, then an invalid one)],
# values(rng)); the last parameter set must give -inf everywhere
LOGP = {
    "LKJCorr": ("LKJCorr", [dict(n=3, eta=2.0), dict(n=3, eta=0.7), dict(n=3, eta=-1.0)],
                _lkj_corr_values),
    "LKJCorr_matrix": ("LKJCorr", [dict(n=3, eta=1.5, return_matrix=True)],
                       lambda rng: np.concatenate([_corr(rng, 3, 4), [[[1.0, 0.9, 0.9],
                                                                       [0.9, 1.0, -0.9],
                                                                       [0.9, -0.9, 1.0]]]])),
    "LKJCholeskyCov": ("_LKJCholeskyCov", [
        dict(eta=2.0, n=3, sd_dist="exp"), dict(eta=0.5, n=3, sd_dist="halfnormal"),
        dict(eta=-0.5, n=3, sd_dist="exp")], _lkj_cov_values),
    "Wishart": ("Wishart", [dict(nu=5.0, V=U3), dict(nu=3.5, V=np.eye(3)),
                            dict(nu=1.0, V=U3)],
                lambda rng: np.concatenate([_spd(rng, 3, (5,)), [np.diag([-1.0, -2.0, 3.0])]])),
    "Wishart_scale_chol": ("Wishart", [dict(nu=4.0, scale_chol=np.linalg.cholesky(U3))],
                           lambda rng: _spd(rng, 3, (5,))),
    "Multinomial": ("Multinomial", [dict(n=10, p=[0.2, 0.3, 0.5]),
                                    dict(n=10, p=[0.1, 0.1, 0.8])],
                    lambda rng: _multinomial_values(rng, 10, 3)),
    "DirichletMultinomial": ("DirichletMultinomial", [
        dict(n=10, a=[0.5, 2.0, 1.5]), dict(n=10, a=[3.0, 3.0, 3.0]),
        dict(n=10, a=[-1.0, 2.0, 1.5])], lambda rng: _multinomial_values(rng, 10, 3)),
    "OrderedMultinomial": ("OrderedMultinomial", [
        dict(eta=0.3, cutpoints=[-1.0, 0.5, 2.0], n=12), dict(eta=-1.2, cutpoints=[-1.0, 0.5, 2.0],
                                                              n=12)],
        lambda rng: _multinomial_values(rng, 12, 4)),
    "MatrixNormal": ("MatrixNormal", [
        dict(mu=np.arange(6.0).reshape(3, 2), rowcov=U3, colcov=V2),
        dict(mu=0.5, rowchol=np.linalg.cholesky(U3), colchol=np.linalg.cholesky(V2))],
        lambda rng: rng.normal(size=(4, 3, 2))),
    "CAR": ("CAR", [dict(mu=np.zeros(5), W=RING, alpha=0.6, tau=2.0),
                    dict(mu=np.linspace(-1, 1, 5), W=RING, alpha=-0.3, tau=0.5),
                    dict(mu=np.zeros(5), W=RING, alpha=1.0, tau=2.0)],
            lambda rng: rng.normal(size=(4, 5))),
    "ICAR": ("ICAR", [dict(W=RING, sigma=1.5), dict(W=RING, sigma=0.7, zero_sum_stdev=0.01),
                      dict(W=RING, sigma=-1.0)], lambda rng: rng.normal(size=(4, 5))),
    "StickBreakingWeights": ("StickBreakingWeights", [
        dict(alpha=2.0, K=4), dict(alpha=0.5, K=4), dict(alpha=-1.0, K=4)],
        lambda rng: _stick_values(rng, 4)),
    "ZeroSumNormal": ("ZeroSumNormal", [dict(sigma=1.5, shape=(5,)), dict(sigma=0.3, shape=(5,)),
                                        dict(sigma=-1.0, shape=(5,))],
                      lambda rng: _zero_sum(rng, (4, 5), (-1,))),
    "ZeroSumNormal_2axes": ("ZeroSumNormal", [
        dict(sigma=0.8, n_zerosum_axes=2, shape=(3, 4))],
        lambda rng: _zero_sum(rng, (4, 3, 4), (-1, -2))),
    "ZeroSumNormal_support_shape": ("ZeroSumNormal", [dict(sigma=2.0, support_shape=6)],
                                    lambda rng: _zero_sum(rng, (3, 6), (-1,))),
}


def _dist(pm, cls_name, params):
    params = dict(params)
    sd = params.get("sd_dist")
    if sd == "exp":
        params["sd_dist"] = pm.Exponential.dist(1.0, shape=3)
    elif sd == "halfnormal":
        params["sd_dist"] = pm.HalfNormal.dist(2.0, shape=3)
    if cls_name == "_LKJCholeskyCov":
        from pymc_tpu.distributions.multivariate import _LKJCholeskyCov as jcls
        from pymc_tpu_torch.distributions.multivariate import _LKJCholeskyCov as tcls

        return (jcls if pm is pmj else tcls).dist(**params)
    return getattr(pm, cls_name).dist(**params)


# the values built off the support come last in these cases
OFF_SUPPORT_LAST = ("LKJCorr", "LKJCorr_matrix", "LKJCholeskyCov", "Multinomial",
                    "DirichletMultinomial", "StickBreakingWeights", "ZeroSumNormal", "Wishart")


@pytest.mark.parametrize("name", sorted(LOGP))
def test_logp_and_support_point_match(name):
    cls_name, param_sets, values = LOGP[name]
    x = values(_rng(name))
    dists = [_dist(pmj, cls_name, params) for params in param_sets]
    # one compilation for every parameter set and the support point
    ref = jax.jit(lambda v: [d.logp(v) for d in dists] + [dists[0].support_point()])(
        jnp.asarray(x))
    got = [_dist(pmt, cls_name, params) for params in param_sets]
    for d, r in zip(got, ref):
        lp, r = d.logp(torch.as_tensor(x)).numpy(), np.asarray(r)
        if name == "Wishart":
            # the last value is symmetric with a positive determinant and
            # two negative eigenvalues: PyMC's matrix_pos_def check gives
            # -inf, and so does the port; pymc_tpu tests only the sign of
            # the determinant and gives a finite logp (ROADMAP.md §3)
            assert np.isneginf(lp[-1]) and (np.isfinite(r[-1]) or np.isneginf(lp).all())
            lp, r = lp[:-1], r[:-1]
        np.testing.assert_allclose(lp, r, rtol=RTOL)
    if len(param_sets) > 2:
        assert np.isneginf(got[-1].logp(torch.as_tensor(x)).numpy()).all()
    if name in OFF_SUPPORT_LAST:
        assert np.isneginf(got[0].logp(torch.as_tensor(x)).numpy()[-1])
    sp = got[0].support_point().numpy()
    np.testing.assert_allclose(sp, np.broadcast_to(np.asarray(ref[-1]), sp.shape), rtol=1e-12)


def test_multinomial_constant_p_checks():
    with pytest.raises(ValueError, match="Negative `p`"):
        pmt.Multinomial.dist(n=5, p=[-0.1, 1.1])
    with pytest.warns(UserWarning, match="automatically rescaled"):
        d = pmt.Multinomial.dist(n=5, p=[1.0, 3.0])
    np.testing.assert_allclose(d.p.value.numpy(), [0.25, 0.75])


@pytest.mark.parametrize("W, msg", [
    (np.ones(3), "ndim=2"), (np.ones((2, 3)), "square"),
    (np.array([[0, 1], [0, 0]]), "symmetric"), (np.array([[0, 2], [2, 0]]), "only 1s and 0s"),
])
def test_icar_matrix_checks(W, msg):
    with pytest.raises(ValueError, match=msg):
        pmt.ICAR.dist(W=W)


def test_car_w_must_be_a_matrix():
    with pytest.raises(TypeError, match="W must be a matrix"):
        pmt.CAR.dist(mu=np.zeros(3), W=np.ones(3), alpha=0.5, tau=1.0)


def test_car_nonsymmetric_w_is_neg_inf():
    W = RING.copy()
    W[0, 1] = 0.0
    x = torch.as_tensor(np.linspace(-1, 1, 5))
    assert np.isneginf(float(pmt.CAR.dist(mu=np.zeros(5), W=W, alpha=0.5, tau=1.0).logp(x)))


@pytest.mark.parametrize("name", sorted(MULTIVARIATE_MODELS))
def test_model_logp_and_grad_match(name):
    mj, mt = multivariate_model(name, pmj), multivariate_model(name, pmt)
    ij, it = mj.raveled_info(), mt.raveled_info()
    assert list(it.names) == list(ij.names) and it.shapes == ij.shapes
    q = _rng(name).normal(0.0, 0.6, size=(8, it.total_size))
    lp, grad = mt.logp_dlogp_fn(device="cpu")(torch.as_tensor(q))
    f = jax.jit(jax.vmap(jax.value_and_grad(lambda z: mj.logp_fn()(unravel_vector(z, ij)))))
    lp_ref, grad_ref = (np.asarray(a) for a in f(jnp.asarray(q)))
    assert np.isfinite(lp_ref).all()
    np.testing.assert_allclose(lp.numpy(), lp_ref, rtol=RTOL)
    np.testing.assert_allclose(grad.numpy(), grad_ref, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * np.abs(grad_ref).max())


def _multinomial_mv(n, p):
    p = np.asarray(p)
    return n * p, n * p * (1 - p)


def _dm_mv(n, a):
    a = np.asarray(a)
    A = a.sum()
    return n * a / A, n * (a / A) * (1 - a / A) * (n + A) / (1 + A)


def _stick_mv(alpha, K):
    k = np.arange(K)
    mean = np.append(1 / (1 + alpha) * (alpha / (1 + alpha)) ** k, (alpha / (1 + alpha)) ** K)
    m2 = np.append(2 / ((1 + alpha) * (2 + alpha)) * (alpha / (alpha + 2)) ** k,
                   (alpha / (alpha + 2)) ** K)
    return mean, m2 - mean**2


def _om_probs(eta, cut):
    cdf = 1 / (1 + np.exp(-(np.asarray(cut) - eta)))
    return np.diff(np.concatenate([[0.0], cdf, [1.0]]))


def _car_mv(W, alpha, tau):
    cov = np.linalg.inv(tau * (np.diag(W.sum(-1)) - alpha * W))
    return np.zeros(len(W)), np.diag(cov)


def _corr_entries(x, n, packed_cov):
    """The strictly-lower correlations of each draw (and the stds of a
    packed covariance factor)."""
    if not packed_cov:
        return x, None
    L = np.zeros(x.shape[:-1] + (n, n))
    r, c = np.tril_indices(n)
    L[..., r, c] = x
    sd = np.sqrt((L**2).sum(-1))
    C = L @ np.swapaxes(L, -1, -2) / (sd[..., :, None] * sd[..., None, :])
    return _packed(C, -1), sd


# name -> (class, params, draws -> the statistics held, (exact means, exact variances))
MOMENTS = {
    "LKJCorr": ("LKJCorr", dict(n=4, eta=2.0), lambda x: x, (0.0, 1 / (4 + 4 - 1))),
    "LKJCorr_matrix": ("LKJCorr", dict(n=3, eta=1.5, return_matrix=True),
                       lambda x: _packed(x, -1), (0.0, 1 / (3 + 3 - 1))),
    "LKJCholeskyCov": ("_LKJCholeskyCov", dict(eta=2.0, n=3, sd_dist="exp"),
                       lambda x: np.concatenate(_corr_entries(x, 3, True), -1),
                       (np.r_[0.0, 0.0, 0.0, 1.0, 1.0, 1.0], np.r_[[1 / 6] * 3, [1.0] * 3])),
    "Wishart": ("Wishart", dict(nu=5.0, V=U3), lambda x: x.reshape(len(x), -1),
                (5.0 * U3.ravel(), 5.0 * (U3**2 + np.outer(np.diag(U3), np.diag(U3))).ravel())),
    "Multinomial": ("Multinomial", dict(n=10, p=[0.2, 0.3, 0.5]), lambda x: x,
                    _multinomial_mv(10, [0.2, 0.3, 0.5])),
    "DirichletMultinomial": ("DirichletMultinomial", dict(n=10, a=[0.5, 2.0, 1.5]), lambda x: x,
                             _dm_mv(10, [0.5, 2.0, 1.5])),
    "OrderedMultinomial": ("OrderedMultinomial", dict(eta=0.3, cutpoints=[-1.0, 0.5, 2.0], n=12),
                           lambda x: x, _multinomial_mv(12, _om_probs(0.3, [-1.0, 0.5, 2.0]))),
    "MatrixNormal": ("MatrixNormal", dict(mu=np.arange(6.0).reshape(3, 2), rowcov=U3, colcov=V2),
                     lambda x: x.reshape(len(x), -1),
                     (np.arange(6.0), np.outer(np.diag(U3), np.diag(V2)).ravel())),
    "CAR": ("CAR", dict(mu=np.zeros(5), W=RING, alpha=0.6, tau=2.0), lambda x: x,
            _car_mv(RING, 0.6, 2.0)),
    "StickBreakingWeights": ("StickBreakingWeights", dict(alpha=2.0, K=4), lambda x: x,
                             _stick_mv(2.0, 4)),
    "ZeroSumNormal": ("ZeroSumNormal", dict(sigma=1.5, shape=(5,)), lambda x: x,
                      (0.0, 1.5**2 * (1 - 1 / 5))),
    "ZeroSumNormal_2axes": ("ZeroSumNormal", dict(sigma=0.8, n_zerosum_axes=2, shape=(3, 4)),
                            lambda x: x.reshape(len(x), -1),
                            (0.0, 0.8**2 * (1 - 1 / 3) * (1 - 1 / 4))),
}


@pytest.mark.parametrize("name", sorted(MOMENTS))
def test_draws_match_moments(name):
    cls_name, params, stat, (mean, var) = MOMENTS[name]
    d = _dist(pmt, cls_name, params)
    x = d.sample(torch.Generator().manual_seed(sum(map(ord, name))), N_DRAWS).numpy()
    assert x.shape == (N_DRAWS,) + d.shape and np.isfinite(x).all()
    if name.startswith("ZeroSumNormal"):
        for ax in range(1, params.get("n_zerosum_axes", 1) + 1):
            np.testing.assert_allclose(x.sum(axis=-ax), 0.0, atol=1e-12)
    if name in ("StickBreakingWeights",):
        np.testing.assert_allclose(x.sum(-1), 1.0, rtol=1e-12)
    if "Multinomial" in name:
        assert x.dtype == np.int64 and (x.sum(-1) == params["n"]).all()
    s = stat(x).astype(np.float64)
    c = s - s.mean(0)
    se_mean = np.sqrt(np.broadcast_to(var, s.shape[1:]) / N_DRAWS)
    se_var = np.sqrt(np.maximum(np.mean(c**4, 0) - np.mean(c**2, 0) ** 2, 0.0) / N_DRAWS)
    z_mean = (s.mean(0) - mean) / se_mean
    z_var = (s.var(0) - var) / se_var
    assert np.abs(z_mean).max() < 5 and np.abs(z_var).max() < 5, (z_mean, z_var)


def test_icar_cannot_be_drawn_from():
    with pytest.raises(NotImplementedError, match="Cannot sample"):
        pmt.ICAR.dist(W=RING).sample(torch.Generator().manual_seed(0), 3)


def test_wishart_bartlett_shim():
    for pm in (pmj, pmt):
        with pm.Model() as m, pytest.warns(FutureWarning, match="deprecated"):
            pm.WishartBartlett("w", S=U3, nu=5.0)
        assert [rv.name for rv in m.free_RVs] == ["w"]
    with pmt.Model() as m, warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        chol = pmt.WishartBartlett("L", S=np.linalg.cholesky(U3), nu=5.0, is_cholesky=True,
                                   return_cholesky=True)
    assert [rv.name for rv in m.free_RVs] == ["_L_wishart"] and chol.shape == (3, 3)
    with pytest.raises(NotImplementedError, match="initval"), pmt.Model(), \
            warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        pmt.WishartBartlett("w", S=U3, nu=5.0, initval=U3)


def test_lkj_cholesky_cov_returns_its_deterministics():
    with pmt.Model() as m:
        out = pmt.LKJCholeskyCov("c", n=3, eta=2.0, sd_dist=pmt.Exponential.dist(1.0, shape=3))
        packed = pmt.LKJCholeskyCov("p", n=3, eta=2.0,
                                    sd_dist=pmt.Exponential.dist(1.0, shape=3), compute_corr=False)
    assert [d.name for d in m.deterministics] == ["c_chol", "c_corr", "c_stds"]
    assert [tuple(o.shape) for o in out] == [(3, 3), (3, 3), (3,)] and packed.shape == (6,)
    q = torch.as_tensor(_rng("lkjcov").normal(size=(4, 12)))
    post = m.postprocess_fn(device="cpu")(q)
    L = post["c_chol"]
    np.testing.assert_allclose(post["c_stds"].numpy(), L.pow(2).sum(-1).sqrt().numpy(),
                               rtol=1e-12)
    np.testing.assert_allclose(torch.diagonal(post["c_corr"], dim1=-2, dim2=-1).numpy(), 1.0,
                               rtol=1e-12)



def test_prior_predictive_draws_anew_for_each_point():
    # sample_prior_predictive maps one draw over the points with
    # torch.func.vmap(randomness="different"), which an in-place draw
    # (Tensor.exponential_) cannot take: Exponential, the classes drawn
    # through it, Categorical, and LKJCholeskyCov with an Exponential sd_dist
    with pmt.Model() as m:
        pmt.Exponential("e", 2.0)
        pmt.Categorical("k", p=[0.2, 0.8])
        pmt.LKJCholeskyCov("c", n=2, eta=2.0, sd_dist=pmt.Exponential.dist(1.0, shape=2))
    n = 4000
    draws = pmt.sample_prior_predictive(n, model=m, random_seed=0, device="cpu",
                                        return_inferencedata=False)
    for name, mean, sd in (("e", 0.5, 0.5), ("k", 0.8, 0.4)):
        x = draws[name]
        assert x.shape == (n,) and abs(x.mean() - mean) < 5 * sd / np.sqrt(n)
    assert draws["c_stds"].shape == (n, 2) and np.unique(draws["c_stds"]).size == 2 * n
    assert abs(draws["c_stds"].mean() - 1.0) < 5 / np.sqrt(2 * n)
