"""The port's covariance functions against pymc_tpu on the CPU, in float64.

Every class of `pymc_tpu/gp/cov.py`: the full matrix, its diagonal and the
cross-covariance at rtol 1e-10, with active_dims, vector lengthscales and
the algebra; the power spectral densities (ExpQuad, the Materns, scaled
and summed) and Periodic's expansion coefficients at rtol 1e-10. The cases
copy `tests/test_gp_cov_oracle.py`'s; a warping, lengthscale or scaling
function is written once per package (jax.numpy or torch).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import pymc_tpu as pmj
import pymc_tpu_torch as pmt


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _xp(pm):
    return jnp if pm is pmj else torch


RNG = np.random.default_rng(11)
X1 = np.sort(RNG.uniform(0, 3, 10))[:, None]
XS1 = np.linspace(-0.5, 3.5, 6)[:, None]
X2 = RNG.normal(size=(9, 2))
XS2 = RNG.normal(size=(5, 2))
W = RNG.random((6, 3))
KAPPA = RNG.random(6)
XC = np.concatenate([RNG.integers(0, 6, size=(8, 1)), RNG.random((8, 1))], axis=1)
XCS = np.concatenate([RNG.integers(0, 6, size=(4, 1)), RNG.random((4, 1))], axis=1)


def _warp(pm):
    xp = _xp(pm)
    return lambda x, a, b, c: x + a * xp.tanh(b * (x - c))


def _lengthscale(pm):
    xp = _xp(pm)
    return lambda x, x1, x2, w, x0: (x1 + x2) / 2.0 - (x1 - x2) / 2.0 * xp.tanh((x - x0) / w)


# name -> (build(pm), X, Xs)
COVS = {
    "expquad_ard": (lambda pm: pm.gp.cov.ExpQuad(2, ls=[0.7, 1.4]), X2, XS2),
    "ratquad": (lambda pm: pm.gp.cov.RatQuad(1, ls=0.4, alpha=0.5), X1, XS1),
    "ratquad_ard": (lambda pm: pm.gp.cov.RatQuad(2, ls=[0.5, 0.9], alpha=2.0), X2, XS2),
    "matern52": (lambda pm: pm.gp.cov.Matern52(1, 0.3), X1, XS1),
    "matern52_ls_inv": (lambda pm: pm.gp.cov.Matern52(2, ls_inv=[2.0, 0.5]), X2, XS2),
    "matern32": (lambda pm: pm.gp.cov.Matern32(2, 0.4), X2, XS2),
    "matern12": (lambda pm: pm.gp.cov.Matern12(1, 0.3), X1, XS1),
    "exponential": (lambda pm: pm.gp.cov.Exponential(1, 0.3), X1, XS1),
    "cosine": (lambda pm: pm.gp.cov.Cosine(1, 0.9), X1, XS1),
    "periodic": (lambda pm: pm.gp.cov.Periodic(1, period=1.1, ls=0.6), X1, XS1),
    "periodic_ard": (lambda pm: pm.gp.cov.Periodic(2, period=1.3, ls=[0.6, 0.9]), X2, XS2),
    "active_dims": (lambda pm: pm.gp.cov.Matern32(2, 0.8, active_dims=[1]), X2, XS2),
    "repeated_active_dims": (lambda pm: pm.gp.cov.ExpQuad(2, [0.5, 2.0], active_dims=[0, 0]),
                             X2, XS2),
    "linear": (lambda pm: pm.gp.cov.Linear(2, c=0.2), X2, XS2),
    "polynomial": (lambda pm: pm.gp.cov.Polynomial(2, c=0.2, d=3, offset=0.5), X2, XS2),
    "warped_input": (lambda pm: pm.gp.cov.WarpedInput(
        1, cov_func=pm.gp.cov.Matern52(1, 0.2), warp_func=_warp(pm), args=(1, 10, 1)), X1, XS1),
    "gibbs": (lambda pm: pm.gp.cov.Gibbs(1, _lengthscale(pm), args=(0.05, 0.6, 0.4, 1.0)),
              X1, XS1),
    "scaled_cov": (lambda pm: pm.gp.cov.ScaledCov(
        1, cov_func=pm.gp.cov.Matern52(1, 0.2), scaling_func=lambda x, a, b: a + b * x,
        args=(2, -1)), X1, XS1),
    "coregion_w_kappa": (lambda pm: pm.gp.cov.Coregion(2, W=W, kappa=KAPPA, active_dims=[0]),
                         XC, XCS),
    "coregion_b": (lambda pm: pm.gp.cov.Coregion(2, B=W @ W.T + np.diag(KAPPA),
                                                 active_dims=[0]), XC, XCS),
    "kron": (lambda pm: pm.gp.cov.Kron([pm.gp.cov.ExpQuad(1, 0.5), pm.gp.cov.Matern32(1, 0.8)]),
             X2, XS2),
    "exponentiated": (lambda pm: pm.gp.cov.Exponentiated(pm.gp.cov.Matern32(1, 0.5), 2.5),
                      X1, XS1),
    "circular_tau4": (lambda pm: pm.gp.cov.Circular(1, period=1.0, tau=4), X1, XS1),
    "circular_tau5": (lambda pm: pm.gp.cov.Circular(1, period=2.0, tau=5), X1, XS1),
    "wrapped_expquad": (lambda pm: pm.gp.cov.WrappedPeriodic(pm.gp.cov.ExpQuad(1, ls=0.2),
                                                             period=1.0), X1, XS1),
    "wrapped_ratquad": (lambda pm: pm.gp.cov.WrappedPeriodic(
        pm.gp.cov.RatQuad(2, alpha=1.5, ls=[0.4, 0.8]), period=1.7), X2, XS2),
    "wrapped_matern52": (lambda pm: pm.gp.cov.WrappedPeriodic(pm.gp.cov.Matern52(1, ls=0.3),
                                                              period=1.2), X1, XS1),
    "wrapped_matern32": (lambda pm: pm.gp.cov.WrappedPeriodic(pm.gp.cov.Matern32(1, ls=0.3),
                                                              period=1.2), X1, XS1),
    "wrapped_matern12": (lambda pm: pm.gp.cov.WrappedPeriodic(pm.gp.cov.Matern12(1, ls=0.3),
                                                              period=1.2), X1, XS1),
    "product_plus_noise": (lambda pm: pm.gp.cov.ExpQuad(2, 0.5) * pm.gp.cov.Matern32(2, 1.0)
                           + pm.gp.cov.WhiteNoise(0.1), X2, XS2),
    "scaled_power_sum": (lambda pm: 1.7 * pm.gp.cov.Cosine(1, 2.0) ** 2
                         + pm.gp.cov.Periodic(1, 0.8, 0.5) + pm.gp.cov.Constant(0.3), X1, XS1),
}


@pytest.mark.parametrize("part", ["full", "diag", "cross"])
@pytest.mark.parametrize("name", sorted(COVS))
def test_covariance_matches_pymc_tpu(name, part):
    build, X, Xs = COVS[name]
    cj, ct = build(pmj), build(pmt)
    if part == "full":
        ref, got = cj(X), ct(X)
    elif part == "diag":
        ref, got = cj(X, diag=True), ct(X, diag=True)
    else:
        ref, got = cj(X, Xs), ct(X, Xs)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-10, atol=1e-14)


OMEGA1 = np.linspace(0.05, 6.0, 7)[:, None]
OMEGA2 = RNG.uniform(0.0, 4.0, size=(6, 2))
PSDS = {
    "expquad": (lambda pm: pm.gp.cov.ExpQuad(1, ls=0.7), OMEGA1),
    "expquad_ard": (lambda pm: pm.gp.cov.ExpQuad(2, ls=[0.7, 1.3]), OMEGA2),
    "matern52": (lambda pm: pm.gp.cov.Matern52(1, ls=0.7), OMEGA1),
    "matern32_ard": (lambda pm: pm.gp.cov.Matern32(2, ls=[0.4, 1.1]), OMEGA2),
    "matern12": (lambda pm: pm.gp.cov.Matern12(1, ls=1.9), OMEGA1),
    "scaled": (lambda pm: 2.5**2 * pm.gp.cov.ExpQuad(1, ls=0.7), OMEGA1),
    "scaled_right": (lambda pm: pm.gp.cov.Matern52(1, ls=0.7) * 3.0, OMEGA1),
    "sum": (lambda pm: pm.gp.cov.ExpQuad(2, ls=0.5) + 0.5 * pm.gp.cov.Matern32(2, ls=2.0),
            OMEGA2),
}


@pytest.mark.parametrize("name", sorted(PSDS))
def test_power_spectral_density_matches_pymc_tpu(name):
    build, omega = PSDS[name]
    ref = build(pmj).power_spectral_density(omega)
    got = build(pmt).power_spectral_density(torch.as_tensor(omega))
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-10, atol=1e-300)


@pytest.mark.parametrize("ls", [0.2, 0.5, 1.7])
def test_periodic_expansion_coefficients_match_pymc_tpu(ls):
    # PyMC's coefficients are 2 ive(j, 1 / ls^2), the j = 0 term halved.
    # pymc_tpu runs the Bessel recurrence upward, which loses every digit
    # as j grows past 1 / ls^2 (its error passes 1e-10 at ls = 0.5 from j =
    # 9 and at 1.7 from j = 4, and grows ~1e3-fold an order): the port keeps
    # PyMC's values, and matches pymc_tpu on the orders its recurrence gets
    # right. The divergence is the reference's (ROADMAP §3).
    from scipy.special import ive

    J = 12
    exact = ive(np.arange(J), 1.0 / ls**2) * np.where(np.arange(J) > 0, 2.0, 1.0)
    ref = np.asarray(pmj.gp.cov.Periodic(1, period=2.0, ls=ls).power_spectral_density_approx(J))
    got = _np(pmt.gp.cov.Periodic(1, period=2.0, ls=ls).power_spectral_density_approx(J))
    np.testing.assert_allclose(got, exact, rtol=1e-10)
    accurate = np.abs(ref / exact - 1.0) <= 1e-10
    assert accurate[:4].all()
    assert accurate.all() == (ls < 0.3)
    np.testing.assert_allclose(got[accurate], ref[accurate], rtol=1e-10)


def test_spectral_density_errors_match_pymc_tpu():
    with pytest.raises(ValueError, match="Stationary"):
        pmt.gp.cov.Linear(1, c=0.0).power_spectral_density(torch.ones(3, 1))
    with pytest.raises(NotImplementedError):
        pmt.gp.cov.Cosine(1, 1.0).power_spectral_density(torch.ones(3, 1))
    with pytest.raises(NotImplementedError, match="products"):
        (pmt.gp.cov.ExpQuad(1, 1.0) * pmt.gp.cov.Matern32(1, 1.0)).power_spectral_density(
            torch.ones(3, 1)
        )
    with pytest.raises(TypeError):
        pmt.gp.cov.WrappedPeriodic(pmt.gp.cov.Linear(1, c=1), period=1)
    with pytest.raises(ValueError, match="exactly one"):
        pmt.gp.cov.Coregion(2, W=W, kappa=KAPPA)
    with pytest.raises(ValueError, match="larger"):
        pmt.gp.cov.ExpQuad(1, 1.0, active_dims=[3])


def test_kron_is_the_kronecker_product_on_a_grid():
    # K((x1, x2), (y1, y2)) = K1(x1, y1) K2(x2, y2), x1 the slow axis
    g1, g2 = RNG.random((4, 1)), RNG.random((3, 2))
    k1, k2 = pmt.gp.cov.ExpQuad(1, 0.5), pmt.gp.cov.Matern32(2, 0.8)
    grid = np.array([np.concatenate([a, b]) for a in g1 for b in g2])
    K = pmt.gp.cov.Kron([k1, k2])(grid)
    np.testing.assert_allclose(K.numpy(), np.kron(k1(g1).numpy(), k2(g2).numpy()), rtol=1e-12)


def test_symbolic_hyperparameters_match_pymc_tpu():
    # hyperparameters that are random variables evaluate inside the graph
    def build(pm):
        with pm.Model() as m:
            ls = pm.Gamma("ls", 2, 1)
            period = pm.Gamma("period", 5, 5)
            alpha = pm.Gamma("alpha", 2, 1)
            cov = (pm.gp.cov.Periodic(1, period=period, ls=ls)
                   * pm.gp.cov.RatQuad(1, alpha=alpha, ls=ls)
                   + pm.gp.cov.Circular(1, period=period))
            pm.Deterministic("K", cov(X1))
            pm.Deterministic("Kd", cov(X1, diag=True))
        return m

    point = {"ls": 0.8, "period": 1.3, "alpha": 0.7}
    mj, mt = build(pmj), build(pmt)
    from pymc_tpu.graph import evaluate as evaluate_j
    from pymc_tpu_torch.graph import evaluate as evaluate_t

    env_t = {k: torch.tensor(v, dtype=torch.float64) for k, v in point.items()}
    for name in ("K", "Kd"):
        ref = evaluate_j(mj[name], dict(point))
        got = evaluate_t(mt[name], env_t)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-10)
