"""Model builders shared by `chip_smoke.py`, the fixture scripts and the tests.

`gp_marginal_model` is BASELINE config #4 in the form the JAX package
benchmarks (`benchmarks/suite.py::case_gp_marginal`): a marginal GP with an
`eta**2 * ExpQuad` kernel and Gaussian noise on n sorted inputs. Each
builder takes the package to build with (`pymc_tpu_torch` by default), so
the reference package builds the same model from the same data. The radon
GLM's builder is `bench.build_model`; its sampling arguments are here.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "gp_data", "gp_marginal_model", "GP_SAMPLE_KWARGS", "GP_SCALARS", "RADON_SAMPLE_KWARGS",
]

# bench.py's many-chain configuration (pooled mass and step, target_accept
# 0.95) at 64 chains, its depth cut from tune 300 / draws 256 so that
# chip_smoke.py, which also samples the GP, stays well inside its time limit
RADON_SAMPLE_KWARGS = dict(
    chains=64, tune=200, draws=128, random_seed=0, mass_adapt="pooled",
    step_adapt="pooled", target_accept=0.95,
)

# case_gp_marginal's keyword arguments to `sample` at 64 chains
GP_SAMPLE_KWARGS = dict(draws=300, tune=300, chains=64, random_seed=0, mass_adapt="pooled")
GP_SCALARS = ("ls", "eta", "sigma")


def gp_data(n=150):
    """(n, X (n, 1), y (n,)): sorted inputs on [0, 10] and a noisy 2 sin(x),
    from seed 5 (`benchmarks/suite.py::_gp_data`)."""
    rng = np.random.default_rng(5)
    X = np.sort(rng.uniform(0, 10, n))[:, None]
    y = np.sin(X[:, 0]) * 2 + rng.normal(0, 0.3, n)
    return n, X, y


def gp_marginal_model(n=150, pm=None):
    """ls ~ Gamma(2, 1), eta ~ HalfNormal(2), sigma ~ HalfNormal(1);
    y ~ MvNormal(0, eta^2 ExpQuad(X; ls) + sigma^2 I + 1e-6 I)."""
    if pm is None:
        import pymc_tpu_torch as pm
    _, X, y = gp_data(n)
    with pm.Model() as m:
        ls = pm.Gamma("ls", 2, 1)
        eta = pm.HalfNormal("eta", 2)
        gp = pm.gp.Marginal(cov_func=eta**2 * pm.gp.cov.ExpQuad(1, ls=ls))
        sigma = pm.HalfNormal("sigma", 1)
        gp.marginal_likelihood("y", X=X, y=y, sigma=sigma)
    return m
