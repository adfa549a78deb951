"""The prior jitter's effect on the latent GP of BASELINE config #4
(`benchmarks/suite.py::case_gp`, `pymc_tpu_torch.models.gp_latent_model`),
on the CPU, with no sampling.

1. Posterior. f ~ N(0, eta^2 K + j I) with y ~ N(f, sigma^2) is the
   marginal model y ~ N(0, eta^2 K + (sigma^2 + j) I), so the exact
   posterior of (ls, eta, sigma) under a jitter rule j(eta) is a
   three-dimensional integral. It is computed on a grid in (log ls, log
   eta, log sigma), one eigendecomposition of K(ls) per ls, for float64's
   1e-6 and for float32 rules max(1e-4, r eta^2) (the port's and the JAX
   package's default at r = 3e-4 until the port's prior rule became
   `gp.gp.F32_PRIOR_JITTER`), and printed beside the float64 fixtures.
2. float32 Cholesky. For each r, LAPACK's float32 factor of K(ls) + r I on
   case_gp's inputs (ExpQuad, unit amplitude, 200 lengthscales on [0.05,
   50]): how many fail, and the largest ||L L^T - (K + r I)||_2 / r,
   against the float64 K.

Usage:
    python scripts/gp_latent_jitter_posterior.py     # ~1 minute on 8 cores
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from scipy import stats  # noqa: E402

from pymc_tpu_torch.gp.gp import F32_PRIOR_JITTER  # noqa: E402
from pymc_tpu_torch.models import gp_data  # noqa: E402

FIXTURES = {name: os.path.join(ROOT, "tests", "data", f"torch_gp_{name}_reference.json")
            for name in ("latent", "marginal")}
RATES = tuple(sorted({3e-4, F32_PRIOR_JITTER, 1e-4, 3e-5, 1e-5}, reverse=True))


def posterior_moments(jitter, x, y):
    """{name: (mean, sd)} of ls, eta and sigma under the prior jitter
    `jitter(eta)`, by quadrature on a 160 x 220 x 200 grid."""
    log_ls = np.linspace(np.log(0.7), np.log(4.5), 160)
    log_eta = np.linspace(np.log(0.5), np.log(12.0), 220)
    log_sigma = np.linspace(np.log(0.22), np.log(0.42), 200)
    ls, eta, sigma = np.exp(log_ls), np.exp(log_eta), np.exp(log_sigma)
    d2 = (x[:, None] - x[None, :]) ** 2
    noise = sigma[None, :] ** 2 + jitter(eta)[:, None]  # (eta, sigma)
    loglik = np.empty((ls.size, eta.size, sigma.size))
    for i, l in enumerate(ls):
        lam, Q = np.linalg.eigh(np.exp(-0.5 * d2 / l**2))
        ev = eta[:, None, None] ** 2 * np.clip(lam, 0.0, None) + noise[:, :, None]
        loglik[i] = -0.5 * (np.log(ev).sum(-1) + ((Q.T @ y) ** 2 / ev).sum(-1))
    logp = (loglik
            + (stats.gamma(2).logpdf(ls) + log_ls)[:, None, None]
            + (stats.halfnorm(scale=2).logpdf(eta) + log_eta)[None, :, None]
            + (stats.halfnorm(scale=1).logpdf(sigma) + log_sigma)[None, None, :])
    w = np.exp(logp - logp.max())
    w /= w.sum()
    edge = w[[0, -1]].sum() + w[:, [0, -1]].sum() + w[:, :, [0, -1]].sum()
    assert edge < 1e-5, f"the grid cuts {edge:.1e} of the posterior's mass"
    out = {}
    for axis, (name, v) in enumerate((("ls", ls), ("eta", eta), ("sigma", sigma))):
        marginal = w.sum(axis=tuple(a for a in range(3) if a != axis))
        mean = float((marginal * v).sum())
        out[name] = (mean, float(np.sqrt((marginal * v**2).sum() - mean**2)))
    return out


def cholesky_sweep(x, rate):
    """(failures, largest backward error / jitter) of float32 LAPACK
    factors of ExpQuad(x; ls) + rate I over 200 lengthscales."""
    x = torch.as_tensor(x)
    d2 = (x[:, None] - x[None, :]) ** 2
    ls = torch.as_tensor(np.geomspace(0.05, 50.0, 200))[:, None, None]
    eye = torch.eye(x.numel(), dtype=torch.float64)
    A = torch.exp(-0.5 * d2 / ls**2) + rate * eye
    L, info = torch.linalg.cholesky_ex(A.float())
    ok = info == 0
    L = L[ok].double()
    err = torch.linalg.matrix_norm(L @ L.mT - A[ok], ord=2) / rate
    return int((~ok).sum()), float(err.max()) if err.numel() else float("nan")


def main():
    _, X, y = gp_data(150)
    x = X[:, 0]
    rules = {"float64, 1e-6": lambda e: np.full_like(e, 1e-6)}
    for r in RATES:
        rules[f"float32, max(1e-4, {r:g} eta^2)"] = lambda e, r=r: np.maximum(1e-4, r * e**2)
    for label, rule in rules.items():
        mom = posterior_moments(rule, x, y)
        print(f"posterior at {label}: " + "; ".join(
            f"{k} {m:.5f} (sd {s:.5f})" for k, (m, s) in mom.items()), flush=True)
    for name, path in FIXTURES.items():
        with open(path) as f:
            ref = json.load(f)["params"]
        print(f"{name} fixture (pymc_tpu, float64, NUTS): " + "; ".join(
            f"{k} {v['mean']:.5f} (mcse {v['mcse']:.5f})" for k, v in ref.items()))
    print(f"min spacing of the inputs {np.diff(x).min():.3e}")
    for r in RATES + (3e-6,):
        fails, err = cholesky_sweep(x, r)
        print(f"float32 Cholesky at jitter {r:g} (unit amplitude): {fails} of 200 "
              f"lengthscales fail; largest ||L L^T - A||_2 / jitter {err:.3f}")


if __name__ == "__main__":
    main()
