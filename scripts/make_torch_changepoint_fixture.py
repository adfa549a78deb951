"""Write the posterior reference of the change-point model
(`pymc_tpu_torch.models.changepoint_model`) that `chip_smoke.py` phase 12a
checks the PyTorch port against.

Runs `pymc_tpu` on the CPU in float64 on the model (built by `pymc_tpu`)
at the card's configuration, `models.CHANGEPOINT_SAMPLE_KWARGS` (64 chains,
tune 1000, draws 1000, seed 0, automatic step assignment: NUTS on the two
rates, Metropolis on the switchpoint and on the two imputed counts), and
writes the mean, sd, MCSE and R-hat of early_rate, late_rate, switchpoint
and both entries of disasters_unobserved, with the port's estimators
(`pymc_tpu_torch.stats.convergence`, which rank tied values at their mean
rank). It also writes the model's exact posterior means
(`models.changepoint_posterior`: the rates are conjugate, so the
switchpoint's posterior is a product of Gamma-Poisson marginal
likelihoods), and each pymc_tpu mean's distance from them in its MCSE.

The exact means are what the card is held to: pymc_tpu's Metropolis steps
keep the logp of their own last draw, which is stale once another step of
the compound has moved the point, so its compound posterior is biased
(ROADMAP.md §3); the port takes the ratio against the current point, as
PyMC does.

Usage:
    python scripts/make_torch_changepoint_fixture.py
"""

from __future__ import annotations

import json
import os
import sys
import warnings

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import pymc_tpu as pm  # noqa: E402
from pymc_tpu_torch.models import (  # noqa: E402
    CHANGEPOINT_SAMPLE_KWARGS, CHANGEPOINT_SCALARS, changepoint_model, changepoint_posterior,
)
from pymc_tpu_torch.stats.convergence import mcse_mean, rhat  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "torch_changepoint_reference.json")


def scalar_draws(posterior):
    """{name: (chain, draw) float64}: the scalars and each imputed count."""
    out = {n: np.asarray(posterior[n].values, dtype=np.float64) for n in CHANGEPOINT_SCALARS}
    unobserved = np.asarray(posterior["disasters_unobserved"].values, dtype=np.float64)
    for i in range(unobserved.shape[-1]):
        out[f"disasters_unobserved[{i}]"] = unobserved[..., i]
    return out


def main():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        model = changepoint_model(pm)
    idata = pm.sample(model=model, progressbar=False, compute_convergence_checks=False,
                      **CHANGEPOINT_SAMPLE_KWARGS)
    exact = changepoint_posterior()
    params = {}
    for name, x in scalar_draws(idata.posterior).items():
        mcse = float(mcse_mean(x))
        params[name] = {
            "mean": float(x.mean()), "sd": float(x.std(ddof=1)), "mcse": mcse,
            "rhat": float(rhat(x)), "mcse_from_exact": (float(x.mean()) - exact[name]) / mcse,
        }
    out = {
        "description": "pymc_tpu posterior of models.changepoint_model on the CPU in float64, "
                       "and the model's exact posterior means "
                       "(scripts/make_torch_changepoint_fixture.py)",
        "config": CHANGEPOINT_SAMPLE_KWARGS,
        "exact": exact,
        "params": params,
    }
    with open(OUT, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
