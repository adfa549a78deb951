"""Write the stress-GLM posterior reference that `chip_smoke.py` checks the
PyTorch port's ChEES run against.

Runs `pymc_tpu` on the CPU (float64) on BASELINE config #3 at full width
(`pymc_tpu_torch.models.stress_glm_model`: 5,000 groups, 20,000
observations, 10,004 free parameters) with ChEES as
`benchmarks/suite.py::case_stress_chees` samples it off the TPU: 64 chains,
pooled mass and step, target_accept 0.95, seed 0, only the four
hyperparameters kept. Tune and draws are longer than the benchmark's 300 and
128 (TUNE, DRAWS below), so that the reference has converged and its MCSE
is small. Writes the posterior mean, sd, MCSE, R-hat and bulk ESS of mu_a,
sd_a, mu_b and sd_b, the mean number of leapfrogs a draw and the run's
walls to `tests/data/torch_stress_reference.json`.

Took 74 minutes on 8 CPU cores.

Usage:
    python scripts/make_torch_stress_fixture.py
"""

from __future__ import annotations

import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import pymc_tpu as pm  # noqa: E402
from pymc_tpu.stats.convergence import ess, mcse_mean, rhat  # noqa: E402
from pymc_tpu_torch.models import (  # noqa: E402
    STRESS_HYPERS,
    STRESS_SAMPLE_KWARGS,
    stress_glm_model,
)

OUT = os.path.join(ROOT, "tests", "data", "torch_stress_reference.json")
CHAINS, TUNE, DRAWS = 64, 1000, 1000


def main():
    config = dict(
        STRESS_SAMPLE_KWARGS, chains=CHAINS, tune=TUNE, draws=DRAWS,
        var_names=list(STRESS_HYPERS),
    )
    t0 = time.perf_counter()
    idata = pm.sample(
        model=stress_glm_model(pm=pm), progressbar=False,
        compute_convergence_checks=False, **config,
    )
    wall = time.perf_counter() - t0
    post, stats = idata.posterior, idata.sample_stats
    params = {}
    for name in STRESS_HYPERS:
        x = np.asarray(post[name].values, dtype=np.float64)
        params[name] = {
            "mean": float(x.mean()),
            "sd": float(x.std(ddof=1)),
            "mcse": float(mcse_mean(x)),
            "rhat": float(rhat(x)),
            "ess_bulk": float(ess(x)),
        }
    out = {
        "description": "pymc_tpu ChEES posterior of the stress GLM (BASELINE "
        "config #3, benchmarks/suite.py::_stress_model) on the CPU in float64 "
        "(scripts/make_torch_stress_fixture.py)",
        "config": config,
        "mean_n_steps": float(np.asarray(stats["n_steps"].values).mean()),
        "mean_acceptance": float(np.asarray(stats["acceptance_rate"].values).mean()),
        "divergences": int(np.asarray(stats["diverging"].values).sum()),
        "wall_seconds": wall,
        "tuning_seconds": float(post.attrs["tuning_time"]),
        "sampling_seconds": float(post.attrs["sampling_time"]),
        "params": params,
    }
    with open(OUT, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
