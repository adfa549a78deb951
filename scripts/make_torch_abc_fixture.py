"""Write the ABC reference that `chip_smoke.py` phase 16b checks the
PyTorch port's Simulator and `sample_smc` against.

Runs `pymc_tpu.sample_smc` on the CPU in float64 on the model of
`examples/abc_simulator.py` (`pymc_tpu_torch.models.abc_simulator_model`
built by `pymc_tpu` with the example's `simulate(key, mu)`: 200
observations, sum_stat "sort", epsilon 0.5) at the example's 1,000 draws
and 2 chains, once for each seed of `models.ABC_SEEDS` (0-4). Writes each
run's posterior mean and sd of mu, their mean over the seeds and the
seed-to-seed standard deviation of the mean to
`tests/data/torch_abc_reference.json`. About a minute.

Usage:
    python scripts/make_torch_abc_fixture.py
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
from pymc_tpu_torch.models import ABC_SEEDS, ABC_SMC_KWARGS, abc_simulator_model  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "torch_abc_reference.json")


def simulate(key, mu):
    """examples/abc_simulator.py's simulation."""
    return mu + jax.random.normal(key, (200,))


def main():
    runs = []
    for seed in ABC_SEEDS:
        t0 = time.perf_counter()
        idata = pm.sample_smc(model=abc_simulator_model(pm, simulate), random_seed=seed,
                              progressbar=False, **ABC_SMC_KWARGS)
        mu = np.asarray(idata.posterior["mu"].values, dtype=np.float64)
        runs.append({"seed": seed, "mean": float(mu.mean()), "sd": float(mu.std(ddof=1)),
                     "n_stages": int(idata.posterior.attrs["n_stages"]),
                     "wall_s": time.perf_counter() - t0})
    means = np.array([r["mean"] for r in runs])
    out = {
        "description": "pymc_tpu.sample_smc on examples/abc_simulator.py's model on the CPU "
        "in float64, one run a seed (scripts/make_torch_abc_fixture.py)",
        "config": ABC_SMC_KWARGS,
        "seeds": list(ABC_SEEDS),
        "runs": runs,
        "mu": {"mean": float(means.mean()), "seed_sd": float(means.std(ddof=1)),
               "posterior_sd": float(np.mean([r["sd"] for r in runs]))},
    }
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
