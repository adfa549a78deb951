"""Write the posterior reference of the BEST model (`benchmarks/suite.py::
case_best`) that `chip_smoke.py` phase 11a checks the PyTorch port
against.

Runs `pymc_tpu` on the CPU in float64 on `pymc_tpu_torch.models.best_model`
(the suite's model and data, built by `pymc_tpu`) at 64 chains, tune 1000,
draws 2000, pooled mass, seed 0: fewer chains than the card's 512, so that
the run takes minutes on a CPU; 128,000 draws hold each mean to a small
fraction of its sd. Writes the posterior mean, sd, MCSE and R-hat of the
named scalars (`models.BEST_SCALARS`) to `tests/data/torch_best_reference.json`.

Usage:
    python scripts/make_torch_best_fixture.py
"""

from __future__ import annotations

import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import pymc_tpu as pm  # noqa: E402
from pymc_tpu.stats.convergence import mcse_mean, rhat  # noqa: E402
from pymc_tpu_torch.models import BEST_SCALARS, best_model  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "torch_best_reference.json")
CONFIG = dict(chains=64, tune=1000, draws=2000, random_seed=0, mass_adapt="pooled")


def write_reference(model, names, config, out_path, description):
    """Sample `model` with pymc_tpu at `config` and write the summary of
    `names` to `out_path`."""
    idata = pm.sample(model=model, progressbar=False, compute_convergence_checks=False,
                      **config)
    post = idata.posterior
    params = {}
    for name in names:
        x = np.asarray(post[name].values, dtype=np.float64)
        params[name] = {
            "mean": float(x.mean()),
            "sd": float(x.std(ddof=1)),
            "mcse": float(mcse_mean(x)),
            "rhat": float(rhat(x)),
        }
    out = {
        "description": description,
        "config": config,
        "divergences": int(idata.sample_stats["diverging"].values.sum()),
        "params": params,
    }
    with open(out_path, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(json.dumps(out))


def main():
    write_reference(
        best_model(pm), BEST_SCALARS, CONFIG, OUT,
        "pymc_tpu posterior of models.best_model (suite.py::case_best) on the CPU in "
        "float64 (scripts/make_torch_best_fixture.py)",
    )


if __name__ == "__main__":
    main()
