"""Write the posterior reference of the correlated-effects radon model
(`pymc_tpu_torch.models.radon_lkj_model`) that `chip_smoke.py` phase 14a
checks the PyTorch port against.

Runs `pymc_tpu` on the CPU in float64 on the model (built by `pymc_tpu`
from the same data) at the card's configuration,
`models.LKJ_RADON_SAMPLE_KWARGS` (64 chains started from 3,000 ADVI steps,
tune 400, draws 250, pooled mass and step, target_accept 0.95, seed 0),
and writes the mean, sd, MCSE and R-hat of both entries of mu_ab and
chol_stds, chol_corr[0, 1] and sigma (`models.LKJ_RADON_SCALARS`), the
divergences and the largest R-hat of a free variable to
`tests/data/torch_lkj_radon_reference.json`.

Usage:
    python scripts/make_torch_lkj_radon_fixture.py
"""

from __future__ import annotations

import json
import os
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import pymc_tpu as pm  # noqa: E402
from pymc_tpu.stats.convergence import mcse_mean, rhat  # noqa: E402
from pymc_tpu_torch.models import (  # noqa: E402
    LKJ_RADON_SAMPLE_KWARGS, lkj_radon_scalars, radon_lkj_model,
)

OUT = os.path.join(ROOT, "tests", "data", "torch_lkj_radon_reference.json")


def main():
    model = radon_lkj_model(pm)
    idata = pm.sample(model=model, progressbar=False, compute_convergence_checks=False,
                      **LKJ_RADON_SAMPLE_KWARGS)
    params = {
        # copies: pymc_tpu's R-hat and ESS overwrite their input (ROADMAP.md §3)
        name: {"mean": float(x.mean()), "sd": float(x.std(ddof=1)),
               "mcse": float(mcse_mean(x.copy())), "rhat": float(rhat(x.copy()))}
        for name, x in lkj_radon_scalars(idata.posterior).items()
    }
    out = {
        "description": "pymc_tpu posterior of models.radon_lkj_model on the CPU in float64 "
                       "(scripts/make_torch_lkj_radon_fixture.py)",
        "config": LKJ_RADON_SAMPLE_KWARGS,
        "divergences": int(idata.sample_stats["diverging"].values.sum()),
        "max_rhat_free": max(float(np.nanmax(rhat(np.array(idata.posterior[rv.name].values))))
                             for rv in model.free_RVs),
        "params": params,
    }
    with open(OUT, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
