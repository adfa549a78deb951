"""Write the radon GLM posterior reference that `chip_smoke.py` checks the
PyTorch port against.

Runs `pymc_tpu` on the CPU (float64) with the arguments `chip_smoke.py`
samples the radon GLM with (`pymc_tpu_torch.models.RADON_SAMPLE_KWARGS`:
`bench.py`'s many-chain configuration at 64 chains, tune 200, draws 128,
pooled mass and step adaptation, target_accept 0.95, seed 0). Writes the
posterior mean, sd and MCSE of the five scalar parameters to
`tests/data/torch_radon_reference.json`.

Usage:
    python scripts/make_torch_radon_fixture.py
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
from bench import build_model  # noqa: E402
from pymc_tpu.stats.convergence import mcse_mean, rhat  # noqa: E402
from pymc_tpu_torch.models import RADON_SAMPLE_KWARGS as CONFIG  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "torch_radon_reference.json")
SCALARS = ("mu_a", "mu_b", "sigma_a", "sigma_b", "sigma_y")


def main():
    idata = pm.sample(
        model=build_model(pm), progressbar=False,
        compute_convergence_checks=False, **CONFIG,
    )
    post = idata.posterior
    params = {}
    for name in SCALARS:
        x = np.asarray(post[name].values, dtype=np.float64)
        params[name] = {
            "mean": float(x.mean()),
            "sd": float(x.std(ddof=1)),
            "mcse": float(mcse_mean(x)),
            "rhat": float(rhat(x)),
        }
    out = {
        "description": "pymc_tpu posterior of bench.build_model on the CPU "
        "in float64 (scripts/make_torch_radon_fixture.py)",
        "config": CONFIG,
        "divergences": int(idata.sample_stats["diverging"].values.sum()),
        "params": params,
    }
    with open(OUT, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
