"""Write the marginal-GP posterior reference that `chip_smoke.py` checks the
PyTorch port against.

Runs `pymc_tpu` on the CPU (float64) on BASELINE config #4 as
`benchmarks/suite.py::case_gp_marginal` benchmarks it: n = 150, 64 chains,
tune 300, draws 300, pooled mass, seed 0. Writes the posterior mean, sd,
MCSE and R-hat of ls, eta and sigma to
`tests/data/torch_gp_marginal_reference.json`.

Usage:
    python scripts/make_torch_gp_marginal_fixture.py
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
from pymc_tpu_torch.models import GP_SAMPLE_KWARGS, GP_SCALARS, gp_marginal_model  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "torch_gp_marginal_reference.json")


def main():
    idata = pm.sample(
        model=gp_marginal_model(150, pm), progressbar=False,
        compute_convergence_checks=False, **GP_SAMPLE_KWARGS,
    )
    post = idata.posterior
    params = {}
    for name in GP_SCALARS:
        x = np.asarray(post[name].values, dtype=np.float64)
        params[name] = {
            "mean": float(x.mean()),
            "sd": float(x.std(ddof=1)),
            "mcse": float(mcse_mean(x)),
            "rhat": float(rhat(x)),
        }
    out = {
        "description": "pymc_tpu posterior of the marginal GP (benchmarks/suite.py::"
        "case_gp_marginal, n = 150) on the CPU in float64 "
        "(scripts/make_torch_gp_marginal_fixture.py)",
        "config": dict(GP_SAMPLE_KWARGS, n=150),
        "divergences": int(idata.sample_stats["diverging"].values.sum()),
        "params": params,
    }
    with open(OUT, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
