"""Write the SMC reference that `chip_smoke.py` checks the PyTorch port's
`sample_smc` against.

Runs `pymc_tpu.sample_smc` on the CPU (float64) on BASELINE config #5,
`benchmarks/suite.py::case_smc`'s bimodal mixture
(`pymc_tpu_torch.models.smc_mixture_model`), with the suite's arguments
(`pymc_tpu_torch.models.SMC_SAMPLE_KWARGS`: 2000 draws, 4 chains, IMH,
threshold 0.5, correlation_threshold 0.01) at each seed of
`SMC_SEEDS` (0-4). Writes each chain's posterior mean of mu and w and its
log marginal likelihood (20 chains), their means, and the standard error
of each mean from the spread between chains, to
`tests/data/torch_smc_reference.json`. About 20 s.

Usage:
    python scripts/make_torch_smc_fixture.py
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
from pymc_tpu_torch.models import (  # noqa: E402
    SMC_SAMPLE_KWARGS, SMC_SEEDS, smc_chain_estimates, smc_mixture_model,
)

OUT = os.path.join(ROOT, "tests", "data", "torch_smc_reference.json")


def main():
    chains, runs = {}, []
    for seed in SMC_SEEDS:
        t0 = time.perf_counter()
        idata = pm.sample_smc(
            model=smc_mixture_model(pm), progressbar=False,
            **dict(SMC_SAMPLE_KWARGS, random_seed=seed),
        )
        wall = time.perf_counter() - t0
        for name, values in smc_chain_estimates(idata).items():
            chains.setdefault(name, []).extend(values.tolist())
        attrs = idata.posterior.attrs
        runs.append({
            "seed": seed, "wall_s": wall, "n_stages": int(attrs["n_stages"]),
            "n_steps_history": attrs["n_steps_history"],
        })
    params = {
        name: {
            "mean": float(np.mean(v)),
            "se": float(np.std(v, ddof=1) / np.sqrt(len(v))),
            "chains": v,
        }
        for name, v in chains.items()
    }
    out = {
        "description": "pymc_tpu.sample_smc on benchmarks/suite.py::case_smc's model on "
        "the CPU in float64, one entry per chain over the seeds "
        "(scripts/make_torch_smc_fixture.py)",
        "config": SMC_SAMPLE_KWARGS,
        "seeds": list(SMC_SEEDS),
        "runs": runs,
        "params": params,
    }
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
        f.write("\n")
    print(json.dumps({k: (v["mean"], v["se"]) for k, v in params.items()}))
    print(json.dumps(runs))


if __name__ == "__main__":
    main()
