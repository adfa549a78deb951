"""Write the latent-GP posterior reference that `chip_smoke.py` checks the
PyTorch port's phase 9c against.

Runs `pymc_tpu` on the CPU (float64) on BASELINE config #4 in its latent
form, `benchmarks/suite.py::case_gp` (n = 150, `Latent.prior` with an
`eta**2 * ExpQuad` kernel; `pymc_tpu_torch.models.gp_latent_model`), and
writes the posterior mean, sd, MCSE and R-hat of ls, eta and sigma, with
the run's settings, divergences, mean tree depth and wall time, to
`tests/data/torch_gp_latent_reference.json`.

The JAX package takes about 17 ms a logp+grad at 8 chains and 93 ms at 64
on 8 CPU cores, and this model's trees are deep (about 8 doublings while
it tunes), so 64 chains (the port's setting on the card) would take hours;
the default is 8 chains with the suite's per-chain mass below 64 chains.
The hyperparameters' posterior is the marginal GP's
(`tests/data/torch_gp_marginal_reference.json`): f integrated out, both
models give y ~ N(0, eta^2 K + (sigma^2 + 1e-6) I), which
`tests/test_torch_gp_approx.py` checks against this file.

Usage:
    python scripts/make_torch_gp_latent_fixture.py [--chains 8] [--tune 200] [--draws 200]
"""

from __future__ import annotations

import argparse
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
from pymc_tpu.stats.convergence import mcse_mean, rhat  # noqa: E402
from pymc_tpu_torch.models import GP_SCALARS, gp_latent_model  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "torch_gp_latent_reference.json")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--chains", type=int, default=8)
    parser.add_argument("--tune", type=int, default=200)
    parser.add_argument("--draws", type=int, default=200)
    args = parser.parse_args()
    config = dict(
        chains=args.chains, tune=args.tune, draws=args.draws, random_seed=0,
        mass_adapt="pooled" if args.chains >= 64 else "per_chain",
    )
    t0 = time.perf_counter()
    idata = pm.sample(
        model=gp_latent_model(150, pm), progressbar=False, compute_convergence_checks=False,
        **config,
    )
    wall = time.perf_counter() - t0
    post, stats = idata.posterior, idata.sample_stats
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
        "description": "pymc_tpu posterior of the latent GP (benchmarks/suite.py::case_gp, "
        "n = 150) on the CPU in float64 (scripts/make_torch_gp_latent_fixture.py)",
        "config": dict(config, n=150),
        "wall_s": wall,
        "divergences": int(stats["diverging"].values.sum()),
        "mean_tree_depth": float(np.mean(stats["tree_depth"].values)),
        "params": params,
    }
    with open(OUT, "w") as f:
        json.dump(out, f, indent=2)
        f.write("\n")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
