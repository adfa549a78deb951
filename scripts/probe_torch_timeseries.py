"""Run `chip_smoke.py`'s phase 15 alone on one CUDA card: quantiles,
Censored, Truncated and the time-series family. Builds csrc/leapfrog.cu
and csrc/cholesky.cu, then 15a samples the survival example
(`models.survival_model`), 15b the stochastic-volatility example
(`models.stochastic_volatility_model`) and 15c checks the classes on the
card, each checked as `chip_smoke.py` checks it.

Usage:
    python3 scripts/probe_torch_timeseries.py
    python3 scripts/probe_torch_timeseries.py --sv 16:400:200 --survival 64:400:300
        (chains:tune:draws of 15b and 15a in place of models.SV_SMOKE_KWARGS
        and models.SURVIVAL_SMOKE_KWARGS)
    python3 scripts/probe_torch_timeseries.py --only b    (15b alone; a, b, c)
    python3 scripts/probe_torch_timeseries.py --only "" --measure 16:300:200,8:300:200
        (sample 15b's model at each chains:tune:draws with no reference and
        print its walls, leapfrogs a draw, R-hats and means)
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from pymc_tpu_torch import models  # noqa: E402


def config(base, spec):
    if not spec:
        return base
    chains, tune, draws = (int(x) for x in spec.split(":"))
    return dict(base, chains=chains, tune=tune, draws=draws)


def measure(card, spec):
    """Sample the stochastic-volatility model at chains:tune:draws and print
    what picking 15b's configuration needs."""
    import numpy as np

    from pymc_tpu_torch.stats.convergence import mcse_mean, rhat

    cfg = config(models.SV_SMOKE_KWARGS, spec)
    t0 = cs.time.perf_counter()
    idata, launches = cs.sample_counted(models.stochastic_volatility_model(), cfg)
    wall = cs.time.perf_counter() - t0
    post = idata.posterior
    rhats = {n: float(np.nanmax(rhat(post[n].values))) for n in post.keys()}
    means = {n: (float(post[n].values.mean()), float(mcse_mean(post[n].values.astype(float))))
             for n in models.SV_SCALARS}
    _, true_h = models.stochastic_volatility_data()
    corr = float(np.corrcoef(post["vol"].values.mean(axis=(0, 1)), np.exp(true_h))[0, 1])
    cs.sampling_summary(f"SV {spec}", idata, models.SV_SCALARS, card)
    print(f"SV {spec}: wall {wall:.1f} s; leapfrogs a draw "
          f"{cs.leapfrogs_per_draw(idata, cfg):.1f}; max R-hat {rhats}; means (mcse) {means}; "
          f"vol corr {corr:.4f}; launches {launches}")


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--sv", default="")
    parser.add_argument("--survival", default="")
    parser.add_argument("--only", default="abc")
    parser.add_argument("--measure", default="")
    args = parser.parse_args()
    models.SV_SMOKE_KWARGS = config(models.SV_SMOKE_KWARGS, args.sv)
    models.SURVIVAL_SMOKE_KWARGS = config(models.SURVIVAL_SMOKE_KWARGS, args.survival)
    card, _ = cs.check_device()
    cs.build_kernels()
    for spec in filter(None, args.measure.split(",")):
        measure(card, spec)
    paths = {}
    failures = cs.CaptureFailures()
    try:
        if "a" in args.only:
            paths["survival"] = cs.run_survival(card)
        if "b" in args.only:
            paths["stochastic volatility"] = cs.run_stochastic_volatility(card)
        if "c" in args.only:
            paths["MvGaussianRandomWalk"] = cs.check_timeseries_classes(card, failures)
    finally:
        failures.close()
    print("launches: " + "; ".join(f"{name} {p}" for name, p in paths.items()))
    print(f"total wall {cs.time.perf_counter() - cs.T_START:.1f} s")


if __name__ == "__main__":
    main()
