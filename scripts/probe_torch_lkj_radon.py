"""Sample the correlated-effects radon model (`models.radon_lkj_model`,
`chip_smoke.py` phase 14a) on one CUDA card under several sampler
settings, and print what each run's adaptation ended with.

Each argument is one run, `label:key=value,...`, its keys `sample`'s
(tune, draws, chains, mass_adapt, step_adapt, target_accept, init,
n_init, max_treedepth) and `float64=1` (sample in float64 on the card). For each
run: the walls, the final step size, the mean tree depth and lock-step
leapfrogs a draw, divergences, the R-hat of each free variable and of the
six scalars of `models.LKJ_RADON_SCALARS` with their means against
tests/data/torch_lkj_radon_reference.json (in that file's MCSE), and the
spread over chains of each chain's mean of chol_stds and sigma.

Usage:
    python3 scripts/probe_torch_lkj_radon.py \\
        f32:tune=200,draws=100 f64:tune=200,draws=100,float64=1
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

REFERENCE = os.path.join(ROOT, "tests", "data", "torch_lkj_radon_reference.json")
INT_KEYS = ("tune", "draws", "chains", "max_treedepth", "float64", "n_init")
FLOAT_KEYS = ("target_accept",)


def parse(arg):
    label, _, rest = arg.partition(":")
    kw = {}
    for item in filter(None, rest.split(",")):
        k, v = item.split("=")
        kw[k] = int(v) if k in INT_KEYS else float(v) if k in FLOAT_KEYS else v
    return label, kw


def run(label, kw, card, ref):
    import pymc_tpu_torch as pm
    from pymc_tpu_torch.models import LKJ_RADON_SAMPLE_KWARGS, lkj_radon_scalars, radon_lkj_model
    from pymc_tpu_torch.sampling import mcmc
    from pymc_tpu_torch.stats.convergence import mcse_mean, rhat

    kw = dict(kw)
    float64 = bool(kw.pop("float64", 0))
    depth = kw.pop("max_treedepth", None)
    config = dict(LKJ_RADON_SAMPLE_KWARGS, **kw)
    if depth is not None:
        config["nuts"] = {"max_treedepth": depth}
    floatx = mcmc.floatX
    if float64:
        # `sample` takes its float type from the device; this probe alone
        # asks the card for float64
        mcmc.floatX = lambda device=None: torch.float64
    model = radon_lkj_model()
    t0 = time.perf_counter()
    try:
        idata = pm.sample(model=model, device="cuda", compute_convergence_checks=False, **config)
    finally:
        mcmc.floatX = floatx
    wall = time.perf_counter() - t0
    post, stats = idata.posterior, idata.sample_stats
    a = post.attrs
    leapfrogs = (a["n_leapfrog"] - a["n_step_search"]) / (config["tune"] + config["draws"])
    step = np.asarray(stats["step_size"].values)
    print(f"[{label}] {'float64' if float64 else 'float32'} {config}  [{card}]")
    print(f"[{label}] wall {wall:.1f} s (tuning {a['tuning_time']:.1f}, sampling "
          f"{a['sampling_time']:.1f}); final step size {float(step[:, -1].mean()):.5f} (chains "
          f"{float(step[:, -1].min()):.5f}-{float(step[:, -1].max()):.5f}); mean tree depth "
          f"{float(stats['tree_depth'].values.mean()):.2f}; lock-step leapfrogs a draw "
          f"{leapfrogs:.1f}; divergences {int(stats['diverging'].values.sum())}")
    free = {rv.name: float(np.nanmax(rhat(post[rv.name].values.copy()))) for rv in model.free_RVs}
    print(f"[{label}] max R-hat of the free variables: "
          + ", ".join(f"{k} {v:.4f}" for k, v in free.items()))
    for name, x in lkj_radon_scalars(post).items():
        z = (float(x.mean()) - ref[name]["mean"]) / float(np.hypot(mcse_mean(x), ref[name]["mcse"]))
        per_chain = x.mean(axis=1)
        print(f"[{label}] {name}: mean {float(x.mean()):.5f} ({z:+.2f} combined MCSE from "
              f"{ref[name]['mean']:.5f}), R-hat {float(rhat(x.copy())):.4f}, chain means "
              f"{np.quantile(per_chain, [0.0, 0.1, 0.5, 0.9, 1.0]).round(4).tolist()}")
    sys.stdout.flush()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("probe_torch_lkj_radon: no CUDA card")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    with open(REFERENCE) as f:
        ref = json.load(f)["params"]
    for arg in sys.argv[1:]:
        run(*parse(arg), card, ref)


if __name__ == "__main__":
    main()
