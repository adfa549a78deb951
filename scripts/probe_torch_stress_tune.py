"""How long ChEES must tune on the stress GLM before its hyperparameters
settle, and whether the port's warmup follows `pymc_tpu`'s.

Samples the stress GLM (BASELINE config #3, 10,004 parameters) with
`pymc_tpu_torch.models.STRESS_SAMPLE_KWARGS`, once for each TUNE:DRAWS pair
given, and prints for each run its walls, leapfrogs, final trajectory
length, step size, mean L and acceptance, then for every window of 128
draws the mean, sd, R-hat and bulk ESS of mu_a, sd_a, mu_b and sd_b, and
the spread of sd_a's chain means over the last 64 draws. The sampler is
deterministic for a seed on the card, so a run's first window equals a run
with the same tune and draws 128.

Options:
    --chains N     chains (default: STRESS_SAMPLE_KWARGS's 1024)
    --seeds A,B    one run of each pair per seed (default: 0)
    --device D     cuda (default; float32, the card's name and power limit
                   are printed) or cpu (float64)
    --float64      on cuda, sample in float64 instead of float32
    --reference    sample with `pymc_tpu` (JAX on the CPU, float64) instead
                   of the port, for the same model and keyword arguments

Usage:
    python3 scripts/probe_torch_stress_tune.py 300:640 1000:128
    python3 scripts/probe_torch_stress_tune.py --chains 64 --seeds 0,1 300:20
    python3 scripts/probe_torch_stress_tune.py --reference --chains 64 300:20
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WINDOW = 128


def _parse():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("runs", nargs="*", default=["300:640"], help="TUNE:DRAWS pairs")
    ap.add_argument("--chains", type=int, default=None)
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--float64", action="store_true")
    ap.add_argument("--reference", action="store_true")
    return ap.parse_args()


def _reference_sampler():
    """pymc_tpu's sample and model on the CPU in float64, and its stats."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import pymc_tpu as pm
    from pymc_tpu.stats.convergence import ess, rhat
    from pymc_tpu_torch.models import stress_glm_model

    def run(**kw):
        return pm.sample(model=stress_glm_model(pm=pm), progressbar=False, **kw)

    return run, ess, rhat, "pymc_tpu, CPU, float64"


def _port_sampler(device, float64):
    import torch

    import pymc_tpu_torch as pm
    from pymc_tpu_torch.models import stress_glm_model
    from pymc_tpu_torch.sampling import mcmc
    from pymc_tpu_torch.stats.convergence import ess, rhat

    if device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("probe_torch_stress_tune: no CUDA card")
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
    else:
        card = "CPU"
    if float64:
        # `sample` takes its float type from the device; this probe alone
        # asks the card for float64
        mcmc.floatX = lambda device=None: torch.float64
    dtype = "float64" if float64 or device == "cpu" else "float32"
    model = stress_glm_model()

    def run(**kw):
        return pm.sample(model=model, device=device, **kw)

    return run, ess, rhat, f"pymc_tpu_torch, {card}, {dtype}"


def main():
    args = _parse()
    from pymc_tpu_torch.models import STRESS_HYPERS, STRESS_SAMPLE_KWARGS

    if args.reference:
        run, ess, rhat, label = _reference_sampler()
    else:
        run, ess, rhat, label = _port_sampler(args.device, args.float64)
    print(label, flush=True)
    chains = args.chains or STRESS_SAMPLE_KWARGS["chains"]
    for seed in (int(s) for s in args.seeds.split(",")):
        for tune, draws in (tuple(int(x) for x in r.split(":")) for r in args.runs):
            kw = dict(STRESS_SAMPLE_KWARGS, tune=tune, draws=draws, chains=chains,
                      random_seed=seed, var_names=list(STRESS_HYPERS))
            t0 = time.perf_counter()
            idata = run(compute_convergence_checks=False, **kw)
            a, st, post = idata.posterior.attrs, idata.sample_stats, idata.posterior
            T = a.get("trajectory_length")
            print(f"chains {chains} seed {seed} tune {tune} draws {draws}: wall "
                  f"{time.perf_counter() - t0:.1f} s, tuning {a['tuning_time']:.1f} s, "
                  f"sampling {a['sampling_time']:.1f} s, leapfrogs {a.get('n_leapfrog')}, "
                  f"T {'n/a' if T is None else f'{T:.4f}'}, step "
                  f"{float(np.mean(st['step_size'].values)):.5f}, mean L drawing "
                  f"{float(st['n_steps'].values.mean()):.2f}, acc "
                  f"{float(st['acceptance_rate'].values.mean()):.4f}  [{label}]", flush=True)
            for lo in range(0, draws, WINDOW):
                parts = []
                for n in STRESS_HYPERS:
                    x = np.asarray(post[n].values[:, lo:lo + WINDOW])
                    parts.append(f"{n} mean {x.mean():.5f} sd {x.std():.5f} rhat "
                                 f"{float(rhat(x)):.4f} ess {float(ess(x)):.0f}")
                print(f"  draws [{lo}, {min(lo + WINDOW, draws)}): " + "; ".join(parts),
                      flush=True)
            m = post["sd_a"].values[:, -64:].mean(axis=1)
            print(f"  sd_a chain means over the last 64 draws: min {m.min():.4f} "
                  f"max {m.max():.4f}", flush=True)


if __name__ == "__main__":
    main()
