"""Where the time goes in the PyTorch port's sampler on one CUDA card.

For the radon GLM (bench.build_model) and the marginal GP
(pymc_tpu_torch.models.gp_marginal_model, n = 150), each at 64 chains in
float32:
  1. logp+grad alone: host ms per batched call (wall of 50 calls ended by a
     synchronize), and under torch.profiler the device ms and the number of
     kernels per call;
  2. a short pymc_tpu_torch.sample run (tune 10, draws 5, trees cut at
     depth 4, so at most 15 leapfrogs a draw) under torch.profiler: its
     wall, the device's kernel time and busy share, kernels per logp+grad
     call, and the five kernels with the most device time.
The card's name and power limit are printed beside the numbers; the script
exits non-zero without CUDA. The short run's trees follow an unadapted step
size and are cut at depth 4, so its figures describe the per-leapfrog and
per-doubling costs, not the tree sizes of a full run.

Usage:
    python3 scripts/profile_torch_sampler.py
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

CHAINS = 64


def kernel_stats(prof):
    """(device ms summed over kernels, kernel count, [(name, ms, count)])."""
    rows = []
    for evt in prof.key_averages():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = getattr(evt, "self_device_time_total", None)
        if ms is None:
            ms = evt.self_cuda_time_total
        rows.append((evt.key, ms / 1e3, evt.count))
    rows.sort(key=lambda r: -r[1])
    return sum(r[1] for r in rows), sum(r[2] for r in rows), rows


def probe(label, model, card):
    import pymc_tpu_torch as pm

    D = model.raveled_info().total_size
    fn = model.logp_dlogp_fn(device="cuda")
    q = torch.as_tensor(
        np.random.default_rng(0).normal(0.0, 0.5, size=(CHAINS, D)),
        device="cuda", dtype=torch.float32,
    )
    for _ in range(10):
        fn(q)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(50):
        fn(q)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) / 50 * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            fn(q)
        torch.cuda.synchronize()
    dev_ms, n_kernels, _ = kernel_stats(prof)
    print(f"{label} logp+grad (C={CHAINS}, D={D}): host ms per call {host_ms:.3f}; "
          f"device ms per call {dev_ms / 10:.4f}; kernels per call {n_kernels / 10:.1f}  [{card}]")

    kw = dict(draws=5, tune=10, chains=CHAINS, random_seed=0, mass_adapt="pooled",
              max_treedepth=4, compute_convergence_checks=False, device="cuda")
    pm.sample(model=model, **dict(kw, draws=1, tune=1))  # warm up
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        idata = pm.sample(model=model, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_ms, n_kernels, rows = kernel_stats(prof)
    calls = idata.posterior.attrs["n_logp_grad"]
    print(f"{label} sample(tune 10, draws 5, max_treedepth 4): wall {wall:.3f} s (profiled); device kernel "
          f"time {dev_ms / 1e3:.4f} s; busy {100 * dev_ms / 1e3 / wall:.2f} %; "
          f"{calls} logp+grad calls; {wall / calls * 1e3:.3f} ms and "
          f"{n_kernels / calls:.1f} kernels per call  [{card}]")
    for name, ms, count in rows[:5]:
        print(f"    {ms:10.3f} ms  {count:7d}x  {name[:90]}")


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_sampler: no CUDA card")
    import bench
    import pymc_tpu_torch as pm
    from pymc_tpu_torch.models import gp_marginal_model

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    probe("radon", bench.build_model(pm), card)
    probe("GP marginal n=150", gp_marginal_model(150), card)


if __name__ == "__main__":
    main()
