"""Where the time goes in the PyTorch port's sampler on one CUDA card.

For the radon GLM (bench.build_model) and the marginal GP
(pymc_tpu_torch.models.gp_marginal_model, n = 150), each at 64 chains in
float32:
  1. logp+grad alone: host ms per batched call (wall of 50 calls ended by a
     synchronize), and under torch.profiler the device ms and the number of
     kernels per call;
  2. the leaf loop of one NUTS subtree alone (2**6 leaves, a small step so
     that no chain turns early): host ms per leaf, and under the profiler
     the kernels per leaf, split into logp+grad and the NUTS side (the
     uniform draw, the fused leaf kernel, the read of the active count);
  3. a short pymc_tpu_torch.sample run (tune 10, draws 5, trees cut at
     depth 4, so at most 15 leapfrogs a draw), once without the profiler
     for host ms per batched leapfrog, then under it: the device's kernel
     time and busy share, kernels per batched leapfrog split into
     logp+grad and everything else (the leaves, and spread over them the
     per-doubling merge, the subtree set-up and the per-draw adaptation),
     and the five kernels with the most device time with their shares.
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


def leaf_loop(fn, q, gen, depth=6):
    """One subtree of 2**depth leaves from q with a small step; returns the
    number of leaves run."""
    from pymc_tpu_torch.ops.leapfrog import SubtreeState, nuts_leaf_step

    C, D = q.shape
    logp, grad = fn(q)
    p = torch.randn(C, D, generator=gen, device="cuda")
    h0 = -logp + 0.5 * torch.sum(p * p, dim=-1)
    s = SubtreeState(
        q, p, grad, logp, h0, torch.ones_like(q), torch.full((C,), 1e-3, device="cuda"),
        torch.ones(C, dtype=torch.bool, device="cuda"),
        torch.full((C,), depth, dtype=torch.int32, device="cuda"), depth + 1,
    )
    leaves = 0
    while True:
        lp, g = fn(s.q_half)
        u = torch.rand(C, generator=gen, device="cuda")
        leaves += 1
        if not int(nuts_leaf_step(s, lp, g, u)):
            return leaves


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
    k_logp = n_kernels / 10
    print(f"{label} logp+grad (C={CHAINS}, D={D}): host ms per call {host_ms:.3f}; "
          f"device ms per call {dev_ms / 10:.4f}; kernels per call {k_logp:.1f}  [{card}]")

    gen = torch.Generator(device="cuda").manual_seed(0)
    leaf_loop(fn, q, gen)  # warm up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    leaves = leaf_loop(fn, q, gen)
    torch.cuda.synchronize()
    leaf_ms = (time.perf_counter() - t0) / leaves * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        leaves_p = leaf_loop(fn, q, gen)
        torch.cuda.synchronize()
    _, n_kernels, _ = kernel_stats(prof)
    print(f"{label} leaf loop ({leaves} leaves): host ms per leaf {leaf_ms:.3f}; kernels per "
          f"leaf {n_kernels / leaves_p:.1f} = logp+grad {k_logp:.1f} + NUTS "
          f"{n_kernels / leaves_p - k_logp:.1f} (the subtree's set-up spread over "
          f"{leaves_p} leaves included)  [{card}]")

    kw = dict(draws=5, tune=10, chains=CHAINS, random_seed=0, mass_adapt="pooled",
              max_treedepth=4, compute_convergence_checks=False, device="cuda")
    pm.sample(model=model, **dict(kw, draws=1, tune=1))  # warm up
    t0 = time.perf_counter()
    idata = pm.sample(model=model, **kw)
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        idata = pm.sample(model=model, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_ms, n_kernels, rows = kernel_stats(prof)
    calls = idata.posterior.attrs["n_logp_grad"]
    per_call = n_kernels / calls
    print(f"{label} sample(tune 10, draws 5, max_treedepth 4): wall {wall_plain:.3f} s, "
          f"host ms per batched leapfrog {wall_plain / calls * 1e3:.3f} (not profiled); "
          f"profiled wall {wall:.3f} s; device kernel time {dev_ms / 1e3:.4f} s; busy "
          f"{100 * dev_ms / 1e3 / wall:.2f} %; {calls} logp+grad calls; kernels per "
          f"batched leapfrog {per_call:.1f} = logp+grad {k_logp:.1f} + NUTS and adaptation "
          f"{per_call - k_logp:.1f}  [{card}]")
    for name, ms, count in rows[:5]:
        print(f"    {ms:10.3f} ms  {100 * ms / dev_ms:5.1f} %  {count:7d}x  {name[:80]}")


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
