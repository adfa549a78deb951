"""Where the time goes in the PyTorch port's sampler on one CUDA card.

NUTS mode (the default): for the radon GLM (bench.build_model) and the
marginal GP (pymc_tpu_torch.models.gp_marginal_model, n = 150), each at 64
chains in float32:
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
     the fused leaf kernel's device time, launches and share, and the
     kernels with the most device time with their shares.
The short run's trees follow an unadapted step size and are cut at depth
4, so its figures describe the per-leapfrog and per-doubling costs, not
the tree sizes of a full run.

Stress mode (--stress): the stress GLM (BASELINE config #3, 10,004
parameters) at 1024 chains with ChEES, as chip_smoke.py phase 7 samples
it: step 1 at (1024, 10004), then step 3 with sampler="chees" (tune 10,
draws 5, every leapfrog of a draw the same L): kernels per batched
leapfrog split into logp+grad and the rest (the pair, the freeze of
non-finite lanes and, spread over the leapfrogs, the per-draw ChEES update
and adaptation), host ms per leapfrog, the busy share, and the top device
kernels with the share of the gather's backward
(`indexing_backward_kernel` and the other index/scatter kernels).

The card's name and power limit are printed beside the numbers; the script
exits non-zero without CUDA.

Usage:
    python3 scripts/profile_torch_sampler.py            # radon and GP, NUTS
    python3 scripts/profile_torch_sampler.py --stress   # stress GLM, ChEES
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
STRESS_CHAINS = 1024


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


def logp_grad_alone(label, model, chains, card):
    """Step 1; returns (fn, q, kernels per call)."""
    D = model.raveled_info().total_size
    # the eager function, its kernels launched one by one (the samplers
    # replay them from a CUDA graph: ops/cuda_graph.py)
    fn = model.logp_dlogp_fn(device="cuda").fn
    q = torch.as_tensor(
        np.random.default_rng(0).normal(0.0, 0.5, size=(chains, D)),
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
    dev_ms, n_kernels, rows = kernel_stats(prof)
    k_logp = n_kernels / 10
    print(f"{label} logp+grad (C={chains}, D={D}): wall ms per call (50 calls, then a "
          f"synchronize) {host_ms:.3f}; "
          f"device ms per call {dev_ms / 10:.4f}; kernels per call {k_logp:.1f}  [{card}]")
    for name, ms, count in rows[:5]:
        print(f"    {ms:10.3f} ms  {100 * ms / dev_ms:5.1f} %  {count:7d}x  {name[:80]}")
    return fn, q, k_logp


def sample_window(label, model, kw, k_logp, card):
    """Step 3: a short sample run, unprofiled and then profiled."""
    import pymc_tpu_torch as pm

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
    print(f"{label} sample({', '.join(f'{k} {v}' for k, v in kw.items() if k in SHOWN)}): "
          f"wall {wall_plain:.3f} s, host ms per batched leapfrog "
          f"{wall_plain / calls * 1e3:.3f} (not profiled); profiled wall {wall:.3f} s; "
          f"device kernel time {dev_ms / 1e3:.4f} s; busy {100 * dev_ms / 1e3 / wall:.2f} %; "
          f"{calls} logp+grad calls; kernels per batched leapfrog {per_call:.1f} = logp+grad "
          f"{k_logp:.1f} + sampler and adaptation {per_call - k_logp:.1f}  [{card}]")
    leaf = [(ms, count) for name, ms, count in rows if "nuts_leaf" in name]
    if leaf:
        leaf_ms, leaf_n = sum(r[0] for r in leaf), sum(r[1] for r in leaf)
        print(f"{label} leaf kernel: {leaf_ms:.3f} ms over {leaf_n} launches "
              f"({1e3 * leaf_ms / leaf_n:.3f} us each), {100 * leaf_ms / dev_ms:.2f} % of the "
              f"device time, {100 * leaf_ms / 1e3 / wall:.3f} % of the wall  [{card}]")
    for name, ms, count in rows[:8]:
        print(f"    {ms:10.3f} ms  {100 * ms / dev_ms:5.1f} %  {count:7d}x  {name[:80]}")
    return dev_ms, rows


SHOWN = ("sampler", "tune", "draws", "chains", "max_treedepth")


def probe(label, model, card):
    fn, q, k_logp = logp_grad_alone(label, model, CHAINS, card)

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
    sample_window(label, model, kw, k_logp, card)


def probe_stress(card):
    """The stress GLM at 1024 chains with ChEES."""
    from pymc_tpu_torch.models import STRESS_SAMPLE_KWARGS, stress_glm_model

    model = stress_glm_model()
    label = "stress GLM"
    _, _, k_logp = logp_grad_alone(label, model, STRESS_CHAINS, card)
    kw = dict(STRESS_SAMPLE_KWARGS, draws=5, tune=10, compute_convergence_checks=False,
              device="cuda")
    dev_ms, rows = sample_window(label, model, kw, k_logp, card)
    gather = [(n, ms) for n, ms, _ in rows if "index" in n.lower() or "scatter" in n.lower()]
    share = 100 * sum(ms for _, ms in gather) / dev_ms
    print(f"{label}: index/scatter kernels {share:.2f} % of the device time: "
          + "; ".join(f"{n[:60]} {100 * ms / dev_ms:.2f} %" for n, ms in gather))


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
    if "--stress" in sys.argv[1:]:
        probe_stress(card)
        return
    probe("radon", bench.build_model(pm), card)
    probe("GP marginal n=150", gp_marginal_model(150), card)


if __name__ == "__main__":
    main()
