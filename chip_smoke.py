"""Drive the PyTorch port (pymc_tpu_torch) on one CUDA card and check it.

Phases, in order; any failure ends the script with a non-zero exit:
  1. device   — require CUDA; print the card's name and power limit
  2. build    — build the leapfrog kernels from pymc_tpu_torch/csrc with nvcc
  3. kernels  — each kernel against its plain PyTorch version on the card,
                at several shapes in float32 and float64, and timed with
                CUDA events at the sampler's shapes
  4. logp     — the radon GLM's (C, D) -> (logp, grad) on the card in
                float32 against the port on the CPU in float64
  5. sampling — pymc_tpu_torch.sample on bench.build_model at bench.py's
                many-chain configuration (64 chains, tune 300, draws 256,
                pooled mass and step, target_accept 0.95); both kernels
                must carry every leapfrog, R-hat must be < 1.05 and the
                posterior means must match tests/data/torch_radon_reference.json
                (made by pymc_tpu on the CPU) within 5 combined MCSE

The line before the last is one JSON object with each kernel's launches,
error and times; the last line is {"ok": true, "device": {...}}.

Usage:
    python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

REFERENCE = os.path.join(ROOT, "tests", "data", "torch_radon_reference.json")
KERNEL_SOURCE = "pymc_tpu_torch/csrc/leapfrog.cu"
SHAPES = [(64, 175), (1, 1), (7, 175), (1024, 175), (64, 4097)]
TIMED_SHAPES = [(64, 175), (1024, 175)]
# q', p_half and p' differ from the plain version only by FMA contraction;
# ke also by the order of the row sum
RTOL = {torch.float32: 1e-6, torch.float64: 1e-13}
RTOL_KE = {torch.float32: 1e-5, torch.float64: 1e-12}
CONFIG = dict(
    chains=64, tune=300, draws=256, random_seed=0, mass_adapt="pooled",
    step_adapt="pooled", target_accept=0.95,
)
SCALARS = ("mu_a", "mu_b", "sigma_a", "sigma_b", "sigma_y")


def phase(name):
    print(f"== {name}", flush=True)


def check_close(label, out, ref, rtol):
    """|out - ref| <= rtol * (|ref| + max|ref|) elementwise: relative to the
    row scale, since a near-zero element of p + eps/2 * g carries the
    rounding error of its larger terms. Returns the max abs error."""
    err = (out.double() - ref.double()).abs()
    bound = rtol * (ref.double().abs() + ref.double().abs().max())
    if not bool(torch.isfinite(out).all()) or bool((err > bound).any()):
        raise AssertionError(
            f"{label}: max abs err {float(err.max()):.3e} exceeds rtol {rtol:g}"
        )
    return float(err.max())


def cuda_ms(fn, n=200, warmup=20):
    """(device ms, host ms) per call. Device: median over n calls of CUDA
    events around one call, enqueued behind a ~0.5 ms device sleep so the
    host's enqueue time does not land between the events. Host: wall time
    of n back-to-back calls over n, synchronised at the end."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    return float(np.median(times)), (time.perf_counter() - t0) / n * 1e3


def leapfrog_inputs(C, D, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device="cuda", dtype=dtype)

    q, p, grad = randn(C, D), randn(C, D), randn(C, D)
    inv_mass = 0.5 + torch.rand(C, D, generator=g, device="cuda", dtype=dtype)
    sign = torch.where(torch.rand(C, generator=g, device="cuda") < 0.5, -1.0, 1.0)
    eps = (0.05 + 0.25 * torch.rand(C, generator=g, device="cuda", dtype=dtype)) * sign.to(dtype)
    return q, p, grad, inv_mass, eps


def check_device():
    """Phase 1: the card, its power limit and the versions; returns
    (card line from nvidia-smi, torch.cuda.get_device_name(0))."""
    phase("1 device")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; no CPU fallback")
    import pymc_tpu_torch as pm

    for mod in (pm, bench_module()):
        if not os.path.abspath(mod.__file__).startswith(ROOT + os.sep):
            raise SystemExit(f"chip_smoke: {mod.__name__} imported from outside {ROOT}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind}")
    return card, kind


def bench_module():
    import bench

    return bench


def build_kernels():
    """Phase 2: nvcc builds csrc/leapfrog.cu for sm_90a."""
    from pymc_tpu_torch.ops import _build

    phase("2 build")
    t0 = time.perf_counter()
    _build.load_library("leapfrog")
    print(f"built {KERNEL_SOURCE} in {time.perf_counter() - t0:.2f} s "
          f"(nvcc {_build.build_seconds.get('leapfrog', 0.0):.2f} s)")
    print(_build.build_log.get("leapfrog", "").strip())


def check_kernels(card):
    """Phase 3: each kernel against its plain version on the card, then
    both timed. Returns (max abs errors at the sampler's shape in float32,
    {shape: median ms})."""
    from pymc_tpu_torch.ops import leapfrog as lf

    phase("3 kernels against their plain versions")
    errs = {}
    for dtype in (torch.float32, torch.float64):
        for C, D in SHAPES:
            q, p, grad, im, eps = leapfrog_inputs(C, D, dtype, seed=C + D)
            qk, phk = lf.leapfrog_kick_drift(q, p, grad, im, eps)
            qr, phr = lf.kick_drift_plain(q, p, grad, im, eps)
            pk, kek = lf.leapfrog_final_kick(phr, grad, im, eps)
            pr, ker = lf.final_kick_plain(phr, grad, im, eps)
            torch.cuda.synchronize()
            tag = f"({C}, {D}) {dtype}"
            e_kd = max(check_close(f"kick_drift q' {tag}", qk, qr, RTOL[dtype]),
                       check_close(f"kick_drift p_half {tag}", phk, phr, RTOL[dtype]))
            e_fk = check_close(f"final_kick p' {tag}", pk, pr, RTOL[dtype])
            e_ke = check_close(f"final_kick ke {tag}", kek, ker, RTOL_KE[dtype])
            print(f"{tag}: kick_drift max abs err {e_kd:.3e}, "
                  f"final_kick p' {e_fk:.3e} ke {e_ke:.3e}")
            if (C, D) == SHAPES[0] and dtype == torch.float32:
                errs = {"kick_drift": e_kd, "final_kick": max(e_fk, e_ke)}
    times = {}
    for C, D in TIMED_SHAPES:
        q, p, grad, im, eps = leapfrog_inputs(C, D, torch.float32, seed=1)
        ph = lf.kick_drift_plain(q, p, grad, im, eps)[1]
        calls = {
            "kick_drift": lambda: lf.leapfrog_kick_drift(q, p, grad, im, eps),
            "kick_drift_plain": lambda: lf.kick_drift_plain(q, p, grad, im, eps),
            "final_kick": lambda: lf.leapfrog_final_kick(ph, grad, im, eps),
            "final_kick_plain": lambda: lf.final_kick_plain(ph, grad, im, eps),
        }
        # plain, kernel, kernel, plain: compare within one card and call
        order = ["kick_drift_plain", "kick_drift", "final_kick_plain", "final_kick"]
        measured = {k: [] for k in calls}
        for k in order + order[::-1]:
            measured[k].append(cuda_ms(calls[k]))
        times[(C, D)] = {k: min(m[0] for m in v) for k, v in measured.items()}
        for k, v in measured.items():
            print(f"({C}, {D}) float32 {k}: device ms "
                  f"{', '.join(f'{m[0]:.5f}' for m in v)}; host ms per call "
                  f"{', '.join(f'{m[1]:.5f}' for m in v)}  [{card}]")
    return errs, times


def check_logp():
    """Phase 4: the radon (C, D) -> (logp, grad) at 64 points, float32 on
    the card against float64 on the CPU."""
    import pymc_tpu_torch as pm

    phase("4 radon logp/grad on the card")
    model = bench_module().build_model(pm)
    D = model.raveled_info().total_size
    q_np = np.random.default_rng(0).normal(0.0, 0.5, size=(64, D))
    q_card = torch.as_tensor(q_np, device="cuda", dtype=torch.float32)
    lp_c, g_c = model.logp_dlogp_fn(device="cuda")(q_card)
    lp_r, g_r = model.logp_dlogp_fn(device="cpu")(torch.as_tensor(q_np))
    lp_c, g_c = lp_c.double().cpu(), g_c.double().cpu()
    lp_err = float(((lp_c - lp_r).abs() / lp_r.abs()).max())
    g_err = float((g_c - g_r).abs().max())
    g_tol = 1e-3 * float(g_r.abs().max())
    print(f"logp max rel err {lp_err:.3e} (tol 1e-4); "
          f"grad max abs err {g_err:.3e} (tol {g_tol:.3e})")
    if not (lp_err < 1e-4 and g_err < g_tol):
        raise AssertionError("radon logp/grad on the card disagrees with the CPU")


def run_sampler(card, config=CONFIG):
    """Phase 5: sample the radon GLM on the card with the launch counts
    reset just before; returns (idata, {kernel: launches}, max R-hat)."""
    import pymc_tpu_torch as pm
    from pymc_tpu_torch.ops import leapfrog as lf
    from pymc_tpu_torch.stats.convergence import ess, grad_evals_per_sec, rhat

    phase("5 sampling")
    model = bench_module().build_model(pm)
    lf.leapfrog_kick_drift.launches = 0
    lf.leapfrog_final_kick.launches = 0
    idata = pm.sample(model=model, device="cuda", compute_convergence_checks=False, **config)
    launches = {
        "kick_drift": lf.leapfrog_kick_drift.launches,
        "final_kick": lf.leapfrog_final_kick.launches,
    }
    post, stats = idata.posterior, idata.sample_stats
    wall = post.attrs["sampling_time"]
    # min bulk ESS as bench.py:89-104 computes it
    min_ess = min(
        float(np.nanmin(ess(post[n].values)))
        for n in ("mu_a", "mu_b", "sigma_a", "sigma_b", "a", "b")
    )
    max_rhat = max(float(np.nanmax(rhat(post[n].values))) for n in post.keys())
    syncs = post.attrs["sampling_host_syncs"]
    print(f"min-ESS/s {min_ess / wall:.2f} (min ESS {min_ess:.1f}); "
          f"grad-evals/s {grad_evals_per_sec(idata):.1f}; sampling wall {wall:.2f} s; "
          f"tuning wall {post.attrs['tuning_time']:.2f} s  [{card}]")
    print(f"divergences {int(stats['diverging'].values.sum())}; max R-hat {max_rhat:.4f}; "
          f"leapfrogs {post.attrs['n_leapfrog']}; launches {launches}; mean tree depth "
          f"{float(stats['tree_depth'].values.mean()):.2f}; host syncs while drawing "
          f"{syncs} ({syncs / config['draws']:.1f} per draw)")
    return idata, launches, max_rhat


def check_posterior(idata, launches, max_rhat):
    """Phase 5 checks: kernels carried every leapfrog, convergence, finite
    draws, posterior means against the pymc_tpu reference."""
    from pymc_tpu_torch.stats.convergence import mcse_mean

    post = idata.posterior
    n_leapfrog = post.attrs["n_leapfrog"]
    if not all(n == n_leapfrog and n > 0 for n in launches.values()):
        raise AssertionError(f"launch counts {launches} != leapfrogs {n_leapfrog}")
    if not max_rhat < 1.05:
        raise AssertionError(f"max R-hat {max_rhat:.4f} >= 1.05")
    for name in post.keys():
        if post[name].shape[:2] != (CONFIG["chains"], CONFIG["draws"]):
            raise AssertionError(f"{name} has shape {post[name].shape}")
        if not np.isfinite(post[name].values).all():
            raise AssertionError(f"non-finite draws in {name}")
    with open(REFERENCE) as f:
        ref = json.load(f)["params"]
    for name in SCALARS:
        x = post[name].values.astype(np.float64)
        mean = float(x.mean())
        se = float(np.hypot(mcse_mean(x), ref[name]["mcse"]))
        z = (mean - ref[name]["mean"]) / se
        print(f"{name}: mean {mean:.5f} (reference {ref[name]['mean']:.5f}), "
              f"{z:+.2f} combined MCSE")
        if not abs(z) <= 5.0:
            raise AssertionError(f"{name} posterior mean is {z:+.2f} MCSE off the reference")


def main():
    t_start = time.perf_counter()
    card, kind = check_device()
    build_kernels()
    errs, times = check_kernels(card)
    check_logp()
    idata, launches, max_rhat = run_sampler(card)
    check_posterior(idata, launches, max_rhat)
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": KERNEL_SOURCE,
            "replaces": f"pymc_tpu/ops/pallas_kernels.py:{line}",
            "launches": launches[key],
            "max_abs_err": errs[key],
            "ms": times[TIMED_SHAPES[0]][key],
            "plain_ms": times[TIMED_SHAPES[0]][f"{key}_plain"],
        }
        for key, name, line in (
            ("kick_drift", "leapfrog_kick_drift", 97),
            ("final_kick", "leapfrog_final_kick", 123),
        )
    ]
    print(f"total wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
