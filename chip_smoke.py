"""Drive the PyTorch port (pymc_tpu_torch) on one CUDA card and check it.

Phases, in order; any failure ends the script with a non-zero exit:
  1. device   — require CUDA; print the card's name and power limit
  2. build    — build pymc_tpu_torch/csrc/leapfrog.cu and cholesky.cu with
                nvcc, one process each, started together; print ptxas's
                register and shared-memory report
  3. kernels  — each kernel against its plain PyTorch version on the card:
                the leapfrog pair at the (chains, D) of both sampled models
                and at edges of its range, in float32 and float64,
                the batched Cholesky at the GP path's (64, 150) and at n from
                1 to 1000 in float32 and float64, on both sides of the
                shared-memory limit, and on batches with indefinite
                matrices; each timed with CUDA events at the sampler's
                shapes, the Cholesky at (64, 150), (1024, 150) and (8, 500)
                also against torch.linalg.cholesky_ex (the yardstick) and
                torch.linalg.cholesky
  4. logp     — the radon GLM's and the marginal GP's (C, D) -> (logp,
                grad) on the card in float32 against the port on the CPU
                in float64
  5. sampling — pymc_tpu_torch.sample on bench.build_model at bench.py's
                many-chain configuration cut in depth (64 chains, tune 200,
                draws 128, pooled mass and step, target_accept 0.95,
                pymc_tpu_torch.models.RADON_SAMPLE_KWARGS); both leapfrog
                kernels must carry every leapfrog, R-hat must be < 1.05 and
                the posterior means must match
                tests/data/torch_radon_reference.json (made by pymc_tpu on
                the CPU) within 5 combined MCSE
  6. GP       — pymc_tpu_torch.sample on the marginal GP (BASELINE config
                #4, n = 150) with benchmarks/suite.py::case_gp_marginal's
                arguments (64 chains, tune 300, draws 300, pooled mass);
                the Cholesky kernel must factor the covariance stack of
                every batched logp+grad, the leapfrog kernels must carry
                every leapfrog, R-hat must be < 1.05 and the means of ls,
                eta and sigma must match
                tests/data/torch_gp_marginal_reference.json within 5
                combined MCSE

Each sampling phase sets every kernel's launch count to 0 just before it
samples and reads the counts just after. The line before the last is one
JSON object with each kernel's launches (summed over both sampling phases),
error, times and bound; the last line is {"ok": true, "device": {...}}.

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
GP_REFERENCE = os.path.join(ROOT, "tests", "data", "torch_gp_marginal_reference.json")
KERNEL_SOURCE = "pymc_tpu_torch/csrc/leapfrog.cu"
CHOL_SOURCE = "pymc_tpu_torch/csrc/cholesky.cu"
# edges of the leapfrog kernels' range; the sampled models' own (chains, D)
# come first, from sampled_shapes()
EDGE_SHAPES = [(1, 1), (7, 175), (1024, 175), (64, 4097)]
TIMED_SHAPES = [(64, 175), (1024, 175)]
# q', p_half and p' differ from the plain version only by FMA contraction;
# ke also by the order of the row sum
RTOL = {torch.float32: 1e-6, torch.float64: 1e-13}
RTOL_KE = {torch.float32: 1e-5, torch.float64: 1e-12}
SCALARS = ("mu_a", "mu_b", "sigma_a", "sigma_b", "sigma_y")
# (C, n, dtype): the GP path's stack first, then edges of the kernel's range;
# the tiles of a matrix stay in shared memory up to n = 320 (float32) and
# n = 224 (float64), beyond that in a device workspace
CHOL_SHAPES = [
    (64, 150, torch.float32), (64, 150, torch.float64), (1, 1, torch.float32),
    (7, 13, torch.float32), (3, 160, torch.float32), (1024, 150, torch.float32),
    (8, 161, torch.float32), (4, 256, torch.float32), (2, 320, torch.float32),
    (2, 321, torch.float32), (8, 500, torch.float32), (2, 1000, torch.float32),
    (4, 161, torch.float64), (3, 224, torch.float64), (2, 225, torch.float64),
    (2, 300, torch.float64),
]
# (C, n) timed in float32, the GP path's first; indefinite batches at these n
CHOL_TIMED = [(64, 150), (1024, 150), (8, 500)]
CHOL_INDEFINITE = [150, 300, 500]
# |L - L_plain| <= tol * n * max|L_plain|: float32 is tests/ops/test_linalg.py's bound
CHOL_TOL = {torch.float32: 2e-5, torch.float64: 1e-12}
# published H100 SXM peaks: HBM bytes/s, and FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


def bound_ms(n_bytes, n_ops, dtype):
    """(least ms the card could take, "bytes" or "operations")."""
    t_bytes = n_bytes / PEAK_BYTES * 1e3
    t_ops = n_ops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    """Phase 2: nvcc builds csrc/leapfrog.cu and csrc/cholesky.cu for
    sm_90a, one process each, started together."""
    from pymc_tpu_torch.ops import _build

    phase("2 build")
    t0 = time.perf_counter()
    _build.load_libraries(["leapfrog", "cholesky"])
    print(f"built {KERNEL_SOURCE} and {CHOL_SOURCE} in {time.perf_counter() - t0:.2f} s")
    for name in ("leapfrog", "cholesky"):
        print(f"-- {name}.cu: nvcc {_build.build_seconds.get(name, 0.0):.2f} s")
        print(_build.build_log.get(name, "").strip())


def sampled_shapes():
    """The (chains, D) that phases 5 and 6 hand the leapfrog kernels."""
    import pymc_tpu_torch as pm
    from pymc_tpu_torch.models import GP_SAMPLE_KWARGS, RADON_SAMPLE_KWARGS, gp_marginal_model

    return [
        (RADON_SAMPLE_KWARGS["chains"], bench_module().build_model(pm).raveled_info().total_size),
        (GP_SAMPLE_KWARGS["chains"], gp_marginal_model(150).raveled_info().total_size),
    ]


def check_kernels(card):
    """Phase 3: each kernel against its plain version on the card, then
    both timed. Returns (max abs errors over the sampled models' shapes in
    float32, {shape: median ms})."""
    from pymc_tpu_torch.ops import leapfrog as lf

    phase("3 kernels against their plain versions")
    path = sampled_shapes()
    print(f"sampled models' (chains, D): {path}")
    errs = {"kick_drift": 0.0, "final_kick": 0.0}
    for dtype in (torch.float32, torch.float64):
        for C, D in path + EDGE_SHAPES:
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
            if (C, D) in path and dtype == torch.float32:
                errs = {"kick_drift": max(errs["kick_drift"], e_kd),
                        "final_kick": max(errs["final_kick"], e_fk, e_ke)}
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


def spd_stack(C, n, dtype, seed):
    """(C, n, n) SPD matrices B B^T / n + I, B standard normal from `seed`
    (eigenvalues in about [1, 5])."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    B = torch.randn(C, n, n, generator=g, device="cuda", dtype=torch.float64)
    eye = torch.eye(n, device="cuda", dtype=torch.float64)
    return (B @ B.transpose(-1, -2) / n + eye).to(dtype)


def chol_bound(C, n):
    """Bound of one factorisation in float32: A's lower triangle read once,
    the dense L written once; C n^3 / 3 multiply-adds."""
    return bound_ms(C * (n * (n + 1) // 2 + n * n) * 4, C * n**3 / 3, torch.float32)


def check_cholesky(card):
    """Phase 3, Cholesky: the kernel against cholesky_plain on the card at
    CHOL_SHAPES and on batches with indefinite matrices, each call one
    launch, then timed at CHOL_TIMED in float32 against its plain version,
    torch.linalg.cholesky_ex and torch.linalg.cholesky. Returns (max abs
    error at (64, 150) float32, {name: median ms} at (64, 150))."""
    from pymc_tpu_torch.ops import linalg as la

    phase("3 cholesky kernel against its plain version")

    def factor(A):
        before = la.cholesky_batched.launches
        L = la.cholesky_batched(A)
        if la.cholesky_batched.launches != before + 1:
            raise AssertionError(f"cholesky_batched at {tuple(A.shape)} launched no kernel")
        return L

    err_main = None
    for C, n, dtype in CHOL_SHAPES:
        A = spd_stack(C, n, dtype, seed=C + n)
        L = factor(A)
        ref = la.cholesky_plain(A)
        torch.cuda.synchronize()
        tag = f"({C}, {n}) {dtype}"
        err = float((L.double() - ref.double()).abs().max())
        tol = CHOL_TOL[dtype] * n * float(ref.double().abs().max())
        upper_zero = bool((torch.triu(L, 1) == 0).all())
        print(f"{tag}: max abs err {err:.3e} (tol {tol:.3e}); upper triangle zero {upper_zero}")
        if not (bool(torch.isfinite(L).all()) and err <= tol and upper_zero):
            raise AssertionError(f"cholesky kernel disagrees with its plain version at {tag}")
        if err_main is None:
            err_main = err
    # indefinite matrices: A - 3 I has eigenvalues on both sides of 0
    for n in CHOL_INDEFINITE:
        A = spd_stack(16, n, torch.float32, seed=99 + n)
        bad = torch.zeros(16, dtype=torch.bool, device="cuda")
        bad[[3, 7, 12]] = True
        A[bad] -= 3.0 * torch.eye(n, device="cuda")
        L = factor(A)
        ref = la.cholesky_plain(A)
        torch.cuda.synchronize()
        nonfinite = ~torch.isfinite(L).flatten(1).all(dim=1)
        err = float((L[~bad].double() - ref[~bad].double()).abs().max())
        tol = CHOL_TOL[torch.float32] * n * float(ref[~bad].double().abs().max())
        print(f"indefinite batch (16, {n}): non-finite factors at "
              f"{nonfinite.nonzero().flatten().tolist()} (indefinite "
              f"{bad.nonzero().flatten().tolist()}); others max abs err {err:.3e}")
        if not (bool((nonfinite == bad).all()) and err <= tol):
            raise AssertionError(f"cholesky kernel mishandles indefinite matrices at n = {n}")
    times = {}
    for C, n in CHOL_TIMED:
        A = spd_stack(C, n, torch.float32, seed=1)
        calls = {
            "plain": lambda: la.cholesky_plain(A),
            "kernel": lambda: la.cholesky_batched(A),
            "library": lambda: torch.linalg.cholesky_ex(A),
            "cholesky": lambda: torch.linalg.cholesky(A),
        }
        # in turns, mirrored: compare within one card and call
        order = ["plain", "kernel", "library", "cholesky"]
        measured = {k: [] for k in calls}
        for k in order + order[::-1]:
            measured[k].append(cuda_ms(calls[k]))
        times[(C, n)] = {k: min(m[0] for m in v) for k, v in measured.items()}
        for k, v in measured.items():
            print(f"({C}, {n}) float32 cholesky {k}: device ms "
                  f"{', '.join(f'{m[0]:.5f}' for m in v)}; host ms per call "
                  f"{', '.join(f'{m[1]:.5f}' for m in v)}  [{card}]")
        b_ms, b_by = chol_bound(C, n)
        print(f"({C}, {n}) float32 cholesky: kernel {times[(C, n)]['kernel']:.5f} ms, "
              f"cholesky_ex {times[(C, n)]['library']:.5f} ms, bound {b_ms:.7f} ms "
              f"({b_by})  [{card}]")
    return err_main, times[CHOL_TIMED[0]]


def check_logp_on_card(label, model):
    """(C, D) -> (logp, grad) at 64 points, float32 on the card against
    float64 on the CPU: logp max relative error < 1e-4, grad max abs error
    < 1e-3 of the largest gradient entry."""
    D = model.raveled_info().total_size
    q_np = np.random.default_rng(0).normal(0.0, 0.5, size=(64, D))
    q_card = torch.as_tensor(q_np, device="cuda", dtype=torch.float32)
    lp_c, g_c = model.logp_dlogp_fn(device="cuda")(q_card)
    lp_r, g_r = model.logp_dlogp_fn(device="cpu")(torch.as_tensor(q_np))
    lp_c, g_c = lp_c.double().cpu(), g_c.double().cpu()
    lp_err = float(((lp_c - lp_r).abs() / lp_r.abs()).max())
    g_err = float((g_c - g_r).abs().max())
    g_tol = 1e-3 * float(g_r.abs().max())
    print(f"{label}: logp max rel err {lp_err:.3e} (tol 1e-4); "
          f"grad max abs err {g_err:.3e} (tol {g_tol:.3e})")
    if not (lp_err < 1e-4 and g_err < g_tol):
        raise AssertionError(f"{label} logp/grad on the card disagrees with the CPU")


def check_logp():
    """Phase 4: the radon GLM's and the marginal GP's logp/grad on the card."""
    import pymc_tpu_torch as pm
    from pymc_tpu_torch.models import gp_marginal_model

    phase("4 logp/grad on the card")
    check_logp_on_card("radon", bench_module().build_model(pm))
    check_logp_on_card("GP marginal (n = 150)", gp_marginal_model(150))


def sample_counted(model, config):
    """pm.sample on the card with every kernel's launch count set to 0 just
    before and read just after; returns (idata, {kernel: launches})."""
    import pymc_tpu_torch as pm
    from pymc_tpu_torch.ops import leapfrog as lf
    from pymc_tpu_torch.ops import linalg as la

    wrappers = {
        "kick_drift": lf.leapfrog_kick_drift,
        "final_kick": lf.leapfrog_final_kick,
        "cholesky": la.cholesky_batched,
    }
    for w in wrappers.values():
        w.launches = 0
    idata = pm.sample(model=model, device="cuda", compute_convergence_checks=False, **config)
    return idata, {k: w.launches for k, w in wrappers.items()}


def run_sampler(card):
    """Phase 5: sample the radon GLM on the card; returns (idata,
    {kernel: launches}, max R-hat)."""
    import pymc_tpu_torch as pm
    from pymc_tpu_torch.models import RADON_SAMPLE_KWARGS
    from pymc_tpu_torch.stats.convergence import ess, grad_evals_per_sec, rhat

    phase("5 sampling")
    idata, launches = sample_counted(bench_module().build_model(pm), RADON_SAMPLE_KWARGS)
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
          f"{syncs} ({syncs / RADON_SAMPLE_KWARGS['draws']:.1f} per draw)")
    return idata, launches, max_rhat


def check_posterior(idata, launches, max_rhat):
    """Phase 5 checks: kernels carried every leapfrog, convergence, finite
    draws, posterior means against the pymc_tpu reference."""
    from pymc_tpu_torch.models import RADON_SAMPLE_KWARGS
    from pymc_tpu_torch.stats.convergence import mcse_mean

    post = idata.posterior
    n_leapfrog = post.attrs["n_leapfrog"]
    if not all(launches[k] == n_leapfrog > 0 for k in ("kick_drift", "final_kick")):
        raise AssertionError(f"launch counts {launches} != leapfrogs {n_leapfrog}")
    if not max_rhat < 1.05:
        raise AssertionError(f"max R-hat {max_rhat:.4f} >= 1.05")
    for name in post.keys():
        expected = (RADON_SAMPLE_KWARGS["chains"], RADON_SAMPLE_KWARGS["draws"])
        if post[name].shape[:2] != expected:
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


def run_gp(card):
    """Phase 6: sample the marginal GP on the card and check it; returns
    {kernel: launches}."""
    from pymc_tpu_torch.models import GP_SAMPLE_KWARGS, GP_SCALARS, gp_marginal_model
    from pymc_tpu_torch.stats.convergence import ess, grad_evals_per_sec, mcse_mean, rhat

    phase("6 GP marginal sampling")
    idata, launches = sample_counted(gp_marginal_model(150), GP_SAMPLE_KWARGS)
    post, stats = idata.posterior, idata.sample_stats
    wall = post.attrs["sampling_time"]
    n_leapfrog, n_calls = post.attrs["n_leapfrog"], post.attrs["n_logp_grad"]
    min_ess = min(float(np.nanmin(ess(post[n].values))) for n in GP_SCALARS)
    max_rhat = max(float(np.nanmax(rhat(post[n].values))) for n in GP_SCALARS)
    print(f"min-ESS/s {min_ess / wall:.2f} (min ESS {min_ess:.1f}); "
          f"grad-evals/s {grad_evals_per_sec(idata):.1f}; sampling wall {wall:.2f} s; "
          f"tuning wall {post.attrs['tuning_time']:.2f} s  [{card}]")
    print(f"divergences {int(stats['diverging'].values.sum())}; max R-hat {max_rhat:.4f}; "
          f"leapfrogs {n_leapfrog}; logp+grad calls {n_calls}; launches {launches}; "
          f"mean tree depth {float(stats['tree_depth'].values.mean()):.2f}")
    if not (launches["cholesky"] == n_calls and n_calls >= n_leapfrog > 0):
        raise AssertionError(
            f"cholesky launches {launches['cholesky']} != logp+grad calls {n_calls}"
        )
    if not all(launches[k] == n_leapfrog for k in ("kick_drift", "final_kick")):
        raise AssertionError(f"leapfrog launches {launches} != leapfrogs {n_leapfrog}")
    if not max_rhat < 1.05:
        raise AssertionError(f"GP max R-hat {max_rhat:.4f} >= 1.05")
    for name in post.keys():
        if not np.isfinite(post[name].values).all():
            raise AssertionError(f"non-finite draws in {name}")
    with open(GP_REFERENCE) as f:
        ref = json.load(f)["params"]
    for name in GP_SCALARS:
        x = post[name].values.astype(np.float64)
        se = float(np.hypot(mcse_mean(x), ref[name]["mcse"]))
        z = (float(x.mean()) - ref[name]["mean"]) / se
        print(f"{name}: mean {float(x.mean()):.5f} (reference {ref[name]['mean']:.5f}), "
              f"{z:+.2f} combined MCSE")
        if not abs(z) <= 5.0:
            raise AssertionError(f"GP {name} posterior mean is {z:+.2f} MCSE off the reference")
    return launches


def kernel_records(launches, errs, times, chol_err, chol_times):
    """The `kernels` line: every kernel with its launches on the main paths,
    error against its plain version, times and bound at the sampler's shape."""
    C, D = TIMED_SHAPES[0]
    f32 = torch.float32
    records = []
    for key, name, line, n_bytes, n_ops in (
        ("kick_drift", "leapfrog_kick_drift", 97, 6 * C * D * 4 + 4 * C, 6 * C * D),
        ("final_kick", "leapfrog_final_kick", 123, 4 * C * D * 4 + 8 * C, 6 * C * D + C),
    ):
        b_ms, b_by = bound_ms(n_bytes, n_ops, f32)
        records.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": f"pymc_tpu/ops/pallas_kernels.py:{line}",
            "launches": launches[key], "max_abs_err": errs[key],
            "ms": times[(C, D)][key], "plain_ms": times[(C, D)][f"{key}_plain"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
    b_ms, b_by = chol_bound(*CHOL_TIMED[0])
    records.append({
        "name": "cholesky_batched", "route": "cuda", "source": CHOL_SOURCE,
        "replaces": "pymc_tpu/ops/linalg.py:137", "launches": launches["cholesky"],
        "max_abs_err": chol_err, "ms": chol_times["kernel"], "plain_ms": chol_times["plain"],
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": chol_times["library"],
    })
    return records


def main():
    t_start = time.perf_counter()
    card, kind = check_device()
    build_kernels()
    errs, times = check_kernels(card)
    chol_err, chol_times = check_cholesky(card)
    check_logp()
    idata, launches, max_rhat = run_sampler(card)
    check_posterior(idata, launches, max_rhat)
    gp_launches = run_gp(card)
    total = {k: launches[k] + gp_launches[k] for k in launches}
    kernels = kernel_records(total, errs, times, chol_err, chol_times)
    print(f"launches: radon {launches}; GP {gp_launches}")
    print(f"total wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
