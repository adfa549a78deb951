"""Drive the PyTorch port (pymc_tpu_torch) on one CUDA card and check it.

Phases, in order; any failure ends the script with a non-zero exit:
  1. device   — require CUDA; print the card's name and power limit
  2. build    — build pymc_tpu_torch/csrc/leapfrog.cu and cholesky.cu with
                nvcc, one process each, started together; print ptxas's
                register and shared-memory report
  3. kernels  — each kernel against its plain PyTorch version on the card:
                the leapfrog pair at the (chains, D) of the three sampled
                models (the stress GLM's (1024, 10004) among them) and at
                edges of its range, in float32 and float64,
                the fused NUTS leaf at the same shapes and dtypes from
                states that hold every n from 0 to 2**10 - 1 and every
                checkpoint slot, with inactive, turning and diverging rows
                (logp -inf or NaN, energy error > 1000) and rows that take
                the proposal; timed against the plain leaf and against the
                sequence it replaced in the sampler (final_kick kernel,
                plain bookkeeping, kick_drift kernel),
                the batched Cholesky at the GP path's (64, 150) and at n from
                1 to 1000 in float32 and float64, on both sides of the
                shared-memory limit, and on batches with indefinite
                matrices; each timed with CUDA events at the sampler's
                shapes (the pair also at (1024, 10004)), the Cholesky at
                (64, 150), (1024, 150) and (8, 500) also against
                torch.linalg.cholesky_ex (the yardstick) and
                torch.linalg.cholesky
  4. logp     — the radon GLM's, the marginal GP's and the stress GLM's
                (C, D) -> (logp, grad) on the card in float32 against the
                port on the CPU in float64 (the stress GLM at its 1024
                chains)
  5. sampling — pymc_tpu_torch.sample on bench.build_model at bench.py's
                many-chain configuration cut in depth (64 chains, tune 200,
                draws 128, pooled mass and step, target_accept 0.95,
                pymc_tpu_torch.models.RADON_SAMPLE_KWARGS); the leaf
                kernel must carry every NUTS leapfrog, final_kick every
                leapfrog of the step-size search, kick_drift those and the
                first of every subtree; R-hat must be < 1.05 and
                the posterior means must match
                tests/data/torch_radon_reference.json (made by pymc_tpu on
                the CPU) within 5 combined MCSE
  6. GP       — pymc_tpu_torch.sample on the marginal GP (BASELINE config
                #4, n = 150) with benchmarks/suite.py::case_gp_marginal's
                arguments cut in depth (64 chains, tune 200, draws 200,
                pooled mass; pymc_tpu_torch.models.GP_SMOKE_KWARGS);
                the Cholesky kernel must factor the covariance stack of
                every batched logp+grad, the leapfrog kernels must carry
                their leapfrogs as in phase 5, R-hat must be < 1.05 and the
                means of ls,
                eta and sigma must match
                tests/data/torch_gp_marginal_reference.json within 5
                combined MCSE
  7. stress   — pymc_tpu_torch.sample with sampler="chees" on the stress
                GLM (BASELINE config #3: 5,000 groups, 20,000
                observations, 10,004 parameters) with
                benchmarks/suite.py::case_stress_chees's arguments at 1024
                chains with a longer warmup (tune 600 for 300, draws 128,
                pooled mass and step, target_accept 0.95, var_names the
                four hyperparameters;
                pymc_tpu_torch.models.STRESS_SAMPLE_KWARGS); kick_drift and
                final_kick must each carry every leapfrog (the step-size
                search's and the sum of L over every draw), the leaf and
                Cholesky kernels none; every draw finite, the posterior
                exactly the four hyperparameters, their means within 5
                combined MCSE of tests/data/torch_stress_reference.json,
                and R-hat < 1.05 on mu_a, sd_a and mu_b, < 1.55 on sd_b
                (see STRESS_RHAT_LIMIT); prints min-ESS/s,
                grad-evals/s, time to R-hat < 1.01, the walls, mean L, the
                final trajectory length, host syncs per draw and the peak
                device memory
  8. SMC      — pymc_tpu_torch.sample_smc on BASELINE config #5
                (benchmarks/suite.py::case_smc's bimodal mixture, 120
                observations) with the suite's arguments (2000 draws, 4
                chains, IMH, threshold 0.5, correlation_threshold 0.01;
                pymc_tpu_torch.models.SMC_SAMPLE_KWARGS) at seeds 0-4,
                then once with MH at seed 0; every chain must reach beta =
                1 with every particle finite, the Cholesky kernel must
                factor the particle covariances once a stage and no other
                kernel run; the posterior means of mu and w and the mean
                log marginal likelihood over the 20 IMH chains must lie
                within SMC_Z combined standard errors (each side's from its
                spread between chains) of tests/data/torch_smc_reference.json
                (made by pymc_tpu on the CPU), MH's mean of mu too; prints
                each run's wall, stages, sweeps a stage, acceptance and
                host reads a stage, and the kernels of one sweep (profiled)
  9. GP       — prediction and the rest of BASELINE config #4's forms:
                9a. logp/grad at 64 points on the card in float32 against
                the CPU in float64 for the latent GP (n = 150), HSGP (m =
                32), a Student-t process, MarginalApprox with VFE and with
                FITC (20 inducing points), LatentKron and MarginalKron on a
                15 x 10 grid, each with its Cholesky launches a logp+grad
                (1, 0, 1, 2, 2, 2 and 0); the forms whose prior jitter
                depends on the float type take GP_FORM_JITTER on both sides;
                then the latent GP at its float32 default jitter against
                models.gp_latent_logp_plain in float64 with that jitter,
                and the card's factors of its prior covariance at 600
                (ls, eta): none non-finite, backward error < 0.5 jitter;
                9b. sample_posterior_predictive of f_pred =
                gp.conditional(..., pred_noise=True) at 100 points on [0,
                12] over phase 6's 12,800 draws, at seeds 0 and 1: every
                draw finite, two Cholesky launches a run (Ky and the
                conditional covariance), the
                draws' mean and variance at each point within GP_PRED_Z
                Monte Carlo standard errors of Marginal.predict's on the
                same draws on the CPU in float64; its wall and peak memory.
                The latent GP sampled with NUTS (config #4's named form) is
                scripts/probe_torch_gp_latent.py's: its deep lock-step trees
                take longer than this script's time limit allows

Phase 3 also checks and times the Cholesky at SMC's (4, 3) stack and at
phase 9's shapes, and phase 4 compares the two mixture models' logp/grad
and SMC's tempered density on the card with the CPU. Each sampling or
predictive phase sets every kernel's launch count to 0 just before it runs
and reads the counts just after. The line before the last is one JSON
object with each kernel's launches (summed over the sampling and
predictive phases), error, times and bound; the last line is {"ok": true,
"device": {...}}.

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
STRESS_REFERENCE = os.path.join(ROOT, "tests", "data", "torch_stress_reference.json")
SMC_REFERENCE = os.path.join(ROOT, "tests", "data", "torch_smc_reference.json")
# The default prior jitter of the latent, TP, Kron and sparse forms depends
# on the float type (1e-6 or 1e-4 in float64, at least 1e-4 in float32), so
# the float32 and float64 models differ by more than float32's rounding:
# phase 9a builds them with this jitter on both sides
GP_FORM_JITTER = 1e-2
# phase 9a also holds the latent GP at its float32 default jitter (3e-5
# eta^2, at least 1e-4) to the float64 model with that jitter. There K's
# condition reaches ~5e6, so float32's Cholesky moves f = L v, and with it
# the logp, far more than at GP_FORM_JITTER: LAPACK's float32 factor gives
# 1.9e-3 and 4.9e-4 at these points, and a backward error of 0.11 jitters
# over the lengthscales (tests/test_torch_gp_approx.py)
LATENT_LOGP_RTOL = 1e-2
LATENT_GRAD_RTOL = 5e-3
LATENT_BACKWARD_TOL = 0.5
# phase 9b: the predictive's mean and variance at each new point are held
# within this many Monte Carlo standard errors of Marginal.predict's
GP_PRED_Z = 5.0
GP_PRED_POINTS = 100
# two seeds, so that a shift of the draws' mean that one seed shows can be
# told from chance
GP_PRED_SEEDS = (0, 1)
# SMC's estimates differ from run to run: a mean over chains is held within
# this many combined standard errors, each from its side's between-chain
# spread (20 chains of pymc_tpu's, 20 of the port's IMH, 4 of its MH run)
SMC_Z = 5.0
# The stress GLM's hyperparameters and the R-hat each is held below. sd_b's
# limit is wider: with ChEES it has about 2 effective draws in each chain's
# 128 (bulk ESS 2,212 to 2,831 over 1024 chains at tune 600 to 1000 on the
# H100), and split R-hat^2 ~ 1 + 1 / (ESS per half chain) puts a sampler
# that mixes this slowly near 1.3 however long it tunes; pymc_tpu's ChEES,
# in the fixture's run, draws 0.031 effective draws of sd_b a draw, 4 in
# 128. Converged runs read 1.28 to 1.40 on the H100 and unconverged ones
# (tune 300) 1.70 to 1.80; 1.55 lies between. Its mean is held to the
# reference within 5 combined MCSE like the others'.
STRESS_RHAT_LIMIT = {"mu_a": 1.05, "sd_a": 1.05, "mu_b": 1.05, "sd_b": 1.55}
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
    (4, 3, torch.float32), (4, 3, torch.float64),
    (7, 13, torch.float32), (3, 160, torch.float32), (1024, 150, torch.float32),
    (8, 161, torch.float32), (4, 256, torch.float32), (2, 320, torch.float32),
    (2, 321, torch.float32), (8, 500, torch.float32), (2, 1000, torch.float32),
    (4, 161, torch.float64), (3, 224, torch.float64), (2, 225, torch.float64),
    (2, 300, torch.float64), (12800, 150, torch.float32), (12800, 100, torch.float32),
    (64, 20, torch.float32), (64, 15, torch.float32), (64, 10, torch.float32),
]
# (C, n) timed in float32, the GP path's first, SMC's particle covariances
# last; indefinite batches at these n
CHOL_TIMED = [(64, 150), (1024, 150), (8, 500), (4, 3)]
# phase 9's shapes: the predictive's Ky and conditional covariance over
# 12,800 draws, MarginalApprox's Kuu and B at 20 inducing points, the Kron
# factors of the 15 x 10 grid
CHOL_TIMED_GP = [(12800, 150), (12800, 100), (64, 20), (64, 15), (64, 10)]
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


T_START = time.perf_counter()


def phase(name):
    print(f"== {name} (at {time.perf_counter() - T_START:.1f} s)", flush=True)


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


def sleep_cycles_per_ms():
    """Cycles of torch.cuda._sleep the card spins in one ms, measured once."""
    if not hasattr(sleep_cycles_per_ms, "rate"):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)  # warm up
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        sleep_cycles_per_ms.rate = 10_000_000 / start.elapsed_time(end)
    return sleep_cycles_per_ms.rate


def cuda_ms(fn, n=200, warmup=20, setup=None):
    """(device ms, host ms) per call. Host: wall time of n back-to-back
    calls over n, synchronised at the end; with setup (run before every
    call: it restores a state the call updates in place) the host time of
    the calls alone. Device: median over n calls of CUDA events around one
    call, enqueued behind a device sleep of twice the host ms a call (at
    least 0.5 ms), so the host's enqueue time does not land between the
    events."""
    for _ in range(warmup):
        if setup is not None:
            setup()
        fn()
    torch.cuda.synchronize()
    host = 0.0
    for _ in range(n):
        if setup is not None:
            setup()
        t0 = time.perf_counter()
        fn()
        host += time.perf_counter() - t0
    torch.cuda.synchronize()
    host_ms = host / n * 1e3
    sleep = int(max(0.5, 2.0 * host_ms) * sleep_cycles_per_ms())
    times = []
    for _ in range(n):
        if setup is not None:
            setup()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times)), host_ms


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


def stress_shape():
    """The (chains, D) that phase 7 hands the pair: (1024, 10004)."""
    from pymc_tpu_torch.models import STRESS_SAMPLE_KWARGS, stress_glm_model

    return (STRESS_SAMPLE_KWARGS["chains"], stress_glm_model().raveled_info().total_size)


def check_kernels(card):
    """Phase 3: each kernel against its plain version on the card, then
    both timed. Returns (max abs errors over the sampled models' shapes in
    float32, {shape: median ms})."""
    from pymc_tpu_torch.ops import leapfrog as lf

    phase("3 kernels against their plain versions")
    path = sampled_shapes() + [stress_shape()]
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
    for C, D in TIMED_SHAPES + [stress_shape()]:
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
        for key, (b_ms, b_by) in pair_bounds(C, D).items():
            print(f"({C}, {D}) float32 {key}: {times[(C, D)][key]:.5f} ms against a bound of "
                  f"{b_ms:.7f} ms ({b_by})  [{card}]")
    return errs, times


def pair_bounds(C, D):
    """{kernel: (bound ms, by)} of the pair at (C, D) in float32: kick_drift
    reads q, p, grad, inv_mass and eps and writes q' and p_half; final_kick
    reads p_half, grad, inv_mass and eps and writes p' and ke."""
    return {
        "kick_drift": bound_ms(6 * C * D * 4 + 4 * C, 6 * C * D, torch.float32),
        "final_kick": bound_ms(4 * C * D * 4 + 8 * C, 6 * C * D + C, torch.float32),
    }


LEAF_SLOTS = 10  # checkpoint slots: n < 2**10 writes and reads all ten
LEAF_TIE = 1e-5  # float32: margins this close (relative) may flip a decision


def leaf_state(C, D, dtype, seed):
    """A SubtreeState on the card mid-subtree, and the leaf's (logp, grad,
    u): row c sits at leaf n = (389 c + seed) mod 1024 (every n once at C =
    1024) with every checkpoint slot filled; about 1/8 of the rows are not
    in the subtree, 1/16 already turned, 1/16 already diverged; of the
    stepping rows 1/32 get logp -inf, 1/32 NaN, 1/32 an energy error above
    1000, and 1/8 an energy error near -3 (they take the proposal)."""
    from pymc_tpu_torch.ops import leapfrog as lf

    g = torch.Generator(device="cuda").manual_seed(seed)
    rng = np.random.default_rng(seed)

    def randn(*shape, scale=1.0):
        return scale * torch.randn(*shape, generator=g, device="cuda", dtype=dtype)

    def rows(frac):
        return torch.as_tensor(rng.random(C) < frac, device="cuda")

    n = (389 * np.arange(C) + seed) % 1024
    bits = np.array([int(x).bit_length() for x in n])
    depth = np.minimum(10, bits + rng.integers(0, 3, C))
    inv_mass = 0.5 + torch.rand(C, D, generator=g, device="cuda", dtype=dtype)
    sign = torch.where(torch.rand(C, generator=g, device="cuda") < 0.5, -1.0, 1.0)
    eps = (0.05 + 0.25 * torch.rand(C, generator=g, device="cuda", dtype=dtype)) * sign.to(dtype)
    s = lf.SubtreeState(
        randn(C, D), randn(C, D), randn(C, D), randn(C, scale=10.0), randn(C), inv_mass, eps,
        ~rows(1 / 8), torch.as_tensor(depth, dtype=torch.int32, device="cuda"), LEAF_SLOTS,
    )
    s.n.copy_(torch.as_tensor(n, dtype=torch.int32, device="cuda"))
    for name in ("q", "p", "grad", "prop_q", "prop_p", "prop_grad", "q_half", "p_half",
                 "p_ckpt", "psum_ckpt"):
        getattr(s, name).copy_(randn(*getattr(s, name).shape))
    s.p_sum.copy_(randn(C, D, scale=3.0))
    for name in ("logp", "prop_logp", "prop_energy"):
        getattr(s, name).copy_(randn(C, scale=10.0))
    s.log_size.copy_(torch.where(s.n == 0, -torch.inf, randn(C, scale=2.0)))
    s.sum_accept.copy_(torch.rand(C, generator=g, device="cuda", dtype=dtype) * s.n)
    s.max_eerr.copy_(randn(C))
    s.turning.copy_(rows(1 / 16))
    s.diverging.copy_(rows(1 / 16))
    s.act.copy_(s.active0 & (s.n < s.n_target) & ~s.turning & ~s.diverging)

    logp = randn(C, scale=10.0)
    grad = randn(C, D)
    u = torch.rand(C, generator=g, device="cuda", dtype=dtype)
    ke = lf.final_kick_plain(s.p_half, grad, s.inv_mass, s.eps)[1]
    noise = torch.where(rows(1 / 8), -3.0, randn(C, scale=1.5))
    s.h0.copy_(-logp + ke - noise - torch.where(rows(1 / 32), 2000.0, 0.0))
    logp = torch.where(rows(1 / 32), -torch.inf, logp)
    logp = torch.where(rows(1 / 32), torch.nan, logp)
    return s, logp, grad, u


def leaf_flags(s, logp, grad, u):
    """Each row's decisions at this leaf, from the plain arithmetic in
    float64: act, take, write_ckpt, add_psum, check_turn, the number of
    U-turn slots checked, and near_tie: a margin of log u against log_w -
    log_size_new, or of a U-turn dot against 0, within LEAF_TIE of the
    magnitudes that enter it."""
    from pymc_tpu_torch.ops import leapfrog as lf

    f8 = torch.float64
    im, e, act = s.inv_mass.to(f8), s.eps.to(f8), s.act
    p = s.p_half.to(f8) + 0.5 * e[:, None] * grad.to(f8)
    ke = 0.5 * torch.sum(p * im * p, dim=-1)
    lp, h0, log_size = logp.to(f8), s.h0.to(f8), s.log_size.to(f8)
    eerr = (-lp + ke) - h0
    ok = torch.isfinite(eerr)
    div = act & (~ok | (eerr > lf.MAX_ENERGY_ERROR))
    log_w = torch.where(ok, -eerr, -torch.inf)
    lsn = torch.logaddexp(log_size, log_w)
    lhs, rhs = torch.log(u.to(f8)), log_w - lsn
    take = act & ~div & (lhs < rhs)

    def mag(x):
        return torch.where(torch.isfinite(x), x.abs(), 0.0)

    scale = mag(lp) + ke + mag(h0) + mag(log_size) + mag(lhs)
    tie = act & ~div & torch.isfinite(rhs) & ((lhs - rhs).abs() <= LEAF_TIE * scale)

    n = s.n.long()
    pc = lf.popcount(s.n).long()
    t_ones = lf.popcount(s.n ^ (s.n + 1)).long() - 1
    S = s.p_ckpt.shape[1]
    slots = torch.arange(S, device="cuda")
    in_range = (slots[None, :] >= (pc - t_ones)[:, None]) & (slots[None, :] <= (pc - 1)[:, None])
    is_even = (n & 1) == 0
    check_turn = act & ~is_even & ~div
    rho = (s.p_sum.to(f8) + p)[:, None, :] - s.psum_ckpt.to(f8)
    ds_terms = im[:, None, :] * s.p_ckpt.to(f8) * rho
    dl_terms = rho * (im * p)[:, None, :]
    near0 = (ds_terms.sum(-1).abs() <= LEAF_TIE * ds_terms.abs().sum(-1)) | (
        dl_terms.sum(-1).abs() <= LEAF_TIE * dl_terms.abs().sum(-1)
    )
    tie |= check_turn & (in_range & near0).any(-1)
    eerr_safe = torch.where(ok, eerr, torch.inf)
    bigger = act & (eerr_safe.abs() > s.max_eerr.to(f8).abs())
    return {
        "act": act, "take": take, "write_ckpt": act & is_even & (pc < S), "bigger": bigger,
        "add_psum": act & ~div, "check_turn": check_turn,
        "n_slots": torch.where(check_turn, in_range.sum(-1), 0), "near_tie": tie,
        "scale": scale,
    }


def leaf_bound(s, flags):
    """(bound ms, by) of one leaf on this state, counting per row what the
    leaf needs. A row that steps reads p_half, grad', q_half and inv_mass,
    p_sum where it adds to it or checkpoints it, and two checkpoint rows per
    U-turn slot; it writes q, p, grad, the proposal where it takes it, p_sum
    where it adds to it, two checkpoint rows at even n, and the next q_half,
    p_half. A row that does not step reads q, p, grad and inv_mass and
    writes the next q_half, p_half. Scalars at their sizes: a stepping row
    reads eps, h0, logp', log_size, max_eerr, sum_accept and u, act,
    turning, diverging, active0, n and n_target, and writes n, logp,
    sum_accept, diverging and act, turning where it checks a U-turn,
    log_size where it adds, max_eerr where it grows, prop_logp and
    prop_energy where it takes; a row that does not step reads eps and act
    (its act stays false)."""
    C, D = s.q.shape
    size = s.q.element_size()
    f = {k: v.long() for k, v in flags.items() if k not in ("near_tie", "scale")}
    act, rest = f["act"], 1 - f["act"]
    rows = (act * (4 + (f["add_psum"] | f["write_ckpt"]) + 2 * f["n_slots"] + 3
                   + 3 * f["take"] + f["add_psum"] + 2 * f["write_ckpt"])
            + rest * 4 + 2)
    scalars = (act * ((7 + 2 + f["add_psum"] + f["bigger"] + 2 * f["take"]) * size
                      + 4 + 2 * 4 + 4 + 2 + f["check_turn"])
               + rest * (size + 1))
    n_bytes = int(rows.sum()) * D * size + int(scalars.sum()) + 8  # + the count
    n_ops = int((act * (11 + 6 * f["n_slots"]) + rest * 5).sum()) * D
    return bound_ms(n_bytes, n_ops, s.q.dtype)


LEAF_INTS = ("n", "turning", "diverging", "act")
LEAF_ROWS = ("q", "p", "grad", "prop_q", "prop_p", "prop_grad", "p_sum", "q_half", "p_half",
             "logp", "prop_logp")
LEAF_ENERGY = ("prop_energy", "log_size", "sum_accept", "max_eerr")


def check_leaf_close(label, out, ref, rtol, scale=None):
    """check_close where non-finite values must match exactly (NaN to NaN,
    inf to inf of one sign); `scale` (per row) adds to the tolerance."""
    fin = torch.isfinite(ref)
    same = (out == ref) | (torch.isnan(out) & torch.isnan(ref))
    if bool((~fin & ~same).any()) or bool((fin & ~torch.isfinite(out)).any()):
        raise AssertionError(f"{label}: non-finite values differ")
    if not bool(fin.any()):
        return 0.0
    o, r = out.double()[fin], ref.double()[fin]
    err = (o - r).abs()
    bound = rtol * (r.abs() + r.abs().max())
    if scale is not None:
        bound = bound + rtol * scale.expand_as(fin)[fin]
    if bool((err > bound).any()):
        raise AssertionError(f"{label}: max abs err {float(err.max()):.3e} exceeds rtol {rtol:g}")
    return float(err.max())


def compare_leaf(tag, sk, sp, keep, scale, k):
    """The kernel's state sk against the plain version's sp after leaf k,
    on the rows `keep`; returns the max abs error of the float buffers."""
    dtype = sk.q.dtype
    for name in LEAF_INTS:
        a, b = getattr(sk, name)[keep], getattr(sp, name)[keep]
        if not bool((a == b).all()):
            raise AssertionError(f"nuts_leaf {name} {tag}: {int((a != b).sum())} rows differ")
    count = int(sk.count[k & 1])
    if count != int(sk.act.sum()) or int(sk.count[(k + 1) & 1]) != 0:
        raise AssertionError(f"nuts_leaf count {tag}: {sk.count.tolist()} with "
                             f"{int(sk.act.sum())} active rows after leaf {k}")
    if bool(keep.all()) and count != int(sp.count[k & 1]):
        raise AssertionError(f"nuts_leaf count {tag}: {count} != plain {int(sp.count[k & 1])}")
    err = 0.0
    for name in LEAF_ROWS + ("p_ckpt", "psum_ckpt"):
        err = max(err, check_leaf_close(f"nuts_leaf {name} {tag}", getattr(sk, name)[keep],
                                        getattr(sp, name)[keep], RTOL[dtype]))
    for name in LEAF_ENERGY:
        err = max(err, check_leaf_close(f"nuts_leaf {name} {tag}", getattr(sk, name)[keep],
                                        getattr(sp, name)[keep], RTOL_KE[dtype],
                                        scale=scale[keep]))
    return err


def replaced_sequence(s, logp, grad, u):
    """The leaf as the sampler ran it before the fused kernel: the plain
    leaf with its final kick and kick-drift on the two leapfrog kernels (on
    the card their wrappers launch the kernels and never reach the plain
    versions patched here)."""
    from pymc_tpu_torch.ops import leapfrog as lf

    if not s.q.is_cuda:
        raise ValueError("replaced_sequence: the state must lie on the card")
    plain = lf.final_kick_plain, lf.kick_drift_plain
    lf.final_kick_plain, lf.kick_drift_plain = lf.leapfrog_final_kick, lf.leapfrog_kick_drift
    try:
        return lf.nuts_leaf_step_plain(s, logp, grad, u)
    finally:
        lf.final_kick_plain, lf.kick_drift_plain = plain


def check_leaf(card):
    """Phase 3, the fused leaf: nuts_leaf_step against nuts_leaf_step_plain
    on the card, two leaves from each state, every call one launch; then
    timed at LEAF_TIMED in float32 against the plain leaf and against the
    sequence it replaced in the sampler. Returns (max abs error over the
    sampled models' shapes in float32, {name: (device ms, host ms)} at
    (64, 175), bound (ms, by) at (64, 175))."""
    from pymc_tpu_torch.ops import leapfrog as lf

    phase("3 nuts_leaf kernel against its plain version")
    path = sampled_shapes()
    err_path = 0.0
    for dtype in (torch.float32, torch.float64):
        for C, D in path + EDGE_SHAPES:
            sk, logp, grad, u = leaf_state(C, D, dtype, seed=C + D)
            sp = sk.clone()
            keep = torch.ones(C, dtype=torch.bool, device="cuda")
            ties, err = 0, 0.0
            covered = {k: 0 for k in ("take", "write_ckpt", "check_turn")}
            g = torch.Generator(device="cuda").manual_seed(C + D + 1)
            for k in range(2):
                flags = leaf_flags(sk, logp, grad, u)
                for key in covered:
                    covered[key] += int(flags[key].sum())
                tie = flags["near_tie"] & keep
                ties += int(tie.sum())
                if dtype == torch.float32:
                    keep &= ~tie
                before = lf.nuts_leaf_step.launches
                lf.nuts_leaf_step(sk, logp, grad, u)
                if lf.nuts_leaf_step.launches != before + 1:
                    raise AssertionError(f"nuts_leaf_step at ({C}, {D}) launched no kernel")
                lf.nuts_leaf_step_plain(sp, logp, grad, u)
                torch.cuda.synchronize()
                tag = f"({C}, {D}) {dtype} leaf {k}"
                err = max(err, compare_leaf(tag, sk, sp, keep, flags["scale"], k))
                # the next leaf: fresh gradients at the new points
                grad = torch.randn(grad.shape, generator=g, device="cuda", dtype=dtype)
                u = torch.rand(u.shape, generator=g, device="cuda", dtype=dtype)
            held = "left out" if dtype == torch.float32 else "held to equality"
            print(f"({C}, {D}) {dtype}: nuts_leaf max abs err {err:.3e}; near-ties {ties} "
                  f"({held}); rows taking {covered['take']}, writing a "
                  f"checkpoint {covered['write_ckpt']}, checking U-turns {covered['check_turn']}")
            if (C, D) in path and dtype == torch.float32:
                err_path = max(err_path, err)
    times, bound = {}, None
    for C, D in TIMED_SHAPES:
        pristine, logp, grad, u = leaf_state(C, D, torch.float32, seed=1)
        b_ms, b_by = leaf_bound(pristine, leaf_flags(pristine, logp, grad, u))
        work = {k: pristine.clone() for k in ("kernel", "plain", "sequence")}

        def restore(s):
            return lambda: [getattr(s, f).copy_(getattr(pristine, f)) for f in s.BUFFERS]

        calls = {
            "nuts_leaf": (lambda: lf.nuts_leaf_step(work["kernel"], logp, grad, u),
                          restore(work["kernel"])),
            "nuts_leaf_plain": (lambda: lf.nuts_leaf_step_plain(work["plain"], logp, grad, u),
                                restore(work["plain"])),
            "sequence": (lambda: replaced_sequence(work["sequence"], logp, grad, u),
                         restore(work["sequence"])),
        }
        order = list(calls)
        measured = {k: [] for k in calls}
        for k in order + order[::-1]:
            measured[k].append(cuda_ms(calls[k][0], setup=calls[k][1]))
        times[(C, D)] = {k: (min(m[0] for m in v), min(m[1] for m in v))
                         for k, v in measured.items()}
        for k, v in measured.items():
            print(f"({C}, {D}) float32 {k}: device ms "
                  f"{', '.join(f'{m[0]:.5f}' for m in v)}; host ms per call "
                  f"{', '.join(f'{m[1]:.5f}' for m in v)}  [{card}]")
        print(f"({C}, {D}) float32 nuts_leaf bound {b_ms:.7f} ms ({b_by})  [{card}]")
        if bound is None:
            bound = (b_ms, b_by)
    return err_path, times[TIMED_SHAPES[0]], bound


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
    error at (64, 150) float32, {(C, n): {name: median ms}})."""
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
    for C, n in CHOL_TIMED + CHOL_TIMED_GP:
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
    times["backward"] = chol_backward_times(card, *CHOL_TIMED[0])
    return err_main, times


def chol_backward_bound(C, n):
    """Bound of a factorisation and its backward in float32: the forward's
    bytes and C n^3 / 3 multiply-adds, then L and the cotangent read and
    the (C, n, n) gradient written, and the backward's C (n^3 + 2 n^3)
    multiply-adds (L^T Lbar, two triangular solves)."""
    fwd_bytes = C * (n * (n + 1) // 2 + n * n) * 4
    return bound_ms(fwd_bytes + 3 * C * n * n * 4, C * (n**3 / 3 + 3 * n**3), torch.float32)


def chol_backward_times(card, C, n):
    """A logp+grad's Cholesky, forward and backward, at (C, n) in float32:
    the kernel with its backward rule against cholesky_ex with torch's.
    Returns {name: device ms}."""
    from pymc_tpu_torch.ops import linalg as la

    A = spd_stack(C, n, torch.float32, seed=1).requires_grad_()
    G = torch.randn(A.shape, generator=torch.Generator(device="cuda").manual_seed(2),
                    device="cuda")
    calls = {
        "kernel": lambda: torch.autograd.grad(la.cholesky_batched(A), A, G),
        "library": lambda: torch.autograd.grad(torch.linalg.cholesky_ex(A)[0], A, G),
    }
    measured = {k: [] for k in calls}
    for k in list(calls) + list(calls)[::-1]:
        measured[k].append(cuda_ms(calls[k]))
    out = {k: min(m[0] for m in v) for k, v in measured.items()}
    b_ms, b_by = chol_backward_bound(C, n)
    print(f"({C}, {n}) float32 cholesky forward and backward: kernel {out['kernel']:.5f} ms, "
          f"cholesky_ex {out['library']:.5f} ms, bound {b_ms:.7f} ms ({b_by})  [{card}]")
    return out


def check_logp_on_card(label, model, chains=64):
    """(C, D) -> (logp, grad) at `chains` points, float32 on the card
    against float64 on the CPU: logp max relative error < 1e-4, grad max
    abs error < 1e-3 of the largest gradient entry."""
    D = model.raveled_info().total_size
    q_np = np.random.default_rng(0).normal(0.0, 0.5, size=(chains, D))
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
    """Phase 4: the radon GLM's, the marginal GP's, the stress GLM's and the
    two mixture models' logp/grad on the card, and SMC's tempered
    density."""
    import pymc_tpu_torch as pm
    from pymc_tpu_torch.models import (
        gp_marginal_model, mixture_model, smc_mixture_model, stress_glm_model,
    )

    phase("4 logp/grad on the card")
    check_logp_on_card("radon", bench_module().build_model(pm))
    check_logp_on_card("GP marginal (n = 150)", gp_marginal_model(150))
    C, _ = stress_shape()
    check_logp_on_card(f"stress GLM ({C} chains)", stress_glm_model(), chains=C)
    check_logp_on_card("SMC mixture (config #5)", smc_mixture_model())
    check_logp_on_card("mixture (case_mixture)", mixture_model())
    check_smc_density()


def check_smc_density():
    """SMC's (prior, likelihood) logps on the card in float32 against the
    CPU in float64, at as many points as one run has particles: points of
    the unconstrained space (every one valid) and the card's prior draws,
    of which those whose mu came out ascending are valid (the others have
    no ordered value). A valid point must get a finite prior logp: the
    float32 sum of w must stay within Dirichlet's and Mixture's 1e-6 of
    1."""
    from pymc_tpu_torch.models import SMC_SAMPLE_KWARGS, smc_mixture_model
    from pymc_tpu_torch.smc.sampling import prior_particles, tempered_density

    model = smc_mixture_model()
    n = SMC_SAMPLE_KWARGS["draws"] * SMC_SAMPLE_KWARGS["chains"]
    on_card = tempered_density(model, "cuda", torch.float32)
    on_cpu = tempered_density(model, "cpu", torch.float64)
    gen = torch.Generator(device="cuda").manual_seed(0)
    q_prior = prior_particles(model, n, gen, "cuda", torch.float32)
    q_free = torch.as_tensor(np.random.default_rng(0).normal(0.0, 2.0, size=(n, 3)),
                             device="cuda", dtype=torch.float32)
    for label, q in (("unconstrained points", q_free), ("prior draws", q_prior)):
        prior_c, like_c = (x.double().cpu() for x in on_card(q))
        prior_r, like_r = on_cpu(q.double().cpu())
        valid = torch.isfinite(prior_r)
        if q is q_free and not bool(valid.all()):
            raise AssertionError("SMC prior logp is not finite at every unconstrained point")
        bad = int((valid & ~torch.isfinite(prior_c)).sum())
        err = max(float(((a - b).abs() / (b.abs() + 1.0))[valid].max())
                  for a, b in ((prior_c, prior_r), (like_c, like_r)))
        print(f"SMC tempered density, {label}: {int(valid.sum())} of {n} valid, "
              f"{bad} with a non-finite prior logp on the card; max rel err {err:.3e} "
              f"(tol 1e-4)")
        if bad or not err < 1e-4 or not bool(torch.isfinite(like_c[valid]).all()):
            raise AssertionError(f"SMC tempered density on the card disagrees ({label})")


def counted(call):
    """call() with every kernel's launch count set to 0 just before and read
    just after; returns (its result, {kernel: launches})."""
    from pymc_tpu_torch.ops import leapfrog as lf
    from pymc_tpu_torch.ops import linalg as la

    wrappers = {
        "kick_drift": lf.leapfrog_kick_drift,
        "final_kick": lf.leapfrog_final_kick,
        "nuts_leaf": lf.nuts_leaf_step,
        "cholesky": la.cholesky_batched,
    }
    for w in wrappers.values():
        w.launches = 0
    out = call()
    return out, {k: w.launches for k, w in wrappers.items()}


def sample_counted(model, config, sampler=None):
    """`sampler` (default pm.sample) on the card, counted; returns (idata,
    {kernel: launches})."""
    import pymc_tpu_torch as pm

    return counted(lambda: (sampler or pm.sample)(
        model=model, device="cuda", compute_convergence_checks=False, **config
    ))


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


def check_launch_identities(label, attrs, launches):
    """Each NUTS leapfrog is one nuts_leaf launch; each leapfrog of the
    step-size search one final_kick and one kick_drift launch; each subtree
    starts with one kick_drift launch."""
    search, subtrees = attrs["n_step_search"], attrs["n_subtrees"]
    nuts_leapfrogs = attrs["n_leapfrog"] - search
    expect = {"nuts_leaf": nuts_leapfrogs, "final_kick": search,
              "kick_drift": search + subtrees}
    print(f"{label}: NUTS leapfrogs {nuts_leapfrogs}, step-size search leapfrogs {search}, "
          f"subtrees {subtrees}; launches {launches}")
    if not (nuts_leapfrogs > 0 and all(launches[k] == v for k, v in expect.items())):
        raise AssertionError(f"{label} launches {launches} != expected {expect}")


def check_posterior(idata, launches, max_rhat):
    """Phase 5 checks: kernels carried every leapfrog, convergence, finite
    draws, posterior means against the pymc_tpu reference."""
    from pymc_tpu_torch.models import RADON_SAMPLE_KWARGS
    from pymc_tpu_torch.stats.convergence import mcse_mean

    post = idata.posterior
    check_launch_identities("radon", post.attrs, launches)
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
    ({kernel: launches}, idata)."""
    from pymc_tpu_torch.models import GP_SCALARS, GP_SMOKE_KWARGS, gp_marginal_model
    from pymc_tpu_torch.stats.convergence import ess, grad_evals_per_sec, mcse_mean, rhat

    phase("6 GP marginal sampling")
    idata, launches = sample_counted(gp_marginal_model(150), GP_SMOKE_KWARGS)
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
    check_launch_identities("GP", post.attrs, launches)
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
    return launches, idata


def run_stress(card):
    """Phase 7: sample the stress GLM with ChEES on the card and check it;
    returns {kernel: launches}."""
    from pymc_tpu_torch.models import STRESS_HYPERS, STRESS_SAMPLE_KWARGS, stress_glm_model
    from pymc_tpu_torch.stats.convergence import (
        ess, grad_evals_per_sec, mcse_mean, rhat, time_to_rhat,
    )

    phase("7 stress GLM sampling with ChEES")
    model = stress_glm_model()
    torch.cuda.reset_peak_memory_stats()
    idata, launches = sample_counted(model, STRESS_SAMPLE_KWARGS)
    peak = torch.cuda.max_memory_allocated()
    post, stats, attrs = idata.posterior, idata.sample_stats, idata.posterior.attrs
    chains, draws = STRESS_SAMPLE_KWARGS["chains"], STRESS_SAMPLE_KWARGS["draws"]
    wall = attrs["sampling_time"]
    n_steps = stats["n_steps"].values
    search = attrs["n_step_search"]
    # every leapfrog of the run: the step-size search's and L per draw, tuning
    # included; of these the sampling draws' L are in n_steps
    leapfrogs = attrs["n_leapfrog"]
    tune_leapfrogs = leapfrogs - search - int(n_steps[0].sum())
    ess_min = min(float(np.nanmin(ess(post[n].values))) for n in STRESS_HYPERS)
    rhats = {n: float(np.nanmax(rhat(post[n].values))) for n in STRESS_HYPERS}
    t_rhat = time_to_rhat(idata, var_names=list(STRESS_HYPERS))
    mean_L = (leapfrogs - search) / (STRESS_SAMPLE_KWARGS["tune"] + draws)
    print(f"min-ESS/s {ess_min / wall:.3f} (min ESS {ess_min:.1f}); grad-evals/s "
          f"{grad_evals_per_sec(idata):.1f}; time to R-hat < 1.01 {t_rhat:.2f} s; sampling "
          f"wall {wall:.2f} s; tuning wall {attrs['tuning_time']:.2f} s  [{card}]")
    print(f"mean L {mean_L:.2f} over tuning and sampling, {float(n_steps.mean()):.2f} while "
          f"drawing (min {int(n_steps.min())}, max {int(n_steps.max())}); final trajectory "
          f"length {attrs['trajectory_length']:.5f}; step size "
          f"{float(stats['step_size'].values[0, 0]):.5f}; mean acceptance "
          f"{float(stats['acceptance_rate'].values.mean()):.4f}; divergences "
          f"{int(stats['diverging'].values.sum())}  [{card}]")
    print(f"host syncs while drawing {attrs['sampling_host_syncs']} "
          f"({attrs['sampling_host_syncs'] / draws:.2f} per draw); peak device memory "
          f"{peak / 2**30:.3f} GiB ({peak} B); R-hat "
          + ", ".join(f"{n} {r:.4f} (< {STRESS_RHAT_LIMIT[n]})" for n, r in rhats.items())
          + f"  [{card}]")
    print(f"stress: leapfrogs {leapfrogs} = step-size search {search} + tuning "
          f"{tune_leapfrogs} + sampling {int(n_steps[0].sum())}; logp+grad calls "
          f"{attrs['n_logp_grad']}; launches {launches}")
    expect = {"kick_drift": leapfrogs, "final_kick": leapfrogs, "nuts_leaf": 0, "cholesky": 0}
    if not (tune_leapfrogs >= STRESS_SAMPLE_KWARGS["tune"] and launches == expect
            and (n_steps == n_steps[:1]).all()):
        raise AssertionError(f"stress launches {launches} != expected {expect}")
    if sorted(post.keys()) != sorted(STRESS_HYPERS):
        raise AssertionError(f"stress posterior holds {sorted(post.keys())}")
    for name in STRESS_HYPERS:
        if post[name].shape != (chains, draws):
            raise AssertionError(f"{name} has shape {post[name].shape}")
        if not np.isfinite(post[name].values).all():
            raise AssertionError(f"non-finite draws in {name}")
    with open(STRESS_REFERENCE) as f:
        ref = json.load(f)["params"]
    for name in STRESS_HYPERS:
        x = post[name].values.astype(np.float64)
        se = float(np.hypot(mcse_mean(x), ref[name]["mcse"]))
        z = (float(x.mean()) - ref[name]["mean"]) / se
        print(f"{name}: mean {float(x.mean()):.5f} (reference {ref[name]['mean']:.5f}), "
              f"{z:+.2f} combined MCSE; R-hat {float(rhat(x)):.4f}; bulk ESS "
              f"{float(ess(x)):.1f} ({float(ess(x)) / chains:.2f} per chain)")
        if not abs(z) <= 5.0:
            raise AssertionError(f"stress {name} posterior mean is {z:+.2f} MCSE off the reference")
    for name, r in rhats.items():
        if not r < STRESS_RHAT_LIMIT[name]:
            raise AssertionError(f"stress {name} R-hat {r:.4f} >= {STRESS_RHAT_LIMIT[name]}")
    return launches


def run_smc_once(model, config, card):
    """One sample_smc run on the card, counted and checked: every chain at
    beta = 1, every particle finite, one Cholesky launch a stage and no
    other kernel. Returns (idata, {kernel: launches}, wall s)."""
    import pymc_tpu_torch as pm

    t0 = time.perf_counter()
    idata, launches = sample_counted(model, dict(config, progressbar=False), pm.sample_smc)
    wall = time.perf_counter() - t0
    attrs, stats = idata.posterior.attrs, idata.sample_stats
    stages = attrs["n_stages"]
    sweeps = np.array(attrs["n_steps_history"])
    label = f"SMC {attrs['kernel']} seed {config['random_seed']}"
    print(f"{label}: wall {wall:.3f} s (stage loop {attrs['sampling_time']:.3f} s); "
          f"{stages} stages; sweeps a stage (max over chains) "
          f"{sweeps.max(axis=1).tolist()}, mean {float(sweeps.mean()):.2f}; final acceptance "
          f"{np.round(stats['accept_rate'].values[:, 0], 4).tolist()}, mean over stages "
          f"{float(np.mean(attrs['accept_rate_history'])):.4f}; host reads "
          f"{attrs['sampling_host_syncs']} ({attrs['sampling_host_syncs'] / stages:.2f} a stage); "
          f"log marginal likelihood "
          f"{np.round(stats['log_marginal_likelihood'].values[:, 0], 4).tolist()}; "
          f"launches {launches}  [{card}]")
    expect = {"kick_drift": 0, "final_kick": 0, "nuts_leaf": 0, "cholesky": stages}
    if launches != expect:
        raise AssertionError(f"{label}: launches {launches} != expected {expect}")
    if not (stats["beta"].values == 1.0).all():
        raise AssertionError(f"{label}: chains short of beta = 1: {stats['beta'].values[:, 0]}")
    for name in ("mu", "w"):
        if not np.isfinite(idata.posterior[name].values).all():
            raise AssertionError(f"{label}: non-finite particles in {name}")
    if attrs["device"] != "cuda":
        raise AssertionError(f"{label} ran on {attrs['device']}")
    return idata, launches, wall


def smc_z(label, name, ours, ref):
    """Combined-standard-error distance of a mean over chains from the
    fixture's, printed; fails beyond SMC_Z."""
    ours = np.asarray(ours, dtype=np.float64)
    se = float(np.hypot(ours.std(ddof=1) / np.sqrt(len(ours)), ref["se"]))
    z = (float(ours.mean()) - ref["mean"]) / se
    print(f"{label} {name}: mean {ours.mean():.6f} over {len(ours)} chains (reference "
          f"{ref['mean']:.6f}), {z:+.2f} combined standard errors")
    if not abs(z) <= SMC_Z:
        raise AssertionError(f"{label} {name} is {z:+.2f} standard errors off the reference")


def smc_kernels_per_sweep(card):
    """Kernels of one IMH sweep and of the rest of a stage: one stage from
    the prior with the loop capped at 1 and at 2 sweeps (the Pearson rule
    never stops a chain after its first sweep), same state and draws, each
    profiled; the difference is one sweep with its host read."""
    from torch.profiler import ProfilerActivity, profile

    from pymc_tpu_torch.models import SMC_SAMPLE_KWARGS, smc_mixture_model
    from pymc_tpu_torch.sampling.chees import HostReads
    from pymc_tpu_torch.smc import kernels as sk
    from pymc_tpu_torch.smc.sampling import prior_particles, tempered_density

    model = smc_mixture_model()
    C, N = SMC_SAMPLE_KWARGS["chains"], SMC_SAMPLE_KWARGS["draws"]
    fn = tempered_density(model, "cuda", torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = sk.smc_init(prior_particles(model, C * N, gen, "cuda", torch.float32)
                        .reshape(C, N, -1), fn)
    kernels = {}
    for steps in (1, 2, 1, 2):
        draws = sk.TorchSMCDraws(torch.Generator(device="cuda").manual_seed(1), torch.float32,
                                 torch.device("cuda"))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            out = sk.smc_stage(sk.IMH(max_steps=steps), fn, state, draws, HostReads())
            torch.cuda.synchronize()
        if not bool((out.n_steps == steps).all()):
            raise AssertionError(f"SMC profile: {out.n_steps.tolist()} sweeps, not {steps}")
        kernels[steps] = sum(e.count for e in prof.key_averages()
                             if e.device_type == torch.autograd.DeviceType.CUDA)
    sweep = kernels[2] - kernels[1]
    print(f"SMC kernels: one IMH sweep {sweep} (with its host read), the rest of a stage "
          f"{kernels[1] - sweep} (the beta bisection, resample, covariance and Cholesky); "
          f"stage capped at 1 sweep {kernels[1]}, at 2 {kernels[2]}  [{card}]")
    return sweep


def run_smc(card):
    """Phase 8: sample_smc on config #5 at SMC_SEEDS with IMH and at seed 0
    with MH, checked against the pymc_tpu fixture; returns {kernel:
    launches} summed over the runs."""
    from pymc_tpu_torch.models import (
        SMC_SAMPLE_KWARGS, SMC_SEEDS, smc_chain_estimates, smc_mixture_model,
    )

    phase("8 SMC on the bimodal mixture (config #5)")
    with open(SMC_REFERENCE) as f:
        ref = json.load(f)["params"]
    model = smc_mixture_model()
    total, chains, walls, lml = None, {}, [], []
    for seed in SMC_SEEDS:
        idata, launches, wall = run_smc_once(model, dict(SMC_SAMPLE_KWARGS, random_seed=seed),
                                             card)
        total = launches if total is None else {k: total[k] + launches[k] for k in total}
        walls.append(wall)
        for name, values in smc_chain_estimates(idata).items():
            chains.setdefault(name, []).extend(values.tolist())
    lml = np.array(chains["log_marginal_likelihood"])
    print(f"SMC IMH over seeds {list(SMC_SEEDS)}: wall a run {np.round(walls, 3).tolist()} s; "
          f"log marginal likelihood {lml.mean():.4f} (sd {lml.std(ddof=1):.4f}, min "
          f"{lml.min():.4f}, max {lml.max():.4f}) over {len(lml)} chains  [{card}]")
    for name, values in chains.items():
        smc_z("SMC IMH", name, values, ref[name])
    idata, launches, _ = run_smc_once(model, dict(SMC_SAMPLE_KWARGS, kernel="mh"), card)
    total = {k: total[k] + launches[k] for k in total}
    mh = smc_chain_estimates(idata)
    for name in ("mu[0]", "mu[1]"):
        smc_z("SMC MH", name, mh[name], ref[name])
    smc_kernels_per_sweep(card)
    return total


def gp_forms():
    """Phase 9a's model forms: [(label, model, Cholesky launches a
    logp+grad)]."""
    from pymc_tpu_torch import models

    J = GP_FORM_JITTER
    return [
        ("latent GP (n = 150)", models.gp_latent_model(150, jitter=J), 1),
        ("HSGP (n = 150, m = 32)", models.gp_hsgp_model(150, 32), 0),
        ("TP (n = 150, nu = 5)", models.gp_tp_model(150, jitter=J), 1),
        ("MarginalApprox VFE (20 inducing)", models.gp_approx_model("VFE", jitter=J), 2),
        ("MarginalApprox FITC (20 inducing)", models.gp_approx_model("FITC", jitter=J), 2),
        ("LatentKron (15 x 10 grid)", models.gp_kron_model("latent", jitter=J), 2),
        ("MarginalKron (15 x 10 grid)", models.gp_kron_model("marginal"), 0),
    ]


def check_gp_forms():
    """Phase 9a: each GP form's logp/grad on the card in float32 against the
    CPU in float64 at 64 points, and its Cholesky launches a logp+grad; then
    the latent GP at its float32 default jitter."""
    from pymc_tpu_torch.ops import linalg as la

    phase("9a GP forms: logp/grad on the card, Cholesky launches")
    for label, model, expect in gp_forms():
        la.cholesky_batched.launches = 0
        check_logp_on_card(label, model)  # one logp+grad on the card
        got = la.cholesky_batched.launches
        print(f"{label}: {got} Cholesky launches a logp+grad (expected {expect})")
        if got != expect:
            raise AssertionError(f"{label}: {got} Cholesky launches a logp+grad, not {expect}")
    check_latent_default_jitter()


def check_latent_default_jitter(chains=64):
    """The latent GP as it is sampled, float32 with its default prior jitter
    max(1e-4, F32_PRIOR_JITTER eta^2), against models.gp_latent_logp_plain
    in float64 with the same jitter: logp and grad at `chains` points
    (LATENT_LOGP_RTOL, LATENT_GRAD_RTOL of the largest entry), one Cholesky
    launch; and the card's factors of its prior covariance over lengthscales
    on [0.05, 50] and three amplitudes: none non-finite, and L L^T within
    LATENT_BACKWARD_TOL jitters of the float64 matrix in the 2-norm, so the
    float32 model's prior is the float64 one with the same jitter."""
    from pymc_tpu_torch import models
    from pymc_tpu_torch.gp.gp import F32_PRIOR_JITTER
    from pymc_tpu_torch.ops import linalg as la

    label = "latent GP (n = 150), default float32 jitter"
    model = models.gp_latent_model(150)
    D = model.raveled_info().total_size
    q = np.random.default_rng(0).normal(0.0, 0.5, size=(chains, D))
    la.cholesky_batched.launches = 0
    lp_c, g_c = model.logp_dlogp_fn(device="cuda")(
        torch.as_tensor(q, device="cuda", dtype=torch.float32))
    launches = la.cholesky_batched.launches
    lp_r, g_r = models.gp_latent_logp_plain(q, jitter_rel=F32_PRIOR_JITTER, jitter_min=1e-4)
    lp_c, g_c = lp_c.double().cpu(), g_c.double().cpu()
    lp_err = float(((lp_c - lp_r).abs() / lp_r.abs()).max())
    g_err = float((g_c - g_r).abs().max() / g_r.abs().max())
    _, X, _ = models.gp_data(150)
    x = torch.as_tensor(X[:, 0])
    ls = torch.as_tensor(np.geomspace(0.05, 50.0, 200))
    eta2 = torch.as_tensor([0.25, 5.5, 64.0])  # eta 0.5, near its posterior mean 2.35, 8
    A = eta2[:, None, None, None] * torch.exp(
        -0.5 * (x[:, None] - x[None, :]) ** 2 / ls[None, :, None, None] ** 2)
    jitter = torch.clamp_min(F32_PRIOR_JITTER * eta2, 1e-4)[:, None, None, None]
    A = (A + jitter * torch.eye(x.numel(), dtype=A.dtype)).reshape(-1, x.numel(), x.numel())
    L = la.cholesky_batched(A.to("cuda", torch.float32)).double()
    bad = int((~torch.isfinite(L).all(dim=(-2, -1))).sum())
    back = torch.linalg.matrix_norm(L @ L.mT - A.cuda(), ord=2).cpu().reshape(3, -1) / jitter[:, 0, 0]
    back = float(torch.nan_to_num(back, nan=float("inf")).max())
    print(f"{label}: logp max rel err {lp_err:.3e} (tol {LATENT_LOGP_RTOL}); grad max abs err "
          f"{g_err:.3e} of the largest entry (tol {LATENT_GRAD_RTOL}); {launches} Cholesky "
          f"launches a logp+grad (expected 1); prior factors at {A.shape[0]} (ls, eta): "
          f"{bad} non-finite, largest ||L L^T - A||_2 / jitter {back:.3f} (tol "
          f"{LATENT_BACKWARD_TOL})")
    if not (lp_err < LATENT_LOGP_RTOL and g_err < LATENT_GRAD_RTOL and launches == 1
            and bad == 0 and back < LATENT_BACKWARD_TOL):
        raise AssertionError(f"{label}: the card's float32 model is not the float64 one "
                             "with the same jitter")


def predictive_moments(gp, Xnew, post, chunk=1600, device="cpu", dtype=torch.float64):
    """Marginal.predict's (mean, variance) at Xnew with the noise, by
    default on the CPU in float64, at every draw of `post` (ls, eta,
    sigma): two (draws, points) float64 arrays."""
    from pymc_tpu_torch.models import GP_SCALARS

    fn = torch.func.vmap(gp.predict_fn(Xnew, diag=True, pred_noise=True, device=device,
                                       dtype=dtype))
    points = {k: torch.as_tensor(post[k].values.reshape(-1), dtype=dtype, device=device)
              for k in GP_SCALARS}
    N = next(iter(points.values())).shape[0]
    parts = [fn({k: v[i:i + chunk] for k, v in points.items()}) for i in range(0, N, chunk)]
    return tuple(torch.cat([p[j] for p in parts]).double().cpu().numpy() for j in (0, 1))


def run_gp_predictive(card, idata):
    """Phase 9b: sample_posterior_predictive of the conditional at
    GP_PRED_POINTS points on [0, 12] over phase 6's draws on the card, once
    for each seed of GP_PRED_SEEDS; returns {kernel: launches} summed over
    the runs."""
    import pymc_tpu_torch as pm
    from pymc_tpu_torch.models import gp_marginal_model

    phase("9b GP posterior predictive over phase 6's draws")
    model, gp = gp_marginal_model(150, return_gp=True)
    Xnew = np.linspace(0.0, 12.0, GP_PRED_POINTS)[:, None]
    with model:
        gp.conditional("f_pred", Xnew, pred_noise=True)
    t0 = time.perf_counter()
    mu, var = predictive_moments(gp, Xnew, idata.posterior)
    N = mu.shape[0]
    mean_ref = mu.mean(axis=0)
    var_ref = var.mean(axis=0) + mu.var(axis=0)
    # the draws' spread around the predictive means is the only Monte Carlo
    # noise: y_d = mu_d + e_d, e_d ~ N(0, var_d) independent
    se_mean = np.sqrt(var.mean(axis=0) / N)
    se_var = np.sqrt(4.0 * ((mu - mean_ref) ** 2 * var).sum(axis=0) + 2.0 * (var**2).sum(axis=0)) / N
    at = [0, int(np.abs(Xnew[:, 0] - 10.0).argmin()), GP_PRED_POINTS - 1]
    print(f"predict on the CPU in float64 over the {N} draws: {time.perf_counter() - t0:.1f} s; "
          f"at x = {Xnew[at, 0].round(3).tolist()} mean {mean_ref[at].round(4).tolist()}, "
          f"variance {var_ref[at].round(4).tolist()}")
    # the same predict on the card in float32: how far the card's means and
    # variances alone move the draws' moments
    mu_c, var_c = predictive_moments(gp, Xnew, idata.posterior, device="cuda",
                                     dtype=torch.float32)
    d_mean = (mu_c.mean(axis=0) - mean_ref) / se_mean
    d_var = (var_c.mean(axis=0) + mu_c.var(axis=0) - var_ref) / se_var
    print(f"predict on the card in float32: its mean of the means off the CPU's by at most "
          f"{np.abs(d_mean).max():.4f} standard errors (x = {Xnew[np.abs(d_mean).argmax(), 0]:.3f}), "
          f"its variance by {np.abs(d_var).max():.4f}")
    total = {}
    for seed in GP_PRED_SEEDS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        pp, launches = counted(lambda: pm.sample_posterior_predictive(
            idata, model=model, var_names=["f_pred"], random_seed=seed,
            return_inferencedata=False, device="cuda",
        ))
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        draws = pp["f_pred"].astype(np.float64)
        C, D = idata.posterior["ls"].shape
        y = draws.reshape(C * D, GP_PRED_POINTS)
        bad = int((~np.isfinite(y)).any(axis=1).sum())
        print(f"seed {seed}: {C * D} draws of f_pred at {GP_PRED_POINTS} points in {wall:.3f} s; "
              f"peak device memory {peak / 2**30:.3f} GiB ({peak} B); draws with a non-finite "
              f"value {bad}; launches {launches}  [{card}]")
        expect = {"kick_drift": 0, "final_kick": 0, "nuts_leaf": 0, "cholesky": 2}
        if draws.shape != (C, D, GP_PRED_POINTS) or bad or launches != expect:
            raise AssertionError(f"predictive: shape {draws.shape}, {bad} non-finite draws, "
                                 f"launches {launches} != {expect}")
        z_mean = (y.mean(axis=0) - mean_ref) / se_mean
        z_var = (y.var(axis=0) - var_ref) / se_var
        print(f"seed {seed}: max |z| of the draws' mean {np.abs(z_mean).max():.2f} (x = "
              f"{Xnew[np.abs(z_mean).argmax(), 0]:.3f}), of their variance "
              f"{np.abs(z_var).max():.2f} (x = {Xnew[np.abs(z_var).argmax(), 0]:.3f}); mean |z| "
              f"{np.abs(z_mean).mean():.2f} and {np.abs(z_var).mean():.2f}; z of the mean at x = "
              f"{Xnew[at[1], 0]:.3f} {z_mean[at[1]]:+.2f} (limit {GP_PRED_Z})")
        if not (np.abs(z_mean).max() <= GP_PRED_Z and np.abs(z_var).max() <= GP_PRED_Z):
            raise AssertionError("posterior predictive moments disagree with Marginal.predict")
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
    return total


def pair_records(launches, errs, times, shape):
    """The pair's records of the `kernels` line, timed at `shape`."""
    records = []
    for (key, (b_ms, b_by)), name, line in zip(
        pair_bounds(*shape).items(), ("leapfrog_kick_drift", "leapfrog_final_kick"), (97, 123),
    ):
        records.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE,
            "replaces": f"pymc_tpu/ops/pallas_kernels.py:{line}",
            "launches": launches[key], "max_abs_err": errs[key],
            "ms": times[shape][key], "plain_ms": times[shape][f"{key}_plain"],
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        })
    return records


def kernel_records(launches, errs, times, leaf, chol_err, chol_times):
    """The `kernels` line: every kernel with its launches on the main paths,
    error against its plain version, times and bound at the shape that
    launches it most: the pair at the stress GLM's (1024, 10004), the leaf
    at the radon GLM's (64, 175), the Cholesky at the GP's (64, 150)."""
    records = pair_records(launches, errs, times, stress_shape())
    leaf_err, leaf_times, (b_ms, b_by) = leaf
    records.append({
        "name": "nuts_leaf_step", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": "pymc_tpu/ops/pallas_kernels.py:123", "launches": launches["nuts_leaf"],
        "max_abs_err": leaf_err, "ms": leaf_times["nuts_leaf"][0],
        "plain_ms": leaf_times["nuts_leaf_plain"][0], "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
    })
    records.append(chol_record(launches, chol_err, chol_times, CHOL_TIMED[0]))
    return records


def chol_record(launches, chol_err, chol_times, shape):
    """The Cholesky's record of the `kernels` line, timed at `shape`."""
    b_ms, b_by = chol_bound(*shape)
    t = chol_times[shape]
    return {
        "name": "cholesky_batched", "route": "cuda", "source": CHOL_SOURCE,
        "replaces": "pymc_tpu/ops/linalg.py:137", "launches": launches["cholesky"],
        "max_abs_err": chol_err, "ms": t["kernel"], "plain_ms": t["plain"],
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": t["library"],
    }


def main():
    card, kind = check_device()
    build_kernels()
    errs, times = check_kernels(card)
    leaf = check_leaf(card)
    chol_err, chol_times = check_cholesky(card)
    check_logp()
    idata, launches, max_rhat = run_sampler(card)
    check_posterior(idata, launches, max_rhat)
    gp_launches, gp_idata = run_gp(card)
    stress_launches = run_stress(card)
    smc_launches = run_smc(card)
    check_gp_forms()
    paths = {"radon": launches, "GP": gp_launches, "stress": stress_launches,
             "SMC": smc_launches, "GP predictive": run_gp_predictive(card, gp_idata)}
    total = {k: sum(p[k] for p in paths.values()) for k in launches}
    kernels = kernel_records(total, errs, times, leaf, chol_err, chol_times)
    print("launches: " + "; ".join(f"{name} {p}" for name, p in paths.items()))
    print(f"total wall {time.perf_counter() - T_START:.1f} s")
    # the pair at the NUTS shape, where the kernels line held it until it
    # moved to the stress GLM's (1024, 10004); the Cholesky at SMC's stack
    print(f"pair at the radon GLM's {TIMED_SHAPES[0]}: "
          f"{json.dumps(pair_records(total, errs, times, TIMED_SHAPES[0]))}")
    print(f"cholesky at SMC's {CHOL_TIMED[-1]}: "
          f"{json.dumps(chol_record(total, chol_err, chol_times, CHOL_TIMED[-1]))}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
