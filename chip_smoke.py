"""Drive the PyTorch port (pymc_tpu_torch) on one CUDA card and check it.

Phases, in order; any failure ends the script with a non-zero exit:
  1. device   — require CUDA; print the card's name and power limit
  2. build    — build pymc_tpu_torch/csrc/leapfrog.cu and cholesky.cu with
                nvcc, one process each, started together; print ptxas's
                register and shared-memory report
  3. kernels  — each kernel against its plain PyTorch version on the card:
                the leapfrog pair at the (chains, D) of both sampled models
                and at edges of its range, in float32 and float64,
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
                shapes, the Cholesky at (64, 150), (1024, 150) and (8, 500)
                also against torch.linalg.cholesky_ex (the yardstick) and
                torch.linalg.cholesky
  4. logp     — the radon GLM's and the marginal GP's (C, D) -> (logp,
                grad) on the card in float32 against the port on the CPU
                in float64
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
                arguments (64 chains, tune 300, draws 300, pooled mass);
                the Cholesky kernel must factor the covariance stack of
                every batched logp+grad, the leapfrog kernels must carry
                their leapfrogs as in phase 5, R-hat must be < 1.05 and the
                means of ls,
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
        "nuts_leaf": lf.nuts_leaf_step,
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
    return launches


def kernel_records(launches, errs, times, leaf, chol_err, chol_times):
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
    leaf_err, leaf_times, (b_ms, b_by) = leaf
    records.append({
        "name": "nuts_leaf_step", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": "pymc_tpu/ops/pallas_kernels.py:123", "launches": launches["nuts_leaf"],
        "max_abs_err": leaf_err, "ms": leaf_times["nuts_leaf"][0],
        "plain_ms": leaf_times["nuts_leaf_plain"][0], "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None,
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
    leaf = check_leaf(card)
    chol_err, chol_times = check_cholesky(card)
    check_logp()
    idata, launches, max_rhat = run_sampler(card)
    check_posterior(idata, launches, max_rhat)
    gp_launches = run_gp(card)
    total = {k: launches[k] + gp_launches[k] for k in launches}
    kernels = kernel_records(total, errs, times, leaf, chol_err, chol_times)
    print(f"launches: radon {launches}; GP {gp_launches}")
    print(f"total wall {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({
        "ok": True,
        "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()},
    }))


if __name__ == "__main__":
    main()
