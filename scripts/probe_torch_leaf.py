"""Phase 3's fused NUTS leaf alone on one CUDA card, with the measurements
that chose the leaf kernel's design.

Builds csrc/leapfrog.cu, then checks and times the leaf as `chip_smoke.py`'s
phase 3 does (`chip_smoke.check_leaf`: mid-subtree and all-but-one-stopped
states against the plain leaf, one call at a time and back to back, beside
one load pass). Options:
  --sweep  builds the source once for each team, 2, 4 and 8 warps a chain
           row (nvcc -DPT_LEAF_WARPS=W, all started together), checks
           each against the plain leaf and times it at D from 32 to 4097
           (C = 64) and 32 to 1024 (C = 1024), in float32 and float64: the
           measurements behind the team tables kFewRows and kManyRows of
           csrc/leapfrog.cu
  --walls  then sample chip_smoke.py's phases 5 (the radon GLM), 9c (the
           latent GP) and 14a (the correlated-effects radon model), as
           chip_smoke.py checks them, and print each phase's wall
  --trace  builds a copy of the source in which the first thread of each
           row reads clock64() and %globaltimer at each phase's start, and
           prints, per phase, the median SM cycles over the stepping rows at
           (64, 175) and (1024, 175): where a leaf's time goes

To time an older tree's leaf on the same card, copy this script and
chip_smoke.py into that tree and run it there.

Usage:
    python3 scripts/probe_torch_leaf.py [--sweep] [--walls] [--trace]
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SWEEP_D = [32, 64, 128, 175, 256, 384, 512, 768, 1024, 2048, 3072, 4097]
# C = 1024 up to D = 1024: a longer state, cloned for every call, fills the card
SWEEP_C = {64: max(SWEEP_D), 1024: 1024}
SWEEP_WARPS = [2, 4, 8]
# the back-to-back figure clones the state BACK_TO_BACK times: only below this
B2B_STATE_BYTES = 160 * 2**20


def build(name, source, flags=()):
    """Start nvcc on `source` (text) as build/pymc_tpu_torch/probe/<name>;
    returns a function that waits for it and loads the library."""
    from pymc_tpu_torch.ops import _build

    out_dir = os.path.join(_build.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"leapfrog_{name}.cu")
    with open(path, "w") as f:
        f.write(source)
    lib = path[:-3] + ".so"
    proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-o", lib, path],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)

    def wait():
        log, _ = proc.communicate()
        spills = [ln.strip() for ln in log.splitlines()
                  if "spill" in ln and " 0 bytes spill stores" not in ln]
        print(f"-- {name}: nvcc rc {proc.returncode}; spills: {spills or 'none'}", flush=True)
        if proc.returncode != 0:
            raise SystemExit(f"probe: nvcc failed for {name}:\n{log}")
        return ctypes.CDLL(lib)

    return wait


def kernel_source():
    from pymc_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC_DIR, "leapfrog.cu")) as f:
        return f.read()


def use_library(lib, dtype):
    """Route nuts_leaf_step's `dtype` launches through the leaf of `lib`."""
    from pymc_tpu_torch.ops import leapfrog as lf

    fn = getattr(lib, f"pt_nuts_leaf_{lf._SUFFIX[dtype]}")
    fn.argtypes = [ctypes.POINTER(lf._LeafBuffers), ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lf._kernels[("pt_nuts_leaf", dtype)] = fn


def sweep(card):
    """Each team at each (C, D, dtype): two leaves against the plain leaf,
    then device ms of one call and, where the state is small enough, back
    to back."""
    from pymc_tpu_torch.ops import leapfrog as lf

    src = kernel_source()
    waits = {w: build(f"w{w}", src, [f"-DPT_LEAF_WARPS={w}"]) for w in SWEEP_WARPS}
    libs = {w: wait() for w, wait in waits.items()}
    kept = {dtype: lf._leaf_kernel(dtype) for dtype in (torch.float32, torch.float64)}
    rows = []
    try:
        for dtype in (torch.float32, torch.float64):
            for C, d_max in SWEEP_C.items():
                for D in (d for d in SWEEP_D if d <= d_max):
                    row = {"C": C, "D": D, "dtype": str(dtype).split(".")[-1]}
                    for warps, lib in libs.items():
                        use_library(lib, dtype)
                        sk, logp, grad, u = cs.leaf_state(C, D, dtype, seed=C + D)
                        cs.check_leaf_steps(f"{warps} warps ({C}, {D}) {dtype}", sk, logp, grad,
                                            u, seed=C + D + 1)
                        del sk
                        pristine, logp, grad, u = cs.leaf_state(C, D, dtype, seed=1)
                        size = sum(getattr(pristine, f).nbytes for f in pristine.BUFFERS)
                        measured, b2b = cs.time_leaf(pristine, logp, grad, u, plain=False,
                                                     back_to_back=size <= B2B_STATE_BYTES)
                        row[f"w{warps}"] = min(m[0] for m in measured["nuts_leaf"])
                        row[f"w{warps}_b2b"] = b2b
                        del pristine
                        torch.cuda.empty_cache()
                    print(f"sweep {json.dumps(row)}  [{card}]", flush=True)
                    rows.append(row)
    finally:
        for dtype, fn in kept.items():
            lf._kernels[("pt_nuts_leaf", dtype)] = fn
    return rows


MARKS = 7
TRACE_ROWS = 1024
TRACE_HEAD = f"""
__device__ long long leaf_marks[{TRACE_ROWS} * {MARKS} * 2];
#define LEAF_MARK(k)                                                      \\
  if (leader && c < {TRACE_ROWS}) {{                                       \\
    long long t_;                                                         \\
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_));                \\
    leaf_marks[(c * {MARKS} + (k)) * 2] = clock64();                       \\
    leaf_marks[(c * {MARKS} + (k)) * 2 + 1] = t_;                          \\
  }}
"""
TRACE_TAIL = f"""
extern "C" int pt_probe_leaf_marks(long long* out) {{
  const size_t bytes = sizeof(long long) * {TRACE_ROWS} * {MARKS} * 2;
  cudaError_t err = cudaMemcpyFromSymbol(out, leaf_marks, bytes);
  if (err == cudaSuccess) {{
    void* p = nullptr;
    err = cudaGetSymbolAddress(&p, leaf_marks);
    if (err == cudaSuccess) err = cudaMemset(p, 0, bytes);
  }}
  return (int)err;
}}
"""
# the row leader's marks in the leaf: its start; the scalars in (the branch
# on act taken); the row's and the slots' reads issued; the decisions taken
# (the reads in, ke and the U-turn dots reduced); phase B's writes issued;
# phase C done; the row's scalars written
TRACE_AT = [
    ("  const LeafRow<T> r = load_row<T>(b, logp_new, u, c);\n  if (!r.act) {",
     "  LEAF_MARK(0)\n  const LeafRow<T> r = load_row<T>(b, logp_new, u, c);\n  if (!r.act) {"),
    ("  // one more for everything else the row reads",
     "  LEAF_MARK(1)\n  // one more for everything else the row reads"),
    ("  const T e = r.e;\n  T sums", "  LEAF_MARK(2)\n  const T e = r.e;\n  T sums"),
    ("  // B: masked writes, then the next leaf's half kick and drift\n  T* __restrict__ q_r",
     "  LEAF_MARK(3)\n  T* __restrict__ q_r"),
    ("  // C: the U-turn slots past the first P", "  LEAF_MARK(4)\n  // C: the U-turn slots past the first P"),
    ("  if (leader) finish_row<T>(b, r, dec, turning_new, c, leaf);\n",
     "  LEAF_MARK(5)\n  if (leader) finish_row<T>(b, r, dec, turning_new, c, leaf);\n"
     "  LEAF_MARK(6)\n"),
]


def traced_source(src):
    for old, new in TRACE_AT:
        if src.count(old) != 1:
            raise SystemExit(f"probe: {old[:60]!r} not found once in leapfrog.cu")
        src = src.replace(old, new)
    return src.replace("namespace {", TRACE_HEAD + "\nnamespace {", 1) + TRACE_TAIL


def trace(card):
    """The row leaders' marks on one call of the traced row kernel: per
    phase, the median over stepping rows of the SM cycles, and the span in
    ns from the first row's start to the last row's end."""
    from pymc_tpu_torch.ops import leapfrog as lf

    lib = build("trace", traced_source(kernel_source()))()
    kept = lf._leaf_kernel(torch.float32)
    marks_fn = lib.pt_probe_leaf_marks
    marks_fn.argtypes = [ctypes.c_void_p]
    marks_fn.restype = ctypes.c_int
    buf = np.zeros(TRACE_ROWS * MARKS * 2, dtype=np.int64)
    use_library(lib, torch.float32)
    try:
        for C, D in cs.TIMED_SHAPES:
            pristine, logp, grad, u = cs.leaf_state(C, D, torch.float32, seed=1)
            for _ in range(3):  # the last of a few calls
                s = pristine.clone()
                torch.cuda.synchronize()
                lf.nuts_leaf_step(s, logp, grad, u)
                torch.cuda.synchronize()
                if marks_fn(buf.ctypes.data) != 0:
                    raise SystemExit("probe: reading the marks failed")
            m = buf.reshape(TRACE_ROWS, MARKS, 2)[:C]
            stepped = (m[:, 1:, 0] != 0).all(axis=1)
            cycles = np.diff(m[stepped, :, 0], axis=1)
            ns = m[:, :, 1]
            span = int(ns[stepped, MARKS - 1].max() - ns[:, 0][ns[:, 0] > 0].min())
            n = pristine.n.cpu().numpy()[stepped]
            slow = np.argsort(-cycles.sum(axis=1))[:3]
            print(f"trace ({C}, {D}) float32, {int(stepped.sum())} stepping rows of {C}: median "
                  f"SM cycles from start to scalars in, reads issued, decisions, writes issued, "
                  f"later U-turn slots done, scalars written: "
                  f"{np.median(cycles, axis=0).tolist()}; slowest row "
                  f"{int(cycles.sum(axis=1).max())} cycles; first start to last end {span} ns; "
                  f"the slowest rows' n and cycles: "
                  + "; ".join(f"{int(n[j])} {cycles[j].tolist()}" for j in slow) + f"  [{card}]",
                  flush=True)
    finally:
        lf._kernels[("pt_nuts_leaf", torch.float32)] = kept


def walls(card):
    """Phases 5, 9c and 14a as chip_smoke.py runs them; {phase: wall s}."""
    from pymc_tpu_torch.models import GP_LATENT_SAMPLE_KWARGS

    out = {}
    t0 = time.perf_counter()
    idata, launches, max_rhat = cs.run_sampler(card)
    cs.check_posterior(idata, launches, max_rhat)
    out["5"] = time.perf_counter() - t0
    cs.phase("9c latent GP sampling (config #4's named form)")
    t0 = time.perf_counter()
    cs.run_gp_latent(card, GP_LATENT_SAMPLE_KWARGS)
    out["9c"] = time.perf_counter() - t0
    failures = cs.CaptureFailures()
    t0 = time.perf_counter()
    try:
        cs.run_lkj_radon(card, failures)
    finally:
        failures.close()
    out["14a"] = time.perf_counter() - t0
    print(f"phase walls {json.dumps(out)}  [{card}]", flush=True)
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--walls", action="store_true")
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args()
    card, _ = cs.check_device()
    from pymc_tpu_torch.ops import _build

    cs.phase("2 build")
    _build.load_libraries(["leapfrog", "cholesky"] if args.walls else ["leapfrog"])
    print(_build.build_log.get("leapfrog", "").strip())
    cs.check_leaf(card)
    if args.trace:
        cs.phase("leaf kernel: where a leaf's time goes")
        trace(card)
    if args.sweep:
        cs.phase("leaf kernel: warps a row")
        sweep(card)
    if args.walls:
        walls(card)
    print(f"total wall {time.perf_counter() - cs.T_START:.1f} s")


if __name__ == "__main__":
    main()
