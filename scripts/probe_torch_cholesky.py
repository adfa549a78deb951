"""Time the batched Cholesky kernel of pymc_tpu_torch/csrc/cholesky.cu at
other thread-block sizes and register budgets, on one CUDA card.

The port builds the kernel with 256 threads a block and asks, in
`__launch_bounds__`, for two float32 blocks an SM where a matrix fits in
shared memory (at most 65536 / (2 * 256) = 128 registers a thread). This
probe builds the same source with the block size replaced, and optionally
with that least number of blocks per SM replaced for every instance:
variant "256x1" is 256 threads with no register cap. One nvcc per variant, started together, into
build/pymc_tpu_torch/probe/. It checks each variant against
`cholesky_plain`, and times them in turns with `torch.linalg.cholesky_ex`
at the GP path's (64, 150) and at (1024, 150), float32, with chip_smoke.py's
CUDA-event method. Smaller blocks let more matrices share an SM at large C.

With --trace it also builds a copy in which thread 0 of each block reads
clock64() at the kernel's start, after every barrier and when it has
factored a diagonal tile, and prints block 0's cycles per phase at
(64, 150): where one factorisation's time goes.

Usage:
    python3 scripts/probe_torch_cholesky.py [--variants 256 256x1 128 ...] [--trace]
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pymc_tpu_torch.ops import _build  # noqa: E402
from pymc_tpu_torch.ops import linalg as la  # noqa: E402

LINE = "constexpr int kThreads = 256;"
BOUNDS = "__launch_bounds__(kThreads, (min_blocks<T, kShared>()))"
SHAPES = [(64, 150), (1024, 150)]
MAX_MARKS = 64
# thread 0 of each block notes the SM clock; pt_probe_marks copies block 0's
TRACE_HEAD = f"""
__device__ long long probe_marks[{MAX_MARKS}];
__device__ int probe_count;
#define PROBE_MARK()                                                  \\
  if (threadIdx.x == 0 && blockIdx.x == 0) {{                         \\
    const int c_ = probe_count++;                                     \\
    if (c_ < {MAX_MARKS}) probe_marks[c_] = clock64();                \\
  }}
"""
TRACE_TAIL = f"""
extern "C" int pt_probe_marks(long long* out) {{
  int count = 0;
  cudaMemcpyFromSymbol(&count, probe_count, sizeof(int));
  cudaMemcpyFromSymbol(out, probe_marks, sizeof(long long) * {MAX_MARKS});
  const int zero = 0;
  cudaMemcpyToSymbol(probe_count, &zero, sizeof(int));
  return count;
}}
"""


def traced(src):
    """The kernel with a clock mark at its start, after every barrier and
    every diagonal tile, and at its end (after one more barrier)."""
    head, body = src.split("__global__ void " + BOUNDS, 1)
    body = body.replace("__syncthreads();", "__syncthreads();\n  PROBE_MARK();")
    body = re.sub(r"(factor_diagonal\([^;]*\);)", r"\1\n    PROBE_MARK();", body)
    body = body.replace("  T* Lb = L + base;\n", "  T* Lb = L + base;\n  PROBE_MARK();\n", 1)
    body = re.sub(r"(write_column\(t, Lb, n, nt - 1, warp, kWarps\);\n)",
                  r"\1  __syncthreads();\n  PROBE_MARK();\n", body, count=1)
    head = head.replace("namespace {", TRACE_HEAD + "\nnamespace {", 1)
    return head + "__global__ void " + BOUNDS + body + TRACE_TAIL


def build(variants, trace=False):
    """{name: ctypes library}, one nvcc per variant, all started together;
    the traced copy of the source as it stands as "trace"."""
    with open(os.path.join(_build.CSRC_DIR, "cholesky.cu")) as f:
        src = f.read()
    for line in (LINE, BOUNDS):
        if line not in src:
            raise SystemExit(f"probe: {line!r} not found in cholesky.cu")
    out_dir = os.path.join(_build.BUILD_DIR, "probe")
    os.makedirs(out_dir, exist_ok=True)
    sources = {}
    for v in variants:
        threads, _, blocks = v.partition("x")
        text = src.replace(LINE, f"constexpr int kThreads = {int(threads)};")
        if blocks:
            text = text.replace(BOUNDS, f"__launch_bounds__(kThreads, {int(blocks)})")
        sources[f"kernel_t{v}"] = text
    if trace:
        sources["trace"] = traced(src)
    jobs = {}
    for name, text in sources.items():
        path = os.path.join(out_dir, f"cholesky_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = path[:-3] + ".so"
        proc = subprocess.Popen([_build._nvcc(), *_build.NVCC_FLAGS, "-o", lib, path],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs[name] = (proc, lib)
    libs = {}
    for name, (proc, lib) in jobs.items():
        log, _ = proc.communicate()
        print(f"-- {name}:\n{log.strip()}")
        if proc.returncode != 0:
            raise SystemExit(f"probe: nvcc failed for {name}")
        libs[name] = ctypes.CDLL(lib)
    return libs


def trace(lib, n=150, C=64):
    """Block 0's cycles from the kernel's start to each mark, and per phase."""
    call = launcher(lib)
    marks_fn = lib.pt_probe_marks
    marks_fn.argtypes = [ctypes.c_void_p]
    marks_fn.restype = ctypes.c_int
    A = cs.spd_stack(C, n, torch.float32, seed=1)
    buf = (ctypes.c_longlong * MAX_MARKS)()
    for _ in range(3):  # the last of a few calls
        call(A)
        torch.cuda.synchronize()
        count = marks_fn(buf)
    marks = list(buf)[:count]
    steps = [b - a for a, b in zip(marks, marks[1:])]
    print(f"trace ({C}, {n}) float32, block 0: {count} marks, {marks[-1] - marks[0]} cycles "
          f"from start to end; per phase (start, after each barrier or diagonal tile, end): "
          f"{steps}")


def launcher(lib):
    """A float32 call of the kernel in `lib`, allocating as the wrapper does."""
    work_fn = lib.pt_cholesky_workspace
    work_fn.argtypes = [ctypes.c_int64] * 3
    work_fn.restype = ctypes.c_int64
    fn = lib.pt_cholesky_f32
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(A):
        C, n = A.shape[0], A.shape[-1]
        L = torch.empty_like(A)
        elems = work_fn(C, n, A.element_size())
        work = torch.empty(elems, dtype=A.dtype, device=A.device) if elems else None
        rc = fn(A.data_ptr(), L.data_ptr(), None if work is None else work.data_ptr(), C, n,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: cudaError {rc}")
        return L

    return call


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="+", default=["256", "256x1", "128"],
                    help="threads a block, optionally x the least blocks per SM")
    ap.add_argument("--trace", action="store_true", help="per-phase cycles of block 0")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("probe: torch.cuda.is_available() is False")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(card)
    libs = build(args.variants, trace=args.trace)
    if args.trace:
        trace(libs.pop("trace"))
    calls = {name: launcher(lib) for name, lib in libs.items()}
    for C, n in SHAPES:
        A = cs.spd_stack(C, n, torch.float32, seed=1)
        ref = la.cholesky_plain(A)
        for name, call in calls.items():
            err = float((call(A).double() - ref.double()).abs().max())
            tol = cs.CHOL_TOL[torch.float32] * n * float(ref.double().abs().max())
            if not err <= tol:
                raise SystemExit(f"probe: {name} disagrees at ({C}, {n}): {err:.3e}")
        timed = {**{k: (lambda c=c: c(A)) for k, c in calls.items()},
                 "cholesky_ex": lambda: torch.linalg.cholesky_ex(A)}
        order = list(timed)
        measured = {k: [] for k in timed}
        for k in order + order[::-1]:
            measured[k].append(cs.cuda_ms(timed[k])[0])
        for k, v in measured.items():
            print(f"({C}, {n}) float32 {k}: device ms {', '.join(f'{m:.5f}' for m in v)}"
                  f"  [{card}]")


if __name__ == "__main__":
    main()
