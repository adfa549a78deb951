"""Run chip_smoke.py's SMC checks alone on one CUDA card: the quick proof
that the SMC path of pymc_tpu_torch builds, runs and agrees, in about a
minute instead of the whole script's ~15.

Builds csrc/cholesky.cu, checks the Cholesky kernel against its plain
version at SMC's (4, 3) stack in float32 and float64 and times it there
(kernel, plain, `torch.linalg.cholesky_ex`), compares SMC's tempered
density on the card with the CPU (phase 4's `check_smc_density`), and runs
phase 8 (`run_smc`): `sample_smc` on BASELINE config #5 at seeds 0-4 with
IMH and at seed 0 with MH, held to tests/data/torch_smc_reference.json, and
the kernels of one sweep.

Usage:
    python3 scripts/probe_torch_smc.py
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pymc_tpu_torch.ops import _build  # noqa: E402
from pymc_tpu_torch.ops import linalg as la  # noqa: E402


def main():
    card, _ = cs.check_device()
    _build.load_library("cholesky")
    print(f"built {cs.CHOL_SOURCE}: nvcc {_build.build_seconds.get('cholesky', 0.0):.2f} s")
    C, n = cs.CHOL_TIMED[-1]
    for dtype in (torch.float32, torch.float64):
        A = cs.spd_stack(C, n, dtype, seed=C + n)
        L, ref = la.cholesky_batched(A), la.cholesky_plain(A)
        err = float((L.double() - ref.double()).abs().max())
        print(f"cholesky ({C}, {n}) {dtype}: max abs err {err:.3e}")
        if not err <= cs.CHOL_TOL[dtype] * n * float(ref.double().abs().max()):
            raise AssertionError(f"cholesky kernel disagrees at ({C}, {n}) {dtype}")
    A = cs.spd_stack(C, n, torch.float32, seed=1)
    calls = {"plain": lambda: la.cholesky_plain(A), "kernel": lambda: la.cholesky_batched(A),
             "library": lambda: torch.linalg.cholesky_ex(A)}
    order = list(calls)
    for k in order + order[::-1]:
        dev, host = cs.cuda_ms(calls[k])
        print(f"({C}, {n}) float32 cholesky {k}: device ms {dev:.5f}; host ms {host:.5f}  "
              f"[{card}]")
    cs.check_smc_density()
    print(f"launches {cs.run_smc(card)}")
    print(f"total wall {cs.time.perf_counter() - cs.T_START:.1f} s")


if __name__ == "__main__":
    main()
