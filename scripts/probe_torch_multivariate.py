"""Run `chip_smoke.py`'s phase 14 alone on one CUDA card: the multivariate
family. Builds csrc/leapfrog.cu and csrc/cholesky.cu, then 14a samples the
correlated-effects radon model (`models.radon_lkj_model`), 14b an
LKJCorr(n = 10, eta = 2) prior, and 14c checks every class of the slice on
the card (logp/grad against the CPU, CUDA-graph capture, values that are
not positive definite, prior draws against exact moments), each checked as
`chip_smoke.py` checks it.

Usage:
    python3 scripts/probe_torch_multivariate.py
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main():
    card, _ = cs.check_device()
    cs.build_kernels()
    paths, chol_times = cs.run_multivariate(card)
    print("launches: " + "; ".join(f"{name} {p}" for name, p in paths.items()))
    print(f"cholesky forward and backward at (64, {cs.LKJ_CORR_N}): {json.dumps(chol_times)}")
    print(f"total wall {cs.time.perf_counter() - cs.T_START:.1f} s")


if __name__ == "__main__":
    main()
