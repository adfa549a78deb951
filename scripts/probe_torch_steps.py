"""Run `chip_smoke.py`'s phase 12 alone on one CUDA card: step methods and
compound sampling. Builds csrc/leapfrog.cu and csrc/cholesky.cu, then 12a
samples the change-point model (`models.changepoint_model`, NUTS +
Metropolis, two imputed counts) at `models.CHANGEPOINT_SAMPLE_KWARGS`, 12b
the radon GLM with `step=pm.HamiltonianMC()`, and 12c the other steppers on
models with known posteriors, each checked as `chip_smoke.py` checks it.

Usage:
    python3 scripts/probe_torch_steps.py [12a 12b 12c]
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main():
    parts = sys.argv[1:] or ["12a", "12b", "12c"]
    card, _ = cs.check_device()
    cs.build_kernels()
    runs = {"12a": cs.run_changepoint, "12b": cs.run_hmc_radon, "12c": cs.run_steppers}
    failures = cs.CaptureFailures()
    for part in parts:
        print(f"{part} launches {runs[part](card, failures)}")
    failures.close()
    print(f"total wall {cs.time.perf_counter() - cs.T_START:.1f} s")


if __name__ == "__main__":
    main()
