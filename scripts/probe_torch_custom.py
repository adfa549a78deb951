"""Run `chip_smoke.py`'s phase 16 alone on one CUDA card: CustomDist,
Simulator with ABC SMC, the derived densities, the Bessel functions and
nested models. Builds csrc/leapfrog.cu and csrc/cholesky.cu, then 16a
samples the radon GLM with a CustomDist likelihood inside a named model
(`models.radon_custom_model`), 16b the ABC example through `sample_smc`
(`models.abc_simulator_model`), 16c the derived model
(`models.derived_model`) and 16d checks every class on the card, each
checked as `chip_smoke.py` checks it.

Usage:
    python3 scripts/probe_torch_custom.py
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
    paths = cs.run_custom(card)
    print(f"launches: {json.dumps(paths)}")
    print(f"total wall {cs.time.perf_counter() - cs.T_START:.1f} s")


if __name__ == "__main__":
    main()
