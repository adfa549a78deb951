"""The init family's checks of chip_smoke.py alone, on one CUDA card:
phases 1 and 2 (the card, the build), phase 3's Cholesky checks and times
(among them phase 10's shapes and the jvp), phase 4's CUDA-graph check,
and phase 10 (BASELINE config #2 with the ADVI init, the radon GLM with a
full mass, MAP and the Hessian on the marginal GP with sample(init="map"),
the VI objectives against the CPU), without the other sampling phases.
Phase 10b's leapfrogs a draw are not set beside phase 5's here.

Usage:
    python3 scripts/probe_torch_init.py
"""

from __future__ import annotations

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main():
    card, _ = cs.check_device()
    cs.build_kernels()
    cs.check_cholesky(card)
    cs.check_graphed_logp(card)
    cs.phase("10 inits")
    paths = {"radon ADVI init": cs.run_radon_advi(card),
             "radon full mass": cs.run_radon_full(card, None),
             "GP MAP": cs.run_gp_map(card)}
    cs.check_vi_objectives(card)
    print("launches: " + "; ".join(f"{name} {p}" for name, p in paths.items()))
    print(f"total wall {time.perf_counter() - cs.T_START:.1f} s")


if __name__ == "__main__":
    main()
