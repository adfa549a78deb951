"""Run `chip_smoke.py`'s phase 18 alone on one CUDA card: the logprob
engine's structural matchers. Builds csrc/leapfrog.cu and csrc/cholesky.cu,
then 18a samples the survival example with a
CustomDist(dist=minimum(Weibull, t_end)) likelihood
(`models.survival_minimum_model`), 18b checks every structural form on the
card against the CPU and the forms' models' logp+grad from a CUDA graph,
and 18c draws the index and switch mixtures on the card, each checked as
`chip_smoke.py` checks it.

Usage:
    python3 scripts/probe_torch_structural.py
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
    paths = cs.run_structural(card)
    print(f"launches: {json.dumps(paths)}")
    print(f"total wall {cs.time.perf_counter() - cs.T_START:.1f} s")


if __name__ == "__main__":
    main()
