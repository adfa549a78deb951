"""Run `chip_smoke.py`'s phase 17 alone on one CUDA card: the logprob
engine's elementwise chains. Builds csrc/leapfrog.cu and csrc/cholesky.cu,
then 17a samples the radon GLM with a CustomDist(dist=exp(Normal))
likelihood (`models.radon_lognormal_model`), 17b checks every chain of the
registry on the card against the CPU and the model's logp+grad from a CUDA
graph, and 17c draws exp(Normal) on the card, each checked as
`chip_smoke.py` checks it.

Usage:
    python3 scripts/probe_torch_transformed.py
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
    paths = cs.run_transformed(card)
    print(f"launches: {json.dumps(paths)}")
    print(f"total wall {cs.time.perf_counter() - cs.T_START:.1f} s")


if __name__ == "__main__":
    main()
