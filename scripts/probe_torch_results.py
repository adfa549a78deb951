"""Run `chip_smoke.py`'s phase 13 alone on one CUDA card: the rest of
`sample` and the results layer. Builds csrc/leapfrog.cu and
csrc/cholesky.cu, samples phase 5's radon GLM and phase 6's marginal GP
(13a and 13b read their posteriors), then 13a stops the radon run at 64
draws through its callback, resumes it from its FileTrace and checks the
log-likelihood, loo, waic, hdi, R-hat and the MultiTrace, and 13b computes
the marginal GP's log-likelihood on the card, each checked as
`chip_smoke.py` checks it.

Usage:
    python3 scripts/probe_torch_results.py
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main():
    card, _ = cs.check_device()
    cs.build_kernels()
    idata, launches, max_rhat = cs.run_sampler(card)
    cs.check_posterior(idata, launches, max_rhat)
    _, gp_idata = cs.run_gp(card)
    t0 = cs.time.perf_counter()
    print(f"launches {cs.run_results(card, idata, gp_idata)}")
    print(f"phase 13 wall {cs.time.perf_counter() - t0:.1f} s; "
          f"total wall {cs.time.perf_counter() - cs.T_START:.1f} s")


if __name__ == "__main__":
    main()
