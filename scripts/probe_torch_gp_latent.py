"""Sample the latent GP, BASELINE config #4 in its named form, on one CUDA
card, alone: `chip_smoke.py`'s phase 9c (`benchmarks/suite.py::case_gp`,
n = 150, `gp.Latent.prior` with an `eta**2 * ExpQuad` kernel, 153 free
parameters, NUTS at 64 chains, pooled mass, float32,
`pymc_tpu_torch.models.GP_LATENT_SAMPLE_KWARGS`), with options to try
other settings. Builds csrc/leapfrog.cu and csrc/cholesky.cu, samples and
checks as phase 9c does (`chip_smoke.run_gp_latent`). On an H100 the
default run takes about 160 s with its build: ~1,000 lock-step leapfrogs
a draw at ~0.74 ms each.

Usage:
    python3 scripts/probe_torch_gp_latent.py [--tune N] [--float64] [--jitter-rel R]

--tune replaces GP_LATENT_SAMPLE_KWARGS's number of tuning draws;
--float64 samples in float64 on the card (the model is then the float64
one, prior jitter 1e-6, as the fixture's); --jitter-rel sets the float32
prior jitter's factor (`gp.gp.F32_PRIOR_JITTER`) for this run. Each run
prints its readings and its `posterior summary` line before the checks,
so a failing try still reports them.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from pymc_tpu_torch.models import GP_LATENT_SAMPLE_KWARGS  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tune", type=int, default=GP_LATENT_SAMPLE_KWARGS["tune"])
    ap.add_argument("--float64", action="store_true")
    ap.add_argument("--jitter-rel", type=float, default=None)
    args = ap.parse_args()
    card, _ = cs.check_device()
    cs.build_kernels()
    if args.float64:
        import torch

        from pymc_tpu_torch.sampling import mcmc

        mcmc.floatX = lambda device=None: torch.float64
    if args.jitter_rel is not None:
        from pymc_tpu_torch.gp import gp

        gp.F32_PRIOR_JITTER = args.jitter_rel
    config = dict(GP_LATENT_SAMPLE_KWARGS, tune=args.tune)
    print(f"try: {vars(args)}")
    cs.phase(f"latent GP sampling {config}")
    print(f"launches {cs.run_gp_latent(card, config)}")
    print(f"total wall {cs.time.perf_counter() - cs.T_START:.1f} s")


if __name__ == "__main__":
    main()
