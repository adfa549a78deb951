"""Write the posterior reference of the stochastic-volatility model
(`examples/stochastic_volatility.py`) that `chip_smoke.py` phase 15b checks
the PyTorch port against.

Runs `pymc_tpu` on the CPU in float64 on `pymc_tpu_torch.models.
stochastic_volatility_model` (the example's model and data, built by
`pymc_tpu`) at 32 chains, tune 2000, draws 3000, target_accept 0.95 (the
example's), pooled mass, seed 0: step_sigma mixes slowly in its funnel
(at 16 chains and 1000/1000 its R-hat is 1.075), so the run is long, about
30 minutes on 8 CPU cores. Writes the posterior mean, sd, MCSE and R-hat of
step_sigma and nu (`models.SV_SCALARS`) to `tests/data/torch_sv_reference.json`.

Usage:
    python scripts/make_torch_sv_fixture.py
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from make_torch_best_fixture import pm, write_reference  # noqa: E402
from pymc_tpu_torch.models import SV_SCALARS, stochastic_volatility_model  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "torch_sv_reference.json")
CONFIG = dict(chains=32, tune=2000, draws=3000, random_seed=0, target_accept=0.95,
              mass_adapt="pooled")


def main():
    write_reference(
        stochastic_volatility_model(pm), SV_SCALARS, CONFIG, OUT,
        "pymc_tpu posterior of models.stochastic_volatility_model "
        "(examples/stochastic_volatility.py) on the CPU in float64 "
        "(scripts/make_torch_sv_fixture.py)",
    )


if __name__ == "__main__":
    main()
