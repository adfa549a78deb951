"""Write the posterior reference of the censored survival model
(`examples/survival_analysis.py`) that `chip_smoke.py` phase 15a checks the
PyTorch port against.

Runs `pymc_tpu` on the CPU in float64 on `pymc_tpu_torch.models.
survival_model` (the example's model and data, built by `pymc_tpu`) at 16
chains, tune 1000, draws 1000, pooled mass, seed 0. Writes the posterior
mean, sd, MCSE and R-hat of alpha, b0 and b1 (`models.SURVIVAL_SCALARS`)
to `tests/data/torch_survival_reference.json`.

Usage:
    python scripts/make_torch_survival_fixture.py
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from make_torch_best_fixture import pm, write_reference  # noqa: E402
from pymc_tpu_torch.models import SURVIVAL_SCALARS, survival_model  # noqa: E402

OUT = os.path.join(ROOT, "tests", "data", "torch_survival_reference.json")
CONFIG = dict(chains=16, tune=1000, draws=1000, random_seed=0, mass_adapt="pooled")


def main():
    write_reference(
        survival_model(pm), SURVIVAL_SCALARS, CONFIG, OUT,
        "pymc_tpu posterior of models.survival_model (examples/survival_analysis.py) on the "
        "CPU in float64 (scripts/make_torch_survival_fixture.py)",
    )


if __name__ == "__main__":
    main()
