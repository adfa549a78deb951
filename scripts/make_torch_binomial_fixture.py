"""Write the posterior reference of the hierarchical binomial model
(`examples/hierarchical_binomial.py`) that `chip_smoke.py` phase 11b checks
the PyTorch port against.

Runs `pymc_tpu` on the CPU in float64 on
`pymc_tpu_torch.models.hierarchical_binomial_model` (built by `pymc_tpu`)
at 64 chains, tune 1000, draws 1000, pooled mass, seed 0: the card's
configuration (`models.BINOMIAL_SAMPLE_KWARGS`). Writes the posterior
mean, sd, MCSE and R-hat of phi, kappa_log and kappa
(`models.BINOMIAL_SCALARS`) to
`tests/data/torch_binomial_reference.json`.

Usage:
    python scripts/make_torch_binomial_fixture.py
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from make_torch_best_fixture import pm, write_reference  # noqa: E402
from pymc_tpu_torch.models import (  # noqa: E402
    BINOMIAL_SAMPLE_KWARGS, BINOMIAL_SCALARS, hierarchical_binomial_model,
)

OUT = os.path.join(ROOT, "tests", "data", "torch_binomial_reference.json")


def main():
    write_reference(
        hierarchical_binomial_model(pm), BINOMIAL_SCALARS, BINOMIAL_SAMPLE_KWARGS, OUT,
        "pymc_tpu posterior of models.hierarchical_binomial_model "
        "(examples/hierarchical_binomial.py) on the CPU in float64 "
        "(scripts/make_torch_binomial_fixture.py)",
    )


if __name__ == "__main__":
    main()
