"""Write the posterior reference of the derived-density model that
`chip_smoke.py` phase 16c checks the PyTorch port against.

Runs `pymc_tpu` NUTS on the CPU in float64 on `pymc_tpu_torch.models.
derived_model` (a rounded Normal through `Discretized` and the maxima of
five Normals through `Max`, built by `pymc_tpu`) at
`models.DERIVED_SAMPLE_KWARGS` (16 chains, tune 1000, draws 1000, pooled
mass, seed 0). Writes the posterior mean, sd, MCSE and R-hat of mu and
sigma (`models.DERIVED_SCALARS`) to `tests/data/torch_derived_reference.json`.

Usage:
    python scripts/make_torch_derived_fixture.py
"""

from __future__ import annotations

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from make_torch_best_fixture import pm, write_reference  # noqa: E402
from pymc_tpu_torch.models import (  # noqa: E402
    DERIVED_SAMPLE_KWARGS, DERIVED_SCALARS, derived_model,
)

OUT = os.path.join(ROOT, "tests", "data", "torch_derived_reference.json")


def main():
    write_reference(
        derived_model(pm), DERIVED_SCALARS, DERIVED_SAMPLE_KWARGS, OUT,
        "pymc_tpu posterior of models.derived_model (Discretized and Max likelihoods) on the "
        "CPU in float64 (scripts/make_torch_derived_fixture.py)",
    )


if __name__ == "__main__":
    main()
