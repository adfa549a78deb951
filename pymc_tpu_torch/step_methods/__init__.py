"""Step methods (reference pymc/step_methods/__init__.py:36 STEP_METHODS;
pymc_tpu/step_methods/__init__.py)."""

from . import arraystep, quadpotential
from .arraystep import ArrayStep, ArrayStepShared, metrop_select
from .compound import Competence, CompoundStep, assign_step_methods
from .hmc import NUTS, HamiltonianMC
from .metropolis import (
    BinaryGibbsMetropolis,
    BinaryMetropolis,
    CategoricalGibbsMetropolis,
    DEMetropolis,
    DEMetropolisZ,
    Metropolis,
)
from .quadpotential import (
    QuadPotentialDiag,
    QuadPotentialDiagAdapt,
    QuadPotentialFull,
    QuadPotentialFullAdapt,
    QuadPotentialFullInv,
    isquadpotential,
    quad_potential,
)
from .slicer import Slice

STEP_METHODS = (
    NUTS,
    HamiltonianMC,
    Metropolis,
    BinaryMetropolis,
    BinaryGibbsMetropolis,
    CategoricalGibbsMetropolis,
    DEMetropolis,
    DEMetropolisZ,
    Slice,
)

__all__ = [
    "Competence",
    "CompoundStep",
    "assign_step_methods",
    "NUTS",
    "HamiltonianMC",
    "Metropolis",
    "BinaryMetropolis",
    "BinaryGibbsMetropolis",
    "CategoricalGibbsMetropolis",
    "DEMetropolis",
    "DEMetropolisZ",
    "Slice",
    "STEP_METHODS",
]
