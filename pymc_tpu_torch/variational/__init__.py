"""Variational inference: counterpart of `pymc_tpu/variational/`."""

from . import opvi, updates
from .opvi import Approximation, Group, sample_approx
from .updates import (
    adadelta, adagrad, adagrad_window, adam, adamax, apply_momentum, apply_nesterov_momentum,
    momentum, nesterov_momentum, norm_constraint, rmsprop, sgd, total_norm_constraint,
)
from .approximations import Blocked, Empirical, FullRank, MeanField, VIState
from .callbacks import CheckParametersConvergence, Tracker
from . import operators, stein, test_functions
from .inference import ADVI, ASVGD, SVGD, FullRankADVI, ImplicitGradient, Inference, KLqp, fit
from .operators import KL, KSD, ObjectiveFunction, Operator, Stein, TestFunction

__all__ = [
    "ImplicitGradient", "KL", "KSD", "Operator", "ObjectiveFunction", "TestFunction", "Stein",
    "operators", "stein", "test_functions", "Group", "Approximation", "sample_approx", "sgd",
    "momentum", "nesterov_momentum", "adagrad", "adagrad_window", "rmsprop", "adadelta", "adam",
    "adamax", "apply_momentum", "apply_nesterov_momentum", "norm_constraint",
    "total_norm_constraint", "ADVI", "ASVGD", "SVGD", "FullRankADVI", "Inference", "KLqp", "fit",
    "MeanField", "FullRank", "Empirical", "Blocked", "VIState", "CheckParametersConvergence",
    "Tracker", "updates",
]
