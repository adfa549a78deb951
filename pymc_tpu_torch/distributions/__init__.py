"""Distributions of the PyTorch port (the JAX package's names)."""

from . import moments, shape_utils, transforms
from .censored import Censored
from .custom import CustomDist, DensityDist
from .derived import Compared, CumSum, Discretized, Max, Min, OrderStatistic
from .continuous import *  # noqa: F401,F403
from .continuous import __all__ as _cont_all
from .discrete import *  # noqa: F401,F403
from .discrete import __all__ as _disc_all
from .distribution import Continuous, DiracDelta, Discrete, Distribution
from .mixture import *  # noqa: F401,F403
from .mixture import __all__ as _mix_all
from .multivariate import *  # noqa: F401,F403
from .multivariate import __all__ as _mv_all
from .simulator import Simulator
from .timeseries import *  # noqa: F401,F403
from .timeseries import __all__ as _ts_all
from .transformed import TransformedDistribution, dist_from_expression
from .truncated import Truncated

__all__ = [
    "Distribution", "Continuous", "Discrete", "DiracDelta", "transforms", *_cont_all, *_disc_all,
    *_mv_all,
    *[n for n in _mix_all if n != "MixtureTransformWarning"],
    *_ts_all, "Censored", "Truncated", "CustomDist", "DensityDist", "Simulator", "Discretized",
    "OrderStatistic", "Max", "Min", "CumSum", "Compared", "moments", "shape_utils",
    "TransformedDistribution", "dist_from_expression",
]
