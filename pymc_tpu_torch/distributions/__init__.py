"""Distributions of the PyTorch port (the JAX package's names)."""

from . import transforms
from .censored import Censored
from .continuous import *  # noqa: F401,F403
from .continuous import __all__ as _cont_all
from .discrete import *  # noqa: F401,F403
from .discrete import __all__ as _disc_all
from .distribution import Continuous, Discrete, Distribution
from .mixture import *  # noqa: F401,F403
from .mixture import __all__ as _mix_all
from .multivariate import *  # noqa: F401,F403
from .multivariate import __all__ as _mv_all
from .timeseries import *  # noqa: F401,F403
from .timeseries import __all__ as _ts_all
from .truncated import Truncated

__all__ = [
    "Distribution", "Continuous", "Discrete", "transforms", *_cont_all, *_disc_all,
    *_mv_all,
    *[n for n in _mix_all if n != "MixtureTransformWarning"],
    *_ts_all, "Censored", "Truncated",
]
