"""Mass-matrix scaling helpers (reference pymc/tuning/scaling.py:
guess_scaling:113, trace_cov:139); counterpart of
`pymc_tpu/tuning/scaling.py`."""

import numpy as np

from .starting import guess_scaling

__all__ = ["guess_scaling", "trace_cov"]


def trace_cov(trace, vars=None, model=None):
    """The empirical covariance of the flattened posterior draws of an
    InferenceData (reference scaling.py:139)."""
    post = trace.posterior
    names = vars if vars is not None else list(post.keys())
    cols = []
    for n in names:
        values = np.asarray(post[getattr(n, "name", n)].values)
        cols.append(values.reshape(-1, int(np.prod(values.shape[2:]) or 1)))
    return np.atleast_2d(np.cov(np.concatenate(cols, axis=1), rowvar=False))
