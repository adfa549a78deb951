"""GP utilities (reference pymc/gp/util.py): `stabilize`,
`kmeans_inducing_points` and `replace_with_values`.

Counterpart of `pymc_tpu/gp/util.py`; `plot_gp_dist` is not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph import Node, evaluate

JITTER_DEFAULT = 1e-6

__all__ = ["stabilize", "kmeans_inducing_points", "replace_with_values", "JITTER_DEFAULT"]


def stabilize(K, jitter=None):
    """Add `jitter` to the diagonal of a covariance for Cholesky safety
    (reference gp/util.py:77). The default is dtype-aware: JITTER_DEFAULT
    (1e-6) in float64; in float32 at least 1e-4 and `gp.F32_PRIOR_JITTER`
    times the mean of the diagonal."""
    from .gp import _stabilize

    return _stabilize(K, jitter)


def replace_with_values(vars_needed, replacements=None, model=None):
    """Evaluate graph nodes under a {name: value} environment on the CPU
    (reference gp/util.py:30); one node gives one numpy array, several a
    list."""
    env = {k: torch.as_tensor(np.asarray(v)) for k, v in (replacements or {}).items()}
    memo = {}
    out = [
        evaluate(v, env, memo).numpy() if isinstance(v, Node) else v for v in vars_needed
    ]
    return out[0] if len(out) == 1 else out


def kmeans_inducing_points(n_inducing, X, **kmeans_kwargs):
    """K-means initialization of inducing point locations (reference
    gp/util.py:95): whiten, scipy's kmeans, unwhiten."""
    if isinstance(X, Node):
        X = evaluate(X, {})
    if isinstance(X, torch.Tensor):
        X = X.cpu().numpy()
    if isinstance(X, (np.ndarray, tuple, list)):
        X = np.asarray(X, dtype=np.float64)
    else:
        raise TypeError(f"X must be castable to an ndarray for k-means, got {type(X)}")
    scaling = np.std(X, 0)
    scaling[scaling <= 1e-6] = 1.0
    Xw = X / scaling
    from scipy.cluster.vq import kmeans

    Xu, _ = kmeans(Xw, k_or_guess=n_inducing, **kmeans_kwargs)
    return Xu * scaling
