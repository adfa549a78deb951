"""GP utilities (reference pymc/gp/util.py), cut to `stabilize`."""

from __future__ import annotations

JITTER_DEFAULT = 1e-6

__all__ = ["stabilize", "JITTER_DEFAULT"]


def stabilize(K, jitter=None):
    """Add `jitter` to the diagonal of a covariance for Cholesky safety
    (reference gp/util.py:77). The default is dtype-aware: JITTER_DEFAULT
    (1e-6) in float64; in float32 at least 1e-4 and 3e-4 times the mean of
    the diagonal."""
    from .gp import _stabilize

    return _stabilize(K, jitter)
