"""VI fit callbacks (reference pymc/variational/callbacks.py:
CheckParametersConvergence:45, Tracker:94); counterpart of
`pymc_tpu/variational/callbacks.py`. A callback runs once a chunk of steps,
on the host: each of these reads the parameters it needs from the device."""

from __future__ import annotations

import numpy as np
import torch

from .updates import tree_leaves

__all__ = ["Callback", "CheckParametersConvergence", "Tracker"]


class Callback:
    def __call__(self, approx, loss_hist, i):  # pragma: no cover
        raise NotImplementedError


class CheckParametersConvergence(Callback):
    """Raise StopIteration when the parameters change by less than
    `tolerance` between two checks `every` steps apart."""

    def __init__(self, every=100, tolerance=1e-3, diff="relative", ord=np.inf):
        self.every = every
        self.tolerance = tolerance
        self.diff = diff
        self.ord = ord
        self.prev = None

    @staticmethod
    def flatten(approx):
        return torch.cat([x.reshape(-1) for x in tree_leaves(approx.params)]).cpu().numpy()

    def __call__(self, approx, loss_hist, i):
        if i % self.every and i > 0:
            return
        current = self.flatten(approx)
        if self.prev is not None:
            delta = current - self.prev
            if self.diff == "relative":
                delta = delta / (np.abs(self.prev) + 1e-10)
            norm = np.linalg.norm(delta, self.ord)
            self.prev = current
            if norm < self.tolerance:
                raise StopIteration(f"Convergence achieved at {i}")
        else:
            self.prev = current


class Tracker(Callback):
    """Record statistics during fit (reference callbacks.py:94), e.g.
    Tracker(mean=lambda approx: approx.params["mu"]). Each function is
    tried with no arguments first, then with (approx, hist, i)."""

    def __init__(self, **kwargs):
        self.whatchdict = kwargs
        self.hist = {k: [] for k in kwargs}

    def __call__(self, approx, loss_hist, i):
        for k, fn in self.whatchdict.items():
            try:
                val = fn()
            except TypeError:
                val = fn(approx, loss_hist, i)
            self.hist[k].append(val.detach().cpu().numpy() if torch.is_tensor(val)
                                else np.asarray(val))

    def __getitem__(self, k):
        return self.hist[k]
