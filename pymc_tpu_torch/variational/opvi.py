"""OPVI surface: Group and sample_approx.

Counterpart of `pymc_tpu/variational/opvi.py` (reference
pymc/variational/opvi.py: Group:582, Approximation:1237, sample_approx).
One group over every latent variable selects a family; several groups
(each a named subset with its own family, and at most one Group(None)
rest group) compose into a Blocked approximation whose one ELBO optimizes
every family together.
"""

from __future__ import annotations

import numpy as np

from ..config import floatX, resolve_device
from ..model.core import modelcontext
from .approximations import Blocked, Empirical, FullRank, MeanField
from .operators import KL, KSD, ObjectiveFunction, Operator, TestFunction

__all__ = ["Group", "Approximation", "sample_approx", "Operator", "ObjectiveFunction",
           "TestFunction", "KL", "KSD"]

_FAMILIES = {
    "mean_field": MeanField, "mf": MeanField,
    "full_rank": FullRank, "fr": FullRank,
    "hist": Empirical, "histogram": Empirical, "empirical": Empirical,
}


class Group:
    """A set of latent variables approximated by one family (reference
    opvi.py:582); `group=None` means every free variable not claimed by
    another group."""

    def __init__(self, group=None, vfam="mean_field", params=None, model=None, **kwargs):
        self.group = group
        self.vfam = str(vfam).lower().replace("-", "_")
        if self.vfam not in _FAMILIES:
            raise ValueError(f"Unknown vfam {vfam!r}; choose from {sorted(_FAMILIES)}")
        self.params = params
        self.kwargs = kwargs
        self._model = model

    def __class_getitem__(cls, item):
        return cls

    def __repr__(self):
        names = ("all free RVs" if self.group is None
                 else [getattr(v, "name", v) for v in self.group])
        return f"Group({names}, vfam={self.vfam!r})"


def _group_indices(model, info, groups):
    """Each Group's variables as flat-space index arrays; a Group(None)
    takes every latent no other group claims."""
    slices = info.slices()
    by_name = {rv.name: rv.value_name for rv in model.free_RVs}
    claimed = set()
    resolved = []
    rest_pos = None
    for g in groups:
        if g.group is None:
            if rest_pos is not None:
                raise ValueError("only one Group(None) rest-group is allowed")
            rest_pos = len(resolved)
            resolved.append(None)
            continue
        idx = []
        for v in g.group:
            name = getattr(v, "name", str(v))
            if name not in by_name:
                raise ValueError(
                    f"{name!r} is not a free variable of the model (free: {sorted(by_name)})"
                )
            if name in claimed:
                raise ValueError(f"{name!r} appears in more than one group")
            claimed.add(name)
            sl = slices[by_name[name]]
            idx.append(np.arange(sl.start, sl.stop))
        resolved.append(np.concatenate(idx) if idx else np.zeros(0, int))
    if rest_pos is not None:
        rest = [np.arange(slices[vn].start, slices[vn].stop)
                for n, vn in by_name.items() if n not in claimed]
        resolved[rest_pos] = np.concatenate(rest) if rest else np.zeros(0, int)
    return resolved


def Approximation(groups, model=None, device=None):
    """The approximation `groups` select (reference opvi.py:1237), with its
    initial parameters on `device` (default: the card)."""
    model = modelcontext(model)
    groups = list(groups)
    info = model.raveled_info()
    D = info.total_size
    device = resolve_device(device)
    dtype = floatX(device)
    if len(groups) == 1 and groups[0].group is None:
        g = groups[0]
        cls = _FAMILIES[g.vfam]
        if cls is Empirical:
            raise NotImplementedError("Empirical groups: build pm.Empirical from draws directly")
        return cls(model, info, cls.init_params(D, device=device, dtype=dtype, **g.kwargs))
    families = []
    for g in groups:
        cls = _FAMILIES[g.vfam]
        if cls is Empirical:
            raise NotImplementedError(
                "Empirical members of a heterogeneous Approximation are not supported (no "
                "density for the ELBO); use SVGD directly"
            )
        families.append(cls)
    blocked_cls = Blocked.make(families, _group_indices(model, info, groups), D)
    params = blocked_cls.init_params(D, group_kwargs=[g.kwargs for g in groups], device=device,
                                     dtype=dtype)
    return blocked_cls(model, info, params)


def sample_approx(approx, draws=100, include_transformed=True, random_seed=None):
    """Draws from a fitted approximation (reference
    approximations.py:sample_approx)."""
    if not hasattr(approx, "sample"):
        raise TypeError(f"{type(approx).__name__} is not an Approximation")
    return approx.sample(draws=draws, random_seed=random_seed)
