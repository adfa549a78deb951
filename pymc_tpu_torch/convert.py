"""Carry state across from numpy to the port's tensors.

The JAX package's values reach the port as numpy arrays (`np.asarray` of a
jax array); these helpers put them on a device in a float type, so both
packages can run from the same state.
"""

from __future__ import annotations

import numpy as np
import torch

from .sampling.adaptation import DualAveragingState, WelfordState
from .sampling.nuts import SamplerState

__all__ = ["tensor_from_numpy", "point_from_numpy", "sampler_state_from_numpy"]

_STATE_TYPES = (SamplerState, DualAveragingState, WelfordState)


def tensor_from_numpy(x, device=None, dtype=torch.float64):
    """A numpy array as a tensor on `device`; floats become `dtype`,
    integers and booleans keep their type."""
    arr = np.asarray(x)
    t = torch.tensor(arr, device=device)
    return t.to(dtype) if arr.dtype.kind == "f" else t


def point_from_numpy(point, device=None, dtype=torch.float64):
    """{value_name: array} (as `pymc_tpu` gives it) -> {value_name: tensor}."""
    return {k: tensor_from_numpy(v, device, dtype) for k, v in point.items()}


def sampler_state_from_numpy(state, device=None, dtype=torch.float64):
    """A NamedTuple of numpy arrays -> the port's NamedTuple of the same
    fields: SamplerState (q, logp, grad, inv_mass, step_size),
    DualAveragingState or WelfordState."""
    fields = getattr(state, "_fields", None)
    for cls in _STATE_TYPES:
        if fields == cls._fields:
            return cls(*[tensor_from_numpy(v, device, dtype) for v in state])
    raise TypeError(
        f"no port state with fields {fields}; expected one of "
        f"{[c._fields for c in _STATE_TYPES]}"
    )
