"""Conversion of sampler output to InferenceData.

Counterpart of `pymc_tpu/backends/arviz.py::to_inference_data` (:52;
reference pymc/backends/arviz.py:613): the posterior and sample_stats
groups with the model's dims and coords, and the observed data.
"""

from __future__ import annotations

import numpy as np

from .inference_data import DataVar, Dataset, InferenceData

__all__ = ["to_inference_data"]


def _var_dims(model, name, trailing_shape):
    """Named dims for a variable's trailing axes (`<name>_dim_<i>` where the
    model has none)."""
    dims = getattr(model.named_vars.get(name), "dims", None)
    return tuple(
        dims[i] if dims is not None and i < len(dims) and dims[i] is not None
        else f"{name}_dim_{i}"
        for i in range(len(trailing_shape))
    )


def to_inference_data(model, posterior, sample_stats, attrs=None):
    """posterior: {name: (chain, draw, *shape)}; sample_stats:
    {name: (chain, draw)} -> InferenceData."""
    coords = {k: np.asarray(v) for k, v in model.coords.items()}
    idata = InferenceData()

    post = Dataset(
        {
            name: DataVar(
                name, arr, ("chain", "draw") + _var_dims(model, name, arr.shape[2:]),
                coords,
            )
            for name, arr in posterior.items()
        },
        coords,
    )
    post.attrs.update(attrs or {})
    idata.add_group("posterior", post)

    stats = Dataset(
        {k: DataVar(k, np.asarray(v), ("chain", "draw"), coords) for k, v in sample_stats.items()},
        coords,
    )
    stats.attrs.update(attrs or {})
    idata.add_group("sample_stats", stats)

    obs = {}
    for orv in model.observed_RVs:
        arr = orv.observed.value.numpy()
        obs[orv.name] = DataVar(orv.name, arr, _var_dims(model, orv.name, arr.shape), coords)
    if obs:
        idata.add_group("observed_data", Dataset(obs, coords))
    return idata
