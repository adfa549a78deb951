"""Conversion of sampler output to InferenceData.

Counterpart of `pymc_tpu/backends/arviz.py::to_inference_data` (:52;
reference pymc/backends/arviz.py:613): the posterior, sample_stats, prior,
prior_predictive, posterior_predictive and predictions groups with the
model's dims and coords, and the observed data; and the `var_names` subset
of the posterior (`pymc_tpu/sampling/mcmc.py:977-985`).
"""

from __future__ import annotations

import logging

import numpy as np

from .inference_data import DataVar, Dataset, InferenceData

__all__ = ["select_var_names", "to_inference_data"]

_log = logging.getLogger("pymc_tpu_torch")


def select_var_names(available, var_names):
    """The names of `available` (in its order) that `var_names` asks for;
    names it asks for that are not there are warned about and left out."""
    wanted = set(var_names)
    known = set(available)
    unknown = wanted - known
    if unknown:
        _log.warning(
            f"var_names {sorted(unknown)} not found in the model "
            f"(available: {sorted(known)}); they will be omitted"
        )
    return [n for n in available if n in wanted]


def _var_dims(model, name, trailing_shape):
    """Named dims for a variable's trailing axes (`<name>_dim_<i>` where the
    model has none)."""
    dims = getattr(model.named_vars.get(name), "dims", None)
    return tuple(
        dims[i] if dims is not None and i < len(dims) and dims[i] is not None
        else f"{name}_dim_{i}"
        for i in range(len(trailing_shape))
    )


def _dataset(model, draws, coords):
    """{name: (chain, draw, *shape)} -> Dataset with the model's dims."""
    return Dataset(
        {
            name: DataVar(
                name, arr, ("chain", "draw") + _var_dims(model, name, arr.shape[2:]), coords
            )
            for name, arr in draws.items()
        },
        coords,
    )


def to_inference_data(model, posterior=None, sample_stats=None, attrs=None, prior=None,
                      prior_predictive=None, posterior_predictive=None, predictions=None):
    """posterior, prior, prior_predictive, posterior_predictive, predictions:
    {name: (chain, draw, *shape)}; sample_stats: {name: (chain, draw)} ->
    InferenceData with those groups (each one given) and the observed data."""
    coords = {k: np.asarray(v) for k, v in model.coords.items()}
    idata = InferenceData()

    if posterior is not None:
        post = _dataset(model, posterior, coords)
        post.attrs.update(attrs or {})
        idata.add_group("posterior", post)

    if sample_stats is not None:
        stats = Dataset(
            {k: DataVar(k, np.asarray(v), ("chain", "draw"), coords)
             for k, v in sample_stats.items()},
            coords,
        )
        stats.attrs.update(attrs or {})
        idata.add_group("sample_stats", stats)

    for group, draws in (("prior", prior), ("prior_predictive", prior_predictive),
                         ("posterior_predictive", posterior_predictive),
                         ("predictions", predictions)):
        if draws is not None:
            idata.add_group(group, _dataset(model, draws, coords))

    obs = {}
    for orv in model.observed_RVs:
        arr = orv.observed.value.numpy()
        obs[orv.name] = DataVar(orv.name, arr, _var_dims(model, orv.name, arr.shape), coords)
    if obs:
        idata.add_group("observed_data", Dataset(obs, coords))
    return idata
