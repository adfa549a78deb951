"""Conversion of sampler output to InferenceData.

Counterpart of `pymc_tpu/backends/arviz.py` (`dataset_from_draws` :41,
`to_inference_data` :52-134, `predictions_to_inference_data` :137;
reference pymc/backends/arviz.py:613): the posterior, sample_stats, warmup,
prior, prior_predictive, posterior_predictive, predictions and
log_likelihood groups with the model's dims and coords, and the observed
data; and the `var_names` subset of the posterior
(`pymc_tpu/sampling/mcmc.py:977-985`). The constant_data group
(`pymc_tpu/backends/arviz.py:113-127`) waits for the Data containers of
`data.py` (the ROADMAP item on model transforms and data): the port's
models hold no Data node yet.
"""

from __future__ import annotations

import logging

import numpy as np

from .inference_data import DataVar, Dataset, InferenceData

__all__ = ["select_var_names", "to_inference_data", "dataset_from_draws",
           "predictions_to_inference_data"]

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


def dataset_from_draws(model, draws, coords=None, sample_dims=("chain", "draw")):
    """draws {name: (*sample_dims, *shape)} -> Dataset with the model's dims
    (`pymc_tpu/backends/arviz.py:41`)."""
    coords = dict(coords or {})
    variables = {}
    for name, arr in draws.items():
        arr = np.asarray(arr)
        dims = tuple(sample_dims) + _var_dims(model, name, arr.shape[len(sample_dims):])
        variables[name] = DataVar(name, arr, dims, coords)
    return Dataset(variables, coords)


def to_inference_data(model, posterior=None, sample_stats=None, warmup_groups=None, prior=None,
                      prior_predictive=None, posterior_predictive=None, attrs=None,
                      include_log_likelihood=False, predictions=None, device=None):
    """posterior, prior, prior_predictive, posterior_predictive, predictions:
    {name: (chain, draw, *shape)}; sample_stats: {name: (chain, draw)};
    warmup_groups: {"warmup_posterior": draws, "warmup_sample_stats":
    stats} -> InferenceData with those groups (each one given) and the
    observed data. include_log_likelihood adds the log_likelihood group,
    evaluated from the posterior on `device` (default: the card;
    stats/log_density.py)."""
    coords = {k: np.asarray(v) for k, v in model.coords.items()}
    idata = InferenceData()

    def stats_dataset(stats):
        return Dataset(
            {k: DataVar(k, np.asarray(v), ("chain", "draw"), coords) for k, v in stats.items()},
            coords,
        )

    if posterior is not None:
        post = dataset_from_draws(model, posterior, coords)
        post.attrs.update(attrs or {})
        idata.add_group("posterior", post)

    if sample_stats is not None:
        stats = stats_dataset(sample_stats)
        stats.attrs.update(attrs or {})
        idata.add_group("sample_stats", stats)

    for group, draws in (warmup_groups or {}).items():
        idata.add_group(group, stats_dataset(draws) if group.endswith("sample_stats")
                        else dataset_from_draws(model, draws, coords))

    for group, draws in (("prior", prior), ("prior_predictive", prior_predictive),
                         ("posterior_predictive", posterior_predictive),
                         ("predictions", predictions)):
        if draws is not None:
            idata.add_group(group, dataset_from_draws(model, draws, coords))

    obs = {}
    for orv in model.observed_RVs:
        arr = orv.observed.value.numpy()
        obs[orv.name] = DataVar(orv.name, arr, _var_dims(model, orv.name, arr.shape), coords)
    if obs:
        idata.add_group("observed_data", Dataset(obs, coords))

    if include_log_likelihood and posterior is not None:
        from ..stats.log_density import compute_log_likelihood

        compute_log_likelihood(idata, model=model, extend_inferencedata=True, device=device)
    return idata


def predictions_to_inference_data(predictions, posterior_trace=None, model=None, coords=None,
                                  dims=None, idata_orig=None, inplace=False):
    """Out-of-sample draws {name: (chain, draw, ...)} as the `predictions`
    group (`pymc_tpu/backends/arviz.py:137`): of a new InferenceData, of a
    copy of `idata_orig`, or of `idata_orig` itself with inplace=True."""
    from ..model.core import modelcontext

    model = modelcontext(model)
    ds = dataset_from_draws(model, {k: np.asarray(v) for k, v in predictions.items()})
    if idata_orig is None:
        idata = InferenceData()
    elif inplace:
        idata = idata_orig
    else:
        idata = InferenceData()
        for g in idata_orig.groups():
            idata.add_group(g, getattr(idata_orig, g))
    idata.add_group("predictions", ds)
    return idata
