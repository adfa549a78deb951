"""Pointwise log densities over a posterior.

Counterpart of `pymc_tpu/stats/log_density.py` (compute_log_likelihood :31,
compute_log_prior :80; reference pymc/stats/log_density.py). Each observed
(or free) variable's elementwise logp is evaluated at every draw on the
device, `sampling.forward.POSTERIOR_CHUNK` draws at a time under
`torch.func.vmap`, where the JAX package maps all C·S draws in one
`jax.vmap` (:60, :90). A multivariate likelihood factors the covariance of
every draw of a chunk in one launch: an MvNormal goes through
`cholesky_batched`'s vmap rule, one Cholesky kernel launch a chunk on the
card.
"""

from __future__ import annotations

from ..backends.arviz import dataset_from_draws
from ..config import resolve_device
from ..model.core import modelcontext
from ..sampling.forward import map_over_posterior, posterior_rows

__all__ = ["compute_log_likelihood", "compute_log_prior"]


def _pointwise(idata, model, rvs, group, value_of, extend_inferencedata, device):
    """{rv name: (chain, draw, *shape) elementwise logp} of `rvs`, each at
    value_of(rv, env, memo), as the Dataset `group` (added to idata with
    extend_inferencedata, which is then returned)."""
    device = resolve_device(device)
    rows, cs = posterior_rows(idata.posterior, [rv.name for rv in model.free_RVs])
    placed = model.placed_constants(device)

    def fn(env):
        memo = dict(placed)
        return {rv.name: rv.dist.logp(value_of(rv, env, memo), env, memo) for rv in rvs}

    ds = dataset_from_draws(model, map_over_posterior(fn, rows, cs, device))
    if extend_inferencedata:
        idata.add_group(group, ds)
        return idata
    return ds


def compute_log_likelihood(idata, *, var_names=None, extend_inferencedata=True, model=None,
                           sample_dims=("chain", "draw"), progressbar=True, compile_kwargs=None,
                           device=None):
    """Elementwise log-likelihood of each observed variable (those
    `var_names` names, default all) at every posterior draw, evaluated on
    `device` (default: the card): the `log_likelihood` group (reference
    log_density.py:31)."""
    model = modelcontext(model)
    if var_names is not None:
        bad = set(var_names) - {orv.name for orv in model.observed_RVs}
        if bad:
            raise ValueError(
                f"var_names must refer to observed_RVs in the model. Got: {sorted(bad)}"
            )
    obs = [orv for orv in model.observed_RVs if var_names is None or orv.name in set(var_names)]
    return _pointwise(idata, model, obs, "log_likelihood", lambda rv, env, memo: rv._eval(env, memo),
                      extend_inferencedata, device)


def compute_log_prior(idata, *, var_names=None, extend_inferencedata=True, model=None,
                      sample_dims=("chain", "draw"), progressbar=True, compile_kwargs=None,
                      device=None):
    """Elementwise prior log-density of each free variable (those
    `var_names` names, default all) at every posterior draw, evaluated on
    `device` (default: the card): the `log_prior` group (reference
    log_density.py:80)."""
    model = modelcontext(model)
    rvs = [rv for rv in model.free_RVs if var_names is None or rv.name in set(var_names)]
    return _pointwise(idata, model, rvs, "log_prior", lambda rv, env, memo: env[rv.name],
                      extend_inferencedata, device)
