"""Forward sampling: prior and posterior predictive, and functions of a
posterior.

Counterpart of `pymc_tpu/sampling/forward.py` (`_generative_fn` :46-110,
`sample_prior_predictive` :138-168, `sample_posterior_predictive`
:171-357, `compute_deterministics` :360, `vectorize_over_posterior` :403,
`compile_forward_sampling_function` :524; reference
pymc/sampling/forward.py:485, :607 and the volatility analysis of
compile_forward_sampling_function, :262). One generative pass
over the model's graph in registration order, mapped over the draws with
`torch.func.vmap(..., randomness="different")`: every draw gets its own
random numbers from the one generator, and `cholesky_batched`'s vmap rule
factors a matrix of every draw in one launch. The pass computes only what
the requested variables need, and nothing above a value the trace gives.

A function of every posterior draw (deterministics, log densities,
`vectorize_over_posterior`) is mapped over the flattened draws with
`torch.func.vmap` on the device, POSTERIOR_CHUNK rows at a time, where the
JAX package maps all C·S draws at once.
"""

from __future__ import annotations

import logging
import warnings

import numpy as np
import torch

from ..backends.arviz import dataset_from_draws, to_inference_data
from ..config import floatX, resolve_device
from ..exceptions import ImplicitFreezeWarning
from ..graph import FreeRV, ObservedRV, _parents, ancestors, evaluate, place_constants
from ..model.core import modelcontext

__all__ = ["sample_prior_predictive", "sample_posterior_predictive", "compute_deterministics",
           "vectorize_over_posterior", "compile_forward_sampling_function", "draw_rv",
           "rv_order", "posterior_rows", "map_over_posterior"]

_log = logging.getLogger("pymc_tpu_torch")

# rows of a flattened posterior evaluated at once on the device: a density
# that builds a matrix a draw (the marginal GP's (150, 150) covariance) holds
# 4096 of them, 369 MB in float32
POSTERIOR_CHUNK = 4096


def _generative_fn(model, device=None, dtype=None, given_names=(), given_det_names=(),
                   outputs=None):
    """fn(generator, given=None) -> {name: value}: one draw of every free RV
    not in `given`, of every observed RV at its data's shape, and every
    deterministic.

    A free RV in `given` (or named in `given_names`) takes its value from
    there; a deterministic named in `given_det_names` too, and every node
    downstream of it sees that value (the reference's freeze_vars). With
    `outputs` (names), fn computes and returns only those variables and what
    they need. The RVs are drawn in registration order, each from its
    distribution with its parents' values of this draw; the constants are
    placed once on `device` (default: the card) in `dtype` (default:
    `floatX(device)`), and `generator` lives there. Under
    `torch.func.vmap(..., randomness="different")` every point of the batch
    gets its own draws.
    """
    placed = model.placed_constants(device, dtype)
    reg_order = {name: i for i, name in enumerate(model.named_vars)}
    plan = sorted(
        [(True, rv) for rv in model.free_RVs] + [(False, rv) for rv in model.observed_RVs],
        key=lambda t: reg_order[t[1].name],
    )
    deterministics = list(model.deterministics)
    given_names, given_det_names = set(given_names), set(given_det_names)
    given_dets = [d for d in deterministics if d.name in given_det_names]
    if outputs is not None:
        stop = {id(rv) for _, rv in plan if rv.name in given_names}
        stop |= {id(d) for d in given_dets}
        needed = {id(n) for n in ancestors([model.named_vars[o] for o in outputs], stop)}
        plan = [(free, rv) for free, rv in plan if id(rv) in needed]
        deterministics = [d for d in deterministics if d.name in set(outputs)]

    def fn(generator, given=None):
        given = given or {}
        env = {}
        memo = dict(placed)
        out = {}
        for det in given_dets:
            memo[id(det)] = env[det.name] = out[det.name] = given[det.name]
        for free, rv in plan:
            env[rv.name] = (given[rv.name] if free and rv.name in given
                            else draw_rv(rv, generator, env, memo))
            out[rv.name] = env[rv.name]
        for det in deterministics:
            if det.name not in given_det_names:
                out[det.name] = evaluate(det, env, memo)
        return out if outputs is None else {k: out[k] for k in outputs}

    return fn


def draw_rv(rv, generator, env, memo):
    """One draw of the random variable `rv` from `generator`, its parents'
    values in `env`; an observed RV is drawn at its data's shape."""
    if not isinstance(rv, ObservedRV):
        return rv.dist.sample(generator, (), env, memo)
    target = tuple(rv.shape)
    n = len(rv.dist.shape)
    extra = target[: len(target) - n] if n <= len(target) else ()
    return torch.broadcast_to(rv.dist.sample(generator, extra, env, memo), target)


def _generator(random_seed, device):
    seed = (int(np.random.default_rng().integers(2**30)) if random_seed is None
            else int(random_seed))
    return torch.Generator(device=device).manual_seed(seed)


def _to_numpy(out, shape):
    """{name: (N, ...) tensor} -> {name: shape + (...) float/int numpy}."""
    return {k: v.detach().cpu().numpy().reshape(shape + tuple(v.shape[1:]))
            for k, v in out.items()}


def _wanted(model, var_names):
    if var_names is None:
        return None
    want = [var_names] if isinstance(var_names, str) else list(var_names)
    missing = [n for n in want if n not in model.named_vars]
    if missing:
        raise KeyError(f"Variables {missing} not found in model")
    return want


def sample_prior_predictive(draws=500, model=None, var_names=None, random_seed=None,
                            idata_kwargs=None, return_inferencedata=True, compile_kwargs=None,
                            samples=None, device=None):
    """Draws of every free RV, deterministic and observed RV from the prior
    (reference forward.py:485): the free RVs and deterministics go to the
    `prior` group, the observed RVs to `prior_predictive`, each with one
    chain. var_names keeps only those variables; return_inferencedata=False
    gives {name: (draws, ...)}. Runs on `device` (default: the card)."""
    model = modelcontext(model)
    if model.potentials:
        warnings.warn(
            "The effect of Potentials on other parameters is ignored during prior predictive "
            "sampling. This is likely to lead to invalid or biased predictive samples.",
            UserWarning,
        )
    if samples is not None:  # deprecated alias
        draws = samples
    device = resolve_device(device)
    gen = _generator(random_seed, device)
    want = _wanted(model, var_names)
    fn = _generative_fn(model, device, floatX(device), outputs=want)
    out = torch.func.vmap(lambda _: fn(gen), randomness="different")(
        torch.empty(draws, device=device)
    )
    out = _to_numpy(out, (1, draws))
    if not return_inferencedata:
        return {k: v[0] for k, v in out.items()}
    obs_names = {orv.name for orv in model.observed_RVs}
    prior = {k: v for k, v in out.items() if k not in obs_names}
    prior_pred = {k: v for k, v in out.items() if k in obs_names}
    return to_inference_data(model, prior=prior or None, prior_predictive=prior_pred or None)


def _ancestor_names(node):
    """Names of the named ancestors of `node` (free RVs, named
    deterministics), the node itself left out."""
    return {a.name for a in ancestors([node])
            if a is not node and getattr(a, "name", None) is not None}


def _observed_dependent_deterministics(model):
    """Deterministics that depend on an observed RV: with the observed RVs,
    the default outputs of posterior predictive sampling."""
    return [d.name for d in model.deterministics
            if any(isinstance(a, ObservedRV) for a in ancestors([d]))]


def _posterior_arrays(trace):
    """{name: (chain, draw, ...) numpy} from an InferenceData, a Dataset, a
    dict of arrays, or a list of points (one chain)."""
    post = trace.posterior if hasattr(trace, "posterior") else trace
    if isinstance(post, (list, tuple)):
        names = set().union(*(p.keys() for p in post)) if post else set()
        return {n: np.stack([np.asarray(p[n]) for p in post])[None] for n in names}
    return {n: np.asarray(getattr(post[n], "values", post[n])) for n in post.keys()}


def _warn_implicit_freeze(model, given_names, freeze_set, sample_set, missing):
    """Warn about trace RVs kept although an ancestor is resampled."""
    seeds = sample_set | set(missing)
    flagged = {}
    for rv in model.free_RVs:
        if rv.name not in given_names or rv.name in freeze_set:
            continue
        hit = _ancestor_names(rv) & seeds
        if hit:
            flagged[rv.name] = sorted(hit)
    if flagged:
        reasons = "; ".join(
            f"{name} (volatile inputs {hit}: an ancestor is resampled)"
            for name, hit in flagged.items()
        )
        warnings.warn(
            f"These trace variables were implicitly frozen at their trace values: {reasons}. "
            "Add them to sample_vars to resample, or to freeze_vars to silence this warning.",
            ImplicitFreezeWarning,
            stacklevel=3,
        )


def sample_posterior_predictive(trace, model=None, var_names=None, sample_vars=None,
                                freeze_vars=None, random_seed=None, progressbar=True,
                                return_inferencedata=True, extend_inferencedata=False,
                                predictions=False, idata_kwargs=None, compile_kwargs=None,
                                sample_dims=None, device=None):
    """Draws from the posterior predictive, one for each draw of the trace
    (reference forward.py:607, pymc_tpu/sampling/forward.py:171-357):

    - free RVs present in the trace are taken from it; missing free RVs and
      the observed RVs are drawn anew;
    - `sample_vars`: RVs or deterministics to draw (or recompute) instead of
      taking them from the trace; their descendants become volatile too;
    - `freeze_vars`: trace variables kept at their trace values; for a
      deterministic this stops its recomputation, for an RV it silences the
      ImplicitFreezeWarning;
    - a trace RV kept while an ancestor is drawn anew warns with
      ImplicitFreezeWarning;
    - `var_names` picks the outputs; by default `sample_vars` when given,
      else the observed RVs and the deterministics that depend on them.

    The result is the `posterior_predictive` group (`predictions` with
    predictions=True), or {name: (chain, draw, ...)} with
    return_inferencedata=False; extend_inferencedata adds the group to
    `trace`. Runs on `device` (default: the card) in its float type. A
    trace with constant data raises: the Data containers whose change would
    make their descendants volatile are not ported.
    """
    model = modelcontext(model)
    if model.potentials:
        warnings.warn(
            "The effect of Potentials on other parameters is ignored during posterior "
            "predictive sampling. This is likely to lead to invalid or biased predictive "
            "samples.",
            UserWarning,
        )
    if hasattr(trace, "groups") and "constant_data" in trace.groups() and len(
        trace.constant_data
    ):
        raise NotImplementedError(
            "sample_posterior_predictive: a trace with constant_data needs the Data "
            "containers of pymc_tpu/data.py, which are not ported"
        )
    if isinstance(sample_vars, str):
        sample_vars = [sample_vars]
    if isinstance(freeze_vars, str):
        freeze_vars = [freeze_vars]
    sample_set, freeze_set = set(sample_vars or ()), set(freeze_vars or ())
    overlap = sample_set & freeze_set
    if overlap:
        raise ValueError(
            f"Variables {sorted(overlap)} cannot be in both sample_vars and freeze_vars"
        )
    free_names = {rv.name for rv in model.free_RVs}
    det_names = {d.name for d in model.deterministics}
    bad = sorted(sample_set - free_names - det_names)
    if bad:
        raise ValueError(
            f"sample_vars entries {bad} are not random variables or deterministics of the model"
        )

    post = _posterior_arrays(trace)
    traced = {rv.name: post[rv.name] for rv in model.free_RVs if rv.name in post}
    if not traced:
        raise ValueError("No free RV draws found in the posterior trace")
    C, D = next(iter(traced.values())).shape[:2]
    not_in_trace = sorted(n for n in freeze_set if n not in post)
    if not_in_trace:
        raise ValueError(f"freeze_vars {not_in_trace} not present in the trace")

    # volatility (reference forward.py:262): what is drawn anew, and what
    # of the trace stays
    missing = [rv.name for rv in model.free_RVs if rv.name not in traced]
    given_names = [n for n in traced if n not in sample_set]
    _warn_implicit_freeze(model, given_names, freeze_set, sample_set, missing)
    seeds = sample_set | set(missing)
    det_given = [
        d.name for d in model.deterministics
        if d.name in post and d.name not in sample_set
        and (d.name in freeze_set or not (_ancestor_names(d) & seeds))
    ]
    if missing:
        _log.info(f"Resampling free RVs not in trace: {missing}")

    if var_names is not None:
        want = _wanted(model, var_names)
    elif sample_set:
        want = sorted(sample_set)
    else:
        want = [o.name for o in model.observed_RVs] + _observed_dependent_deterministics(model)

    device = resolve_device(device)
    dtype = floatX(device)
    gen = _generator(random_seed, device)
    fn = _generative_fn(model, device, dtype, given_names=given_names,
                        given_det_names=det_given, outputs=want)
    flat = {
        n: torch.as_tensor(post[n].reshape((C * D,) + post[n].shape[2:]), device=device)
        for n in given_names + det_given
    }
    flat = {n: v.to(dtype) if v.is_floating_point() else v for n, v in flat.items()}
    out = torch.func.vmap(lambda _, g: fn(gen, g), randomness="different")(
        torch.empty(C * D, device=device), flat
    )
    result = _to_numpy(out, (C, D))
    if not return_inferencedata:
        return result
    group = "predictions" if predictions else "posterior_predictive"
    idata = to_inference_data(model, **{group: result})
    if extend_inferencedata and hasattr(trace, "extend"):
        trace.extend(idata, join="left")
        return trace
    return idata


def posterior_rows(posterior, names):
    """({name: (C*S, ...) numpy}, (C, S)) of the variables `names` that
    `posterior` (a Dataset or a dict of (chain, draw, ...) arrays) holds."""
    rows, cs = {}, None
    for name in names:
        if name in posterior:
            vals = np.asarray(getattr(posterior[name], "values", posterior[name]))
            cs = vals.shape[:2]
            rows[name] = vals.reshape((cs[0] * cs[1],) + vals.shape[2:])
    return rows, cs


def map_over_posterior(fn, rows, shape, device, dtype=None, chunk=None, randomness="error"):
    """fn(row) -> a tensor, or a dict, list or tuple of them, vmapped over
    the rows of `rows` ({name: (N, ...) numpy}, floats cast to `dtype`,
    default `floatX(device)`) on `device`, `chunk` rows (default
    POSTERIOR_CHUNK) at a time; returns the same structure of numpy arrays,
    their N rows reshaped to `shape` (the posterior's (chain, draw))."""
    from torch.utils._pytree import tree_flatten, tree_unflatten

    dtype = dtype or floatX(device)
    chunk = chunk or POSTERIOR_CHUNK
    n = len(next(iter(rows.values())))
    batched = torch.func.vmap(fn, randomness=randomness)
    parts, spec = [], None
    for i in range(0, n, chunk):
        block = {}
        for k, v in rows.items():
            t = torch.as_tensor(v[i : i + chunk], device=device)
            block[k] = t.to(dtype) if t.is_floating_point() else t
        leaves, spec = tree_flatten(batched(block))
        parts.append([leaf.detach().cpu() for leaf in leaves])
    joined = [torch.cat(p).numpy() for p in zip(*parts)]
    return tree_unflatten([v.reshape(tuple(shape) + v.shape[1:]) for v in joined], spec)


def compute_deterministics(idata, *, var_names=None, model=None, sample_dims=("chain", "draw"),
                           merge_dataset=False, progressbar=True, compile_kwargs=None,
                           device=None):
    """The model's deterministics (those `var_names` names, default all)
    recomputed from a posterior's free RVs on `device` (default: the card),
    as a Dataset; with merge_dataset they are written into the posterior,
    which is returned (`pymc_tpu/sampling/forward.py:360`; reference
    sampling/deterministic.py:53)."""
    model = modelcontext(model)
    device = resolve_device(device)
    post = idata.posterior if hasattr(idata, "posterior") else idata
    dets = [d for d in model.deterministics if var_names is None or d.name in set(var_names)]
    rows, cs = posterior_rows(post, [rv.name for rv in model.free_RVs])
    placed = model.placed_constants(device)

    def fn(env):
        memo = dict(placed)
        return {d.name: evaluate(d, env, memo) for d in dets}

    ds = dataset_from_draws(model, map_over_posterior(fn, rows, cs, device))
    if merge_dataset and hasattr(idata, "posterior"):
        for k, v in ds.items():
            idata.posterior[k] = v
        return idata.posterior
    return ds


def rv_order(rvs, satisfied=()):
    """`rvs` in an order in which each comes after the random variables it
    depends on (names in `satisfied` count as given)."""
    satisfied = set(satisfied)
    deps = {
        id(rv): [a for a in ancestors(_parents(rv))
                 if isinstance(a, (FreeRV, ObservedRV)) and a is not rv]
        for rv in rvs
    }
    order, placed = [], set()
    while len(order) < len(rvs):
        ready = [rv for rv in rvs if id(rv) not in placed
                 and all(id(d) in placed or d.name in satisfied for d in deps[id(rv)])]
        if not ready:  # pragma: no cover - a model is a DAG by construction
            raise RuntimeError("cyclic random-variable dependencies")
        order += ready
        placed.update(id(rv) for rv in ready)
    return order


def vectorize_over_posterior(fn=None, idata=None, model=None, *, outputs=None, posterior=None,
                             input_rvs=None, allow_rvs_in_graph=True, random_seed=None,
                             device=None):
    """Apply a computation to every posterior draw on `device` (default:
    the card; `pymc_tpu/sampling/forward.py:403`, reference
    forward.py:1337).

    - `vectorize_over_posterior(fn, idata)`: fn({free RV name: value}) ->
      a tensor or a dict, list or tuple of them, vmapped over the
      flattened (chain, draw) posterior; the same structure of (chain,
      draw, ...) numpy arrays comes back.
    - `vectorize_over_posterior(outputs=[nodes], posterior=ds,
      input_rvs=[rvs])`: each output evaluated at every draw with
      `input_rvs` taken from `posterior`; every other random variable the
      outputs reach is drawn anew for each draw (from a generator seeded
      by `random_seed`) when allow_rvs_in_graph, else RuntimeError.
      Returns a list of (chain, draw, ...) arrays.
    """
    device = resolve_device(device)
    if outputs is not None:
        return _vectorize_outputs(outputs, posterior, list(input_rvs or []), allow_rvs_in_graph,
                                  random_seed, device)
    model = modelcontext(model)
    rows, cs = posterior_rows(idata.posterior, [rv.name for rv in model.free_RVs])
    return map_over_posterior(fn, rows, cs, device)


def _vectorize_outputs(outputs, posterior, input_rvs, allow_rvs_in_graph, random_seed, device):
    input_names = [rv.name for rv in input_rvs]
    if input_names:
        rows, cs = posterior_rows(posterior, input_names)
    else:
        names = list(getattr(posterior, "data_vars", posterior))
        _, cs = posterior_rows(posterior, names[:1])
        rows = {"_": np.zeros(cs[0] * cs[1])}
    volatile = [rv for rv in ancestors(outputs)
                if isinstance(rv, (FreeRV, ObservedRV)) and rv.name not in set(input_names)]
    if volatile and not allow_rvs_in_graph:
        raise RuntimeError(
            "The following random variables found in the extracted graph would be resampled: "
            f"{[rv.name or '<anonymous>' for rv in volatile]} (pass allow_rvs_in_graph=True or "
            "list them in input_rvs)"
        )
    order = rv_order(volatile, input_names)
    placed = place_constants(list(outputs), device, floatX(device))
    gen = _generator(random_seed, device)

    def one(given):
        env = {k: v for k, v in given.items() if k != "_"}
        memo = dict(placed)
        for rv in order:
            env[rv.name] = memo[id(rv)] = draw_rv(rv, gen, env, memo)
        return [evaluate(o, env, memo) for o in outputs]

    return map_over_posterior(one, rows, cs, device, randomness="different")


def compile_forward_sampling_function(outputs=None, vars_in_trace=None, model=None, device=None,
                                      **kwargs):
    """A generative sampler over the model (`pymc_tpu/sampling/
    forward.py:524`): (fn, volatile_names), where fn(generator,
    given_values=None) -> {name: tensor} draws every variable `outputs`
    names (default: all) once; the free RVs named in `vars_in_trace` take
    their values from `given_values`, and the rest (the volatile set,
    observed RVs included) are drawn anew from `generator` (a
    torch.Generator on `device`, default the card). fn may be vmapped with
    randomness="different" for a batch of draws."""
    model = modelcontext(model)
    device = resolve_device(device)
    given = [getattr(v, "name", str(v)) for v in (vars_in_trace or [])]
    want = None if outputs is None else [getattr(o, "name", str(o)) for o in outputs]
    fn = _generative_fn(model, device, floatX(device), given_names=given, outputs=want)
    volatile = ([rv.name for rv in model.free_RVs if rv.name not in set(given)]
                + [orv.name for orv in model.observed_RVs])
    dtype = floatX(device)

    def sampler(generator, given_values=None):
        given_values = {k: torch.as_tensor(v, device=device) for k, v in (given_values or {}).items()}
        return fn(generator, {k: v.to(dtype) if v.is_floating_point() else v
                              for k, v in given_values.items()})

    return sampler, volatile
