"""The Model context — the user-facing model-building layer.

Counterpart of `pymc_tpu/model/core.py` (reference pymc/model/core.py:
Model:1647, register_rv:1907, logp:612, Deterministic:2467). The model is a
static DAG of graph Nodes; its joint log-density is a function
{value_name: unconstrained tensor} -> scalar tensor. The sampler-facing
density `logp_dlogp_fn` maps a (C, D) batch of flat points to
(logp (C,), grad (C, D)) through `torch.func.vmap(torch.func.grad_and_value)`
of the per-point logp, so the graph keeps its per-point semantics.
"""

from __future__ import annotations

import threading
import warnings

import numpy as np
import torch

from ..blocking import RaveledInfo, unravel_vector
from ..config import floatX, intX, resolve_device
from ..distributions.distribution import (
    UNSET,
    _PartialObservedJoint,
    _PartialObservedSlots,
    _scatter_positions,
    scatter_missing,
)
from ..distributions.transforms import ChainedTransform
from ..exceptions import ImputationWarning
from ..ops.cuda_graph import GraphedFunction
from ..graph import (
    ConstantNode,
    DeterministicNode,
    FreeRV,
    ObservedRV,
    ancestors,
    as_node,
    place_constants,
)

__all__ = ["Model", "modelcontext", "Deterministic", "Potential"]


class _ContextStack(threading.local):
    def __init__(self):
        self.stack = []


_MODEL_CONTEXT = _ContextStack()


def modelcontext(model=None):
    """Return the given model or the innermost context model."""
    if model is not None:
        return model
    return Model.get_context()


class Model:
    """Bayesian model: named random variables and deterministics with
    coords/dims bookkeeping.

        with pm.Model(coords={"g": groups}) as model:
            mu = pm.Normal("mu", 0, 1)
            y = pm.Normal("y", mu, 1.0, observed=data)
    """

    @classmethod
    def get_context(cls):
        if not _MODEL_CONTEXT.stack:
            raise TypeError(
                "No model on context stack. Define variables inside a "
                "`with pm.Model():` block, or pass model=... explicitly."
            )
        return _MODEL_CONTEXT.stack[-1]

    def __init__(self, coords=None):
        self.named_vars = {}
        self.free_RVs = []
        self.observed_RVs = []
        self.deterministics = []
        self.potentials = []
        # {rv name: initval}, in the constrained space (reference
        # Model.rvs_to_initial_values)
        self.rvs_to_initial_values = {}
        self._coords = {}
        self._dim_lengths = {}
        for name, values in (coords or {}).items():
            self.add_coord(name, values)

    def __enter__(self):
        _MODEL_CONTEXT.stack.append(self)
        return self

    def __exit__(self, *exc):
        _MODEL_CONTEXT.stack.pop()
        return False

    # ------------------------------------------------------------- coords
    @property
    def coords(self):
        return dict(self._coords)

    def add_coord(self, name, values):
        values = tuple(np.asarray(values).tolist())
        if name in self._dim_lengths and self._dim_lengths[name] != len(values):
            raise ValueError(f"Duplicate coord {name} with conflicting length")
        self._coords[name] = values
        self._dim_lengths[name] = len(values)

    def shape_from_dims(self, dims):
        dims = (dims,) if isinstance(dims, str) else tuple(dims)
        missing = [d for d in dims if d not in self._dim_lengths]
        if missing:
            raise KeyError(
                f"Unknown dimension(s) {missing}. Declare them via coords=."
            )
        return tuple(self._dim_lengths[d] for d in dims)

    # --------------------------------------------------------------- vars
    def __getitem__(self, key):
        return self.named_vars[key]

    @property
    def value_vars(self):
        return [rv.value_name for rv in self.free_RVs]

    @property
    def discrete_value_vars(self):
        """The discrete free RVs, which gradient samplers cannot move
        (pymc_tpu/model/core.py:297)."""
        return [rv for rv in self.free_RVs if rv.dist.is_discrete]

    def add_named_variable(self, var, dims=None):
        if var.name in self.named_vars:
            raise ValueError(f"Variable name {var.name} already exists.")
        if dims is not None:
            dims = (dims,) if isinstance(dims, str) else tuple(dims)
            if len(dims) != len(var.shape):
                raise ValueError(
                    f"{len(dims)} dim labels were provided for {var.name!r} "
                    f"with shape {var.shape}"
                )
            self.shape_from_dims(dims)
            var.dims = dims
        self.named_vars[var.name] = var
        return var

    def register_rv(self, dist, name, *, observed=None, dims=None, transform=UNSET,
                    default_transform=UNSET, initval=None):
        """Create a FreeRV or ObservedRV node for `dist` named `name`
        (reference model/core.py:1907, pymc_tpu/model/core.py:383-482).

        A free RV's transform is its distribution's default one
        (`default_transform=` replaces it, None disables it), with a user
        `transform=` chained once on top: ChainedTransform([base, user]).
        `transform=None` is the deprecated way to disable the default and
        warns. A discrete RV takes no transform, and a transform must treat
        at least the distribution's event dims as one block. `initval` (in
        the constrained space) replaces the support point as the initial
        value.
        """
        if observed is not None:
            # a discrete distribution keeps integer data (float data without
            # NaN is cast to int64); continuous data is float64 at build time;
            # data with NaN is imputed (pymc_tpu/model/core.py:508-517)
            arr = np.asarray(observed)
            if not (dist.is_discrete and np.issubdtype(arr.dtype, np.integer)):
                arr = arr.astype(np.float64)
                if np.isnan(arr).any():
                    return self._make_imputed(dist, name, arr, dims)
                arr = arr.astype(np.int64 if dist.is_discrete else np.float64)
            np.broadcast_shapes(arr.shape, dist.shape)
            rv = ObservedRV(name, dist, arr, model=self)
            self.observed_RVs.append(rv)
        else:
            rv = FreeRV(
                name, dist, shape=dist.shape, dtype=dist.dtype,
                transform=_resolve_transform(dist, name, transform, default_transform),
                model=self,
            )
            self.free_RVs.append(rv)
            if initval is not None:
                self.rvs_to_initial_values[name] = initval
        return self.add_named_variable(rv, dims)

    # --------------------------------------------------------- imputation
    def _make_imputed(self, dist, name, arr, dims):
        """Impute the NaN entries of observed data (pymc_tpu/model/core.py:
        538; reference PartialObservedRV): they become the free variable
        `{name}_unobserved`, the observed entries the likelihood
        `{name}_observed`, and the two together the deterministic `{name}`."""
        warnings.warn(
            f"Data in {name} contains missing values and will be "
            "automatically imputed from the sampling distribution.",
            ImputationWarning,
        )
        mask = np.isnan(arr)
        ev_n = dist.event_ndim
        if ev_n == 0:
            free, obs = self._split_imputed_univariate(dist, name, arr, mask)
        else:
            # separable when each event row is fully observed or fully
            # missing: two independent variables over the batch rows;
            # otherwise the joint density carries the slots
            trimmed = mask[(...,) + (0,) * ev_n]
            expanded = np.broadcast_to(
                np.expand_dims(trimmed, axis=tuple(range(-ev_n, 0))), mask.shape
            )
            if np.array_equal(mask, expanded):
                free, obs = self._split_imputed_separable(dist, name, arr, trimmed)
            else:
                free, obs = self._split_imputed_joint(dist, name, arr, mask)
        flat_mask, pos = _scatter_positions(mask)
        # observed entries from the data (or, in forward sampling, from the
        # resampled observed variable), missing ones from the free variable
        combined = DeterministicNode(
            lambda f, full, m, ix: scatter_missing(full, f, m, ix), (free, obs, flat_mask, pos),
            name=name,
        )
        self.deterministics.append(combined)
        return self.add_named_variable(combined, dims)

    def _add_imputed_pair(self, free, obs):
        self.free_RVs.append(free)
        self.add_named_variable(free)
        self.observed_RVs.append(obs)
        self.add_named_variable(obs)
        return free, obs

    def _split_imputed_univariate(self, dist, name, arr, mask):
        missing_idx = np.nonzero(mask.ravel())[0]
        gathered = dist._gathered((len(missing_idx),), missing_idx, arr.shape)
        free = FreeRV(
            f"{name}_unobserved", gathered, shape=gathered.shape, dtype=gathered.dtype,
            transform=gathered.default_transform(), model=self,
        )
        obs = ObservedRV(f"{name}_observed", dist, _impute_fill(arr, mask, dist.is_discrete),
                         model=self, mask=mask)
        return self._add_imputed_pair(free, obs)

    def _split_imputed_separable(self, dist, name, arr, row_mask):
        """Each event row fully observed or fully missing: the missing rows
        are a variable of their own, with the distribution's default
        transform; the observed term masks whole rows."""
        ev = tuple(dist.event_shape)
        batch_shape = arr.shape[: arr.ndim - len(ev)]
        missing_rows = np.nonzero(row_mask.ravel())[0]
        gathered = dist._gathered((len(missing_rows),), missing_rows, batch_shape,
                                  extra_event=ev)
        free = FreeRV(
            f"{name}_unobserved", gathered, shape=gathered.shape, dtype=gathered.dtype,
            transform=gathered.default_transform(), model=self,
        )
        obs = ObservedRV(
            f"{name}_observed", dist, _impute_fill(arr, np.isnan(arr), dist.is_discrete),
            model=self, mask=row_mask,
        )
        return self._add_imputed_pair(free, obs)

    def _split_imputed_joint(self, dist, name, arr, mask):
        """The mask splits event rows, so the density does not separate: the
        missing entries are transform-free slots of zero density, and the
        observed term is the joint density of the value with the slots put
        in (reference partial_observed_rv_logprob)."""
        n_missing = int(mask.sum())
        slots = _PartialObservedSlots.dist(dist, mask, shape=(n_missing,))
        free = FreeRV(f"{name}_unobserved", slots, shape=(n_missing,), dtype=slots.dtype,
                      transform=None, model=self)
        joint = _PartialObservedJoint.dist(dist, mask, free.name, shape=arr.shape)
        obs = ObservedRV(f"{name}_observed", joint, np.where(mask, 0.0, arr), model=self)
        return self._add_imputed_pair(free, obs)

    # ------------------------------------------------------------- density
    def _roots(self):
        return self.free_RVs + self.observed_RVs + self.deterministics + self.potentials

    def constants(self):
        """Every ConstantNode the model's densities, deterministics and
        potentials read."""
        return [n for n in ancestors(self._roots()) if isinstance(n, ConstantNode)]

    def placed_constants(self, device=None, dtype=None):
        """{id(node): tensor} with every constant on `device` (default: the
        card), floats cast to `dtype` (default: `floatX(device)`): a ready
        memo for `graph.evaluate`, made once per function build instead of
        once per leaf. The density functions below take the same `device`
        and `dtype`."""
        device = resolve_device(device)
        return place_constants(self._roots(), device, dtype or floatX(device))

    def logp_terms_fn(self, device=None, dtype=None, jacobian=True):
        """fn(value_dict) -> {name: summed logp term}, free RVs (with their
        jacobians unless jacobian=False) first, then observed RVs, then
        potentials — the reference's order."""
        placed = self.placed_constants(device, dtype)
        free_RVs = list(self.free_RVs)
        observed_RVs = list(self.observed_RVs)
        potentials = list(self.potentials)

        def fn(value_dict):
            memo = dict(placed)
            env = {}
            for rv in free_RVs:
                v = value_dict[rv.value_name]
                env[rv.name] = rv.transform.backward(v, env, memo) if rv.transform else v
            terms = {}
            for rv in free_RVs:
                lp = rv.dist.logp(env[rv.name], env, memo).sum()
                if jacobian and rv.transform is not None:
                    lp = lp + rv.transform.log_jac_det(value_dict[rv.value_name], env,
                                                       memo).sum()
                terms[rv.name] = lp
            for orv in observed_RVs:
                lp = orv.dist.logp(orv._eval(env, memo), env, memo)
                if orv.mask is not None:
                    lp = torch.where(orv.mask._eval(env, memo), 0.0, lp)
                terms[orv.name] = lp.sum()
            for pot in potentials:
                terms[pot.name] = pot._eval(env, memo).sum()
            return terms

        return fn

    def logp_fn(self, device=None, dtype=None, split=False, jacobian=True):
        """fn(value_dict) -> scalar joint logp, jacobians included (with
        jacobian=False the constrained-space density over the unconstrained
        values, which find_MAP maximises); with split=True fn returns
        (varlogp, datalogp): the free RVs' terms with their jacobians, and
        the rest, for tempering (pymc_tpu model/core.py:803-826)."""
        terms_fn = self.logp_terms_fn(device, dtype, jacobian=jacobian)
        free_names = {rv.name for rv in self.free_RVs}

        def total(terms):
            out = terms[0]
            for t in terms[1:]:
                out = out + t
            return out

        if split:
            def split_fn(value_dict):
                terms = terms_fn(value_dict)
                zero = next(iter(terms.values())).new_zeros(())
                var = [v for k, v in terms.items() if k in free_names]
                data = [v for k, v in terms.items() if k not in free_names]
                return total([zero] + var), total([zero] + data)

            return split_fn

        def fn(value_dict):
            return total(list(terms_fn(value_dict).values()))

        return fn

    def raveled_info(self, vars=None) -> RaveledInfo:
        """The flat layout of `vars` (default: every free RV)."""
        return RaveledInfo.from_rvs(self.free_RVs if vars is None else vars)

    def constrain(self, value_dict, memo=None):
        """{value name: unconstrained value} -> {rv name: constrained value};
        `memo` holds the constants placed on the values' device (see
        `placed_constants`), which parametrised transforms read."""
        env = {}
        for rv in self.free_RVs:
            v = value_dict[rv.value_name]
            env[rv.name] = rv.transform.backward(v, env, memo) if rv.transform else v
        return env

    def unconstrain(self, point, memo=None):
        """{rv name: constrained value} -> {value name: unconstrained value}."""
        env = dict(point)
        return {
            rv.value_name: rv.transform.forward(point[rv.name], env, memo) if rv.transform
            else point[rv.name]
            for rv in self.free_RVs
        }

    def _flat_logp(self, device, dtype, jacobian=True):
        """fn(q (D,)) -> scalar joint logp of one flat unconstrained point;
        a discrete free RV's entries, carried as floats in q, are rounded
        to int64 (their gradient is 0)."""
        info = self.raveled_info()
        scalar_logp = self.logp_fn(device, dtype, jacobian=jacobian)
        discrete = [rv.value_name for rv in self.discrete_value_vars]

        def fn(q):
            vals = unravel_vector(q, info)
            for name in discrete:
                vals[name] = torch.round(vals[name]).to(intX())
            return scalar_logp(vals)

        return fn

    def logp_flat_fn(self, device=None, dtype=None):
        """fn(q (N, D)) -> (logp (N,),) over flat unconstrained points,
        discrete entries rounded: the density of the step methods
        (step_methods/compound.py), replayed from a CUDA graph per input
        shape on the card as `logp_dlogp_fn` is."""
        batched = torch.func.vmap(self._flat_logp(device, dtype))
        return GraphedFunction(lambda q: (batched(q),))

    def logp_dlogp_fn(self, device=None, dtype=None, jacobian=True, round_discrete=False):
        """fn(q (C, D)) -> (logp (C,), grad (C, D)) over flat unconstrained
        points — the sampler-facing density (reference ValueGradFunction
        core.py:142); jacobian as in `logp_fn`. On the card a call replays
        a CUDA graph of the same kernels from the third call of each input
        shape on (ops/cuda_graph.py; `fn.fn` is the eager function): the
        samplers', VI's and MAP's loops call it thousands of times at one
        shape. A discrete free RV raises: it has no gradient, and `sample`
        routes such a model to compound step methods
        (step_methods/compound.py), whose continuous blocks ask for
        round_discrete=True: the discrete entries rounded, their gradient
        0."""
        if self.discrete_value_vars and not round_discrete:
            names = [rv.value_name for rv in self.discrete_value_vars]
            raise NotImplementedError(
                f"Gradient-based samplers need continuous free variables only; "
                f"found discrete {names}. pymc_tpu_torch.sample samples such a model "
                "with compound step methods (NUTS for the continuous block, a "
                "Metropolis-family step for each discrete variable)."
            )
        value_and_grad = torch.func.vmap(
            torch.func.grad_and_value(self._flat_logp(device, dtype, jacobian))
        )

        def fn(q):
            grad, logp = value_and_grad(q)
            return logp, grad.contiguous()

        return GraphedFunction(fn)

    def postprocess_fn(self, device=None, dtype=None):
        """fn(q (N, D)) -> {name: (N, *shape)}: constrained free RVs and the
        deterministics recomputed from flat draws (reference
        sampling/jax.py:151-183 _postprocess_samples). A discrete free RV,
        carried as floats in q, comes out rounded, as int64."""
        info = self.raveled_info()
        placed = self.placed_constants(device, dtype)
        free_RVs = list(self.free_RVs)
        deterministics = list(self.deterministics)

        def post(q):
            vals = unravel_vector(q, info)
            memo = dict(placed)
            env = {}
            for rv in free_RVs:
                v = vals[rv.value_name]
                if rv.dist.is_discrete:
                    v = torch.round(v).to(intX())
                env[rv.name] = rv.transform.backward(v, env, memo) if rv.transform else v
            out = dict(env)
            for det in deterministics:
                out[det.name] = det._eval(env, memo)
            return out

        return torch.func.vmap(post)

    def __repr__(self):
        return f"<Model: {len(self.free_RVs)} free RVs, {len(self.observed_RVs)} observed>"


def _resolve_transform(dist, name, transform, default_transform):
    """The transform of a free RV (pymc_tpu model/core.py:424-472): the
    default (or `default_transform`), with a user `transform` chained on top
    of it once."""
    if transform is None:
        warnings.warn(
            "To disable default transform, please use "
            "default_transform=None instead of transform=None. Setting "
            "transform to None will not have any effect in future.",
            UserWarning,
            stacklevel=4,
        )
        if default_transform is UNSET:
            default_transform = None
        transform = UNSET
    base = dist.default_transform() if default_transform is UNSET else default_transform
    user = None if transform is UNSET else transform
    base, user = (None if t is False else t for t in (base, user))
    if base is None or user is None:
        tr = user if base is None else base
    else:
        tr = ChainedTransform([base, user])
    if tr is not None:
        if dist.is_discrete:
            raise ValueError(
                "Transformations for discrete distributions are not "
                f"allowed (got {tr!r} for {name!r}); discrete values "
                "have no continuous unconstrained space."
            )
        if tr.event_ndim < dist.event_ndim:
            raise NotImplementedError(
                f"Univariate transform {type(tr).__name__} cannot be "
                f"applied to multivariate {name!r} (event_ndim="
                f"{dist.event_ndim}); the Jacobian correction would "
                "broadcast against the collapsed event density. Use a "
                "vector transform (reference raises the same)."
            )
    return tr


def _impute_fill(arr, mask, discrete):
    """The data with its missing entries set to the observed mean (rounded,
    as int64, for a discrete distribution): the masked terms are still
    computed before they are zeroed, and an out-of-support fill would make
    their gradient NaN (pymc_tpu/model/core.py:1122)."""
    obs = arr[~mask]
    fill = float(np.mean(obs)) if obs.size else 0.0
    if discrete:
        return np.where(mask, np.round(fill), arr).astype(np.int64)
    return np.where(mask, fill, arr)


def Deterministic(name, var, model=None, dims=None):
    """Record a named deterministic quantity (reference core.py:2467)."""
    model = modelcontext(model)
    node = var if isinstance(var, DeterministicNode) else as_node(var)
    if not isinstance(node, DeterministicNode):
        node = DeterministicNode(lambda x: x.clone(), (node,))
    node.name = name
    model.deterministics.append(node)
    return model.add_named_variable(node, dims)


def Potential(name, var, model=None, dims=None):
    """Add an arbitrary term to the model's logp (reference core.py:2554);
    its sum joins the density with the observed terms."""
    model = modelcontext(model)
    node = var if isinstance(var, DeterministicNode) else as_node(var)
    if not isinstance(node, DeterministicNode):
        node = DeterministicNode(lambda x: x.clone(), (node,))
    node.name = name
    model.potentials.append(node)
    return model.add_named_variable(node, dims)
