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

from ..blocking import RaveledInfo, ravel_point, unravel_vector
from ..config import config, floatX, intX, resolve_device
from ..distributions.distribution import (
    UNSET,
    _PartialObservedJoint,
    _PartialObservedSlots,
    _scatter_positions,
    scatter_missing,
)
from ..distributions.simulator import SIMULATOR_KEY
from ..distributions.transforms import ChainedTransform
from ..exceptions import ImputationWarning
from ..initial_point import support_point_values
from ..ops.cuda_graph import GraphedFunction
from ..graph import (
    ConstantNode,
    DeterministicNode,
    FreeRV,
    Node,
    ObservedRV,
    ancestors,
    as_node,
    place_constants,
)

__all__ = [
    "Model", "modelcontext", "Deterministic", "Potential", "Point", "compile_fn", "compile",
    "set_data", "BaseModel", "FrozenModel",
]


class _ContextStack(threading.local):
    def __init__(self):
        self.stack = []


_MODEL_CONTEXT = _ContextStack()


def modelcontext(model=None):
    """Return the given model or the innermost context model."""
    if model is not None:
        return model
    return Model.get_context()


class _InitContextMeta(type):
    """Push the instance onto the model-context stack while its __init__
    runs, so that a class-based model (``class MyModel(pm.Model)``)
    registers variables in its constructor (pymc_tpu/model/core.py:69)."""

    def __call__(cls, *args, **kwargs):
        instance = cls.__new__(cls)
        _MODEL_CONTEXT.stack.append(instance)
        try:
            instance.__init__(*args, **kwargs)
        finally:
            _MODEL_CONTEXT.stack.pop()
        return instance


# the registries a nested model shares with its root
_ROOT_REGISTRIES = ("named_vars", "free_RVs", "observed_RVs", "deterministics", "potentials",
                    "rvs_to_initial_values", "_coords", "_dim_lengths")


class Model(metaclass=_InitContextMeta):
    """Bayesian model: named random variables and deterministics with
    coords/dims bookkeeping.

        with pm.Model(coords={"g": groups}) as model:
            mu = pm.Normal("mu", 0, 1)
            y = pm.Normal("y", mu, 1.0, observed=data)

    A model built inside another (or given `model=`) is a sub-model: it
    shares its root's registries, and the names of its variables carry its
    name and its parents' joined by "::" (pymc_tpu/model/core.py:112-210).
    An unnamed sub-model takes its parent's prefix. `check_bounds=False`
    drops the distributions' parameter checks from the model's densities.
    """

    @classmethod
    def get_context(cls, error_if_none=True):
        if not _MODEL_CONTEXT.stack:
            if not error_if_none:
                return None
            raise TypeError(
                "No model on context stack. Define variables inside a "
                "`with pm.Model():` block, or pass model=... explicitly."
            )
        return _MODEL_CONTEXT.stack[-1]

    def __init__(self, name="", coords=None, check_bounds=True, model=None):
        self.name = str(name)
        if self.name.startswith("::") or self.name.endswith("::"):
            raise KeyError(f"name {self.name!r} cannot start or end with the '::' separator")
        # while __init__ runs this model is on the stack (_InitContextMeta):
        # the parent is the nearest enclosing model that is not this one
        self.parent = model if model is not None else next(
            (m for m in reversed(_MODEL_CONTEXT.stack) if m is not self), None)
        self.check_bounds = check_bounds
        if self.parent is None:
            self._root = self
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
        else:
            self._root = self.parent.root
            for attr in _ROOT_REGISTRIES:
                setattr(self, attr, getattr(self._root, attr))
        if coords is not None:
            self.add_coords(coords)

    def __enter__(self):
        _MODEL_CONTEXT.stack.append(self)
        return self

    def __exit__(self, *exc):
        _MODEL_CONTEXT.stack.pop()
        return False

    @property
    def root(self):
        return self._root

    @property
    def isroot(self):
        return self.parent is None

    def __getattr__(self, attr):
        # a model's variables are reachable as attributes by their local name
        # (the class-based-model contract: `self.v2` after pm.Normal("v2"))
        if not attr.startswith("_") and "named_vars" in self.__dict__:
            named = self.__dict__["named_vars"]
            for key in (self.name_for(attr), attr):
                if key in named:
                    return named[key]
        raise AttributeError(f"'{type(self).__name__}' object has no attribute '{attr}'")

    def name_for(self, name):
        """`name` prefixed with this model's name and its named parents',
        joined by "::"; an unnamed sub-model takes its parent's prefix
        (pymc_tpu/model/core.py:196-210)."""
        if self.name:
            prefix, m = self.name, self.parent
            while m is not None and m.name:
                prefix = f"{m.name}::{prefix}"
                m = m.parent
            return f"{prefix}::{name}"
        if self.parent is not None:
            return self.parent.name_for(name)
        return name

    # ------------------------------------------------------------- coords
    @property
    def coords(self):
        return dict(self._coords)

    @property
    def dim_lengths(self):
        return dict(self._dim_lengths)

    def add_coord(self, name, values=None, length=None):
        if values is None and length is None:
            raise ValueError(f"Either values or length must be given for coord {name}")
        if name in self.named_vars:
            raise ValueError(
                f"The coordinate name '{name}' conflicts with an existing model variable name."
            )
        if values is not None:
            values = tuple(np.asarray(values).tolist())
            length = len(values)
        if name in self._dim_lengths and self._dim_lengths[name] != length:
            raise ValueError(f"Duplicate coord {name} with conflicting length")
        self._coords[name] = values
        self._dim_lengths[name] = int(length)

    def add_coords(self, coords):
        for name, values in coords.items():
            self.add_coord(name, values=values)

    def set_dim(self, name, new_length, coord_values=None):
        """Resize a dimension (reference core.py:894). A model's shapes are
        fixed when its variables are built, so this changes the
        bookkeeping, as the JAX package's does; resizing a dimension that
        holds data waits for data.py (`set_data`)."""
        if (coord_values is None and self._coords.get(name) is not None
                and int(new_length) != self._dim_lengths.get(name)):
            raise ValueError(
                f"The dim '{name}' has coord values; pass `coord_values` with the new "
                "length to update them (reference core.py:894)."
            )
        if coord_values is not None and len(coord_values) != new_length:
            raise ValueError(
                f"Length of new coordinate values for dimension '{name}' does not match "
                f"the new length: {len(coord_values)} != {new_length}"
            )
        self._dim_lengths[name] = int(new_length)
        if coord_values is not None:
            self._coords[name] = tuple(np.asarray(coord_values).tolist())

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

    def __contains__(self, key):
        return key in self.named_vars

    @property
    def basic_RVs(self):
        return self.free_RVs + self.observed_RVs

    @property
    def unobserved_RVs(self):
        return self.free_RVs + self.deterministics

    @property
    def continuous_value_vars(self):
        return [rv for rv in self.free_RVs if not rv.dist.is_discrete]

    def add_named_variable(self, var, dims=None):
        if var.name is None:
            raise ValueError("Variable is unnamed")
        if var.name.startswith("::") or var.name.endswith("::"):
            raise KeyError(f"name {var.name!r} cannot start or end with the '::' separator")
        if var.name in self.named_vars:
            raise ValueError(f"Variable name {var.name} already exists.")
        if var.name in self._dim_lengths:
            raise ValueError(
                f"The variable name '{var.name}' conflicts with an existing dimension name."
            )
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
        value. `name` is prefixed with the model's name (`name_for`).
        """
        name = self.name_for(name)
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

    def logp_terms_fn(self, device=None, dtype=None, jacobian=True, elementwise=False):
        """fn(value_dict) -> {name: summed logp term}, free RVs (with their
        jacobians unless jacobian=False) first, then observed RVs, then
        potentials — the reference's order. With elementwise=True each term
        keeps its batch shape (reference Model.logp(sum=False)): a transform
        whose block is wider than the distribution's event collapses those
        axes of the density, and its correction joins it elementwise
        (pymc_tpu/model/core.py:710-796). A Simulator's generator, at
        `SIMULATOR_KEY` in value_dict, is handed to its logp through the
        environment. With the model's check_bounds off, the distributions'
        parameter checks are off while fn runs."""
        placed = self.placed_constants(device, dtype)
        free_RVs = list(self.free_RVs)
        observed_RVs = list(self.observed_RVs)
        potentials = list(self.potentials)
        check_bounds = bool(self.root.check_bounds)

        def terms_of(value_dict):
            memo = dict(placed)
            env = {}
            if SIMULATOR_KEY in value_dict:
                env[SIMULATOR_KEY] = value_dict[SIMULATOR_KEY]
            for rv in free_RVs:
                v = value_dict[rv.value_name]
                env[rv.name] = rv.transform.backward(v, env, memo) if rv.transform else v
            terms = {}
            for rv in free_RVs:
                lp = rv.dist.logp(env[rv.name], env, memo)
                if not elementwise:
                    lp = lp.sum()
                    if jacobian and rv.transform is not None:
                        lp = lp + rv.transform.log_jac_det(value_dict[rv.value_name], env,
                                                           memo).sum()
                    terms[rv.name] = lp
                    continue
                if rv.transform is not None:
                    for _ in range(max(rv.transform.event_ndim - rv.dist.event_ndim, 0)):
                        if lp.ndim:
                            lp = lp.sum(-1)
                    if jacobian:
                        jac = rv.transform.log_jac_det(value_dict[rv.value_name], env, memo)
                        lp = lp + (jac if jac.shape == lp.shape else jac.reshape(lp.shape))
                terms[rv.name] = lp
            for orv in observed_RVs:
                lp = orv.dist.logp(orv._eval(env, memo), env, memo)
                if orv.mask is not None:
                    lp = torch.where(orv.mask._eval(env, memo), 0.0, lp)
                terms[orv.name] = lp if elementwise else lp.sum()
            for pot in potentials:
                pv = pot._eval(env, memo)
                terms[pot.name] = pv if elementwise else pv.sum()
            return terms

        def fn(value_dict):
            if check_bounds:
                return terms_of(value_dict)
            prev, config.check_bounds = config.check_bounds, False
            try:
                return terms_of(value_dict)
            finally:
                config.check_bounds = prev

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

    # --------------------------------------------------- compiled functions
    def _point(self, point, device, dtype):
        """A point dict's values as tensors on `device`, floats in `dtype`
        (default: `floatX(device)`), integers as int64."""
        device = resolve_device(device)
        dtype = dtype or floatX(device)
        return {k: _as_device_tensor(v, device, dtype) for k, v in point.items()}

    def compile_logp(self, vars=None, jacobian=True, sum=True, device=None, dtype=None):
        """fn(point) -> the joint logp at a point dict of unconstrained
        values (reference Model.compile_logp); `vars` (nodes or names)
        keeps their terms only; sum=False gives {name: elementwise logp}."""
        terms_fn = self.logp_terms_fn(device, dtype, jacobian=jacobian, elementwise=not sum)
        names = None
        if vars is not None:
            vars = [vars] if isinstance(vars, (Node, str)) else list(vars)
            names = [v.name if isinstance(v, Node) else str(v) for v in vars]

        def fn(point):
            terms = terms_fn(self._point(point, device, dtype))
            sel = terms if names is None else {n: terms[n] for n in names}
            if not sum:
                return sel
            vals = list(sel.values())
            out = vals[0]
            for v in vals[1:]:
                out = out + v
            return out

        return fn

    def compile_dlogp(self, jacobian=True, device=None, dtype=None):
        """fn(point) -> {value name: d logp / d value} at a point dict of
        unconstrained values, over its float entries."""
        logp = self.logp_fn(device, dtype, jacobian=jacobian)

        def fn(point):
            point = self._point(point, device, dtype)
            floats = {k: v for k, v in point.items() if v.is_floating_point()}
            rest = {k: v for k, v in point.items() if k not in floats}
            return torch.func.grad(lambda f: logp({**rest, **f}))(floats)

        return fn

    def compile_d2logp(self, jacobian=True, negate_output=False, device=None, dtype=None):
        """fn(point) -> the (D, D) Hessian of the joint logp over the
        raveled continuous values (reference Model.compile_d2logp returns
        its negative: pass negate_output=True for that)."""
        info = self.raveled_info(self.continuous_value_vars)
        logp = self.logp_fn(device, dtype, jacobian=jacobian)

        def fn(point):
            point = self._point(point, device, dtype)
            q = ravel_point(point, info)
            h = torch.func.hessian(lambda x: logp({**point, **unravel_vector(x, info)}))(q)
            return -h if negate_output else h

        return fn

    def compile_fn(self, outs, point_fn=True, device=None, dtype=None):
        """fn(point) -> the value of `outs` (a node or a list of nodes) at a
        point dict of constrained values keyed by variable name (reference
        model/core.py:compile_fn)."""
        return _compile_point_fn(self._roots(), outs, device, dtype)

    # ------------------------------------------------------- initial points
    def initial_point(self, random_seed=None, jitter=0.0, device=None, dtype=None):
        """{value name: unconstrained initial value} on `device`: each free
        RV's initval or support point, plus U(-jitter, jitter) noise on the
        continuous ones from a generator seeded `random_seed` (0 if None)."""
        device = resolve_device(device)
        dtype = dtype or floatX(device)
        values = support_point_values(self)
        gen = torch.Generator().manual_seed(0 if random_seed is None else int(random_seed))
        out = {}
        for name, v in values.items():
            if jitter and v.is_floating_point():
                v = v + jitter * (2.0 * torch.rand(v.shape, generator=gen,
                                                   dtype=torch.float64) - 1.0)
            out[name] = _as_device_tensor(v, device, dtype)
        return out

    def check_start_vals(self, start, device=None, dtype=None):
        """Raise SamplingError where a term of the logp is not finite at a
        starting point (one point dict or a list of them; reference
        core.py:1319)."""
        from ..sampling.mcmc import SamplingError

        terms_fn = self.logp_terms_fn(device, dtype)
        for point in start if isinstance(start, list) else [start]:
            terms = {k: float(v) for k, v in terms_fn(self._point(point, device, dtype)).items()}
            bad = {k: v for k, v in terms.items() if not np.isfinite(v)}
            if bad:
                raise SamplingError(
                    f"Initial evaluation of model at starting point failed!\n"
                    f"Starting values:\n{point}\n\nLogp per variable: {bad}"
                )

    def point_logps(self, point=None, round_vals=2, device=None, dtype=None):
        """{variable name without this model's prefix: its summed logp} at
        `point` (default: the initial point; reference core.py:1370)."""
        if point is None:
            point = self.initial_point(device=device, dtype=dtype)
        terms = self.logp_terms_fn(device, dtype)(self._point(point, device, dtype))
        prefix = self.name_for("")
        return {k.removeprefix(prefix): round(float(v), round_vals) for k, v in terms.items()}

    def eval_rv_shapes(self):
        return {rv.name: rv.shape for rv in self.basic_RVs}

    def debug(self, point=None, fn="logp", verbose=False, device=None, dtype=None):
        """Print the variables whose logp term is not finite at `point`
        (default: the initial point) and return them (reference
        core.py:1401)."""
        if point is None:
            point = self.initial_point(device=device, dtype=dtype)
        terms = self.logp_terms_fn(device, dtype)(self._point(point, device, dtype))
        terms = {k: float(v) for k, v in terms.items()}
        problems = {k: v for k, v in terms.items() if not np.isfinite(v)}
        if problems:
            print(f"The variable(s) {list(problems)} have non-finite {fn}.")
            if verbose:
                print(terms)
        else:
            print("No problems found")
        return problems

    def profile(self, outs=None, n=1000, point=None, trace_dir=None, device=None):
        """Seconds a call of `compile_logp()` and of `compile_dlogp()` at
        `point` (default: the initial point), each over `n` calls after one:
        between two CUDA events on the card, by the host clock on the CPU.
        With `trace_dir` the timed calls run under torch.profiler, which
        writes a chrome trace `trace.json` there (reference core.py:1246)."""
        import contextlib
        import os

        device = resolve_device(device)
        if point is None:
            point = self.initial_point(device=device)
        point = self._point(point, device, None)
        prof = contextlib.nullcontext()
        if trace_dir is not None:
            from torch.profiler import ProfilerActivity
            from torch.profiler import profile as torch_profile

            activities = [ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            prof = torch_profile(activities=activities)
        with prof:
            t_logp = _seconds_a_call(self.compile_logp(device=device), point, n, device)
            t_dlogp = _seconds_a_call(self.compile_dlogp(device=device), point, n, device)
        if trace_dir is not None:
            os.makedirs(trace_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(str(trace_dir), "trace.json"))
        print(f"logp: {t_logp * 1e6:.1f} us/call; dlogp: {t_dlogp * 1e6:.1f} us/call "
              f"({n} calls)")
        return {"logp_sec_per_call": t_logp, "dlogp_sec_per_call": t_dlogp, "n_calls": n}

    def set_initval(self, rv, value):
        """Set (or clear, with None) the initial value of a free RV, in the
        constrained space (reference model/core.py set_initval)."""
        name = getattr(rv, "name", str(rv))
        if name not in {r.name for r in self.free_RVs}:
            raise KeyError(f"{name!r} is not a free random variable")
        if value is None:
            self.rvs_to_initial_values.pop(name, None)
        else:
            self.rvs_to_initial_values[name] = value

    def set_data(self, name, values, coords=None):
        """Waits for data.py (`pm.Data`), ROADMAP.md §1 item 7."""
        raise NotImplementedError(
            "Model.set_data waits for data.py (pm.Data), ROADMAP.md §1 item 7: not ported to "
            "pymc_tpu_torch yet"
        )

    def to_graphviz(self, **kwargs):
        """Waits for model_graph.py, ROADMAP.md §1 item 8."""
        raise NotImplementedError(
            "Model.to_graphviz waits for model_graph.py, ROADMAP.md §1 item 8: not ported to "
            "pymc_tpu_torch yet"
        )

    def __repr__(self):
        return (f"<Model '{self.name}': {len(self.free_RVs)} free RVs, "
                f"{len(self.observed_RVs)} observed>")


def _as_device_tensor(v, device, dtype):
    t = v if isinstance(v, torch.Tensor) else torch.as_tensor(np.asarray(v))
    if t.is_floating_point():
        return t.to(device=device, dtype=dtype)
    return t.to(device=device, dtype=intX() if t.dtype != torch.bool else torch.bool)


def _seconds_a_call(fn, point, n, device):
    import time

    fn(point)
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(n):
            fn(point)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / n
    t0 = time.perf_counter()
    for _ in range(n):
        fn(point)
    return (time.perf_counter() - t0) / n


def _compile_point_fn(roots, outs, device, dtype, in_names=None):
    """fn(point) (or fn(*args) with `in_names`) -> the value of `outs`, a
    node or a list of nodes, with the environment taken from the point (or
    the arguments) on `device`, and every constant the nodes read placed
    there."""
    outs_list = list(outs) if isinstance(outs, (list, tuple)) else [outs]
    device = resolve_device(device)
    dtype = dtype or floatX(device)
    placed = place_constants(list(roots) + [o for o in outs_list if isinstance(o, Node)],
                             device, dtype)

    def run(env):
        env = {k: _as_device_tensor(v, device, dtype) for k, v in env.items()}
        memo = dict(placed)
        vals = [o._eval(env, memo) if isinstance(o, Node) else o for o in outs_list]
        return vals if isinstance(outs, (list, tuple)) else vals[0]

    if in_names is None:
        return run

    def fn(*args):
        if len(args) != len(in_names):
            raise TypeError(f"expected {len(in_names)} arguments, got {len(args)}")
        return run(dict(zip(in_names, args)))

    return fn


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
    node.name = model.name_for(name)
    model.deterministics.append(node)
    return model.add_named_variable(node, dims)


def Potential(name, var, model=None, dims=None):
    """Add an arbitrary term to the model's logp (reference core.py:2554);
    its sum joins the density with the observed terms."""
    model = modelcontext(model)
    node = var if isinstance(var, DeterministicNode) else as_node(var)
    if not isinstance(node, DeterministicNode):
        node = DeterministicNode(lambda x: x.clone(), (node,))
    node.name = model.name_for(name)
    model.potentials.append(node)
    return model.add_named_variable(node, dims)


def set_data(new_data, model=None, coords=None):
    """Waits for data.py (`pm.Data`), ROADMAP.md §1 item 7."""
    for name, values in new_data.items():
        modelcontext(model).set_data(name, values, coords=coords)


def Point(*args, filter_model_vars=False, model=None, **kwargs):
    """A point dict of numpy arrays (reference core.py:Point); with
    filter_model_vars, only the keys that name a model variable or a free
    RV's value."""
    d = dict(*args, **kwargs)
    if filter_model_vars:
        model = modelcontext(model)
        names = set(model.named_vars) | {rv.value_name for rv in model.free_RVs}
        d = {k: v for k, v in d.items() if k in names}
    return {k: np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v) for k, v in d.items()}


# the reference's class names (its BaseModel/FrozenModel split is an
# implementation detail of PyTensor)
BaseModel = Model
FrozenModel = Model


def compile_fn(outs, model=None, point_fn=True, device=None, dtype=None):
    """`Model.compile_fn` of the context model."""
    return modelcontext(model).compile_fn(outs, point_fn=point_fn, device=device, dtype=dtype)


def compile(inputs, outputs, random_seed=None, mode=None, device=None, dtype=None, **kwargs):
    """fn(*args) -> the value of `outputs` (a node or a list of nodes) with
    each of `inputs` (nodes or names) bound to its argument, on `device`
    (reference pytensorf.py:924 `compile`; `random_seed`, `mode` and the
    other keyword arguments are taken and unused, as in the JAX package)."""
    in_names = [i.name if isinstance(i, Node) else str(i) for i in inputs]
    return _compile_point_fn([], outputs, device, dtype, in_names=in_names)
