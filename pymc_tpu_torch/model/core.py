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
from ..config import floatX, resolve_device
from ..distributions.distribution import UNSET
from ..distributions.transforms import ChainedTransform
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
            # NaN is cast to int64); continuous data is float64 at build time
            # (reference pymc_tpu/model/core.py:508-515)
            arr = np.asarray(observed)
            if not (dist.is_discrete and np.issubdtype(arr.dtype, np.integer)):
                if np.isnan(arr.astype(np.float64)).any():
                    raise NotImplementedError(
                        f"observed data of {name!r} has missing values; imputation "
                        "is not ported"
                    )
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

    def logp_dlogp_fn(self, device=None, dtype=None, jacobian=True):
        """fn(q (C, D)) -> (logp (C,), grad (C, D)) over flat unconstrained
        points — the sampler-facing density (reference ValueGradFunction
        core.py:142); jacobian as in `logp_fn`. On the card a call replays
        a CUDA graph of the same kernels from the third call of each input
        shape on (ops/cuda_graph.py; `fn.fn` is the eager function): the
        samplers', VI's and MAP's loops call it thousands of times at one
        shape. A discrete free RV raises:
        the JAX package samples it with compound step methods, which this
        port does not have yet."""
        if self.discrete_value_vars:
            names = [rv.value_name for rv in self.discrete_value_vars]
            raise NotImplementedError(
                f"Gradient-based samplers need continuous free variables only; "
                f"found discrete {names}. They need compound step methods, "
                "which pymc_tpu_torch does not have yet."
            )
        info = self.raveled_info()
        scalar_logp = self.logp_fn(device, dtype, jacobian=jacobian)
        value_and_grad = torch.func.vmap(
            torch.func.grad_and_value(lambda q: scalar_logp(unravel_vector(q, info)))
        )

        def fn(q):
            grad, logp = value_and_grad(q)
            return logp, grad.contiguous()

        return GraphedFunction(fn)

    def postprocess_fn(self, device=None, dtype=None):
        """fn(q (N, D)) -> {name: (N, *shape)}: constrained free RVs and the
        deterministics recomputed from flat draws (reference
        sampling/jax.py:151-183 _postprocess_samples)."""
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
