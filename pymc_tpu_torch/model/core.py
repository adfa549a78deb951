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

import numpy as np
import torch

from ..blocking import RaveledInfo, unravel_vector
from ..config import floatX, resolve_device
from ..graph import (
    ConstantNode,
    DeterministicNode,
    FreeRV,
    ObservedRV,
    ancestors,
    as_node,
)

__all__ = ["Model", "modelcontext", "Deterministic"]


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

    def register_rv(self, dist, name, *, observed=None, dims=None):
        """Create a FreeRV or ObservedRV node for `dist` named `name`
        (reference model/core.py:1907). A free RV gets its distribution's
        default transform."""
        if observed is not None:
            arr = np.asarray(observed, dtype=np.float64)
            if np.isnan(arr).any():
                raise NotImplementedError(
                    f"observed data of {name!r} has missing values; imputation "
                    "is not ported"
                )
            np.broadcast_shapes(arr.shape, dist.shape)
            rv = ObservedRV(name, dist, arr, model=self)
            self.observed_RVs.append(rv)
        else:
            rv = FreeRV(
                name, dist, shape=dist.shape, dtype=dist.dtype,
                transform=dist.default_transform(), model=self,
            )
            self.free_RVs.append(rv)
        return self.add_named_variable(rv, dims)

    # ------------------------------------------------------------- density
    def constants(self):
        """Every ConstantNode the model's densities and deterministics read."""
        roots = self.free_RVs + self.observed_RVs + self.deterministics
        return [n for n in ancestors(roots) if isinstance(n, ConstantNode)]

    def placed_constants(self, device=None, dtype=None):
        """{id(node): tensor} with every constant on `device`, floats cast to
        `dtype`: a ready memo for `graph.evaluate`, made once per function
        build instead of once per leaf."""
        device = resolve_device(device)
        dtype = dtype or floatX(device)
        return {
            id(c): c.value.to(
                device=device,
                dtype=dtype if c.value.is_floating_point() else c.value.dtype,
            )
            for c in self.constants()
        }

    def logp_terms_fn(self, device=None, dtype=None):
        """fn(value_dict) -> {name: summed logp term}, free RVs (with their
        jacobians) first, then observed RVs — the reference's order."""
        placed = self.placed_constants(device, dtype)
        free_RVs = list(self.free_RVs)
        observed_RVs = list(self.observed_RVs)

        def fn(value_dict):
            memo = dict(placed)
            env = {}
            for rv in free_RVs:
                v = value_dict[rv.value_name]
                env[rv.name] = rv.transform.backward(v) if rv.transform else v
            terms = {}
            for rv in free_RVs:
                lp = rv.dist.logp(env[rv.name], env, memo).sum()
                if rv.transform is not None:
                    lp = lp + rv.transform.log_jac_det(value_dict[rv.value_name]).sum()
                terms[rv.name] = lp
            for orv in observed_RVs:
                lp = orv.dist.logp(orv._eval(env, memo), env, memo)
                terms[orv.name] = lp.sum()
            return terms

        return fn

    def logp_fn(self, device=None, dtype=None):
        """fn(value_dict) -> scalar joint logp, jacobians included."""
        terms_fn = self.logp_terms_fn(device, dtype)

        def fn(value_dict):
            terms = list(terms_fn(value_dict).values())
            total = terms[0]
            for t in terms[1:]:
                total = total + t
            return total

        return fn

    def raveled_info(self) -> RaveledInfo:
        return RaveledInfo.from_rvs(self.free_RVs)

    def logp_dlogp_fn(self, device=None, dtype=None):
        """fn(q (C, D)) -> (logp (C,), grad (C, D)) over flat unconstrained
        points — the sampler-facing density (reference ValueGradFunction
        core.py:142)."""
        info = self.raveled_info()
        scalar_logp = self.logp_fn(device, dtype)
        value_and_grad = torch.func.vmap(
            torch.func.grad_and_value(lambda q: scalar_logp(unravel_vector(q, info)))
        )

        def fn(q):
            grad, logp = value_and_grad(q)
            return logp, grad.contiguous()

        return fn

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
                env[rv.name] = rv.transform.backward(v) if rv.transform else v
            out = dict(env)
            for det in deterministics:
                out[det.name] = det._eval(env, memo)
            return out

        return torch.func.vmap(post)

    def __repr__(self):
        return f"<Model: {len(self.free_RVs)} free RVs, {len(self.observed_RVs)} observed>"


def Deterministic(name, var, model=None, dims=None):
    """Record a named deterministic quantity (reference core.py:2467)."""
    model = modelcontext(model)
    node = var if isinstance(var, DeterministicNode) else as_node(var)
    if not isinstance(node, DeterministicNode):
        node = DeterministicNode(lambda x: x.clone(), (node,))
    node.name = name
    model.deterministics.append(node)
    return model.add_named_variable(node, dims)
