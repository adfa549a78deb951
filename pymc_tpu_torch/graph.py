"""Lazy symbolic graph over PyTorch operations.

Counterpart of `pymc_tpu/graph.py`. A model is a small static DAG of `Node`
objects whose evaluation is plain PyTorch, so `Model.logp_fn` is an ordinary
function of tensors that `torch.func.grad` and `torch.func.vmap` compose
over. Shapes and dtypes are inferred at construction by running each node's
function on the `meta` device (shapes only, no data).

Node kinds:
  - ConstantNode: wraps a concrete tensor (kept on the CPU; the model moves
    every constant to the sampling device once per `sample` call).
  - FreeRV: a latent random variable; evaluates to its constrained value
    looked up in the evaluation environment.
  - ObservedRV: an observed random variable; evaluates to its data.
  - DeterministicNode: fn(*parents) for any PyTorch function.

`evaluate(node, env, memo)` resolves a node given `env: {rv_name: value}`.
`memo` is keyed by node id; a caller may pre-fill it with device copies of
the constants (see `Model.placed_constants`).
"""

from __future__ import annotations

import numbers
import operator

import numpy as np
import torch

__all__ = [
    "Node",
    "ConstantNode",
    "FreeRV",
    "ObservedRV",
    "DeterministicNode",
    "as_node",
    "evaluate",
    "apply",
    "ancestors",
    "place_constants",
]


def as_tensor(x) -> torch.Tensor:
    """A concrete value as a CPU tensor; floats become float64 (the build
    type, cast to the sampling type when the model places its constants)."""
    if isinstance(x, torch.Tensor):
        return x
    arr = np.asarray(x)
    if arr.dtype.kind == "f":
        arr = arr.astype(np.float64)
    elif arr.dtype.kind in "iu":
        arr = arr.astype(np.int64)
    return torch.as_tensor(arr)


def as_node(x) -> "Node":
    """Wrap a concrete value in a ConstantNode (identity on Nodes)."""
    if isinstance(x, Node):
        return x
    return ConstantNode(x)


def evaluate(x, env=None, memo=None):
    """Evaluate a Node (or pass through a concrete value) under `env`.

    env maps free/observed RV names to their CONSTRAINED values; memo is an
    id-keyed cache shared across one model-function evaluation.
    """
    if not isinstance(x, Node):
        return x
    if memo is None:
        memo = {}
    return x._eval(env if env is not None else {}, memo)


def apply(fn, *args, **kwargs):
    """Apply `fn` symbolically if any argument is a Node, else eagerly.

    Array-like operands (numpy arrays, lists, tensors) of a symbolic call
    become ConstantNodes so that they move to the device with the model;
    Python numbers stay static arguments. kwargs must be static.
    """
    if any(isinstance(a, Node) for a in args):
        args = tuple(
            a if isinstance(a, (Node, numbers.Number)) else as_node(a)
            for a in args
        )
        return DeterministicNode(fn, args, kwargs)
    return fn(*args, **kwargs)


def _meta(x):
    """Shape-only stand-in for a Node argument."""
    return torch.empty(x.shape, dtype=x.dtype, device="meta")


class Node:
    """Abstract lazy value. Subclasses set .shape and .dtype at construction."""

    __array_ufunc__ = None  # make numpy defer to our reflected operators
    __array_priority__ = 1000

    shape: tuple
    dtype: torch.dtype
    name: str | None = None

    def _eval(self, env, memo):
        key = id(self)
        if key in memo:
            return memo[key]
        out = self._compute(env, memo)
        memo[key] = out
        return out

    def _compute(self, env, memo):  # pragma: no cover - abstract
        raise NotImplementedError

    def __getitem__(self, idx):
        if isinstance(idx, (Node, np.ndarray, list, torch.Tensor)):
            return apply(lambda x, ix: x[ix], self, idx)
        return apply(lambda x: x[idx], self)

    @staticmethod
    def _operand_ok(o):
        """False for foreign types with their own operator overloads (e.g.
        gp.cov.Covariance), so the forward operators return NotImplemented
        and Python asks the other operand (pymc_tpu/graph.py:257-265)."""
        return isinstance(
            o, (Node, numbers.Number, np.ndarray, list, tuple, torch.Tensor)
        )

    def __add__(self, o):
        if not self._operand_ok(o):
            return NotImplemented
        return apply(operator.add, self, o)

    def __radd__(self, o):
        return apply(operator.add, o, self)

    def __sub__(self, o):
        if not self._operand_ok(o):
            return NotImplemented
        return apply(operator.sub, self, o)

    def __rsub__(self, o):
        return apply(operator.sub, o, self)

    def __mul__(self, o):
        if not self._operand_ok(o):
            return NotImplemented
        return apply(operator.mul, self, o)

    def __rmul__(self, o):
        return apply(operator.mul, o, self)

    def __truediv__(self, o):
        if not self._operand_ok(o):
            return NotImplemented
        return apply(operator.truediv, self, o)

    def __rtruediv__(self, o):
        return apply(operator.truediv, o, self)

    def __pow__(self, o):
        if not self._operand_ok(o):
            return NotImplemented
        return apply(operator.pow, self, o)

    def __rpow__(self, o):
        return apply(operator.pow, o, self)

    def __neg__(self):
        return apply(operator.neg, self)

    def __hash__(self):
        return id(self)

    def __repr__(self):
        nm = f" '{self.name}'" if self.name else ""
        return f"<{type(self).__name__}{nm} shape={self.shape} dtype={self.dtype}>"

    def __bool__(self):
        raise TypeError(
            f"The truth value of a symbolic {type(self).__name__} is undefined. "
            "Use torch.where for branching on node values."
        )


class ConstantNode(Node):
    def __init__(self, value, name=None):
        self.value = as_tensor(value)
        self.shape = tuple(self.value.shape)
        self.dtype = self.value.dtype
        self.name = name

    def _compute(self, env, memo):
        return self.value


class FreeRV(Node):
    """A latent random variable node; evaluates to env[name], its
    CONSTRAINED value (reference model/core.py:1907 register_rv)."""

    def __init__(self, name, dist, shape, dtype, transform=None, model=None):
        self.name = name
        self.dist = dist
        self.shape = tuple(shape)
        self.dtype = dtype
        self.transform = transform
        self.model = model

    @property
    def value_name(self):
        if self.transform is None:
            return self.name
        return f"{self.name}_{self.transform.name}__"

    @property
    def value_shape(self):
        if self.transform is None:
            return self.shape
        return tuple(self.transform.value_shape(self.shape))

    def _compute(self, env, memo):
        try:
            return env[self.name]
        except KeyError:
            raise KeyError(
                f"No value provided for free random variable '{self.name}'. "
                f"env keys: {list(env)}"
            ) from None


class ObservedRV(Node):
    """An observed random variable; evaluates to its data (a ConstantNode)
    unless the env overrides it (reference model/core.py:1984)."""

    def __init__(self, name, dist, observed, model=None):
        self.name = name
        self.dist = dist
        self.observed = as_node(observed)
        self.shape = self.observed.shape
        self.dtype = self.observed.dtype
        self.model = model

    def _compute(self, env, memo):
        if self.name in env:
            return env[self.name]
        return self.observed._eval(env, memo)


class DeterministicNode(Node):
    """fn(*args, **kwargs) where any positional arg may be a Node."""

    def __init__(self, fn, args, kwargs=None, name=None):
        self.fn = fn
        self.args = tuple(args)
        self.kwargs = dict(kwargs or {})
        self.name = name
        if any(isinstance(v, Node) for v in self.kwargs.values()):
            raise TypeError("Node-valued kwargs are not supported; pass positionally.")
        out = fn(
            *[_meta(a) if isinstance(a, Node) else a for a in self.args],
            **self.kwargs,
        )
        if not isinstance(out, torch.Tensor):
            raise TypeError(
                f"Deterministic fn must return a single tensor, got {type(out)}"
            )
        self.shape = tuple(out.shape)
        self.dtype = out.dtype

    def _compute(self, env, memo):
        args = [a._eval(env, memo) if isinstance(a, Node) else a for a in self.args]
        return self.fn(*args, **self.kwargs)


def _parents(node):
    if isinstance(node, DeterministicNode):
        return [a for a in node.args if isinstance(a, Node)]
    if isinstance(node, FreeRV):
        return [p for p in node.dist.inputs() if isinstance(p, Node)]
    if isinstance(node, ObservedRV):
        return [node.observed] + [p for p in node.dist.inputs() if isinstance(p, Node)]
    return []


def ancestors(nodes, stop=()):
    """All transitive ancestor Nodes (including the inputs), deduplicated;
    the parents of a node whose id is in `stop` are not walked."""
    seen = {}
    stack = [n for n in nodes if isinstance(n, Node)]
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen[id(n)] = n
        if id(n) not in stop:
            stack.extend(_parents(n))
    return list(seen.values())


def place_constants(nodes, device, dtype):
    """{id(node): tensor}: every ConstantNode among the ancestors of `nodes`
    on `device`, floats cast to `dtype` (integers keep their type); a ready
    memo for `evaluate`."""
    return {
        id(c): c.value.to(
            device=device, dtype=dtype if c.value.is_floating_point() else c.value.dtype
        )
        for c in ancestors(nodes)
        if isinstance(c, ConstantNode)
    }
