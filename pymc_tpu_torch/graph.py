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
    "lift",
    "structural",
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


def lift(args):
    """`args` with each unnamed distribution (a `.dist()` object) replaced
    by its anonymous random-variable node (`Distribution.to_node`), so that
    an expression over `.dist()` objects builds the graph the logprob engine
    derives a density from (pymc_tpu/graph.py:105-109)."""
    if not any(getattr(a, "_lift_to_node", False) for a in args):
        return args
    return tuple(a.to_node() if getattr(a, "_lift_to_node", False) else a for a in args)


def structural(fn, kind, **params):
    """`fn`, tagged with the structural form its node builds ("a join", "a
    reduction", ...) and the parameters the logprob engine (distributions/
    transformed.py) reads to derive its density (a join's kind and axis, a
    reduction's op, axis and keepdims, an index, a layout); for closures,
    whose identity no table can hold and whose parameters no node kwarg
    carries (pymc_tpu/math.py's and graph.py's `_measurable_*` markers)."""
    fn._structural = kind
    fn._structural_params = params
    return fn


def apply(fn, *args, **kwargs):
    """Apply `fn` symbolically if any argument is a Node, else eagerly.

    Unnamed distributions among the operands lift to their anonymous
    random-variable nodes (`lift`). Array-like operands (numpy arrays,
    lists, tensors) of a symbolic call become ConstantNodes so that they
    move to the device with the model; Python numbers stay static
    arguments, except a float beside an integer or boolean Node (a discrete
    variable): it becomes a float constant too, so that `0.1 * k` comes out
    in the model's float type as in the JAX package, not in torch's default
    float32. kwargs must be static.
    """
    args = lift(args)
    if any(isinstance(a, Node) for a in args):
        promote = any(isinstance(a, Node) and not a.dtype.is_floating_point for a in args)
        args = tuple(
            a if isinstance(a, Node) or (
                isinstance(a, numbers.Number) and not (promote and isinstance(a, float)))
            else as_node(a)
            for a in args
        )
        return DeterministicNode(fn, args, kwargs)
    return fn(*args, **kwargs)


def _meta(x):
    """Shape-only stand-in for a Node argument."""
    return torch.empty(x.shape, dtype=x.dtype, device="meta")


def _reverse_axes(x):
    """x with its axes in reverse order (numpy's `.T` on any ndim)."""
    return x.permute(*reversed(range(x.ndim)))


def _torch_dtype(dtype):
    """A torch dtype from a torch dtype, a numpy dtype or a dtype name."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.empty(0, dtype=np.dtype(dtype))).dtype


def _cast(x, dtype):
    return x.to(dtype)


def _squeeze(x, axis=None):
    return torch.squeeze(x) if axis is None else torch.squeeze(x, axis)


def _axes(axis, ndim):
    """numpy's `axis` (None, an int or a tuple) as a tuple of dims."""
    if axis is None:
        return tuple(range(ndim))
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def _reduce(x, op, axis=None, keepdims=False):
    """numpy's reductions (std and var with ddof 0; the mean of integers
    in float64) over `axis`, any number of axes at once."""
    dims = _axes(axis, x.ndim)
    if op in ("mean", "std", "var") and not x.is_floating_point():
        x = x.to(torch.float64)
    if op == "prod":
        # torch.prod takes one dim at a time; the last first, so the
        # others keep their numbers
        for d in sorted((d % x.ndim for d in dims), reverse=True):
            x = torch.prod(x, d, keepdim=keepdims)
        return x
    if op in ("std", "var"):
        fn = torch.std if op == "std" else torch.var
        return fn(x, dim=dims, correction=0, keepdim=keepdims)
    fn = {"sum": torch.sum, "mean": torch.mean, "max": torch.amax, "min": torch.amin}[op]
    if not dims:
        return x
    return fn(x, dim=dims, keepdim=keepdims)


def _cumsum(x, axis=None):
    """numpy's cumsum: over the flattened array where axis is None."""
    return torch.cumsum(x.reshape(-1), 0) if axis is None else torch.cumsum(x, axis)


def _dot(a, b):
    """numpy's dot: a product with a scalar, else a sum over the last axis
    of a and the second-to-last of b (the last where b is a vector)."""
    if a.ndim == 0 or b.ndim == 0:
        return a * b
    return torch.tensordot(a, b, dims=([a.ndim - 1], [max(b.ndim - 2, 0)]))


def _scalar_int(ix):
    return ix.ndim == 0 and not ix.dtype.is_floating_point and ix.dtype != torch.bool


def _index_by(x, ix):
    """x[ix] for an index array, or for a 0-d integer index read on the
    device (torch reads a 0-d index on the host, which neither the meta
    device nor vmap allows): a random index selects this way."""
    if ix.is_floating_point():
        raise TypeError("indices must be integers or booleans")
    if _scalar_int(ix):
        return x[ix.reshape(1)][0]
    return x[ix]


def _tuple_index(x, *arrays, index, pos):
    """x[index] with the arrays of the tuple `index` (at `pos`) taken from
    `arrays`, the graph inputs that carry them; where each is a 0-d integer
    (a random index), axis by axis on the device, as `_index_by`."""
    full = list(index)
    for p, ix in zip(pos, arrays):
        full[p] = ix
    if not all(_scalar_int(ix) for ix in arrays) or any(i is None or i is Ellipsis
                                                       for i in full):
        return x[tuple(full)]
    dim = 0
    for ix in full:
        if isinstance(ix, torch.Tensor):
            x = x[(slice(None),) * dim + (ix.reshape(1),)].squeeze(dim)
        elif isinstance(ix, slice):
            x = x[(slice(None),) * dim + (ix,)]
            dim += 1
        else:
            x = x.select(dim, ix)
    return x


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

    # -- the ndarray-like methods of pymc_tpu/graph.py:138-254 -------------
    @property
    def ndim(self):
        return len(self.shape)

    @property
    def size(self):
        return int(np.prod(self.shape)) if self.shape else 1

    @property
    def T(self):
        return apply(_reverse_axes, self)

    def astype(self, dtype):
        return apply(_cast, self, dtype=_torch_dtype(dtype))

    def reshape(self, *shape):
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        return apply(torch.reshape, self, shape=tuple(shape))

    def ravel(self):
        return apply(torch.ravel, self)

    def flatten(self):
        return apply(torch.ravel, self)

    def squeeze(self, axis=None):
        return apply(_squeeze, self, axis=axis)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (tuple, list)):
            axes = tuple(axes[0])
        if not axes:
            return self.T
        return apply(torch.permute, self, dims=tuple(axes))

    def sum(self, axis=None, keepdims=False):
        return apply(_reduce, self, op="sum", axis=axis, keepdims=keepdims)

    def prod(self, axis=None, keepdims=False):
        return apply(_reduce, self, op="prod", axis=axis, keepdims=keepdims)

    def mean(self, axis=None, keepdims=False):
        return apply(_reduce, self, op="mean", axis=axis, keepdims=keepdims)

    def std(self, axis=None, keepdims=False):
        return apply(_reduce, self, op="std", axis=axis, keepdims=keepdims)

    def var(self, axis=None, keepdims=False):
        return apply(_reduce, self, op="var", axis=axis, keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        return apply(_reduce, self, op="max", axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return apply(_reduce, self, op="min", axis=axis, keepdims=keepdims)

    def cumsum(self, axis=None):
        return apply(_cumsum, self, axis=axis)

    def dot(self, other):
        return apply(_dot, self, other)

    def __len__(self):
        if not self.shape:
            raise TypeError("len() of unsized Node")
        return self.shape[0]

    def __iter__(self):
        if not self.shape:
            raise TypeError("iteration over a 0-d Node")
        return (self[i] for i in range(self.shape[0]))

    def __getitem__(self, idx):
        if isinstance(idx, _INDEX_ARRAYS):
            # an array or random index: no marginal (index None)
            return apply(structural(lambda x, ix: _index_by(x, ix), "an index", index=None),
                         self, idx)
        if isinstance(idx, tuple):
            # the arrays of a tuple index (a[county, 0]) become graph
            # inputs too, so they move to the device with the model
            pos = [i for i, ix in enumerate(idx) if isinstance(ix, _INDEX_ARRAYS)]
            if pos:
                return apply(_tuple_index, self, *[idx[i] for i in pos], index=idx, pos=pos)
        # a static basic index: the marginal of the selected components
        return apply(structural(lambda x: x[idx], "an index", index=(idx,)), self)

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

    def __floordiv__(self, o):
        if not self._operand_ok(o):
            return NotImplemented
        return apply(operator.floordiv, self, o)

    def __rfloordiv__(self, o):
        return apply(operator.floordiv, o, self)

    def __mod__(self, o):
        if not self._operand_ok(o):
            return NotImplemented
        return apply(operator.mod, self, o)

    def __rmod__(self, o):
        return apply(operator.mod, o, self)

    def __matmul__(self, o):
        if not self._operand_ok(o):
            return NotImplemented
        return apply(operator.matmul, self, o)

    def __rmatmul__(self, o):
        return apply(operator.matmul, o, self)

    def __neg__(self):
        return apply(operator.neg, self)

    def __pos__(self):
        return self

    def __abs__(self):
        return apply(torch.abs, self)

    def __invert__(self):
        return apply(torch.logical_not, self)

    def __and__(self, o):
        if not self._operand_ok(o):
            return NotImplemented
        return apply(torch.logical_and, self, o)

    def __rand__(self, o):
        return apply(torch.logical_and, o, self)

    def __or__(self, o):
        if not self._operand_ok(o):
            return NotImplemented
        return apply(torch.logical_or, self, o)

    def __ror__(self, o):
        return apply(torch.logical_or, o, self)

    # comparisons build symbolic masks; hashing stays id-based, and a node
    # equals itself (so `in` and dict lookups by identity still work); a
    # foreign operand (None, a string) compares by identity
    def __lt__(self, o):
        return apply(operator.lt, self, o)

    def __le__(self, o):
        return apply(operator.le, self, o)

    def __gt__(self, o):
        return apply(operator.gt, self, o)

    def __ge__(self, o):
        return apply(operator.ge, self, o)

    def __eq__(self, o):
        if o is self:
            return True
        if not self._operand_ok(o):
            return NotImplemented
        return apply(operator.eq, self, o)

    def __ne__(self, o):
        if o is self:
            return False
        if not self._operand_ok(o):
            return NotImplemented
        return apply(operator.ne, self, o)

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


_INDEX_ARRAYS = (Node, np.ndarray, list, torch.Tensor)


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
    unless the env overrides it (reference model/core.py:1984). `mask`, a
    boolean ConstantNode or None, marks the MISSING entries of imputed data,
    whose logp terms are zeroed (pymc_tpu/graph.py ObservedRV.mask)."""

    def __init__(self, name, dist, observed, model=None, mask=None):
        self.name = name
        self.dist = dist
        self.observed = as_node(observed)
        self.shape = self.observed.shape
        self.dtype = self.observed.dtype
        self.model = model
        self.mask = None if mask is None else as_node(np.asarray(mask, dtype=bool))

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
        mask = [] if node.mask is None else [node.mask]
        return [node.observed] + mask + [p for p in node.dist.inputs() if isinstance(p, Node)]
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
