"""Distribution base class.

Counterpart of `pymc_tpu/distributions/distribution.py` (reference
pymc/distributions/distribution.py: Distribution.__new__:465 named path,
.dist:597 unnamed path, support_point:679). A distribution is a plain object
whose parameters are graph Nodes (constants or outputs of other RVs); they
are resolved through the evaluation env, so a model's joint logp stays one
function of tensors.

Subclasses define `param_names`, `support`, `__dist_init__`, `_logp`,
`_sample` and `_support_point`, and `_logcdf` and `_icdf` where the JAX
class has them;
a multivariate one also sets `param_event_ndims` and `event_ndim` and
defines `_event_shape` (reference distribution.py:87-111). A class with an
"interval" support defines `_interval_bounds`, which its default transform
reads. Draws take an explicit `torch.Generator` on the device of the
parameters, and come in their float type.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import intX
from ..graph import FreeRV, Node, apply, as_node, evaluate
from . import transforms as tr
from .dist_math import check_icdf_value, log1mexp

__all__ = ["Distribution", "Continuous", "Discrete", "DiracDelta", "UNSET"]


class _Unset:
    """Marks a keyword argument that was not given (`transform=None` means
    something else)."""

    def __repr__(self):
        return "UNSET"


UNSET = _Unset()
# numbers the anonymous random-variable nodes of unnamed distributions
_ANON_RV_COUNTER = 0


def standard_normal(generator, shape, like):
    """N(0, 1) draws of `shape` in `like`'s float type, on its device."""
    return torch.randn(shape, generator=generator, dtype=like.dtype, device=like.device)


def standard_uniform(generator, shape, like):
    """U(0, 1) draws of `shape` in `like`'s float type, on its device."""
    return torch.rand(shape, generator=generator, dtype=like.dtype, device=like.device)


def as_param(x):
    """A distribution parameter as a Node; concrete values become float
    ConstantNodes so that they move to the device with the model (as floats:
    an integer parameter like `sigma=5` must not stay an integer tensor)."""
    if isinstance(x, Node):
        return x
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return as_node(x.to(torch.float64))  # keeps its autograd history
    return as_node(np.asarray(x, dtype=np.float64))


class Distribution:
    param_names: tuple = ()
    # optional parametrisations handed to _logp/_logcdf as keyword
    # arguments where set (the logit of a sigmoid-headed `p`, NegativeBinomial's
    # own mu): the density then reads them in place of `p`, which is not
    # evaluated (pymc_tpu/distributions/distribution.py aux_param_names)
    aux_param_names: tuple = ()
    # per-parameter event ndim (default zeros): the trailing dims of each
    # parameter that are not batch dims
    param_event_ndims: tuple | None = None
    # ndim of one event: 0 scalar, 1 vector
    event_ndim: int = 0
    support: str = "real"
    is_discrete: bool = False
    # graph.apply and pm.math lift an unnamed distribution among their
    # operands to its anonymous random-variable node (`to_node`), so that an
    # expression over `.dist()` objects is a graph the logprob engine derives
    # a density from (pymc_tpu/distributions/distribution.py:114-189)
    _lift_to_node: bool = True
    __array_ufunc__ = None  # numpy defers to the reflected operators below
    __array_priority__ = 1000

    def to_node(self, name=None):
        """The anonymous FreeRV of this unnamed distribution, made once and
        cached: reusing one `.dist()` object reuses one random leaf (`x =
        Normal.dist(); x + x` is 2x, not the sum of two draws)."""
        node = getattr(self, "_anon_node", None)
        if node is None:
            global _ANON_RV_COUNTER
            _ANON_RV_COUNTER += 1
            node = FreeRV(name or f"_anon_rv_{_ANON_RV_COUNTER}", dist=self,
                          shape=self.shape, dtype=self.dtype)
            self._anon_node = node
        return node

    # arithmetic over unnamed distributions builds graph expressions through
    # the anonymous node
    def __add__(self, o):
        return self.to_node() + o

    def __radd__(self, o):
        return o + self.to_node()

    def __sub__(self, o):
        return self.to_node() - o

    def __rsub__(self, o):
        return o - self.to_node()

    def __mul__(self, o):
        return self.to_node() * o

    def __rmul__(self, o):
        return o * self.to_node()

    def __truediv__(self, o):
        return self.to_node() / o

    def __rtruediv__(self, o):
        return o / self.to_node()

    def __pow__(self, o):
        return self.to_node() ** o

    def __rpow__(self, o):
        return o ** self.to_node()

    def __neg__(self):
        return -self.to_node()

    def __abs__(self):
        return abs(self.to_node())

    def __matmul__(self, o):
        return self.to_node() @ o

    def __rmatmul__(self, o):
        return o @ self.to_node()

    def __getitem__(self, idx):
        return self.to_node()[idx]

    def __gt__(self, o):
        return self.to_node() > o

    def __lt__(self, o):
        return self.to_node() < o

    def __ge__(self, o):
        return self.to_node() >= o

    def __le__(self, o):
        return self.to_node() <= o

    def __new__(cls, name=None, *args, **kwargs):
        """Named-RV path: create the distribution and register it in the
        current model context (reference distribution.py:475-573)."""
        from ..model.core import Model

        if not isinstance(name, str):
            raise TypeError(
                f"Name argument to {cls.__name__} must be a string; got "
                f"{type(name).__name__}. Use .dist() for unnamed distributions."
            )
        observed = kwargs.pop("observed", None)
        dims = kwargs.pop("dims", None)
        # only meaningful on the named path: they go to register_rv, or to
        # the class's hook (e.g. the ordered classes' compute_p)
        transform = kwargs.pop("transform", UNSET)
        default_transform = kwargs.pop("default_transform", UNSET)
        initval = kwargs.pop("initval", None)
        named = {k: kwargs.pop(k) for k in cls._named_only_kwargs if k in kwargs}
        model = Model.get_context()
        sized = kwargs.get("shape") is not None or kwargs.get("size") is not None
        if observed is not None and not sized:
            kwargs["shape"] = np.shape(observed)
        elif dims is not None and not sized:
            kwargs["shape"] = model.shape_from_dims(dims)
        dist = cls.dist(*args, **kwargs)
        rv = model.register_rv(
            dist, name, observed=observed, dims=dims, transform=transform,
            default_transform=default_transform, initval=initval,
        )
        cls._post_register(model, name, dist, rv, **named)
        return rv

    # keyword arguments of the named path only, handed to _post_register
    _named_only_kwargs: tuple = ()

    @classmethod
    def _post_register(cls, model, name, dist, rv, **named):
        """Called after a named random variable is registered."""

    @classmethod
    def dist(cls, *args, shape=None, size=None, **kwargs):
        """Unnamed-distribution path (reference distribution.py:597):
        `shape` is the whole shape, `size` the batch shape alone."""
        if shape is not None and size is not None:
            raise ValueError("Cannot pass both shape and size")
        obj = object.__new__(cls)
        if isinstance(shape, (int, np.integer)):
            shape = (int(shape),)
        if isinstance(size, (int, np.integer)):
            size = (int(size),)
        # the requested shape, which a time series reads its steps from
        obj._shape_arg = None if shape is None else tuple(shape)
        obj._size_arg = None if size is None else tuple(size)
        obj.__dist_init__(*args, **kwargs)
        if obj._size_arg is not None:
            # the event shape comes from the parameters
            obj._resolve_shapes(None)
            obj._shape_arg = obj._size_arg + tuple(obj.event_shape)
        obj._resolve_shapes(obj._shape_arg)
        return obj

    def _resolve_shapes(self, shape):
        """Set batch_shape, event_shape and shape from the parameters'
        shapes, or from a requested `shape` they broadcast to."""
        pshapes = [() if p is None else tuple(p.shape) for p in self.param_values()]
        event_ndims = self.param_event_ndims or (0,) * len(pshapes)
        batch = tuple(np.broadcast_shapes(
            *[s[: len(s) - e] for s, e in zip(pshapes, event_ndims)]
        ))
        event = tuple(self._event_shape(*pshapes))
        if shape is not None:
            if event and shape[len(shape) - len(event):] != event:
                raise ValueError(
                    f"shape {shape} incompatible with event shape {event} of "
                    f"{type(self).__name__}"
                )
            requested = shape[: len(shape) - len(event)]
            # the requested batch shape must be reachable by broadcasting the params
            np.broadcast_shapes(requested, batch)
            batch = requested
        self.batch_shape = batch
        self.event_shape = event
        self.shape = batch + event

    def __dist_init__(self, *args, **kwargs):  # pragma: no cover - abstract
        raise NotImplementedError

    def _event_shape(self, *param_shapes):
        return ()

    def param_values(self):
        return [getattr(self, n) for n in self.param_names]

    def inputs(self):
        """Every value the distribution reads: the graph walks these to find
        a random variable's parents and the constants to place on the
        device (a mixture adds its components')."""
        return self.param_values() + list(self._aux().values())

    def _aux(self):
        """{name: node} of the auxiliary parametrisations that are set."""
        return {n: getattr(self, n) for n in self.aux_param_names
                if getattr(self, n, None) is not None}

    def resolve_params(self, env=None, memo=None, skip=()):
        """The parameters' values; None for a name in `skip` or a parameter
        that is None."""
        if memo is None:
            memo = {}
        return tuple(
            None if (p is None or n in skip) else evaluate(p, env, memo)
            for n, p in zip(self.param_names, self.param_values())
        )

    def _cast_value(self, value, params):
        # through numpy, so that a Python float is float64, not torch's float32
        value = value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))
        if not self.is_discrete and not value.is_floating_point():
            floats = [p for p in params if p is not None and p.is_floating_point()]
            value = value.to(floats[0].dtype if floats else torch.float64)
        return value

    @property
    def dtype(self):
        return torch.float64

    def logp(self, value, env=None, memo=None):
        """Elementwise log-density of `value` over the batch shape. A set
        auxiliary parametrisation stands in for `p` there, which is left
        unevaluated (its sigmoid would be computed for nothing)."""
        memo = {} if memo is None else memo
        aux = {n: evaluate(v, env, memo) for n, v in self._aux().items()}
        params = self.resolve_params(env, memo, skip=("p",) if aux else ())
        return self._logp(self._cast_value(value, params), *params, **aux)

    def logcdf(self, value, env=None, memo=None):
        """Elementwise log of the cdf at `value`."""
        memo = {} if memo is None else memo
        aux = {n: evaluate(v, env, memo) for n, v in self._aux().items()}
        params = self.resolve_params(env, memo)
        return self._logcdf(self._cast_value(value, params), *params, **aux)

    def _logcdf(self, value, *params, **aux):
        raise NotImplementedError(f"logcdf not implemented for {type(self).__name__}")

    def logccdf(self, value, env=None, memo=None):
        """Elementwise log of the survival function at `value`: the class's
        `_logccdf` where it has one (stable in the upper tail: Normal,
        Exponential, Weibull), else log1mexp of `logcdf`
        (`pymc_tpu/distributions/distribution.py:371-399`)."""
        memo = {} if memo is None else memo
        params = self.resolve_params(env, memo)
        try:
            return self._logccdf(self._cast_value(value, params), *params)
        except NotImplementedError:
            return log1mexp(self.logcdf(value, env, memo))

    def _logccdf(self, value, *params):
        raise NotImplementedError

    def icdf(self, q, env=None, memo=None):
        """The quantile function at `q`, cast to the parameters' float type
        and device; NaN for q outside [0, 1] (`pymc_tpu/distributions/
        distribution.py:383-388`)."""
        memo = {} if memo is None else memo
        params = self.resolve_params(env, memo)
        floats = [p for p in params if p is not None and p.is_floating_point()]
        q = q if isinstance(q, torch.Tensor) else torch.as_tensor(np.asarray(q))
        q = q.to(floats[0]) if floats else q.to(torch.float64)
        return check_icdf_value(self._icdf(q, *params), q)

    def _icdf(self, q, *params):
        raise NotImplementedError(f"icdf not implemented for {type(self).__name__}")

    def sample(self, generator, sample_shape=(), env=None, memo=None):
        """Draws of shape sample_shape + self.shape from `generator` (a
        torch.Generator on the parameters' device); int64 for a discrete
        distribution, else the parameters' float type."""
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        draw = self._sample(
            generator, tuple(sample_shape) + self.shape, *self.resolve_params(env, memo)
        )
        return draw.to(intX()) if self.is_discrete else draw

    def _sample(self, generator, shape, *params):  # pragma: no cover - abstract
        raise NotImplementedError(f"random sampling not implemented for {type(self).__name__}")

    def support_point(self, env=None, memo=None):
        """Finite, in-support initial value (reference support_point:679)."""
        pt = torch.as_tensor(self._support_point(*self.resolve_params(env, memo)))
        if self.is_discrete:
            pt = pt.to(intX())
        return torch.broadcast_to(pt, self.shape)

    def default_transform(self):
        """Default value transform from the support declaration (reference
        pymc/distributions/transforms.py:55; pymc_tpu distribution.py:445-466)."""
        if self.is_discrete:
            return None
        s = self.support
        if s == "positive":
            return tr.log
        if s == "unit_interval":
            return tr.logodds
        if s == "interval":
            return tr.IntervalTransform(*self._interval_bounds())
        if s == "simplex":
            return tr.simplex
        if s == "circular":
            return tr.circular
        if s == "ordered":
            return tr.ordered
        return None

    def _interval_bounds(self):
        """(lower, upper) of an "interval" support, either None where open."""
        raise NotImplementedError(f"{type(self).__name__} has no interval bounds")

    def _gathered(self, shape, idx, batch_shape, extra_event=()):
        """This distribution restricted to the flat batch indices `idx` of
        `batch_shape`, with shape `shape + extra_event` (imputation). Rebuilt
        by parameter name, as the JAX package does (its positional order
        differs from the constructor's in some classes)."""
        pe = self.param_event_ndims or (0,) * len(self.param_names)
        kwargs = {
            name: _gather_batch_param(p, batch_shape, idx, e)
            for name, p, e in zip(self.param_names, self.param_values(), pe)
            if p is not None
        }
        return type(self).dist(shape=tuple(shape) + tuple(extra_event), **kwargs)

    def __repr__(self):
        return f"<{type(self).__name__} shape={self.shape}>"


class Continuous(Distribution):
    is_discrete = False


def _gather_batch_param(p, shape, idx, event_ndim=0):
    """Parameter `p` broadcast over the value's batch `shape` (keeping its
    own trailing `event_ndim` dims) and gathered at the flat batch indices
    `idx` (pymc_tpu/distributions/distribution.py:543). The indices are a
    constant of the graph, so they move to the device with the model."""
    if p is None:
        return None

    def gather(x, ix):
        ev = tuple(x.shape[x.ndim - event_ndim:]) if event_ndim else ()
        return torch.broadcast_to(x, tuple(shape) + ev).reshape((-1,) + ev)[ix]

    return apply(gather, p, np.asarray(idx, dtype=np.int64))


def _scatter_positions(mask):
    """(flat mask, for each flat position the index of its entry among the
    missing ones, 0 where observed): the constants that put the missing
    entries into a full-shape value by a gather and a where, which vmap and
    CUDA-graph capture both take."""
    flat = np.asarray(mask, bool).ravel()
    pos = np.where(flat, np.cumsum(flat) - 1, 0).astype(np.int64)
    return as_node(flat), as_node(pos)


def scatter_missing(full, missing, flat_mask, pos):
    """`full` with its masked entries replaced, in order, by `missing`."""
    flat = full.reshape(-1)
    vals = missing.reshape(-1)[pos].to(flat.dtype)
    return torch.where(flat_mask, vals, flat).reshape(full.shape)


class _PartialObservedSlots(Distribution):
    """Value slots for the missing entries of a multivariate value whose
    mask splits its event rows: the joint observed term carries the whole
    density, so the slots add zero (pymc_tpu/distributions/distribution.py:
    563; reference partial_observed_rv_logprob); forward draws take the
    missing positions of a full draw of the base."""

    param_names = ()

    def __dist_init__(self, base, mask):
        self.base = base
        self._mask = np.asarray(mask, bool)
        self._idx = as_node(np.nonzero(self._mask.ravel())[0].astype(np.int64))
        self.is_discrete = base.is_discrete

    @property
    def dtype(self):
        return self.base.dtype

    def inputs(self):
        return [self._idx] + self.base.inputs()

    def default_transform(self):
        return None

    def logp(self, value, env=None, memo=None):
        value = torch.as_tensor(value)
        dtype = value.dtype if value.is_floating_point() else torch.float64
        return torch.zeros(value.shape, dtype=dtype, device=value.device)

    def sample(self, generator, sample_shape=(), env=None, memo=None):
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        draw = self.base.sample(generator, tuple(sample_shape), env, memo)
        flat = draw.reshape(tuple(sample_shape) + (-1,))
        return flat[..., evaluate(self._idx, env, memo)]

    def support_point(self, env=None, memo=None):
        sp = torch.broadcast_to(self.base.support_point(env, memo), self.base.shape)
        return sp.reshape(-1)[evaluate(self._idx, env, memo).cpu()]


class _PartialObservedJoint(Distribution):
    """The observed part of a multivariate value whose mask splits its
    event rows: its logp is the base's joint density of the value with the
    `{name}_unobserved` slots put into its missing entries
    (pymc_tpu/distributions/distribution.py:602)."""

    param_names = ()

    def __dist_init__(self, base, mask, free_name):
        self.base = base
        self._mask = np.asarray(mask, bool)
        self._flat_mask, self._pos = _scatter_positions(self._mask)
        self._free_name = free_name
        self.is_discrete = base.is_discrete

    @property
    def dtype(self):
        return self.base.dtype

    def inputs(self):
        return [self._flat_mask, self._pos] + self.base.inputs()

    def default_transform(self):
        return None

    def logp(self, value, env=None, memo=None):
        memo = {} if memo is None else memo
        value = torch.as_tensor(value)
        free_vals = (env or {}).get(self._free_name)
        if free_vals is not None:
            if not value.is_floating_point():
                value = value.to(free_vals.dtype if free_vals.is_floating_point()
                                 else torch.float64)
            value = scatter_missing(value, free_vals, evaluate(self._flat_mask, env, memo),
                                    evaluate(self._pos, env, memo))
        return self.base.logp(value, env, memo)

    def sample(self, generator, sample_shape=(), env=None, memo=None):
        # the full-shape base draw; the combined deterministic puts the
        # slots' draw into its missing entries
        return self.base.sample(generator, sample_shape, env, memo)

    def support_point(self, env=None, memo=None):
        return torch.broadcast_to(self.base.support_point(env, memo), self.base.shape)


class Discrete(Distribution):
    """Integer-valued: values are int64, and there is no default transform
    (reference distribution.py:498)."""

    is_discrete = True
    support = "discrete"

    @property
    def dtype(self):
        return intX()

    def default_transform(self):
        return None


class DiracDelta(Discrete):
    """Point mass at c (pymc_tpu/distributions/distribution.py:506; reference
    distribution.py:740): logp 0 where the value is close to c (numpy's
    isclose) and -inf elsewhere. c keeps its own type: the draws and the
    support point are c itself, a float or an integer."""

    param_names = ("c",)

    def __dist_init__(self, c):
        self.c = c if isinstance(c, Node) else as_node(np.asarray(c))

    @property
    def dtype(self):
        return self.c.dtype

    def _cast_value(self, value, params):
        return value if isinstance(value, torch.Tensor) else torch.as_tensor(np.asarray(value))

    def _logp(self, value, c):
        dt = torch.promote_types(value.dtype, c.dtype)
        dt = dt if dt.is_floating_point else torch.float64
        out = torch.where(torch.isclose(value.to(dt), c.to(dt)), 0.0, -torch.inf)
        return out.to(dt)

    def _logcdf(self, value, c):
        dt = torch.promote_types(value.dtype, c.dtype)
        dt = dt if dt.is_floating_point else torch.float64
        return torch.where(value >= c, 0.0, -torch.inf).to(dt)

    def sample(self, generator, sample_shape=(), env=None, memo=None):
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        return torch.broadcast_to(evaluate(self.c, env, memo), tuple(sample_shape) + self.shape)

    def support_point(self, env=None, memo=None):
        return torch.broadcast_to(evaluate(self.c, env, memo), self.shape)
