"""User-defined distributions.

Counterpart of `pymc_tpu/distributions/custom.py` (reference
pymc/distributions/custom.py:477 CustomDist, :851 DensityDist). The user's
callables receive the parameters as tensors on the model's device (float32
on the card) and return tensors:

  logp(value, *params), logcdf(value, *params)
  random(*params, rng=generator, size=shape): draws from a torch.Generator
      on the parameters' device (the JAX package passes a key)
  support_point(*params) (or moment=): an initial value
  dist(*params, size): a generating function that returns a Distribution,
      a random variable or a random expression over unnamed `.dist()`
      objects (`pm.math.exp(pm.Normal.dist(mu, sigma, size=size))`), whose
      distribution (derived by `distributions/transformed.py` for an
      expression) serves its density, cdf, draws, support point and
      transform where no explicit callable is given.

The logp runs inside the samplers' `torch.func.vmap` and, on the card, in
the logp+grad that `Model.logp_dlogp_fn` captures in a CUDA graph: a logp
that reads a value on the host cannot be captured and runs eagerly, with
the warning of `ops/cuda_graph.py`. Build constants with `torch.full` or
arithmetic on the parameters, not `torch.tensor(...)` of a host value.
"""

from __future__ import annotations

import re

import torch

from ..config import intX
from ..graph import FreeRV, Node, ObservedRV
from .distribution import Distribution, as_param
from .transformed import dist_from_expression

__all__ = ["CustomDist", "DensityDist"]


class CustomDist(Distribution):
    """Distribution from user callables (reference custom.py:477):
    *dist_params are passed to every callable; ndim_supp and ndims_params
    (or a gufunc `signature` such as "(n),()->(n)") give the event dims of
    the value and of each parameter; dtype "floatX" or an integer type;
    transform, the value transform of a free variable."""

    param_names = ()

    def __dist_init__(self, *dist_params, logp=None, logcdf=None, random=None, dist=None,
                      support_point=None, moment=None, ndim_supp=0, ndims_params=None,
                      signature=None, dtype="floatX", transform=None, class_name="CustomDist"):
        if signature is not None:
            ndims_params, ndim_supp = _parse_signature(signature, len(dist_params), class_name)
        self.dist_params = tuple(as_param(p) for p in dist_params)
        self.param_names = tuple(f"_p{i}" for i in range(len(self.dist_params)))
        self.param_event_ndims = tuple(
            ndims_params if ndims_params is not None else (0,) * len(self.dist_params))
        self._logp_fn = logp
        self._logcdf_fn = logcdf
        self._random_fn = random
        self._dist_fn = dist
        self._support_point_fn = support_point or moment
        self.event_ndim = int(ndim_supp)
        self._dtype_arg = dtype
        self._transform = transform
        self._name = class_name
        self._derived = None
        if logp is None and dist is None:
            raise TypeError(
                "CustomDist requires logp= or a symbolic dist= generating function "
                "(reference custom.py:477)"
            )
        if dist is not None:
            self._derived = self._derive_dist()

    def _derive_dist(self):
        """The distribution that the generating function returns (reference
        custom.py:214 CustomSymbolicDistRV); its shape becomes this one's."""
        size = self._size_arg
        if size is None and self._shape_arg is not None:
            sa = self._shape_arg
            size = sa[: len(sa) - self.event_ndim] if self.event_ndim else sa
        expr = self._dist_fn(*self.dist_params, size)
        if isinstance(expr, Distribution):
            derived = expr
        elif isinstance(expr, (FreeRV, ObservedRV)):
            derived = expr.dist
        elif isinstance(expr, Node):
            derived = dist_from_expression(expr)
        else:
            raise TypeError(
                f"{self._name}: dist= must return a distribution or a random expression "
                f"(got {type(expr).__name__}); eager samplers belong in random="
            )
        self._shape_arg = tuple(int(s) for s in derived.shape)
        self._size_arg = None
        if self.event_ndim == 0:
            self.event_ndim = int(derived.event_ndim)
        return derived

    def param_values(self):
        return list(self.dist_params)

    def inputs(self):
        extra = self._derived.inputs() if self._derived is not None else []
        return list(self.dist_params) + extra

    @property
    def is_discrete(self):
        if self._dtype_arg in ("int32", "int64", "int"):
            return True
        return self._derived is not None and bool(self._derived.is_discrete)

    @is_discrete.setter
    def is_discrete(self, v):
        pass

    @property
    def dtype(self):
        if self._dtype_arg in ("int32", "int64", "int"):
            return intX()
        if self._derived is not None:
            return self._derived.dtype
        return torch.float64

    def default_transform(self):
        if self._transform is not None:
            return self._transform
        if self._derived is not None and self._logp_fn is None:
            return self._derived.default_transform()
        return None

    def _event_shape(self, *param_shapes):
        if self._derived is not None:
            return tuple(self._derived.event_shape)
        if self.event_ndim == 0:
            return ()
        if self._shape_arg is not None:
            return tuple(self._shape_arg[-self.event_ndim:])
        for s, e in zip(param_shapes, self.param_event_ndims):
            if e >= self.event_ndim:
                return tuple(s[len(s) - self.event_ndim:])
        raise ValueError(f"{self._name}: cannot infer event shape; pass shape= explicitly")

    # explicit user callables win; otherwise the generating function's
    # distribution serves every query (reference custom.py:214)
    def logp(self, value, env=None, memo=None):
        if self._logp_fn is None and self._derived is not None:
            return self._derived.logp(value, env, memo)
        return super().logp(value, env, memo)

    def logcdf(self, value, env=None, memo=None):
        if self._logcdf_fn is None and self._derived is not None:
            return self._derived.logcdf(value, env, memo)
        return super().logcdf(value, env, memo)

    def logccdf(self, value, env=None, memo=None):
        if self._logcdf_fn is None and self._derived is not None:
            return self._derived.logccdf(value, env, memo)
        return super().logccdf(value, env, memo)

    def icdf(self, q, env=None, memo=None):
        if self._derived is not None:
            return self._derived.icdf(q, env, memo)
        return super().icdf(q, env, memo)

    def sample(self, generator, sample_shape=(), env=None, memo=None):
        if self._random_fn is None and self._derived is not None:
            return self._derived.sample(generator, sample_shape, env, memo)
        return super().sample(generator, sample_shape, env, memo)

    def support_point(self, env=None, memo=None):
        if self._support_point_fn is None and self._derived is not None:
            return self._derived.support_point(env, memo)
        return super().support_point(env, memo)

    def _logp(self, value, *params):
        if self._logp_fn is None:
            raise NotImplementedError(f"{self._name} has no logp")
        return torch.as_tensor(self._logp_fn(value, *params))

    def _logcdf(self, value, *params):
        if self._logcdf_fn is None:
            raise NotImplementedError(f"{self._name} has no logcdf")
        return torch.as_tensor(self._logcdf_fn(value, *params))

    def _sample(self, generator, shape, *params):
        if self._random_fn is None:
            raise NotImplementedError(f"{self._name} has no random= generating function")
        return torch.as_tensor(self._random_fn(*params, rng=generator, size=shape))

    def _support_point(self, *params):
        if self._support_point_fn is not None:
            return torch.as_tensor(self._support_point_fn(*params))
        like = next((p for p in params if p.is_floating_point()), None)
        if like is None:
            return torch.zeros((), dtype=torch.float64)
        return torch.zeros((), dtype=like.dtype, device=like.device)


def _parse_signature(signature, n_params, class_name):
    """A gufunc signature "(n),(m)->(n)" as (each parameter's core ndim, the
    value's core ndim)."""
    if "->" not in signature:
        raise ValueError(f"{class_name}: invalid signature {signature!r} (missing '->')")
    ins, outs = signature.split("->")
    in_specs = re.findall(r"\(([^)]*)\)", ins)
    out_specs = re.findall(r"\(([^)]*)\)", outs)
    if not out_specs:
        raise ValueError(f"{class_name}: invalid signature {signature!r} (no output spec)")
    if len(in_specs) != n_params:
        raise ValueError(
            f"{class_name}: signature {signature!r} declares {len(in_specs)} inputs but "
            f"{n_params} dist_params were given"
        )

    def core(spec):
        spec = spec.strip()
        return 0 if not spec else len(spec.split(","))

    return [core(sp) for sp in in_specs], core(out_specs[0])


DensityDist = CustomDist  # deprecated alias (reference custom.py:851)
