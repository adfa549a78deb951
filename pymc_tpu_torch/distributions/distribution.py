"""Distribution base class.

Counterpart of `pymc_tpu/distributions/distribution.py` (reference
pymc/distributions/distribution.py: Distribution.__new__:465 named path,
.dist:597 unnamed path, support_point:679). A distribution is a plain object
whose parameters are graph Nodes (constants or outputs of other RVs); they
are resolved through the evaluation env, so a model's joint logp stays one
function of tensors.

Subclasses define `param_names`, `support`, `__dist_init__`, `_logp` and
`_support_point`.
"""

from __future__ import annotations

import numpy as np
import torch

from ..graph import Node, as_node, evaluate
from . import transforms as tr

__all__ = ["Distribution", "Continuous"]


def as_param(x):
    """A distribution parameter as a Node; concrete values become float
    ConstantNodes so that they move to the device with the model (as floats:
    an integer parameter like `sigma=5` must not stay an integer tensor)."""
    if isinstance(x, Node):
        return x
    return as_node(np.asarray(x, dtype=np.float64))


class Distribution:
    param_names: tuple = ()
    support: str = "real"
    is_discrete: bool = False

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
        model = Model.get_context()
        if observed is not None and kwargs.get("shape") is None:
            kwargs["shape"] = np.shape(observed)
        elif dims is not None and kwargs.get("shape") is None:
            kwargs["shape"] = model.shape_from_dims(dims)
        dist = cls.dist(*args, **kwargs)
        return model.register_rv(dist, name, observed=observed, dims=dims)

    @classmethod
    def dist(cls, *args, shape=None, **kwargs):
        """Unnamed-distribution path (reference distribution.py:597)."""
        obj = object.__new__(cls)
        if isinstance(shape, (int, np.integer)):
            shape = (int(shape),)
        obj.__dist_init__(*args, **kwargs)
        batch = tuple(np.broadcast_shapes(*[p.shape for p in obj.param_values()]))
        if shape is not None:
            shape = tuple(shape)
            # the requested shape must be reachable by broadcasting the params
            np.broadcast_shapes(shape, batch)
            batch = shape
        obj.shape = batch
        return obj

    def __dist_init__(self, *args, **kwargs):  # pragma: no cover - abstract
        raise NotImplementedError

    def param_values(self):
        return [getattr(self, n) for n in self.param_names]

    def resolve_params(self, env=None, memo=None):
        return tuple(evaluate(p, env, memo) for p in self.param_values())

    @property
    def dtype(self):
        return torch.float64

    def logp(self, value, env=None, memo=None):
        """Elementwise log-density of `value` over the batch shape."""
        return self._logp(value, *self.resolve_params(env, memo))

    def support_point(self, env=None, memo=None):
        """Finite, in-support initial value (reference support_point:679)."""
        pt = self._support_point(*self.resolve_params(env, memo))
        return torch.broadcast_to(torch.as_tensor(pt), self.shape)

    def default_transform(self):
        """Default value transform from the support declaration
        (reference pymc/distributions/transforms.py:55)."""
        if self.support == "positive":
            return tr.log
        if self.support == "real":
            return None
        raise NotImplementedError(
            f"no default transform for support {self.support!r} in this port"
        )

    def __repr__(self):
        return f"<{type(self).__name__} shape={self.shape}>"


class Continuous(Distribution):
    is_discrete = False
