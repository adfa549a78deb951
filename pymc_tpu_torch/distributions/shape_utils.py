"""Shape utilities.

Counterpart of `pymc_tpu/distributions/shape_utils.py` (reference
pymc/distributions/shape_utils.py: `to_tuple`, `rv_size_is_none`,
`change_dist_size`). Shapes themselves are resolved in
`Distribution._resolve_shapes`. The port's `.dist` takes `shape=` (batch
and event dims), not `size=`, so `change_dist_size` rebuilds with the new
batch shape followed by the distribution's event shape.
"""

from __future__ import annotations

import numpy as np

__all__ = ["to_tuple", "rv_size_is_none", "change_dist_size"]


def to_tuple(shape):
    """Canonicalize a shape spec: None -> (), int -> (int,)
    (reference shape_utils.py:to_tuple)."""
    if shape is None:
        return ()
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    try:
        return tuple(shape)
    except TypeError:
        return (shape,)


def rv_size_is_none(size):
    return size is None


def change_dist_size(dist, new_size, expand=False):
    """The unnamed distribution rebuilt with the batch shape `new_size`
    (with expand=True, `new_size` followed by its old batch shape), from
    its parameters by name (reference shape_utils.py:change_dist_size)."""
    new_size = to_tuple(new_size)
    if expand:
        new_size = new_size + tuple(dist.batch_shape)
    kw = {n: p for n, p in zip(dist.param_names, dist.param_values()) if p is not None}
    return type(dist).dist(shape=new_size + tuple(dist.event_shape), **kw)
