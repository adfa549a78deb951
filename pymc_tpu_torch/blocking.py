"""Raveling between named value dicts and flat parameter vectors.

Counterpart of `pymc_tpu/blocking.py` (reference pymc/blocking.py:44-121).
The layout (names, order, shapes, sizes) is the reference's, so a flat
vector means the same thing in both packages.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["RaveledInfo", "ravel_point", "unravel_vector"]


@dataclass(frozen=True)
class RaveledInfo:
    """Static layout of the flat vector: (name, shape, size, dtype) per var
    in registration order (the reference's point_map_info)."""

    names: tuple
    shapes: tuple
    sizes: tuple
    dtypes: tuple

    @classmethod
    def from_rvs(cls, rvs):
        names, shapes, sizes, dtypes = [], [], [], []
        for rv in rvs:
            shape = tuple(rv.value_shape)
            names.append(rv.value_name)
            shapes.append(shape)
            sizes.append(int(np.prod(shape)) if shape else 1)
            dtypes.append(rv.dtype)
        return cls(tuple(names), tuple(shapes), tuple(sizes), tuple(dtypes))

    @property
    def total_size(self):
        return sum(self.sizes)

    def slices(self):
        out = {}
        off = 0
        for n, s in zip(self.names, self.sizes):
            out[n] = slice(off, off + s)
            off += s
        return out


def ravel_point(point, info: RaveledInfo):
    """{value_name: (..., *shape) tensor} -> flat (..., D) tensor. Leading
    batch axes (chains) carry through."""
    parts = []
    for n, shape in zip(info.names, info.shapes):
        v = point[n]
        lead = v.shape[: v.ndim - len(shape)]
        parts.append(v.reshape(tuple(lead) + (-1,)))
    return torch.cat(parts, dim=-1)


def unravel_vector(q, info: RaveledInfo):
    """flat (..., D) tensor -> {value_name: (..., *shape) tensor}."""
    out = {}
    off = 0
    lead = tuple(q.shape[:-1])
    for n, shape, size in zip(info.names, info.shapes, info.sizes):
        out[n] = q[..., off : off + size].reshape(lead + tuple(shape))
        off += size
    return out
