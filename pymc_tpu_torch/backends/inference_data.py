"""Native InferenceData container (xarray/arviz are intentionally not
dependencies — the reference delegates to ArviZ, backends/arviz.py:613; here a
compact named-dims container provides the same user surface: groups, named
dims/coords, slicing, summaries, netcdf-free persistence via npz).

A copy of `pymc_tpu/backends/inference_data.py` (numpy only): the JAX
package cannot be imported where the port runs, because its `__init__`
imports jax.
"""

from __future__ import annotations

import numpy as np

__all__ = ["DataVar", "Dataset", "InferenceData", "concat_chains"]

GROUPS = (
    "posterior",
    "sample_stats",
    "log_likelihood",
    "posterior_predictive",
    "predictions",
    "prior",
    "prior_predictive",
    "observed_data",
    "constant_data",
    "warmup_posterior",
    "warmup_sample_stats",
    "unconstrained_posterior",
)


class DataVar:
    """A named-dims array (mini xarray.DataArray)."""

    __slots__ = ("name", "values", "dims", "coords", "attrs")

    def __init__(self, name, values, dims=None, coords=None, attrs=None):
        self.name = name
        self.values = np.asarray(values)
        if dims is None:
            dims = tuple(f"{name}_dim_{i}" for i in range(self.values.ndim))
        self.dims = tuple(dims)
        if len(self.dims) != self.values.ndim:
            raise ValueError(
                f"dims {self.dims} do not match array ndim {self.values.ndim} for {name}"
            )
        self.coords = dict(coords or {})
        self.attrs = dict(attrs or {})

    @property
    def shape(self):
        return self.values.shape

    @property
    def ndim(self):
        return self.values.ndim

    @property
    def dtype(self):
        return self.values.dtype

    def _axis(self, dim):
        if isinstance(dim, int):
            return dim
        return self.dims.index(dim)

    def mean(self, dim=None):
        if dim is None:
            return self.values.mean()
        axes = tuple(self._axis(d) for d in ((dim,) if isinstance(dim, (str, int)) else dim))
        new_dims = tuple(d for i, d in enumerate(self.dims) if i not in axes)
        return DataVar(self.name, self.values.mean(axis=axes), new_dims, self.coords)

    def std(self, dim=None):
        if dim is None:
            return self.values.std()
        axes = tuple(self._axis(d) for d in ((dim,) if isinstance(dim, (str, int)) else dim))
        new_dims = tuple(d for i, d in enumerate(self.dims) if i not in axes)
        return DataVar(self.name, self.values.std(axis=axes), new_dims, self.coords)

    def sel(self, **kwargs):
        values = self.values
        dims = list(self.dims)
        for dim, idx in kwargs.items():
            ax = self._axis(dim)
            values = np.take(values, np.asarray(idx), axis=ax) if not np.isscalar(idx) else np.take(values, idx, axis=ax)
            if np.isscalar(idx):
                dims.pop(ax)
        return DataVar(self.name, values, dims, self.coords)

    def isel(self, **kwargs):
        return self.sel(**kwargs)

    def stack_sample(self):
        """Flatten (chain, draw, ...) -> (sample, ...)."""
        v = self.values
        if self.dims[:2] == ("chain", "draw"):
            return v.reshape((-1,) + v.shape[2:])
        return v

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.values, dtype=dtype)

    def __getitem__(self, idx):
        return self.values[idx]

    def __repr__(self):
        return (
            f"<DataVar '{self.name}' {dict(zip(self.dims, self.shape))} "
            f"{self.dtype}>"
        )


class Dataset:
    """Mapping of DataVar with shared coords (mini xarray.Dataset)."""

    def __init__(self, variables=None, coords=None, attrs=None):
        self._vars = dict(variables or {})
        self.coords = dict(coords or {})
        self.attrs = dict(attrs or {})

    def __getitem__(self, key):
        return self._vars[key]

    def __setitem__(self, key, var):
        self._vars[key] = var

    def __contains__(self, key):
        return key in self._vars

    def __iter__(self):
        return iter(self._vars)

    def __len__(self):
        return len(self._vars)

    def keys(self):
        return self._vars.keys()

    def values(self):
        return self._vars.values()

    def items(self):
        return self._vars.items()

    @property
    def data_vars(self):
        # xarray parity: Dataset.data_vars is a mapping property, not a method.
        return dict(self._vars)

    def __getattr__(self, name):
        vars_ = object.__getattribute__(self, "_vars")
        if name in vars_:
            return vars_[name]
        raise AttributeError(name)

    @property
    def dims(self):
        out = {}
        for v in self._vars.values():
            for d, s in zip(v.dims, v.shape):
                out[d] = s
        return out

    def mean(self, dim=None):
        return Dataset(
            {k: v.mean(dim=dim) for k, v in self._vars.items()}, self.coords
        )

    def __repr__(self):
        lines = [f"<Dataset: {len(self._vars)} variables>"]
        for k, v in self._vars.items():
            lines.append(f"  {k:24s} {dict(zip(v.dims, v.shape))} {v.dtype}")
        return "\n".join(lines)


class InferenceData:
    """Container of named Dataset groups (mini arviz.InferenceData)."""

    def __init__(self, **groups):
        self._groups = []
        for name, ds in groups.items():
            if ds is not None:
                self.add_group(name, ds)

    def add_group(self, name, ds):
        if isinstance(ds, dict):
            ds = Dataset(ds)
        setattr(self, name, ds)
        if name not in self._groups:
            self._groups.append(name)

    def extend(self, other, join="left"):
        for g in other.groups():
            if join == "left" and g in self._groups:
                continue
            self.add_group(g, getattr(other, g))

    def groups(self):
        return list(self._groups)

    def __contains__(self, group):
        return group in self._groups

    def __getitem__(self, group):
        if group not in self._groups:
            raise KeyError(group)
        return getattr(self, group)

    def __repr__(self):
        lines = ["Inference data with groups:"]
        for g in self._groups:
            lines.append(f"\t> {g}")
        return "\n".join(lines)

    # ------------------------------------------------------- persistence
    def to_netcdf(self, path):
        """netcdf-free persistence alias (npz store)."""
        return self.to_npz(path)

    def to_npz(self, path):
        """Persist all groups to a single compressed npz (netcdf stand-in).
        Stores per-variable dims plus each group's coords so named axes
        survive the round-trip."""
        payload = {}
        for g in self._groups:
            ds = getattr(self, g)
            for k, v in ds.items():
                payload[f"{g}/{k}"] = v.values
                payload[f"{g}/{k}/__dims__"] = np.array(v.dims, dtype="U64")
            for cname, cvals in getattr(ds, "coords", {}).items():
                payload[f"{g}/__coord__/{cname}"] = np.asarray(cvals)
        # write through a file object so the exact path is kept
        # (np.savez appends ".npz" to bare string paths)
        with open(path, "wb") as f:
            np.savez_compressed(f, **payload)

    @classmethod
    def from_npz(cls, path):
        raw = np.load(path, allow_pickle=False)
        groups, coords = {}, {}
        for key in raw.files:
            if key.endswith("/__dims__"):
                continue
            g, name = key.split("/", 1)
            if name.startswith("__coord__/"):
                coords.setdefault(g, {})[name.split("/", 1)[1]] = raw[key]
                continue
            dims = tuple(raw[f"{key}/__dims__"]) if f"{key}/__dims__" in raw.files else None
            groups.setdefault(g, {})[name] = DataVar(name, raw[key], dims)
        idata = cls()
        for g, vars_ in groups.items():
            idata.add_group(g, Dataset(vars_, coords.get(g, {})))
        return idata


def concat_chains(idata, group="posterior"):
    """Return {name: (chain*draw, ...) np.ndarray} for a group."""
    ds = getattr(idata, group)
    return {k: v.stack_sample() for k, v in ds.items()}
