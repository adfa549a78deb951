"""Trace interface: the reference's chain-trace protocol.

A copy of `pymc_tpu/backends/base.py` (numpy only; reference
pymc/backends/base.py IBaseTrace:47, MultiTrace:322 and
backends/ndarray.py:27 NDArray): the JAX package cannot be imported where
the port runs, because its `__init__` imports jax. The sampler's output is
an InferenceData; these classes give code written against the reference
its record/get_values/get_sampler_stats/point access, and
`multitrace_from_idata` is what `sample(return_inferencedata=False)`
returns.
"""

from __future__ import annotations

import numpy as np

__all__ = ["IBaseTrace", "NDArray", "MultiTrace", "multitrace_from_idata",
           "ChainRecordAdapter"]


class IBaseTrace:
    """Reference backends/base.py:47."""

    chain: int = 0
    varnames: list = []

    def __len__(self):
        raise NotImplementedError

    def record(self, point, stats=None):
        raise NotImplementedError

    def get_values(self, varname, burn=0, thin=1):
        raise NotImplementedError

    def get_sampler_stats(self, stat_name, burn=0, thin=1):
        raise NotImplementedError

    def point(self, idx):
        raise NotImplementedError

    def close(self):
        pass


class NDArray(IBaseTrace):
    """In-memory list-backed trace (reference backends/ndarray.py:27)."""

    def __init__(self, chain=0, varnames=None):
        self.chain = chain
        self.varnames = list(varnames or [])
        self._draws = []
        self._stats = []

    def __len__(self):
        return len(self._draws)

    def record(self, point, stats=None):
        if not self.varnames:
            self.varnames = list(point.keys())
        self._draws.append({k: np.asarray(v) for k, v in point.items()})
        self._stats.append(dict(stats or {}))

    def get_values(self, varname, burn=0, thin=1):
        return np.asarray([d[varname] for d in self._draws[burn::thin]])

    def get_sampler_stats(self, stat_name, burn=0, thin=1):
        return np.asarray([s.get(stat_name) for s in self._stats[burn::thin]])

    def point(self, idx):
        return dict(self._draws[idx])


class MultiTrace:
    """Reference backends/base.py:322."""

    def __init__(self, straces):
        self._straces = {t.chain: t for t in straces}

    @property
    def nchains(self):
        return len(self._straces)

    @property
    def chains(self):
        return sorted(self._straces)

    @property
    def varnames(self):
        first = self._straces[self.chains[0]]
        return first.varnames

    def __len__(self):
        return len(self._straces[self.chains[0]])

    def get_values(self, varname, burn=0, thin=1, combine=True, chains=None):
        chains = self.chains if chains is None else chains
        vals = [
            self._straces[c].get_values(varname, burn, thin) for c in chains
        ]
        return np.concatenate(vals) if combine else vals

    def get_sampler_stats(self, stat_name, burn=0, thin=1, combine=True):
        vals = [
            self._straces[c].get_sampler_stats(stat_name, burn, thin)
            for c in self.chains
        ]
        return np.concatenate(vals) if combine else vals

    def point(self, idx, chain=None):
        chain = self.chains[-1] if chain is None else chain
        return self._straces[chain].point(idx)

    def __getitem__(self, varname):
        return self.get_values(varname)


class ChainRecordAdapter(IBaseTrace):
    """Adapt a chunked store (the FileTrace protocol: ``write_chunk`` /
    ``read_draws`` / ``write_meta`` / ``flush``) into the reference's
    point-oriented chain-trace interface.

    Parity: reference pymc/backends/mcbackend.py:94 (ChainRecordAdapter) —
    the bridge between pymc's ``record(point, stats)`` protocol and an
    external record-oriented backend. Here the external backend is any
    chunked store; points are raveled into flat rows and buffered into
    chunks so the store's durability semantics (atomic chunks, async C++
    writer) apply unchanged.
    """

    def __init__(self, store, chain=0, chunk_size=100):
        self.store = store
        self.chain = chain
        self.chunk_size = int(chunk_size)
        self._layout = None          # [(name, shape, size)]
        self._stat_names = None
        self._buf_q = []
        self._buf_stats = []
        self._len = 0
        meta = store.read_meta() if hasattr(store, "read_meta") else None
        if meta and "point_layout" in meta:
            self._layout = [
                (n, tuple(s), int(sz)) for n, s, sz in meta["point_layout"]
            ]
            self._stat_names = list(meta.get("stat_names", []))
            q, _ = store.read_draws()
            self._len = 0 if q is None else q.shape[0]

    @property
    def varnames(self):
        return [n for n, _, _ in (self._layout or [])]

    @varnames.setter
    def varnames(self, v):  # IBaseTrace class attr compat
        pass

    def __len__(self):
        return self._len

    def record(self, point, stats=None):
        if self._layout is None:
            self._layout = [
                (k, tuple(np.shape(v)), int(np.size(v)))
                for k, v in point.items()
            ]
            self._stat_names = sorted(stats) if stats else []
            if hasattr(self.store, "write_meta"):
                meta = self.store.read_meta() or {}
                meta["point_layout"] = [
                    [n, list(s), sz] for n, s, sz in self._layout
                ]
                meta["stat_names"] = self._stat_names
                self.store.write_meta(meta)
        row = np.concatenate(
            [np.ravel(np.asarray(point[n], dtype=np.float64))
             for n, _, _ in self._layout]
        ) if self._layout else np.zeros((0,))
        self._buf_q.append(row)
        self._buf_stats.append(
            [float(np.asarray((stats or {}).get(s, np.nan)))
             for s in self._stat_names]
        )
        self._len += 1
        if len(self._buf_q) >= self.chunk_size:
            self._flush_chunk()

    def _flush_chunk(self):
        if not self._buf_q:
            return
        q = np.stack(self._buf_q)[:, None, :]  # (S, C=1, D)
        stats = {
            s: np.asarray([r[i] for r in self._buf_stats])[:, None]
            for i, s in enumerate(self._stat_names)
        }
        self.store.write_chunk(q, stats)
        self._buf_q, self._buf_stats = [], []

    def close(self):
        self._flush_chunk()
        if hasattr(self.store, "close"):
            self.store.close()

    # --------------------------------------------------------------- reads
    def _all_rows(self):
        q, stats = self.store.read_draws()
        rows = [] if q is None else [q[:, 0, :]]
        if self._buf_q:
            rows.append(np.stack(self._buf_q))
        if not rows:
            D = sum(sz for _, _, sz in (self._layout or []))
            return np.zeros((0, D)), {}
        all_q = np.concatenate(rows, axis=0)
        all_stats = {}
        for i, s in enumerate(self._stat_names or []):
            parts = []
            if q is not None and s in stats:
                parts.append(stats[s][:, 0])
            if self._buf_stats:
                parts.append(np.asarray([r[i] for r in self._buf_stats]))
            if parts:
                all_stats[s] = np.concatenate(parts)
        return all_q, all_stats

    def _unpack(self, rows, name):
        off = 0
        for n, shape, sz in self._layout:
            if n == name:
                return rows[:, off:off + sz].reshape((rows.shape[0],) + shape)
            off += sz
        raise KeyError(name)

    def get_values(self, varname, burn=0, thin=1):
        rows, _ = self._all_rows()
        return self._unpack(rows, varname)[burn::thin]

    def get_sampler_stats(self, stat_name, burn=0, thin=1):
        _, stats = self._all_rows()
        return stats[stat_name][burn::thin]

    def point(self, idx):
        rows, _ = self._all_rows()
        row = rows[idx][None]
        return {n: self._unpack(row, n)[0] for n, _, _ in self._layout}


def multitrace_from_idata(idata):
    """Build a MultiTrace view over an InferenceData posterior."""
    post = idata.posterior
    names = list(post.keys())
    n_chains = post.dims.get("chain", 1)
    traces = []
    for c in range(n_chains):
        t = NDArray(chain=c, varnames=names)
        n_draws = post.dims.get("draw", 0)
        for i in range(n_draws):
            t.record({k: post[k].values[c, i] for k in names})
        traces.append(t)
    return MultiTrace(traces)
