"""Crash-durable streaming trace and sampler checkpoint for resume.

Counterpart of `pymc_tpu/backends/checkpoint.py` (FileTrace :46; reference
pymc/backends/zarr.py ZarrTrace:279): a directory of npz chunk files and a
snapshot of the sampler state, with the same layout and semantics. Every
written chunk survives a crash, and `pm.sample(trace=FileTrace(path),
resume=True)` continues from the saved state (step sizes, mass, the
generator's position included) and draws what the uninterrupted run draws.

Where the JAX package flattens a pytree (`save_pytree` :25-43), the port
saves a dict of tensors, with the `torch.Generator`'s `get_state()` among
them, through `torch.save`; both are written through a temporary file and
`os.replace`, so a crash leaves the previous snapshot whole.
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

__all__ = ["FileTrace"]


def _atomic_write(target, write):
    """write(tmp) then os.replace(tmp, target): readers see the old file
    or the new one, never a torn one."""
    head, tail = os.path.split(target)
    tmp = os.path.join(head, f".tmp_{tail}")
    write(tmp)
    os.replace(tmp, target)


class FileTrace:
    """Append-only chunked trace store.

    Layout: <path>/meta.json, <path>/chunk_00000.npz (the (S, C, D) flat
    draws `q` and `stat_<name>` (S, C) arrays), <path>/state.pt (the
    sampler state: a dict of tensors).

    use_native_writer : accepted, as `pymc_tpu`'s FileTrace takes it. Chunks
        are written synchronously here, the path `pymc_tpu` takes when its
        native writer is unavailable; the asynchronous writer
        (`backends/native_writer.py`, `cc/trace_writer.cc`) waits for the
        ROADMAP item on durability.
    """

    def __init__(self, path, overwrite=False, use_native_writer=True):
        self.path = str(path)
        if overwrite and os.path.isdir(self.path):
            shutil.rmtree(self.path)
        os.makedirs(self.path, exist_ok=True)
        # numbered after what is on disk, so a resumed run appends
        self._next_chunk = self.n_chunks

    # ------------------------------------------------------------- writing
    def write_meta(self, meta):
        def write(tmp):
            with open(tmp, "w") as f:
                json.dump(meta, f)

        _atomic_write(os.path.join(self.path, "meta.json"), write)

    def read_meta(self):
        p = os.path.join(self.path, "meta.json")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            return json.load(f)

    @staticmethod
    def _is_chunk(fname):
        # completed chunks only: temporary files are dot-prefixed
        return fname.startswith("chunk_") and fname.endswith(".npz")

    @property
    def n_chunks(self):
        return len([f for f in os.listdir(self.path) if self._is_chunk(f)])

    def write_chunk(self, q_draws, stats):
        """q_draws (S, C, D); stats {name: (S, C)}; numpy arrays or
        tensors. Atomic per chunk."""
        i = self._next_chunk
        self._next_chunk += 1
        payload = {"q": _numpy(q_draws)}
        for k, v in stats.items():
            payload[f"stat_{k}"] = _numpy(v)

        def write(tmp):
            with open(tmp, "wb") as f:
                np.savez(f, **payload)

        _atomic_write(os.path.join(self.path, f"chunk_{i:05d}.npz"), write)

    def close(self):
        """Every written chunk is on disk already: writes are synchronous."""
        self.flush()

    def flush(self):
        pass

    def save_state(self, state):
        """state: {name: tensor} (on any device; saved from the host)."""
        host = {k: v.detach().cpu() for k, v in state.items()}
        _atomic_write(os.path.join(self.path, "state.pt"), lambda tmp: torch.save(host, tmp))

    def load_state(self, device="cpu"):
        """The dict `save_state` wrote, its tensors on `device`, or None
        when there is none. A generator's state, saved under "rng", stays
        on the host, where `torch.Generator.set_state` takes it."""
        p = os.path.join(self.path, "state.pt")
        if not os.path.exists(p):
            return None
        state = torch.load(p, map_location="cpu", weights_only=True)
        return {k: v if k == "rng" else v.to(device) for k, v in state.items()}

    def truncate(self, n_draws):
        """Keep the first chunks, which hold `n_draws` draws, and delete the
        rest: a chunk written after the last saved state, by a run that
        stopped before it could save the state that goes with it. Raises
        ValueError when no run of first chunks holds exactly n_draws."""
        files = sorted(f for f in os.listdir(self.path) if self._is_chunk(f))
        total = 0
        for k, f in enumerate(files):
            if total == n_draws:
                for extra in files[k:]:
                    os.remove(os.path.join(self.path, extra))
                break
            with np.load(os.path.join(self.path, f)) as raw:
                total += raw["q"].shape[0]
        if total != n_draws:
            raise ValueError(f"{self.path} holds {total} draws where its state says {n_draws}")
        self._next_chunk = self.n_chunks

    # ------------------------------------------------------------- reading
    def read_draws(self):
        """Every chunk concatenated: ((S_total, C, D) q, {name: (S_total,
        C)}), or (None, {}) when there is none."""
        self.flush()
        files = sorted(f for f in os.listdir(self.path) if self._is_chunk(f))
        qs, stats = [], {}
        for f in files:
            with np.load(os.path.join(self.path, f)) as raw:
                qs.append(raw["q"])
                for k in raw.files:
                    if k.startswith("stat_"):
                        stats.setdefault(k[5:], []).append(raw[k])
        if not qs:
            return None, {}
        return (
            np.concatenate(qs, axis=0),
            {k: np.concatenate(v, axis=0) for k, v in stats.items()},
        )


def _numpy(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
