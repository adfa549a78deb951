"""Slice sampler.

Counterpart of `pymc_tpu/step_methods/slicer.py` (Slice :25; reference
pymc/step_methods/slicer.py:49): univariate slices with stepping out and
shrinking, coordinate by coordinate, the widths tuned during warmup. The
JAX step runs a `lax.while_loop` per chain for each search, capped at 16
steps out on each side and 64 shrinks. Here the chains advance together in
masked loops: a chain whose search ended keeps its interval while the
others go on. Both sides step out together, one (2C, D) density call an
iteration; each shrink is one (C, D) call.

Each loop iteration reads "is any chain still searching?" on the host,
and the loop stops when none is: one host read an iteration, counted in
`host_reads`. Running every loop to its cap with no read, the finished
chains masked, gives the same point fed the same draws, but costs more
than the reads: on one H100 it took 18.0-29.8 host ms a draw against
2.8-3.1 on Normal(1, 2) at 64 chains (81 density calls a draw against
11; PERF.md §6).

The draws it asks its source for, per coordinate: exponential (C,) for
the slice's height, uniform (C,) for the interval's position, then uniform
(C,) for each shrink iteration.
"""

from __future__ import annotations

import numpy as np
import torch

from .compound import BlockedStep, Competence, _unravel_block, flat_point

__all__ = ["Slice"]

_MAX_STEPS_OUT = 16
_MAX_SHRINK = 64


class Slice(BlockedStep):
    name = "slice"
    stats_names = ("nstep_out", "nstep_in")

    def __init__(self, vars=None, w=1.0, tune=True, iter_limit=np.inf, model=None, **kwargs):
        super().__init__(vars, model)
        if any(self.discrete):
            raise ValueError("Slice sampler requires continuous variables")
        self.initial_w = float(w)
        self.tune = tune
        self.host_reads = 0

    @classmethod
    def competence(cls, var, has_grad):
        if var.dist.is_discrete:
            return Competence.INCOMPATIBLE
        return Competence.COMPATIBLE

    def init_state(self, point, chains, draws):
        density = self._density(point)
        return {
            "w": torch.full((chains, self.D), self.initial_w, dtype=density.dtype,
                            device=density.device),
            "n_tunes": torch.zeros((chains,), dtype=density.dtype, device=density.device),
        }

    def _done(self, active):
        """True when no chain is active (one host read)."""
        self.host_reads += 1
        return not bool(active.any())

    def step(self, draws, point, state, flags):
        density = self._density(point)
        info, dtype = density.info, density.dtype
        full = flat_point(point, info, dtype)
        C = full.shape[0]
        w, n_tunes = state["w"].clone(), state["n_tunes"]
        out_ct = torch.zeros((C,), dtype=torch.int64, device=full.device)
        in_ct = torch.zeros_like(out_ct)
        for j, col in enumerate(self._cols):
            x0 = full[:, col]
            y = density.logp(full) - draws.exponential((C,))
            wj = w[:, j]
            left = x0 - wj * draws.uniform((C,))
            right = left + wj

            # step out: both ends at once, each while its logp is above y
            act = torch.ones((2 * C,), dtype=torch.bool, device=full.device)
            ends = torch.cat([left, right])
            delta = torch.cat([-wj, wj])
            both = torch.cat([full, full])
            for _ in range(_MAX_STEPS_OUT):
                both[:, col] = ends
                act = act & (density.logp(both) > torch.cat([y, y]))
                if self._done(act):
                    break
                ends = torch.where(act, ends + delta, ends)
                out_ct += (act[:C].to(torch.int64) + act[C:].to(torch.int64))
            left, right = ends[:C], ends[C:]

            # shrink towards x0 until a point of the slice is drawn
            accepted = torch.zeros((C,), dtype=torch.bool, device=full.device)
            x = x0.clone()
            trial = full.clone()
            for _ in range(_MAX_SHRINK):
                act = ~accepted
                if self._done(act):
                    break
                x_new = left + (right - left) * draws.uniform((C,))
                trial[:, col] = x_new
                ok = density.logp(trial) > y
                left = torch.where(act & ~(ok | (x_new >= x0)), x_new, left)
                right = torch.where(act & ~(ok | (x_new < x0)), x_new, right)
                x = torch.where(act & ok, x_new, x)
                accepted = accepted | (act & ok)
                in_ct += act.to(torch.int64)
            full = full.clone()
            full[:, col] = x
            if self.tune and flags["is_tune"]:
                # the width: a running mean of the final intervals' lengths
                w[:, j] = (wj * n_tunes + torch.abs(right - left)) / (n_tunes + 1.0)
        if self.tune and flags["is_tune"]:
            n_tunes = n_tunes + 1.0
        q = full.index_select(1, self._on("cols", self._cols, full))
        point = _unravel_block(q, point, self.names, self.shapes, self.sizes, self.discrete)
        return point, {"w": w, "n_tunes": n_tunes}, {"nstep_out": out_ct, "nstep_in": in_ct}
