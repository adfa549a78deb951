"""NUTS and HamiltonianMC as step methods of a compound.

Counterpart of `pymc_tpu/step_methods/hmc.py` (NUTS :33, HamiltonianMC
:146; reference pymc/step_methods/hmc/nuts.py:132 and hmc/hmc.py:45).
`sample` runs a model without discrete variables through its own NUTS
loop (sampling/mcmc.py); these steps let a continuous block take its turn
beside discrete steps, or run HamiltonianMC when it is asked for. Each
chain keeps its own dual averaging, started at a step size of 0.1, and its
own diagonal Welford window: the mass switches to the window's variances
at every tune-interval draw of the warmup.

The block's density holds the other variables at their current values
(`BlockedStep._block_logp_grad`): the captured logp+grad sees one (C, D)
flat point.

NUTS draws through `sampling/nuts.py::nuts_transition`, so every leapfrog
of its tree launches `nuts_leaf_kernel` on the card, and every subtree
starts with one `leapfrog_kick_drift` kernel. The chains' trees advance in
lock-step until the deepest one stops: `leapfrogs` counts the lock-step
leaves, `subtrees` the subtrees, the stat n_steps each chain's own leaves.

HamiltonianMC takes n_steps = clip(path_length / step_size, 1, max_steps)
leapfrogs in each chain. The JAX step scans all max_steps (1024) with the
finished chains masked; here the draw reads the largest n_steps over the
chains once (`host_reads`) and runs that many leapfrogs, a finished
chain's step size set to 0, which leaves its position and momentum as
they are. Each leapfrog is one `leapfrog_kick_drift` kernel, one logp+grad
and one `leapfrog_final_kick` kernel; `leapfrogs` counts them.

The draws asked for: NUTS, those of one transition (`StepDraws.nuts`);
HamiltonianMC, normal (C, D) for the momentum, then uniform (C,).
"""

from __future__ import annotations

import torch

from ..ops.leapfrog import leapfrog_final_kick, leapfrog_kick_drift
from ..sampling.adaptation import (
    da_init,
    da_update,
    welford_init,
    welford_update,
    welford_variance,
)
from ..sampling.nuts import nuts_transition
from .compound import BlockedStep, Competence, _ravel_block, _unravel_block, flat_point

__all__ = ["NUTS", "HamiltonianMC"]


class _Hamiltonian(BlockedStep):
    """The adaptation state and its update, which NUTS and HamiltonianMC
    share (pymc_tpu/step_methods/hmc.py:69-144)."""

    def __init__(self, vars, target_accept, model):
        super().__init__(vars, model)
        if any(self.discrete):
            raise ValueError(f"{type(self).__name__} requires continuous variables")
        self.target_accept = target_accept
        self.leapfrogs = 0
        self.host_reads = 0

    def init_state(self, point, chains, draws):
        density = self._density(point)
        kw = dict(dtype=density.dtype, device=density.device)
        return {
            "da": da_init(torch.full((chains,), 0.1, **kw)),
            "wf": welford_init(chains, self.D, **kw),
            "inv_mass": torch.ones((chains, self.D), **kw),
        }

    def _start(self, point, state, flags):
        """(the block's logp+grad, q, logp, grad, step size) at the point."""
        density = self._density(point)
        full = flat_point(point, density.info, density.dtype)
        logp_grad = self._block_logp_grad(density, full)
        q = _ravel_block(point, self.names, density.dtype)
        logp, grad = logp_grad(q)
        da = state["da"]
        step_size = torch.exp(da.log_step if flags["is_tune"] else da.log_step_avg)
        return logp_grad, q, logp, grad, step_size

    def _adapt(self, state, q, accept, flags):
        """Dual averaging on `accept` and the Welford window on q, in the
        warmup only; the mass switches at each tune-interval draw."""
        if not flags["is_tune"]:
            return state
        da = da_update(state["da"], accept, self.target_accept)
        wf = welford_update(state["wf"], q)
        inv_mass = state["inv_mass"]
        if flags["tune_now"]:
            inv_mass = welford_variance(wf).contiguous()
            wf = welford_init(q.shape[0], self.D, dtype=q.dtype, device=q.device)
        return {"da": da, "wf": wf, "inv_mass": inv_mass}


class NUTS(_Hamiltonian):
    name = "nuts"
    stats_names = ("tree_depth", "n_steps", "diverging", "energy", "acceptance_rate", "lp")

    def __init__(self, vars=None, max_treedepth=10, target_accept=0.8, step_scale=0.25,
                 model=None, **kwargs):
        super().__init__(vars, target_accept, model)
        self.max_treedepth = max_treedepth
        self.subtrees = 0

    @classmethod
    def competence(cls, var, has_grad):
        return Competence.INCOMPATIBLE if var.dist.is_discrete else Competence.IDEAL

    def step(self, draws, point, state, flags):
        logp_grad, q, logp, grad, step_size = self._start(point, state, flags)

        source = draws.nuts(*q.shape)
        direction = source.direction

        # the transition reads one count after each leaf, one `.any()`
        # before each doubling and one at its end (sampling/nuts.py)
        def counted(x):
            self.leapfrogs += 1
            self.host_reads += 1
            return logp_grad(x)

        def counted_direction(depth):
            self.host_reads += 1
            self.subtrees += 1
            return direction(depth)

        source.direction = counted_direction
        self.host_reads += 1
        (q_new, _, _), stats = nuts_transition(
            counted, source, q, logp, grad, step_size, state["inv_mass"],
            max_treedepth=self.max_treedepth,
        )
        point = _unravel_block(q_new, point, self.names, self.shapes, self.sizes, self.discrete)
        # a fully diverged trajectory's NaN acceptance counts as a rejection
        accept = torch.clamp(stats.acceptance_rate, 0.0, 1.0)
        accept = torch.where(torch.isfinite(accept), accept, 0.0)
        out = {"tree_depth": stats.depth, "n_steps": stats.n_steps,
               "diverging": stats.diverging, "energy": stats.energy,
               "acceptance_rate": stats.acceptance_rate, "lp": stats.lp}
        return point, self._adapt(state, q_new, accept, flags), out


class HamiltonianMC(_Hamiltonian):
    """Fixed-path-length HMC (reference hmc/hmc.py:45, step at :143)."""

    name = "hmc"
    stats_names = ("accepted", "energy", "lp", "acceptance_rate")

    def __init__(self, vars=None, path_length=2.0, max_steps=1024, target_accept=0.65,
                 model=None, **kwargs):
        super().__init__(vars, target_accept, model)
        self.path_length = float(path_length)
        self.max_steps = int(max_steps)

    @classmethod
    def competence(cls, var, has_grad):
        return Competence.INCOMPATIBLE if var.dist.is_discrete else Competence.COMPATIBLE

    def step(self, draws, point, state, flags):
        logp_grad, q, logp, grad, step_size = self._start(point, state, flags)
        inv_mass = state["inv_mass"]
        p0 = draws.normal(q.shape) / torch.sqrt(inv_mass)
        h0 = -logp + 0.5 * torch.sum(p0 * inv_mass * p0, dim=-1)
        n_steps = torch.clamp(
            self.path_length / torch.clamp(step_size, min=1e-10), max=float(self.max_steps)
        ).to(torch.int32).clamp(min=1)
        n_max = int(n_steps.max())
        self.host_reads += 1
        q_new, p_new, grad_new, logp_new = q, p0, grad, logp
        ke = None
        for i in range(n_max):
            eps = torch.where(n_steps > i, step_size, 0.0)
            q_new, p_half = leapfrog_kick_drift(q_new, p_new, grad_new, inv_mass, eps)
            logp_new, grad_new = logp_grad(q_new)
            p_new, ke = leapfrog_final_kick(p_half, grad_new, inv_mass, eps)
        self.leapfrogs += n_max
        h_new = -logp_new + ke
        log_acc = torch.clamp(h0 - h_new, max=0.0)
        log_acc = torch.where(torch.isfinite(log_acc), log_acc, -torch.inf)
        accept = torch.log(draws.uniform(logp.shape)) < log_acc
        q_out = torch.where(accept[:, None], q_new, q)
        point = _unravel_block(q_out, point, self.names, self.shapes, self.sizes, self.discrete)
        acc_prob = torch.exp(log_acc)
        stats = {"accepted": accept, "acceptance_rate": acc_prob,
                 "lp": torch.where(accept, logp_new, logp),
                 "energy": torch.where(accept, h_new, h0)}
        return point, self._adapt(state, q_out, acc_prob, flags), stats
