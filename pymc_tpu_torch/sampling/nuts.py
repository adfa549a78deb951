"""Batched NUTS with an explicit chain axis and a diagonal mass.

Counterpart of `pymc_tpu/sampling/nuts.py::nuts_transition_batched`
(:564-729) and `_build_subtree_b` (:451-561); reference semantics from
pymc/step_methods/hmc/nuts.py (tree doubling to max_treedepth, multinomial
sampling via logaddexp log_size, generalized U-turn criterion, divergence at
dH > 1000). All chains advance in lock-step and finished chains are masked,
exactly what the JAX package's vmap-of-while lowers to.

The JAX package's `lax.while_loop`s become Python loops: the trajectory's
reads one `.any()` per doubling, the subtree's the count of active chains
after each leaf, so one host sync per leaf and per doubling. A subtree
starts with one half kick and drift (`leapfrog_kick_drift`); each leaf is
then `logp_grad_b(q')`, one uniform draw and one `nuts_leaf_step`, which
does the final kick, the tree bookkeeping and the next kick-drift in one
kernel launch on the card (ops/leapfrog.py).

Randomness is injected through a draw source (`TorchDraws` on a
`torch.Generator`), so the tests can replay the JAX package's key stream.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.leapfrog import SubtreeState, _w, nuts_leaf_step

__all__ = ["NutsStats", "SamplerState", "TorchDraws", "nuts_transition"]


class NutsStats(NamedTuple):
    depth: torch.Tensor
    n_steps: torch.Tensor
    diverging: torch.Tensor
    energy: torch.Tensor
    energy_error: torch.Tensor
    max_energy_error: torch.Tensor
    acceptance_rate: torch.Tensor
    lp: torch.Tensor


class SamplerState(NamedTuple):
    """Per-chain sampler state: q, grad, inv_mass (C, D); logp, step_size (C,)."""

    q: torch.Tensor
    logp: torch.Tensor
    grad: torch.Tensor
    inv_mass: torch.Tensor
    step_size: torch.Tensor


class TorchDraws:
    """The draws of one NUTS transition from a torch.Generator.

    The interface the transition calls, for C chains:
      momentum()               (C, D) standard normals
      direction(depth)         (C,) bool, True = extend to the right
      leaf_uniform(depth, n)   (C,) U(0, 1) for leaf n of the subtree at depth
      accept_uniform(depth)    (C,) U(0, 1) for the subtree merge at depth
    depth and n are (C,) int32 tensors. Each (depth, n) is asked for at most
    once per chain and transition, so fresh draws on every call give
    independent numbers; this source ignores the indices.
    """

    def __init__(self, generator, chains, dim, dtype, device):
        self.gen = generator
        self.C, self.D = chains, dim
        self.dtype, self.device = dtype, device

    def _uniform(self):
        return torch.rand(self.C, generator=self.gen, dtype=self.dtype, device=self.device)

    def momentum(self):
        return torch.randn(
            self.C, self.D, generator=self.gen, dtype=self.dtype, device=self.device
        )

    def direction(self, depth):
        return self._uniform() < 0.5

    def leaf_uniform(self, depth, n):
        return self._uniform()

    def accept_uniform(self, depth):
        return self._uniform()


def _build_subtree(
    logp_grad_b, draws, depth, active0, q0, p0, grad0, logp0, eps_signed,
    inv_mass, h0, max_treedepth,
):
    """2**depth leaves per active chain; chains that turn or diverge (or were
    inactive) are masked. The subtree's state lives in the buffers of a
    SubtreeState, which each leaf's `nuts_leaf_step` updates in place (see
    ops/leapfrog.py). Returns it and the first leaf's momentum."""
    s = SubtreeState(
        q0, p0, grad0, logp0, h0, inv_mass, eps_signed, active0, depth, max_treedepth + 1
    )
    while True:
        logp, grad = logp_grad_b(s.q_half)
        u = draws.leaf_uniform(depth, s.n)
        if not int(nuts_leaf_step(s, logp, grad, u)):
            # the first leaf's momentum sits at checkpoint slot 0 (leaf 0 is even)
            return s, s.p_ckpt[:, 0]


def nuts_transition(
    logp_grad_b, draws, q, logp, grad, step_size, inv_mass, *, max_treedepth=10
):
    """One NUTS draw for all chains.

    logp_grad_b: (C, D) -> (logp (C,), grad (C, D)); draws: a draw source
    (see TorchDraws); q, grad, inv_mass: (C, D); logp, step_size: (C,).
    Returns ((q, logp, grad), NutsStats) with every stat of shape (C,).
    """
    C, D = q.shape
    dtype, device = q.dtype, q.device
    p0 = draws.momentum() / torch.sqrt(inv_mass)
    h0 = -logp + 0.5 * torch.sum(p0 * (inv_mass * p0), dim=-1)

    zeros_c = torch.zeros((C,), dtype=dtype, device=device)
    false_c = torch.zeros((C,), dtype=torch.bool, device=device)
    depth = torch.zeros((C,), dtype=torch.int32, device=device)
    q_left = q_right = q
    p_left = p_right = p0
    grad_left = grad_right = grad
    logp_left = logp_right = logp
    p_sum = p0
    prop_q, prop_p, prop_grad, prop_logp, prop_energy = q, p0, grad, logp, h0
    log_size = sum_accept = max_eerr = zeros_c
    n_leaves = torch.zeros((C,), dtype=torch.int32, device=device)
    turning = diverging = false_c

    while True:
        act = (depth < max_treedepth) & ~turning & ~diverging
        if not bool(act.any()):
            break
        go_right = draws.direction(depth)
        eps_signed = torch.where(go_right, step_size, -step_size)
        sub, p_first = _build_subtree(
            logp_grad_b, draws, depth, act,
            _w(go_right, q_right, q_left), _w(go_right, p_right, p_left),
            _w(go_right, grad_right, grad_left),
            torch.where(go_right, logp_right, logp_left),
            eps_signed, inv_mass, h0, max_treedepth,
        )
        incomplete = sub.turning | sub.diverging

        # biased progressive sampling: take the new subtree's proposal with
        # probability min(1, size_new / size_old)
        u = draws.accept_uniform(depth)
        take_new = act & ~incomplete & (torch.log(u) < sub.log_size - log_size)
        prop_q = _w(take_new, sub.prop_q, prop_q)
        prop_p = _w(take_new, sub.prop_p, prop_p)
        prop_grad = _w(take_new, sub.prop_grad, prop_grad)
        prop_logp = torch.where(take_new, sub.prop_logp, prop_logp)
        prop_energy = torch.where(take_new, sub.prop_energy, prop_energy)

        ok = act & ~incomplete
        right, left = ok & go_right, ok & ~go_right
        q_right, p_right = _w(right, sub.q, q_right), _w(right, sub.p, p_right)
        grad_right = _w(right, sub.grad, grad_right)
        logp_right = torch.where(right, sub.logp, logp_right)
        q_left, p_left = _w(left, sub.q, q_left), _w(left, sub.p, p_left)
        grad_left = _w(left, sub.grad, grad_left)
        logp_left = torch.where(left, sub.logp, logp_left)

        p_sum_old = p_sum
        p_sum = _w(ok, p_sum + sub.p_sum, p_sum)

        # generalized U-turn over the whole trajectory, plus the checks
        # across the boundary between the old trajectory and the subtree
        v_left, v_right = inv_mass * p_left, inv_mass * p_right
        turn_main = (torch.sum(v_left * p_sum, -1) <= 0.0) | (
            torch.sum(v_right * p_sum, -1) <= 0.0
        )
        v_first, v_last = inv_mass * p_first, inv_mass * sub.p
        x_lo = _w(go_right, v_left, v_last)
        x_hi = _w(go_right, v_first, v_right)
        x_rho = _w(go_right, p_sum_old + p_first, sub.p_sum + p_sum_old)
        turn_x = (torch.sum(x_lo * x_rho, -1) <= 0.0) | (torch.sum(x_hi * x_rho, -1) <= 0.0)
        turning_new = ok & (turn_main | turn_x)

        log_size = torch.where(ok, torch.logaddexp(log_size, sub.log_size), log_size)
        sum_accept = torch.where(act, sum_accept + sub.sum_accept, sum_accept)
        n_leaves = torch.where(act, n_leaves + sub.n, n_leaves)
        max_eerr = torch.where(
            act & (torch.abs(sub.max_eerr) > torch.abs(max_eerr)), sub.max_eerr, max_eerr
        )
        turning = torch.where(act, turning_new | sub.turning, turning)
        diverging = torch.where(act, sub.diverging, diverging)
        depth = torch.where(act, depth + 1, depth)

    n = torch.clamp(n_leaves, min=1)
    stats = NutsStats(
        depth=depth,
        n_steps=n_leaves,
        diverging=diverging,
        energy=prop_energy,
        energy_error=prop_energy - h0,
        max_energy_error=max_eerr,
        acceptance_rate=sum_accept / n.to(dtype),
        lp=prop_logp,
    )
    return (prop_q, prop_logp, prop_grad), stats
