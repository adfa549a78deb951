"""ChEES-HMC: jittered HMC with one shared trajectory length for all chains.

Counterpart of `pymc_tpu/sampling/chees.py` (Hoffman, Radul & Sountsov
2021). Every chain takes the same number L of leapfrogs per draw, so there
is no tree, no checkpoint stack and no straggler; the trajectory length T
adapts by Adam on the ChEES criterion, whose gradient is estimated across
chains. Step size and mass adapt as for NUTS (dual averaging, Welford) in
`sampling/mcmc.py`.

Each leapfrog is the pair of hand-written kernels (ops/leapfrog.py): the
half kick and drift, the batched logp+grad, the final half kick. L is a
trip count of the host's loop, so it is read from the card once per draw:
that read is the draw's only host sync.

Randomness is an input: `chees_step` takes the momentum normals `xi` and
the acceptance uniforms `u`, so the tests can feed it the JAX package's
draws (`chees.py:83,97,147` there). A full mass (a DenseMass) runs the
leapfrogs in the whitened coordinates x = L^-1 q with a unit mass through
the same kernels (full_mass.py); the ChEES criterion, which is not
invariant under that map, is computed after mapping x and p back to q.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.leapfrog import leapfrog_final_kick, leapfrog_kick_drift
from .full_mass import DenseMass

__all__ = ["CheesState", "HostReads", "chees_init", "chees_step", "halton_sequence"]


def halton_sequence(n, base=2):
    """First n Halton numbers (numpy float64, made on the host)."""
    out = np.zeros(n)
    for i in range(n):
        f, r = 1.0, 0.0
        idx = i + 1
        while idx > 0:
            f /= base
            r += f * (idx % base)
            idx //= base
        out[i] = r
    return out


class CheesState(NamedTuple):
    q: torch.Tensor  # (C, D)
    logp: torch.Tensor  # (C,)
    grad: torch.Tensor  # (C, D)
    log_T: torch.Tensor  # () trajectory length in time units, Adam-adapted
    adam_m: torch.Tensor  # () Adam first moment
    adam_v: torch.Tensor  # () Adam second moment
    adam_t: torch.Tensor  # () Adam step counter


class HostReads:
    """Reads device values to the host and counts the reads: each read is a
    host sync."""

    def __init__(self):
        self.count = 0

    def __call__(self, x):
        """x (a one-element tensor) as a Python int."""
        self.count += 1
        return int(x)

    def numpy(self, x):
        """x as a numpy array, in one read."""
        self.count += 1
        return x.cpu().numpy()


def chees_init(q, logp, grad, initial_T=1.0):
    def scalar(x):
        return torch.tensor(x, dtype=q.dtype, device=q.device)

    return CheesState(
        q=q, logp=logp, grad=grad, log_T=scalar(math.log(initial_T)),
        adam_m=scalar(0.0), adam_v=scalar(0.0), adam_t=scalar(0.0),
    )


def _kinetic(p, inv_mass):
    return 0.5 * torch.sum(p * inv_mass * p, dim=-1)


def chees_step(
    logp_grad_b, state: CheesState, step_size, inv_mass, halton_u, xi, u, *,
    adapt_T, host_read, max_leapfrogs=1024, adam_lr=0.025,
):
    """One jittered HMC draw for all chains and one ChEES update of T.

    logp_grad_b: (C, D) -> (logp (C,), grad (C, D)); step_size: (C,) per
    chain; inv_mass: (C, D) diagonal, or a DenseMass; halton_u: () in (0,
    1], this draw's jitter, shared by all chains; xi: (C, D) standard normals, the momentum
    before the mass; u: (C,) U(0, 1) for the acceptance; adapt_T: host bool;
    host_read: reads L to the host, as a HostReads does, counting it.
    Returns (CheesState, stats) with stats a dict of (C,) tensors:
    acceptance_rate, accepted, lp, energy, n_steps, trajectory_length,
    diverging.
    """
    C, _ = state.q.shape
    dense = isinstance(inv_mass, DenseMass)
    if dense:
        lg, q = inv_mass.whitened(logp_grad_b), inv_mass.to_x(state.q)
        grad, im = inv_mass.grad_to_x(state.grad), inv_mass.unit(C)
    elif inv_mass.shape != state.q.shape:
        raise NotImplementedError(
            "chees_step: inv_mass is neither a diagonal (C, D) mass nor a DenseMass; "
            "a full Sigma is passed as DenseMass(Sigma)"
        )
    else:
        lg, q, grad, im = logp_grad_b, state.q, state.grad, inv_mass
    eps = step_size
    T_jit = torch.exp(state.log_T) * halton_u
    mean_eps = torch.mean(eps)
    # one number of leapfrogs for every chain, set by the mean step size.
    # Clipped in floating point before the cast: a tiny step makes the ratio
    # overflow int32 (and inf has no integer value at all)
    steps = torch.clamp(torch.ceil(T_jit / torch.clamp(mean_eps, min=1e-10)), 1, max_leapfrogs)
    L = host_read(steps)  # the draw's one host sync

    p0 = xi / torch.sqrt(im)
    h0 = -state.logp + _kinetic(p0, im)

    p, logp = p0, state.logp
    for _ in range(L):
        q_new, p_half = leapfrog_kick_drift(q, p, grad, im, eps)
        logp_new, grad_new = lg(q_new)
        p_new, _ = leapfrog_final_kick(p_half, grad_new, im, eps)
        # a lane whose logp is not finite (diverged) freezes where it is
        ok = torch.isfinite(logp_new)
        q = torch.where(ok[:, None], q_new, q)
        p = torch.where(ok[:, None], p_new, p)
        grad = torch.where(ok[:, None], grad_new, grad)
        logp = torch.where(ok, logp_new, -torch.inf)
    h1 = -logp + _kinetic(p, im)
    if dense:
        q1, p1 = inv_mass.to_q(q), inv_mass.to_q_momentum(p)
        grad1 = inv_mass.to_q_momentum(grad)
    else:
        q1, p1, grad1 = q, p, grad
    logp1 = logp
    log_accept = torch.clamp(h0 - h1, max=0.0)
    log_accept = torch.where(torch.isfinite(log_accept), log_accept, -torch.inf)
    accept_prob = torch.exp(log_accept)
    accept = torch.log(u) < log_accept

    q_out = torch.where(accept[:, None], q1, state.q)
    logp_out = torch.where(accept, logp1, state.logp)
    grad_out = torch.where(accept[:, None], grad1, state.grad)

    # ChEES gradient (Hoffman et al. 2021 eq. 8), estimated across chains:
    # d/dT E[(|q' - mean q'|^2 - |q - mean q|^2)^2] / 4 ~ E[w delta (q'c . p')]
    qc0 = state.q - torch.mean(state.q, dim=0, keepdim=True)
    qc1 = q1 - torch.mean(q1, dim=0, keepdim=True)
    delta = torch.sum(qc1**2, dim=-1) - torch.sum(qc0**2, dim=-1)
    proj = torch.sum(qc1 * p1, dim=-1)
    w = accept_prob / torch.clamp(torch.sum(accept_prob), min=1e-10)
    chees_grad = torch.sum(w * delta * proj) * halton_u
    chees_grad = torch.clamp(
        torch.where(torch.isfinite(chees_grad), chees_grad, 0.0), -1e6, 1e6
    )

    t = state.adam_t + 1.0
    m = 0.9 * state.adam_m + 0.1 * chees_grad
    v = 0.999 * state.adam_v + 0.001 * chees_grad**2
    mhat = m / (1.0 - 0.9**t)
    vhat = v / (1.0 - 0.999**t)
    log_T_new = state.log_T + adam_lr * mhat / (torch.sqrt(vhat) + 1e-8)
    # keep T between one step and max_leapfrogs steps of the mean step size
    log_T_new = torch.minimum(
        torch.maximum(log_T_new, torch.log(mean_eps)), torch.log(mean_eps * max_leapfrogs)
    )
    if adapt_T:
        log_T, adam = log_T_new, (m, v, t)
    else:
        log_T, adam = state.log_T, (state.adam_m, state.adam_v, state.adam_t)

    new_state = CheesState(q_out, logp_out, grad_out, log_T, *adam)
    stats = {
        "acceptance_rate": accept_prob,
        "accepted": accept,
        "lp": logp_out,
        "energy": torch.where(accept, h1, h0),
        "n_steps": torch.full((C,), L, dtype=torch.int32, device=q1.device),
        "trajectory_length": torch.exp(log_T).expand(C),
        "diverging": ~torch.isfinite(h1),
    }
    return new_state, stats
