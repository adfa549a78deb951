"""Warmup adaptation: dual-averaging step size, diagonal Welford mass matrix,
the Stan-style expanding-window schedule and the initial step-size search.

Counterpart of `pymc_tpu/sampling/adaptation.py` (reference
pymc/step_methods/step_sizes.py:41-105 and hmc/quadpotential.py:211-394).
The JAX package vmaps per-chain functions; here every state carries the
chain axis explicitly: dual-averaging fields are (C,), Welford `count` is
(C,) and `mean`/`m2` are (C, D).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.leapfrog import leapfrog_final_kick, leapfrog_kick_drift
from .full_mass import DenseMass

__all__ = [
    "DualAveragingState",
    "da_init",
    "da_update",
    "da_restart",
    "WelfordState",
    "welford_init",
    "welford_update",
    "welford_variance",
    "welford_update_batch",
    "welford_covariance",
    "ExpWeightedState",
    "expw_init",
    "expw_seed",
    "expw_update",
    "expw_inv_mass",
    "build_schedule",
    "find_reasonable_step_size",
]


class DualAveragingState(NamedTuple):
    mu: torch.Tensor
    log_step: torch.Tensor
    log_step_avg: torch.Tensor
    h_bar: torch.Tensor
    count: torch.Tensor


_GAMMA = 0.05
_K = 0.75
_T0 = 10.0


def da_init(step_size):
    log_step = torch.log(step_size)
    return DualAveragingState(
        mu=torch.log(10.0 * step_size),
        log_step=log_step,
        log_step_avg=log_step,
        h_bar=torch.zeros_like(log_step),
        count=torch.ones_like(log_step),
    )


def da_update(state: DualAveragingState, accept_prob, target):
    """One Hoffman-Gelman (2014) dual-averaging update (reference
    step_sizes.py:66)."""
    count = state.count
    w = 1.0 / (count + _T0)
    h_bar = (1.0 - w) * state.h_bar + w * (target - accept_prob)
    log_step = state.mu - h_bar * torch.sqrt(count) / _GAMMA
    mk = count ** -_K
    log_step_avg = mk * log_step + (1.0 - mk) * state.log_step_avg
    return DualAveragingState(
        mu=state.mu,
        log_step=log_step,
        log_step_avg=log_step_avg,
        h_bar=h_bar,
        count=count + 1.0,
    )


def da_restart(state: DualAveragingState):
    """Re-anchor after a mass-matrix window switch (Stan behaviour): keep the
    averaged step size, restart the averaging statistics."""
    log_step = state.log_step_avg
    return DualAveragingState(
        mu=math.log(10.0) + log_step,
        log_step=log_step,
        log_step_avg=log_step,
        h_bar=torch.zeros_like(log_step),
        count=torch.ones_like(state.count),
    )


class WelfordState(NamedTuple):
    count: torch.Tensor  # (C,); full: ()
    mean: torch.Tensor  # (C, D); full: (D,)
    m2: torch.Tensor  # (C, D); full: (D, D)


def welford_init(chains, dim, dtype=torch.float64, device=None, full=False):
    """A zero Welford state: per chain (diagonal), or with full=True one
    state pooled over every chain (`chains` is not used)."""
    if full:
        return WelfordState(
            count=torch.zeros((), dtype=dtype, device=device),
            mean=torch.zeros((dim,), dtype=dtype, device=device),
            m2=torch.zeros((dim, dim), dtype=dtype, device=device),
        )
    z = torch.zeros((chains, dim), dtype=dtype, device=device)
    return WelfordState(
        count=torch.zeros((chains,), dtype=dtype, device=device), mean=z, m2=z
    )


def welford_update(state: WelfordState, x):
    """Add one (C, D) draw per chain."""
    count = state.count + 1.0
    delta = x - state.mean
    mean = state.mean + delta / count[:, None]
    delta2 = x - mean
    return WelfordState(count=count, mean=mean, m2=state.m2 + delta * delta2)


def welford_variance(state: WelfordState):
    """Regularised diagonal variance estimate (reference
    quadpotential.py:211-394 / Stan: shrink towards 1e-3)."""
    n = torch.clamp(state.count, min=2.0)[:, None]
    w = n / (n + 5.0)
    var = w * (state.m2 / (n - 1.0)) + 1e-3 * (1.0 - w)
    return torch.clamp(var, min=1e-12)


def welford_update_batch(state: WelfordState, X):
    """Chan's parallel combine of a (C, D) batch, one draw per chain, into
    the pooled full state: one (D, C) x (C, D) product (reference
    QuadPotentialFullAdapt quadpotential.py:748, pooled across chains)."""
    C = X.shape[0]
    mean_b = torch.mean(X, dim=0)
    Xc = X - mean_b
    m2_b = Xc.T @ Xc
    n = state.count
    tot = n + C
    delta = mean_b - state.mean
    mean = state.mean + delta * (C / tot)
    m2 = state.m2 + m2_b + torch.outer(delta, delta) * (n * C / tot)
    return WelfordState(count=tot, mean=mean, m2=m2)


def welford_covariance(state: WelfordState, regularize=True):
    """The pooled covariance estimate, shrunk towards 1e-3 I as
    `welford_variance` shrinks the diagonal."""
    n = torch.clamp(state.count, min=2.0)
    cov = state.m2 / (n - 1.0)
    if regularize:
        w = n / (n + 5.0)
        eye = torch.eye(cov.shape[-1], dtype=cov.dtype, device=cov.device)
        cov = w * cov + 1e-3 * (1.0 - w) * eye
    return cov


class ExpWeightedState(NamedTuple):
    """Exponentially weighted mean and variance of the draws and of their
    gradients, the grad-based diagonal mass estimator of
    init="jitter+adapt_diag_grad" (reference quadpotential.py:458-580,
    QuadPotentialDiagAdaptExp with use_grads=True); (C, D) each."""

    mean_q: torch.Tensor
    var_q: torch.Tensor
    mean_g: torch.Tensor
    var_g: torch.Tensor


def expw_init(shape, dtype=torch.float64, device=None):
    z = torch.zeros(shape, dtype=dtype, device=device)
    return ExpWeightedState(z, z, z, z)


def expw_seed(q, g):
    """Anchor the estimator at the first draw after the discard window
    (reference quadpotential.py:545-558: init_mean=sample, init_var=0)."""
    return ExpWeightedState(q, torch.zeros_like(q), g, torch.zeros_like(g))


def expw_update(state: ExpWeightedState, q, g, alpha=0.02):
    """One _ExpWeightedVariance.add_sample step for draws and gradients
    (reference quadpotential.py:466-470)."""
    dq = q - state.mean_q
    mean_q = state.mean_q + alpha * dq
    var_q = (1.0 - alpha) * (state.var_q + alpha * dq * dq)
    dg = g - state.mean_g
    mean_g = state.mean_g + alpha * dg
    var_g = (1.0 - alpha) * (state.var_g + alpha * dg * dg)
    return ExpWeightedState(mean_q, var_q, mean_g, var_g)


def expw_inv_mass(state: ExpWeightedState):
    """The diagonal inverse mass sqrt(var_q / var_grad) (reference
    quadpotential.py:575-580 _update_from_variances)."""
    var = torch.sqrt(
        torch.clamp(state.var_q, min=1e-20) / torch.clamp(state.var_g, min=1e-20)
    )
    return torch.clamp(var, 1e-12, 1e12)


def build_schedule(tune):
    """Stan warmup schedule as numpy bool arrays of length `tune`:
      update_mass[i] — accumulate this draw into the Welford estimator
      switch_mass[i] — end of a mass window: swap in the estimate, reset
    (reference quadpotential.py:335-356 window logic)."""
    tune = int(tune)
    update_mass = np.zeros(tune, dtype=bool)
    switch_mass = np.zeros(tune, dtype=bool)
    if tune == 0:
        return {"update_mass": update_mass, "switch_mass": switch_mass}
    init_buffer, term_buffer, base_window = 75, 50, 25
    if tune < init_buffer + term_buffer + base_window:
        init_buffer = max(int(0.15 * tune), 1)
        term_buffer = max(int(0.1 * tune), 1)
        base_window = max(tune - init_buffer - term_buffer, 1)
    start = init_buffer
    end_adapt = tune - term_buffer
    window = base_window
    while start < end_adapt:
        stop = min(start + window, end_adapt)
        # if the remaining tail is too short for another doubling, absorb it
        if stop + 2 * window > end_adapt:
            stop = end_adapt
        update_mass[start:stop] = True
        switch_mass[stop - 1] = True
        start = stop
        window *= 2
    return {"update_mass": update_mass, "switch_mass": switch_mass}


_LOG_HALF = math.log(0.5)
_MAX_STEP_SEARCH = 60


def find_reasonable_step_size(logp_grad_b, q, logp, grad, xi, inv_mass):
    """Hoffman-Gelman heuristic, per chain: double or halve eps until the
    one-step leapfrog acceptance probability crosses 0.5.

    q, grad, xi: (C, D); logp: (C,); inv_mass: (C, D) diagonal, or a
    DenseMass, a full Sigma shared by the chains, whose search runs in the
    whitened coordinates with a unit mass (full_mass.py). `xi` is the
    standard-normal draw behind the momentum (injected, so tests can feed
    the JAX package's draws). The search starts at eps = 1 and stops after
    60 doublings or halvings; each iteration costs one host sync (`.any()`).
    """
    if isinstance(inv_mass, DenseMass):
        return find_reasonable_step_size(
            inv_mass.whitened(logp_grad_b), inv_mass.to_x(q), logp,
            inv_mass.grad_to_x(grad), xi, inv_mass.unit(q.shape[0]),
        )
    p = xi / torch.sqrt(inv_mass)
    h0 = -logp + 0.5 * torch.sum(p * (inv_mass * p), dim=-1)

    def log_ratio(eps):
        q_new, p_half = leapfrog_kick_drift(q, p, grad, inv_mass, eps)
        logp_new, grad_new = logp_grad_b(q_new)
        _, ke = leapfrog_final_kick(p_half, grad_new, inv_mass, eps)
        lr = h0 - (-logp_new + ke)
        return torch.where(torch.isfinite(lr), lr, -torch.inf)

    eps = torch.ones_like(logp)
    lr = log_ratio(eps)
    up = lr > _LOG_HALF
    for _ in range(_MAX_STEP_SEARCH):
        crossed = torch.where(up, lr <= _LOG_HALF, lr > _LOG_HALF)
        if not bool((~crossed).any()):
            break
        eps_new = torch.where(up, eps * 2.0, eps * 0.5)
        lr = torch.where(crossed, lr, log_ratio(eps_new))
        eps = torch.where(crossed, eps, eps_new)
    return torch.clamp(eps, 1e-10, 1e3)
