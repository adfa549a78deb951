"""SMC kernels: tempering, resampling and the IMH and MH mutations.

Counterpart of `pymc_tpu/smc/kernels.py` (SMCState, `smc_init` :52,
`_find_beta` :71, `_systematic_resample` :99, the Pearson tracker :111-128,
`_particle_cov_chol` :131, `_correlation_tuned_loop` :141, IMH :210, MH
:301, `smc_stage` :386; reference pymc/smc/kernels.py). The JAX package
vmaps one chain's stage over chains; here the chain axis is explicit:
particles are (C, N, D), and every step below works on all chains at once.

Randomness comes in from a draw source (`TorchSMCDraws` on the device,
or a test's replay of the JAX package's draws): each stage takes one
uniform a chain for the resample, and each mutation sweep standard normals
(C, N, D) and uniforms (C, N).

Each stage factors the particle covariances of all chains, a (C, D, D)
stack, in one call of `ops.linalg.cholesky_batched`: the hand-written
kernel on the card, which like `jnp.linalg.cholesky` gives NaN for a
matrix that is not positive definite instead of raising or reading back
to the host.

The mutation loop runs until the Pearson rule stops every chain, as the
JAX package's `lax.while_loop` under `vmap` does: a chain that stopped
keeps its particles and counters (`torch.where`, no boolean indexing), and
the loop reads back one flag a sweep, whether any chain goes on, through
the caller's `HostReads`. A chain already at beta = 1 passes through the
stage unchanged and runs no sweep.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..ops.linalg import cholesky_batched

__all__ = ["SMCState", "TorchSMCDraws", "smc_init", "smc_stage", "IMH", "MH"]


class SMCState(NamedTuple):
    particles: torch.Tensor  # (C, N, D) unconstrained
    prior_logp: torch.Tensor  # (C, N)
    like_logp: torch.Tensor  # (C, N)
    beta: torch.Tensor  # (C,)
    log_marginal: torch.Tensor  # (C,) log marginal likelihood so far
    stage: torch.Tensor  # (C,) int32
    acc_rate: torch.Tensor  # (C,) the last mutation's mean acceptance
    proposal_scales: torch.Tensor  # (C, N) MH proposal scales
    chain_acc_rate: torch.Tensor  # (C, N) per-particle acceptance (MH tuning)
    n_steps: torch.Tensor  # (C,) int32 sweeps run in the last stage


class TorchSMCDraws:
    """The stages' random draws from one torch.Generator on the device."""

    def __init__(self, generator, dtype, device):
        self.generator, self.dtype, self.device = generator, dtype, device

    def resample_uniform(self, chains):
        """(C,) U(0, 1): each chain's offset of the systematic resample."""
        return torch.rand((chains,), generator=self.generator, dtype=self.dtype,
                          device=self.device)

    def sweep(self, i, shape):
        """Sweep i of a stage: standard normals of `shape` (C, N, D) and
        (C, N) U(0, 1) for the acceptances."""
        eps = torch.randn(shape, generator=self.generator, dtype=self.dtype, device=self.device)
        u = torch.rand(shape[:-1], generator=self.generator, dtype=self.dtype,
                       device=self.device)
        return eps, u


def _density(prior_like_fn, x):
    """prior_like_fn over (C, N, D) particles: ((C, N), (C, N))."""
    C, N, D = x.shape
    prior, like = prior_like_fn(x.reshape(C * N, D))
    return prior.reshape(C, N), like.reshape(C, N)


def smc_init(particles, prior_like_fn):
    """The stage-0 state of (C, N, D) particles drawn from the prior;
    prior_like_fn maps (P, D) points to their (prior, likelihood) logps."""
    C, N, D = particles.shape
    prior, like = _density(prior_like_fn, particles)

    def full(shape, value, dtype=particles.dtype):
        return torch.full(shape, value, dtype=dtype, device=particles.device)

    return SMCState(
        particles=particles, prior_logp=prior, like_logp=like,
        beta=full((C,), 0.0), log_marginal=full((C,), 0.0),
        stage=full((C,), 0, torch.int32), acc_rate=full((C,), 1.0),
        # reference MH.setup_kernel (kernels.py:587-593): optimal RW scaling
        proposal_scales=full((C, N), min(1.0, 2.38**2 / D)),
        chain_acc_rate=full((C, N), 0.234), n_steps=full((C,), 0, torch.int32),
    )


def _find_beta(beta_old, like_logp, threshold, iters=40):
    """Each chain's next beta: bisection on d = beta_new - beta_old so that
    the incremental weights' ESS is threshold * N (reference
    kernels.py:309-344), 40 steps on the device."""
    target = threshold * like_logp.shape[-1]

    def ess_at(d):
        lw = d[:, None] * like_logp
        lw = lw - torch.logsumexp(lw, dim=-1, keepdim=True)
        return torch.exp(-torch.logsumexp(2.0 * lw, dim=-1))

    lo = torch.zeros_like(beta_old)
    hi = 1.0 - beta_old
    full_ok = ess_at(hi) >= target
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        grow = ess_at(mid) >= target
        lo, hi = torch.where(grow, mid, lo), torch.where(grow, hi, mid)
    d = torch.where(full_ok, 1.0 - beta_old, 0.5 * (lo + hi))
    d = torch.clamp(d, min=1e-6)
    return torch.clamp(beta_old + d, max=1.0)


def _systematic_resample(u, log_weights):
    """(C, N) indices of a sorted-uniform resample of each chain's particles
    by `log_weights` (C, N), with offsets u (C,) (reference kernels.py:668).
    The clip catches a float sum that ends below 1."""
    N = log_weights.shape[-1]
    w = torch.exp(log_weights - torch.logsumexp(log_weights, dim=-1, keepdim=True))
    cum = torch.cumsum(w, dim=-1)
    positions = (torch.arange(N, dtype=w.dtype, device=w.device) + u[:, None]) / N
    return torch.clamp(torch.searchsorted(cum, positions), 0, N - 1)


def _pearson_ref(a):
    """The stage-entry centring of the Pearson tracker (reference
    kernels.py:543-547): am = a - mean, aa = ||am|| over the particles."""
    am = a - torch.mean(a, dim=1, keepdim=True)
    return am, torch.sqrt(torch.sum(am**2, dim=1))


def _pearson_get(am, aa, b):
    """(C, D) |corr| of each dimension of the particles b with the stage's
    entry set (reference kernels.py:549-553); 1 where a variance is 0."""
    bm = b - torch.mean(b, dim=1, keepdim=True)
    bb = torch.sqrt(torch.sum(bm**2, dim=1))
    ab = torch.sum(am * bm, dim=1)
    denom = aa * bb
    return torch.where(denom > 0, torch.abs(ab / torch.where(denom > 0, denom, 1.0)), 1.0)


def _particle_cov_chol(particles):
    """Each chain's particle mean (C, D) and the lower Cholesky factor of
    its covariance (ddof 0) + 1e-6 I, (C, D, D), in one kernel call
    (reference kernels.py:478-480, 610-612)."""
    N, D = particles.shape[1:]
    mean = torch.mean(particles, dim=1)
    diff = particles - mean[:, None, :]
    eye = torch.eye(D, dtype=particles.dtype, device=particles.device)
    cov = (diff.transpose(-1, -2) @ diff) / N + 1e-6 * eye
    return mean, cholesky_batched(cov)


def _mutation_loop(draws, state, sweep, active, correlation_threshold, max_steps, tuned,
                   host_read):
    """Up to max_steps sweeps of `sweep` over the chains `active` (C,).

    sweep(particles, prior_lp, like_lp, eps, u) -> (particles, prior_lp,
    like_lp, accepted (C, N)). With `tuned`, a chain goes on while more than
    90 % of its dimensions drop their |corr| with the stage-entry particles
    by more than correlation_threshold a sweep (reference kernels.py:486-
    525), and the loop ends when no chain goes on; otherwise every active
    chain runs max_steps sweeps. Returns (particles, prior_lp, like_lp,
    acc_rate (C,), per-particle acceptance (C, N), n_steps (C,)).
    """
    particles, prior_lp, like_lp = state.particles, state.prior_logp, state.like_logp
    C, N, D = particles.shape
    am, aa = _pearson_ref(particles)
    old_corr = torch.full((C, D), 2.0, dtype=particles.dtype, device=particles.device)
    acc_sum = torch.zeros((C, N), dtype=particles.dtype, device=particles.device)
    n = torch.zeros((C,), dtype=torch.int32, device=particles.device)
    for i in range(max_steps):
        eps, u = draws.sweep(i, (C, N, D))
        new_p, new_prior, new_like, accepted = sweep(particles, prior_lp, like_lp, eps, u)
        # a stopped chain keeps its carry, as under the JAX package's
        # vmapped while_loop
        particles = torch.where(active[:, None, None], new_p, particles)
        prior_lp = torch.where(active[:, None], new_prior, prior_lp)
        like_lp = torch.where(active[:, None], new_like, like_lp)
        acc_sum = torch.where(active[:, None], acc_sum + accepted.to(acc_sum.dtype), acc_sum)
        n = n + active.to(torch.int32)
        if tuned:
            r = _pearson_get(am, aa, particles)
            keep = torch.mean(((old_corr - r) > correlation_threshold).to(r.dtype), dim=-1) > 0.9
            old_corr = torch.where(active[:, None], r, old_corr)
            active = active & keep
            if i + 1 < max_steps and not host_read(active.any()):
                break
    per_particle = acc_sum / torch.clamp(n, min=1).to(acc_sum.dtype)[:, None]
    return particles, prior_lp, like_lp, torch.mean(per_particle, dim=-1), per_particle, n


class _Kernel:
    def __init__(self, n_steps=None, correlation_threshold=0.01, max_steps=100):
        if not 0.0 <= correlation_threshold <= 1.0:
            raise ValueError("correlation_threshold must be in [0, 1]")
        self.n_steps = n_steps
        self.correlation_threshold = correlation_threshold
        self.max_steps = max_steps if n_steps is None else n_steps

    def _loop(self, draws, state, sweep, active, host_read):
        return _mutation_loop(draws, state, sweep, active, self.correlation_threshold,
                              self.max_steps, self.n_steps is None, host_read)


def _accept(u, log_ratio, prop, p_prior, p_like, particles, prior_lp, like_lp):
    accept = torch.log(u) < log_ratio
    return (
        torch.where(accept[..., None], prop, particles),
        torch.where(accept, p_prior, prior_lp),
        torch.where(accept, p_like, like_lp),
        accept,
    )


class IMH(_Kernel):
    """Independent Metropolis-Hastings from each chain's Gaussian fit to its
    particles (reference kernels.py:446). The sweeps a stage follow the
    Pearson rule; ``n_steps=<int>`` fixes them instead."""

    name = "IMH"

    def mutate(self, draws, state, prior_like_fn, beta, active, host_read):
        mean, chol = _particle_cov_chol(state.particles)
        log_det = torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
        chol_t = chol.transpose(-1, -2)
        b = beta[:, None]

        def logq(x):
            diff = (x - mean[:, None, :]).transpose(-1, -2)
            z = torch.linalg.solve_triangular(chol, diff, upper=False).transpose(-1, -2)
            return -0.5 * torch.sum(z**2, dim=-1) - log_det[:, None]

        def sweep(particles, prior_lp, like_lp, eps, u):
            prop = mean[:, None, :] + eps @ chol_t
            p_prior, p_like = _density(prior_like_fn, prop)
            # forward/backward proposal correction (kernels.py:500-509)
            log_ratio = (
                (p_prior + b * p_like) - (prior_lp + b * like_lp) + logq(particles) - logq(prop)
            )
            return _accept(u, log_ratio, prop, p_prior, p_like, particles, prior_lp, like_lp)

        return self._loop(draws, state, sweep, active, host_read) + (state.proposal_scales,)


class MH(_Kernel):
    """Random-walk Metropolis with particle-covariance proposals and
    per-particle scales (reference kernels.py:556), which start at min(1,
    2.38^2 / D), travel with the particles on resampling and are tuned
    each stage from the second on (`tune_scales`)."""

    name = "MH"

    def tune_scales(self, state):
        """Reference MH.tune (kernels.py:601-607): rescale towards 0.234
        acceptance and average with the population's mean scale."""
        scales = torch.exp(torch.log(state.proposal_scales) + (state.chain_acc_rate - 0.234))
        tuned = 0.5 * (scales + torch.mean(scales, dim=-1, keepdim=True))
        return torch.where(state.stage[:, None] > 0, tuned, state.proposal_scales)

    def mutate(self, draws, state, prior_like_fn, beta, active, host_read):
        _, chol = _particle_cov_chol(state.particles)
        chol_t = chol.transpose(-1, -2)
        scales = state.proposal_scales
        b = beta[:, None]

        def sweep(particles, prior_lp, like_lp, eps, u):
            prop = particles + scales[..., None] * (eps @ chol_t)
            p_prior, p_like = _density(prior_like_fn, prop)
            log_ratio = (p_prior + b * p_like) - (prior_lp + b * like_lp)
            return _accept(u, log_ratio, prop, p_prior, p_like, particles, prior_lp, like_lp)

        return self._loop(draws, state, sweep, active, host_read) + (scales,)


def smc_stage(kernel, prior_like_fn, state, draws, host_read, threshold=0.5):
    """One SMC stage of every chain: reweight, resample, tune, mutate
    (reference SMC_KERNEL.step, kernels.py:373-379). `host_read` reads and
    counts the mutation loop's flags."""
    C, N = state.like_logp.shape
    done = state.beta >= 1.0
    beta_new = _find_beta(state.beta, state.like_logp, threshold)
    lw = (beta_new - state.beta)[:, None] * state.like_logp
    log_marginal = state.log_marginal + torch.logsumexp(lw, dim=-1) - math.log(float(N))
    # per-particle tuning state travels with the particles (reference
    # MH.resample, kernels.py:595-599)
    idx = _systematic_resample(draws.resample_uniform(C), lw)
    resampled = state._replace(
        particles=torch.take_along_dim(state.particles, idx[..., None], dim=1),
        prior_logp=torch.take_along_dim(state.prior_logp, idx, dim=1),
        like_logp=torch.take_along_dim(state.like_logp, idx, dim=1),
        proposal_scales=torch.take_along_dim(state.proposal_scales, idx, dim=1),
        chain_acc_rate=torch.take_along_dim(state.chain_acc_rate, idx, dim=1),
        beta=beta_new, log_marginal=log_marginal,
    )
    if hasattr(kernel, "tune_scales"):
        resampled = resampled._replace(proposal_scales=kernel.tune_scales(resampled))
    particles, prior_lp, like_lp, acc, per_particle, n, scales = kernel.mutate(
        draws, resampled, prior_like_fn, beta_new, ~done, host_read
    )
    new = SMCState(
        particles=particles, prior_logp=prior_lp, like_logp=like_lp, beta=beta_new,
        log_marginal=log_marginal, stage=state.stage + 1, acc_rate=acc,
        proposal_scales=scales, chain_acc_rate=per_particle, n_steps=n,
    )
    # chains already at beta = 1 pass through unchanged
    return SMCState(*(
        torch.where(done.reshape((C,) + (1,) * (old.ndim - 1)), old, fresh)
        for fresh, old in zip(new, state)
    ))
