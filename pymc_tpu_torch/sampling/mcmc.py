"""`sample` — the NUTS driver with a diagonal mass and jitter+adapt_diag init.

Counterpart of the NUTS path of `pymc_tpu/sampling/mcmc.py::sample` (:69,
per-draw `step` :372-491, `_make_postprocess_fn` :1106). Chains are the
leading axis of every tensor on one device. Warmup and sampling run one
Python loop over draws; the adaptation flags of the Stan schedule are host
booleans, so adaptation adds no host sync. Draws and stats stay on the
device until the end and cross to the host once.

Left out against the JAX package: full mass, the exp-weighted and ADVI/MAP
inits, ChEES, compound steps, traces and resume, meshes, warmup groups
(tuned draws are always discarded), and the TPU-only chunk compilation.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..backends.arviz import to_inference_data
from ..config import floatX, resolve_device
from ..initial_point import make_initial_points_per_chain
from ..model.core import modelcontext
from ..ops import _build
from ..stats.convergence import log_warnings, run_convergence_checks
from .adaptation import (
    build_schedule,
    da_init,
    da_restart,
    da_update,
    find_reasonable_step_size,
    welford_init,
    welford_update,
    welford_variance,
)
from .nuts import NutsStats, SamplerState, TorchDraws, nuts_transition

__all__ = ["sample", "SamplingError"]

_log = logging.getLogger("pymc_tpu_torch")

# sample_stats names: the NutsStats fields, with depth as tree_depth
_STAT_NAMES = {f: "tree_depth" if f == "depth" else f for f in NutsStats._fields}


class SamplingError(RuntimeError):
    pass


class _CountedLogpGrad:
    """logp_grad with a count of its calls: one per batched call, whether
    for the starting points or for a leapfrog."""

    def __init__(self, fn):
        self.fn = fn
        self.calls = 0

    def __call__(self, q):
        self.calls += 1
        return self.fn(q)


def _synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def sample(
    draws=1000,
    *,
    tune=1000,
    chains=4,
    model=None,
    random_seed=None,
    target_accept=0.8,
    max_treedepth=10,
    mass_adapt="per_chain",
    step_adapt="per_chain",
    compute_convergence_checks=True,
    device=None,
):
    """Draw posterior samples with batched NUTS on one device, starting every
    chain at the jittered support point (the reference's jitter+adapt_diag).

    mass_adapt / step_adapt : "per_chain" (reference behaviour) or "pooled"
        — pool the Welford variances / the dual-averaging acceptance across
        chains.
    device : "cuda" (default) or "cpu"; the card is used unless "cpu" is
        asked for, and without a card the default raises. The sampler runs
        in float32 on CUDA, float64 on the CPU.

    Returns an InferenceData whose posterior attrs hold sampling_time,
    tuning_time, compile_time (seconds spent building kernels in this call),
    n_leapfrog (batched leapfrog calls, step-size search included),
    n_logp_grad (every batched logp+grad call: the starting points' two and
    the leapfrogs') and
    sampling_host_syncs (the `.any()` syncs of the NUTS loops while
    drawing: one per leapfrog, two per tree doubling, one per draw).
    """
    if draws < 1:
        raise ValueError("draws must be >= 1")
    model = modelcontext(model)
    for name, value in (("mass_adapt", mass_adapt), ("step_adapt", step_adapt)):
        if value not in ("per_chain", "pooled"):
            raise ValueError(f"{name} must be 'per_chain' or 'pooled', got {value!r}")
    device = resolve_device(device)
    dtype = floatX(device)
    if random_seed is None:
        random_seed = int(np.random.default_rng().integers(2**30))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(random_seed))
    built_before = sum(_build.build_seconds.values())

    t0 = time.perf_counter()
    info = model.raveled_info()
    D = info.total_size
    logp_grad = _CountedLogpGrad(model.logp_dlogp_fn(device=device, dtype=dtype))

    q0 = make_initial_points_per_chain(
        model, lambda q: logp_grad(q)[0], chains, gen, device=device, dtype=dtype
    )
    logp0, grad0 = logp_grad(q0)
    calls_before_leapfrogs = logp_grad.calls
    bad = torch.nonzero(~torch.isfinite(logp0)).flatten().tolist()
    if bad:
        raise SamplingError(
            f"Initial evaluation of model at starting point failed for chains {bad}"
        )
    inv_mass = torch.ones((chains, D), dtype=dtype, device=device)
    xi = torch.randn((chains, D), generator=gen, dtype=dtype, device=device)
    eps0 = find_reasonable_step_size(logp_grad, q0, logp0, grad0, xi, inv_mass)
    if step_adapt == "pooled":
        eps0 = eps0.mean().expand(chains).clone()
    state = SamplerState(q0, logp0, grad0, inv_mass, eps0)
    da = da_init(eps0)
    wf = welford_init(chains, D, dtype=dtype, device=device)
    schedule = build_schedule(tune)
    draw_source = TorchDraws(gen, chains, D, dtype, device)

    q_draws, stat_draws = [], []
    for i in range(tune + draws):
        warm = i < tune
        if i == tune:
            _synchronize(device)
            t1 = time.perf_counter()
            calls_at_t1 = logp_grad.calls
        step_size = torch.exp(da.log_step if warm else da.log_step_avg)
        (q, logp, grad), stats = nuts_transition(
            logp_grad, draw_source, state.q, state.logp, state.grad,
            step_size, state.inv_mass, max_treedepth=max_treedepth,
        )
        state = state._replace(q=q, logp=logp, grad=grad, step_size=step_size)
        if not warm:
            q_draws.append(q)
            stat_draws.append(stats)
            continue
        # a NaN acceptance (fully diverged trajectory) counts as a rejection
        accept = torch.clamp(stats.acceptance_rate, 0.0, 1.0)
        accept = torch.where(torch.isfinite(accept), accept, 0.0)
        if step_adapt == "pooled":
            accept = accept.mean().expand(chains)
        da = da_update(da, accept, target_accept)
        if schedule["update_mass"][i]:
            wf = welford_update(wf, q)
        if schedule["switch_mass"][i]:
            new_inv = welford_variance(wf)
            if mass_adapt == "pooled":
                new_inv = new_inv.mean(dim=0, keepdim=True).expand(chains, D)
            state = state._replace(inv_mass=new_inv.contiguous())
            wf = welford_init(chains, D, dtype=dtype, device=device)
            da = da_restart(da)
    _synchronize(device)
    t2 = time.perf_counter()

    # one transfer of every draw and stat to the host; constrained values and
    # deterministics are recomputed there from the flat draws
    q_all = torch.stack(q_draws).cpu()  # (S, C, D)
    stats = NutsStats(*[torch.stack(v).cpu().numpy() for v in zip(*stat_draws)])
    post = model.postprocess_fn(device="cpu", dtype=q_all.dtype)(q_all.reshape(-1, D))
    posterior = {
        name: v.reshape((draws, chains) + v.shape[1:]).swapaxes(0, 1).numpy()
        for name, v in post.items()
    }
    sample_stats = {
        _STAT_NAMES[f]: getattr(stats, f).swapaxes(0, 1) for f in NutsStats._fields
    }
    # each draw's trajectory loop ran max-depth doublings, each with one
    # subtree loop: syncs = leapfrogs + 2 * max depth + 1 per draw
    host_syncs = logp_grad.calls - calls_at_t1 + int(
        (2 * stats.depth.max(axis=1) + 1).sum()
    )
    ss = torch.exp(da.log_step_avg).cpu().numpy()
    sample_stats["step_size"] = np.broadcast_to(ss[:, None], (chains, draws)).copy()
    idata = to_inference_data(
        model,
        posterior=posterior,
        sample_stats=sample_stats,
        attrs={
            "max_treedepth": max_treedepth,
            "sampling_time": t2 - t1,
            "tuning_time": t1 - t0,
            "compile_time": sum(_build.build_seconds.values()) - built_before,
            "n_leapfrog": logp_grad.calls - calls_before_leapfrogs,
            "n_logp_grad": logp_grad.calls,
            "sampling_host_syncs": host_syncs,
            "device": str(device),
            "inference_library": "pymc_tpu_torch",
        },
    )
    _log.info(f"Sampling {draws} draws x {chains} chains took {t2 - t1:.2f}s")
    if compute_convergence_checks:
        log_warnings(run_convergence_checks(idata, model))
    return idata
