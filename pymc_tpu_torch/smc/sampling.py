"""`sample_smc` — tempered sequential Monte Carlo on one device.

Counterpart of `pymc_tpu/smc/sampling.py::sample_smc` (:65-284; reference
pymc/smc/sampling.py:42): `chains` independent SMC runs of `draws`
particles each, drawn from the prior, tempered from beta = 0 to 1 stage by
stage with the IMH or MH kernel of `smc/kernels.py`. The chains are the
leading axis of every tensor. The host loop reads back, once a stage, each
chain's beta, sweep count and acceptance (the JAX package's per-stage
`device_get`s), and stops when every chain is at beta = 1 or after
`max_stages`. Discrete free variables ride as continuous particle
coordinates rounded to the lattice before every density. The results are
an InferenceData with the log marginal likelihood, beta, acceptance and
sweeps in sample_stats and the stage histories in the attrs.

A model with a `Simulator` (likelihood-free ABC) draws a fresh simulation
for every particle at every density evaluation, from the run's generator.
Left out against the JAX package: `mesh=` (the particle axis sharded over
devices) raises NotImplementedError.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..backends.arviz import to_inference_data
from ..blocking import ravel_point, unravel_vector
from ..config import floatX, resolve_device
from ..distributions.simulator import SIMULATOR_KEY, Simulator
from ..model.core import modelcontext
from ..sampling.chees import HostReads
from ..sampling.forward import _generative_fn
from ..sampling.mcmc import _postprocess
from ..stats.convergence import log_warnings, run_convergence_checks
from .kernels import IMH, MH, TorchSMCDraws, smc_init, smc_stage

__all__ = ["sample_smc", "tempered_density", "prior_particles", "has_simulator"]

_log = logging.getLogger("pymc_tpu_torch")


def _snap_fn(model, info, device):
    """q -> q with the discrete free variables' coordinates rounded (pymc_tpu
    smc/sampling.py:102-121: -0.49 -> 0, 0.51 -> 1)."""
    names = {rv.value_name for rv in model.discrete_value_vars}
    if not names:
        return lambda q: q
    mask = torch.zeros(info.total_size, dtype=torch.bool)
    for name, sl in info.slices().items():
        mask[sl] = name in names
    mask = mask.to(device)
    return lambda q: torch.where(mask, torch.round(q), q)


def has_simulator(model):
    """Whether an observed variable of `model` is a Simulator (ABC)."""
    return any(isinstance(orv.dist, Simulator) for orv in model.observed_RVs)


def tempered_density(model, device=None, dtype=None, generator=None):
    """fn(particles (P, D)) -> (prior logp (P,), likelihood logp (P,)) over
    flat unconstrained points on `device` in `dtype`: the free RVs' terms
    with their jacobians, and the observed RVs' terms, a non-finite one
    taken as -inf. A model with a Simulator (ABC) simulates from
    `generator` (a torch.Generator on `device`; default seeded 0): every
    particle of every call gets a simulation of its own
    (`vmap(randomness="different")`; pymc_tpu/smc/sampling.py:119-140
    splits its key per particle)."""
    device = resolve_device(device)
    info = model.raveled_info()
    snap = _snap_fn(model, info, device)
    split_logp = model.logp_fn(device, dtype, split=True)
    sim = has_simulator(model)
    if sim and generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    # a model without a Simulator keeps vmap's guard against drawing
    extra = {SIMULATOR_KEY: generator} if sim else {}
    batched = torch.func.vmap(
        lambda q: split_logp({**unravel_vector(snap(q), info), **extra}),
        randomness="different" if sim else "error",
    )

    def fn(particles):
        prior, like = batched(particles)
        return prior, torch.where(torch.isfinite(like), like, -torch.inf)

    return fn


def prior_particles(model, n, generator, device=None, dtype=None):
    """(n, D) flat unconstrained points, each from its own prior draw of
    the model (sampling/forward.py) on `device` (generator's) in `dtype`."""
    device = resolve_device(device)
    dtype = dtype or floatX(device)
    gen = _generative_fn(model, device, dtype)
    info = model.raveled_info()
    placed = model.placed_constants(device, dtype)

    def one(_):
        draw = gen(generator)
        point = {rv.name: draw[rv.name] for rv in model.free_RVs}
        return ravel_point(model.unconstrain(point, dict(placed)), info).to(dtype)

    return torch.func.vmap(one, randomness="different")(torch.empty(n, device=device))


def _resolve_kernel(kernel, correlation_threshold, kernel_kwargs):
    if isinstance(kernel, str):
        kinds = {"imh": IMH, "mh": MH}
        if kernel.lower() not in kinds:
            raise ValueError(f"Unknown SMC kernel {kernel!r}: expected 'imh' or 'mh'")
        return kinds[kernel.lower()](correlation_threshold=correlation_threshold, **kernel_kwargs)
    if isinstance(kernel, type):
        kernel_kwargs.setdefault("correlation_threshold", correlation_threshold)
        return kernel(**kernel_kwargs)
    return kernel


def _apply_start(model, particles, start):
    """Overwrite (C, N, D) particles with `start`: one dict, or one per
    chain, of (N, *shape) arrays in the value space ("b_log__") or, for a
    transformed variable, in the constrained space under its name; the
    variables it leaves out keep their prior draws (pymc_tpu
    smc/sampling.py:175-203)."""
    chains, draws = particles.shape[:2]
    starts = list(start) if isinstance(start, (list, tuple)) else [start] * chains
    if len(starts) != chains:
        raise ValueError(f"start must be one dict or a list of {chains} dicts")
    particles = particles.clone()
    slices = model.raveled_info().slices()

    def tensor(x):
        return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=particles.dtype,
                               device=particles.device)

    for c, sdict in enumerate(starts):
        for rv in model.free_RVs:
            arr = sdict.get(rv.value_name)
            if arr is None and rv.value_name != rv.name and rv.name in sdict:
                arr = torch.func.vmap(rv.transform.forward)(tensor(sdict[rv.name]))
            if arr is not None:
                particles[c, :, slices[rv.value_name]] = tensor(arr).reshape(draws, -1)
    return particles


def sample_smc(
    draws=2000,
    *,
    kernel="imh",
    chains=4,
    cores=None,
    model=None,
    random_seed=None,
    start=None,
    threshold=0.5,
    correlation_threshold=0.01,
    compute_convergence_checks=True,
    return_inferencedata=True,
    progressbar=True,
    idata_kwargs=None,
    max_stages=100,
    mesh=None,
    device=None,
    **kernel_kwargs,
):
    """Sequential Monte Carlo sampling (reference smc/sampling.py:42).

    kernel : "imh" (default), "mh", a kernel class (instantiated with
        kernel_kwargs) or a kernel instance.
    device : "cuda" (default) or "cpu"; without a card the default raises.
        SMC runs in float32 on CUDA, float64 on the CPU.
    cores, idata_kwargs : accepted, as the JAX package does; they do
        nothing on one device. progressbar logs each stage at INFO.

    Returns an InferenceData (the posterior dict with
    return_inferencedata=False). Its attrs hold n_stages, the beta, sweep
    and acceptance histories, sampling_time, the kernel's name, the device
    and sampling_host_syncs (the stage loop's reads: one flag a sweep of
    the mutation loop but the last possible, and one read of the stage's
    stats).
    """
    if mesh is not None:
        raise NotImplementedError(
            "sample_smc(mesh=...) shards the particles over several devices; "
            "pymc_tpu_torch runs on one"
        )
    model = modelcontext(model)
    device = resolve_device(device)
    dtype = floatX(device)
    if random_seed is None:
        random_seed = int(np.random.default_rng().integers(2**30))
    generator = torch.Generator(device=device)
    generator.manual_seed(int(random_seed))
    kernel = _resolve_kernel(kernel, correlation_threshold, kernel_kwargs)

    prior_like_fn = tempered_density(model, device, dtype, generator)
    info = model.raveled_info()
    particles = prior_particles(model, chains * draws, generator, device, dtype)
    particles = particles.reshape(chains, draws, info.total_size)
    if start is not None:
        particles = _apply_start(model, particles, start)
    state = smc_init(particles, prior_like_fn)
    source = TorchSMCDraws(generator, dtype, device)
    host_read = HostReads()

    t0 = time.perf_counter()
    betas_hist, steps_hist, acc_hist = [], [], []
    stage_i = 0
    while stage_i < max_stages:
        state = smc_stage(kernel, prior_like_fn, state, source, host_read, threshold)
        stats = host_read.numpy(
            torch.stack([state.beta, state.n_steps.to(dtype), state.acc_rate]).double()
        )
        betas_hist.append(stats[0])
        steps_hist.append(stats[1].astype(np.int64))
        acc_hist.append(stats[2])
        stage_i += 1
        if progressbar:
            _log.info(
                f"SMC stage {stage_i}: beta={np.round(stats[0], 4).tolist()} "
                f"acc={np.round(stats[2], 3).tolist()} n_steps={steps_hist[-1].tolist()}"
            )
        if np.all(stats[0] >= 1.0):
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t1 = time.perf_counter()
    _log.info(f"SMC finished in {stage_i} stages, {t1 - t0:.2f}s")

    snap = _snap_fn(model, info, device)
    posterior = _postprocess(model, snap(state.particles).transpose(0, 1), None)
    for rv in model.discrete_value_vars:
        posterior[rv.name] = posterior[rv.name].astype(np.int64)
    lml = state.log_marginal.double().cpu().numpy()

    def per_draw(x):
        return np.broadcast_to(x[:, None], (chains, draws)).copy()

    stats = {
        "log_marginal_likelihood": per_draw(lml),
        "beta": per_draw(betas_hist[-1]),
        "accept_rate": per_draw(acc_hist[-1]),
        "n_steps": per_draw(steps_hist[-1]),
    }
    idata = to_inference_data(
        model,
        posterior=posterior,
        sample_stats=stats,
        attrs={
            "sampling_time": t1 - t0,
            "n_stages": stage_i,
            "inference_library": "pymc_tpu_torch.smc",
            "log_marginal_likelihood": lml.tolist(),
            "beta_history": np.array(betas_hist).tolist(),
            "n_steps_history": np.array(steps_hist).tolist(),
            "accept_rate_history": np.array(acc_hist).tolist(),
            "correlation_threshold": getattr(kernel, "correlation_threshold",
                                             correlation_threshold),
            "threshold": threshold,
            "n_draws": draws,
            "kernel": getattr(kernel, "name", type(kernel).__name__),
            "sampling_host_syncs": host_read.count,
            "device": str(device),
        },
    )
    if compute_convergence_checks:
        log_warnings(run_convergence_checks(idata, model))
    if not return_inferencedata:
        return posterior
    return idata
