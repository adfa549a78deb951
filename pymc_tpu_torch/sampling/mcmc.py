"""`sample` — batched NUTS or ChEES with a diagonal mass and jitter+adapt_diag
init.

Counterpart of `pymc_tpu/sampling/mcmc.py::sample` (:69, per-draw `step`
:372-491, the ChEES branch :344-406, `_package` :953-1005,
`_make_postprocess_fn` :1106). Chains are the leading axis of every tensor
on one device. Warmup and sampling run one Python loop over draws; the
adaptation flags of the Stan schedule are host booleans, so adaptation adds
no host sync. Draws and stats stay on the device until the end; the draws
are postprocessed there in row chunks, and only the variables `var_names`
names (default: all) cross to the host.

Left out against the JAX package: full mass, the exp-weighted
(`jitter+adapt_diag_grad`) and ADVI/MAP inits, compound steps (a discrete
free variable raises), traces and resume, callbacks, meshes, warmup groups
(tuned draws are always discarded), and the TPU-only chunk compilation.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..backends.arviz import select_var_names, to_inference_data
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
from .chees import CheesState, HostReads, chees_step, halton_sequence
from .nuts import NutsStats, SamplerState, TorchDraws, nuts_transition

__all__ = ["sample", "SamplingError"]

_log = logging.getLogger("pymc_tpu_torch")

# sample_stats names: the NutsStats fields, with depth as tree_depth
_STAT_NAMES = {f: "tree_depth" if f == "depth" else f for f in NutsStats._fields}
# rows of flat draws postprocessed at once on the device (pymc_tpu :994)
_POST_CHUNK = 65536


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


def _chees_stats(ch):
    """ChEES stats as NutsStats, as the JAX package maps them (mcmc.py:387-
    400): depth ceil(log2(n_steps + 1)), and as energy error 0 for an
    accepted draw, else -log of its acceptance."""
    n_steps = ch["n_steps"]
    eerr = torch.where(
        ch["accepted"], 0.0, -torch.log(torch.clamp(ch["acceptance_rate"], 1e-30, 1.0))
    )
    return NutsStats(
        depth=torch.ceil(torch.log2(n_steps.to(eerr.dtype) + 1.0)).to(torch.int32),
        n_steps=n_steps,
        diverging=ch["diverging"],
        energy=ch["energy"],
        energy_error=eerr,
        max_energy_error=eerr,
        acceptance_rate=ch["acceptance_rate"],
        lp=ch["lp"],
    )


def _postprocess(model, q_draws, var_names):
    """(S, C, D) flat draws -> {name: (C, S, *shape) numpy}: constrained
    values and deterministics of the variables `var_names` names (default:
    all), computed on the draws' device in chunks of _POST_CHUNK rows, so
    only they cross to the host."""
    S, C, D = q_draws.shape
    flat = q_draws.reshape(S * C, D)
    available = [rv.name for rv in model.free_RVs] + [d.name for d in model.deterministics]
    names = available if var_names is None else select_var_names(available, var_names)
    post_fn = model.postprocess_fn(device=flat.device, dtype=flat.dtype)
    chunks = []
    for i in range(0, S * C, _POST_CHUNK):
        out = post_fn(flat[i : i + _POST_CHUNK])
        chunks.append({n: out[n].cpu() for n in names})
    return {
        n: torch.cat([c[n] for c in chunks]).reshape((S, C) + chunks[0][n].shape[1:])
        .swapaxes(0, 1).numpy()
        for n in names
    }


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
    sampler="nuts",
    var_names=None,
    compute_convergence_checks=True,
    progressbar=True,
    return_inferencedata=True,
    idata_kwargs=None,
    cores=None,
    device=None,
    **kwargs,
):
    """Draw posterior samples with batched NUTS or ChEES on one device,
    starting every chain at the jittered support point (the reference's
    jitter+adapt_diag).

    mass_adapt / step_adapt : "per_chain" (reference behaviour) or "pooled"
        — pool the Welford variances / the dual-averaging acceptance across
        chains.
    sampler : "nuts" (default) or "chees" — ChEES-HMC: every chain takes
        the same number of leapfrogs a draw, from a trajectory length
        adapted in warmup (sampling/chees.py).
    var_names : names of the posterior variables to keep (default: all);
        only these reach the host. Unknown names are warned about and left
        out.
    device : "cuda" (default) or "cpu"; the card is used unless "cpu" is
        asked for, and without a card the default raises. The sampler runs
        in float32 on CUDA, float64 on the CPU.
    progressbar, idata_kwargs, cores, **kwargs : accepted, as
        `pymc_tpu.sample` accepts them (bench.py and the suite pass
        `progressbar=False`); they do nothing on one device.
    return_inferencedata : with False, the posterior dict {name: (chain,
        draw, *shape)} is returned (the JAX package's MultiTrace needs
        `backends/base.py`, which is not ported).

    Returns an InferenceData whose posterior attrs hold sampling_time,
    tuning_time, compile_time (seconds spent building kernels in this call),
    sampler, n_leapfrog (batched leapfrog calls, step-size search included),
    n_logp_grad (every batched logp+grad call: the starting points' two and
    the leapfrogs'), n_step_search (the step-size search's batched
    leapfrogs), n_subtrees (NUTS: batched subtrees built, tuning included,
    one per doubling of the deepest tree of each draw; ChEES: 0) and
    sampling_host_syncs (the syncs of the sampler's loops while drawing:
    NUTS one per leapfrog and per tree doubling, and one per draw; ChEES
    the reads of its number of leapfrogs, counted as they are made: one a
    draw); with ChEES also
    trajectory_length, the adapted T at the end.
    """
    if draws < 1:
        raise ValueError("draws must be >= 1")
    model = modelcontext(model)
    for name, value in (("mass_adapt", mass_adapt), ("step_adapt", step_adapt)):
        if value not in ("per_chain", "pooled"):
            raise ValueError(f"{name} must be 'per_chain' or 'pooled', got {value!r}")
    if str(sampler).lower() not in ("nuts", "chees"):
        raise ValueError(f"Unknown sampler {sampler!r}: expected 'nuts' or 'chees'")
    use_chees = str(sampler).lower() == "chees"
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
    n_step_search = logp_grad.calls - calls_before_leapfrogs
    if step_adapt == "pooled":
        eps0 = eps0.mean().expand(chains).clone()
    state = SamplerState(q0, logp0, grad0, inv_mass, eps0)
    da = da_init(eps0)
    wf = welford_init(chains, D, dtype=dtype, device=device)
    schedule = build_schedule(tune)
    if use_chees:
        halton = torch.as_tensor(
            halton_sequence(tune + draws) * 0.9 + 0.1, dtype=dtype, device=device
        )
        # T starts at about 16 leapfrogs of the found step size
        zero = torch.zeros((), dtype=dtype, device=device)
        chees_extra = (torch.log(16.0 * torch.mean(eps0)), zero, zero, zero)
        # a tighter cap than NUTS's tree: the ChEES gradient stays weakly
        # positive far past the optimum on some targets (pymc_tpu :385-389)
        max_leapfrogs = 2 ** max(max_treedepth - 2, 4)
        host_read = HostReads()
    else:
        draw_source = TorchDraws(gen, chains, D, dtype, device)

    q_draws = torch.empty((draws, chains, D), dtype=dtype, device=device)
    stat_draws, depths = [], []
    for i in range(tune + draws):
        warm = i < tune
        if i == tune:
            _synchronize(device)
            t1 = time.perf_counter()
            calls_at_t1 = logp_grad.calls
            reads_at_t1 = host_read.count if use_chees else 0
        step_size = torch.exp(da.log_step if warm else da.log_step_avg)
        if use_chees:
            xi = torch.randn((chains, D), generator=gen, dtype=dtype, device=device)
            u = torch.rand((chains,), generator=gen, dtype=dtype, device=device)
            st, ch = chees_step(
                logp_grad, CheesState(state.q, state.logp, state.grad, *chees_extra),
                step_size, state.inv_mass, halton[i], xi, u, adapt_T=warm,
                max_leapfrogs=max_leapfrogs, host_read=host_read,
            )
            q, logp, grad = st.q, st.logp, st.grad
            chees_extra = (st.log_T, st.adam_m, st.adam_v, st.adam_t)
            stats = _chees_stats(ch)
        else:
            (q, logp, grad), stats = nuts_transition(
                logp_grad, draw_source, state.q, state.logp, state.grad,
                step_size, state.inv_mass, max_treedepth=max_treedepth,
            )
            depths.append(stats.depth)
        state = state._replace(q=q, logp=logp, grad=grad, step_size=step_size)
        if not warm:
            q_draws[i - tune] = q
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

    posterior = _postprocess(model, q_draws, var_names)
    del q_draws
    stats = NutsStats(*[torch.stack(v).cpu().numpy() for v in zip(*stat_draws)])
    sample_stats = {
        _STAT_NAMES[f]: getattr(stats, f).swapaxes(0, 1) for f in NutsStats._fields
    }
    if use_chees:
        # the reads of the number of leapfrogs, one per draw
        subtrees = 0
        host_syncs = host_read.count - reads_at_t1
    else:
        # each draw's trajectory loop ran max-depth doublings (one subtree
        # each) and read one `.any()` per doubling and one at its end; each
        # leaf read one count: syncs = leapfrogs + max depth + 1 per draw
        max_depth = torch.stack(depths).amax(dim=1).cpu().numpy()
        subtrees = int(max_depth.sum())
        host_syncs = logp_grad.calls - calls_at_t1 + int((max_depth[tune:] + 1).sum())
    ss = torch.exp(da.log_step_avg).cpu().numpy()
    sample_stats["step_size"] = np.broadcast_to(ss[:, None], (chains, draws)).copy()
    extra = {"trajectory_length": float(torch.exp(chees_extra[0]))} if use_chees else {}
    idata = to_inference_data(
        model,
        posterior=posterior,
        sample_stats=sample_stats,
        attrs={
            **extra,
            "max_treedepth": max_treedepth,
            "sampler": "chees" if use_chees else "nuts",
            "sampling_time": t2 - t1,
            "tuning_time": t1 - t0,
            "compile_time": sum(_build.build_seconds.values()) - built_before,
            "n_leapfrog": logp_grad.calls - calls_before_leapfrogs,
            "n_logp_grad": logp_grad.calls,
            "n_step_search": n_step_search,
            "n_subtrees": subtrees,
            "sampling_host_syncs": host_syncs,
            "device": str(device),
            "inference_library": "pymc_tpu_torch",
        },
    )
    _log.info(f"Sampling {draws} draws x {chains} chains took {t2 - t1:.2f}s")
    if compute_convergence_checks:
        log_warnings(run_convergence_checks(idata, model))
    if not return_inferencedata:
        return posterior
    return idata
