"""`sample` — batched NUTS or ChEES with every init of the JAX package:
jittered or plain starts, diagonal or full mass adapted in windows, the
exp-weighted grad-based diagonal, ADVI starts and masses, and MAP starts
with the Hessian's inverse as a static full mass.

Counterpart of `pymc_tpu/sampling/mcmc.py::sample` (:69, the inits
:182-330, per-draw `step` :372-491, the ChEES branch :344-406, `_package`
:953-1005, `init_nuts` :901, `_make_postprocess_fn` :1106). Chains are the
leading axis of every tensor on one device. Warmup and sampling run one
Python loop over draws; the adaptation flags of the Stan schedule are host
booleans, so adaptation adds no host sync. A full mass is a DenseMass,
factored by the Cholesky kernel once at the start and once at each window
switch; the samplers run it in whitened coordinates through the same
kernels (full_mass.py). Draws and stats stay on the device until the end;
the draws are postprocessed there in row chunks, and only the variables
`var_names` names (default: all) cross to the host.

A model with a discrete free variable, or a call with `step=`, goes to
compound step methods (step_methods/compound.py::sample_with_steps), as
`pymc_tpu/sampling/mcmc.py:141-160` routes it.

Left out against the JAX package, each raising NotImplementedError with
its ROADMAP item: warmup groups (`discard_tuned_samples=False`), callbacks, traces and
resume, postprocessing chunks, meshes, the warning stat and the
log-likelihood group; and the TPU-only chunk compilation.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..backends.arviz import select_var_names, to_inference_data
from ..blocking import ravel_point, unravel_vector
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
    expw_init,
    expw_inv_mass,
    expw_seed,
    expw_update,
    find_reasonable_step_size,
    welford_covariance,
    welford_init,
    welford_update,
    welford_update_batch,
    welford_variance,
)
from .chees import CheesState, HostReads, chees_step, halton_sequence
from .full_mass import DenseMass
from .nuts import NutsStats, SamplerState, TorchDraws, nuts_transition

__all__ = ["sample", "init_nuts", "SamplingError", "SUPPORTED_INITS"]

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


# pymc_tpu.sample's init family (pymc_tpu/sampling/mcmc.py:44-54; reference
# pymc/sampling/mcmc.py:1759-2020); "auto" is jitter+adapt_diag
SUPPORTED_INITS = frozenset({
    "adapt_diag",
    "jitter+adapt_diag",
    "jitter+adapt_diag_grad",
    "advi+adapt_diag",
    "advi",
    "advi_map",
    "map",
    "adapt_full",
    "jitter+adapt_full",
})

# the arguments pymc_tpu.sample honours that the port has not ported yet,
# with the ROADMAP item each waits for
_WAITS_FOR = {
    "discard_tuned_samples": "the ROADMAP item on the rest of sample (warmup groups)",
    "callback": "the ROADMAP item on the rest of sample",
    "trace": "the ROADMAP item on the rest of sample (traces and resume)",
    "resume": "the ROADMAP item on the rest of sample (traces and resume)",
    "chunk_size": "the ROADMAP item on the rest of sample (traces and resume)",
    "postprocessing_chunks": "the ROADMAP item on the rest of sample",
    "mesh": "parallel/mesh.py (the ROADMAP's last item)",
    "keep_warning_stat": "the ROADMAP item on the results layer",
    "idata_kwargs": "the ROADMAP item on the results layer (the log-likelihood group)",
    "chain_method": "parallel/mesh.py (the ROADMAP's last item): chains are one device axis here",
}


def _resolve_init(init):
    init = str(init)
    if init == "auto":
        init = "jitter+adapt_diag"
    if init not in SUPPORTED_INITS:
        raise ValueError(f"Unknown initializer: {init!r}. Valid: {sorted(SUPPORTED_INITS)}")
    return init


def _refuse_unported(**asked):
    for name, value in asked.items():
        if value:
            raise NotImplementedError(
                f"sample({name}=...) is not ported to pymc_tpu_torch yet: it waits for "
                f"{_WAITS_FOR[name]}"
            )


def _initial_state(init, model, logp_grad, chains, gen, device, dtype, *, n_init=10_000,
                   initvals=None, jitter_max_retries=10, progressbar=False, record=None):
    """The chains' (C, D) starting points under `init`, with the mass the
    init seeds: (q0, the ADVI variances (D,) or None, the MAP covariance
    (D, D) or None). ADVI inits fit mean-field ADVI (advi_map started at
    the MAP point) and draw the starts from it; map starts every chain at
    the MAP point with the inverse of -H(logp) there, repaired to be
    positive definite; the rest jitter the initial point (or not).
    `record`, a dict, receives the init's wall, host reads and losses."""
    # imported here: variational/ and tuning/ import this package's modules
    from ..distributions.dist_math import softplus
    from ..tuning.starting import find_hessian, find_MAP
    from ..variational.approximations import MeanField
    from ..variational.inference import ADVI

    record = {} if record is None else record
    info = model.raveled_info()
    D = info.total_size
    t0 = time.perf_counter()
    if "advi" in init or init == "map":
        seed = int(torch.randint(2**30, (1,), generator=gen, device=device))
    if "advi" in init:
        start = None
        if init == "advi_map":
            _log.info("Initializing NUTS with MAP-started ADVI...")
            map_pt = find_MAP(model=model, include_transformed=False, seed=seed,
                              progressbar=False, device=device)
            start = {rv.name: map_pt[rv.name] for rv in model.free_RVs if rv.name in map_pt}
        _log.info(f"Initializing NUTS with ADVI ({n_init} iterations)...")
        inference = ADVI(model=model, start=start, random_seed=seed, device=device)
        approx = inference.fit(n_init, progressbar=progressbar)
        eps = torch.randn((chains, D), generator=gen, dtype=dtype, device=device)
        q0 = MeanField.sample_q(approx.params, eps)
        record.update(init_loss=approx.hist, init_host_reads=inference.host_reads.count,
                      init_time=time.perf_counter() - t0)
        return q0, softplus(approx.params["rho"]) ** 2, None
    if init == "map":
        _log.info("Initializing NUTS at the MAP point...")
        map_pt, res = find_MAP(model=model, include_transformed=True, seed=seed,
                               progressbar=False, return_raw=True, device=device)
        q_map = ravel_point({n: torch.as_tensor(map_pt[n]) for n in info.names}, info)
        q0 = q_map.to(device=device, dtype=dtype).expand(chains, D).clone()
        prec = np.asarray(find_hessian(point=map_pt, model=model, device=device), np.float64)
        # Sigma = the precision's inverse, repaired where the Hessian is not
        # positive definite away from an interior optimum
        prec = 0.5 * (prec + prec.T)
        eigmin = float(np.linalg.eigvalsh(prec).min())
        if eigmin <= 1e-10:
            prec = prec + (1e-6 - min(eigmin, 0.0)) * np.eye(D)
        record.update(init_evaluations=int(res.nfev), init_time=time.perf_counter() - t0)
        cov = torch.as_tensor(np.linalg.inv(prec), dtype=dtype, device=device)
        return q0, None, cov
    q0 = make_initial_points_per_chain(
        model, lambda q: logp_grad(q)[0], chains, gen, device=device, dtype=dtype,
        jitter=1.0 if init.startswith("jitter") else 0.0, overrides=initvals,
        jitter_max_retries=jitter_max_retries,
    )
    return q0, None, None


def sample(
    draws=1000,
    *,
    tune=1000,
    chains=4,
    model=None,
    random_seed=None,
    target_accept=0.8,
    max_treedepth=10,
    init="jitter+adapt_diag",
    jitter_max_retries=10,
    initvals=None,
    n_init=10_000,
    mass_matrix=None,
    nuts=None,
    mass_adapt="per_chain",
    step_adapt="per_chain",
    sampler="nuts",
    var_names=None,
    compute_convergence_checks=True,
    return_inferencedata=True,
    device=None,
    progressbar=True,
    cores=None,
    nuts_sampler=None,
    chain_method="vectorized",
    idata_kwargs=None,
    step=None,
    discard_tuned_samples=True,
    callback=None,
    trace=None,
    resume=False,
    chunk_size=None,
    postprocessing_chunks=None,
    mesh=None,
    keep_warning_stat=False,
):
    """Draw posterior samples with batched NUTS or ChEES on one device.

    init : one of SUPPORTED_INITS or "auto" (jitter+adapt_diag); anything
        else raises the JAX package's ValueError. "adapt_diag" and
        "adapt_full" start every chain at the initial point, their
        "jitter+" forms add U(-1, 1) there (up to `jitter_max_retries`
        tries for a finite logp; `initvals` override the initial values);
        "jitter+adapt_diag_grad" adapts the diagonal from exp-weighted
        variances of the draws and gradients; "advi+adapt_diag" starts
        from `n_init` steps of mean-field ADVI and seeds the windowed
        diagonal with its variances; "advi" and "advi_map" (ADVI started
        at the MAP point) keep that mass static; "map" starts at the MAP
        point with the static full mass Sigma = (-H)^-1 there.
    mass_matrix : "diag" or "full" (default: "full" for the adapt_full
        inits and map, else "diag"). A full mass is one Sigma pooled over
        the chains, factored by the Cholesky kernel.
    nuts : {"target_accept", "max_treedepth"} override the arguments;
        "use_pallas" is accepted and does nothing (the port always runs
        its kernels).
    mass_adapt / step_adapt : "per_chain" (reference behaviour) or "pooled"
        — pool the diagonal Welford variances / the dual-averaging
        acceptance across chains (a full mass is always pooled).
    sampler : "nuts" (default) or "chees" — ChEES-HMC: every chain takes
        the same number of leapfrogs a draw, from a trajectory length
        adapted in warmup (sampling/chees.py).
    var_names : names of the posterior variables to keep (default: all);
        only these reach the host. Unknown names are warned about and left
        out.
    device : "cuda" (default) or "cpu"; the card is used unless "cpu" is
        asked for, and without a card the default raises. The sampler runs
        in float32 on CUDA, float64 on the CPU.
    progressbar, cores, nuts_sampler, chain_method="vectorized",
        idata_kwargs={"log_likelihood": False} : accepted, as
        `pymc_tpu.sample` accepts them; they do nothing on one device.
    step : a step method or CompoundStep (or a list of them); the free
        variables they leave go to NUTS, or to a Gibbs or Metropolis step
        where discrete. A model with a discrete free variable goes this
        way without `step=` (step_methods/compound.py::sample_with_steps,
        which takes draws, tune, chains, random_seed, initvals,
        jitter_max_retries, var_names, device, compute_convergence_checks
        and return_inferencedata; the NUTS-only arguments do not apply).
    discard_tuned_samples=False, callback, trace, resume, chunk_size,
        postprocessing_chunks, mesh, keep_warning_stat, another
        chain_method, idata_kwargs asking for more : not ported yet; each
        raises NotImplementedError naming what it waits for.
    return_inferencedata : with False, the posterior dict {name: (chain,
        draw, *shape)} is returned (the JAX package's MultiTrace needs
        `backends/base.py`, which is not ported).

    Returns an InferenceData whose posterior attrs hold sampling_time,
    tuning_time (the init's ADVI or MAP included), compile_time (seconds
    spent building kernels in this call), sampler, init, mass_matrix,
    n_leapfrog (batched leapfrog calls, step-size search included),
    n_logp_grad (every batched logp+grad call of the sampler: the starting
    points' and the leapfrogs'), n_step_search (the step-size search's
    batched leapfrogs), n_subtrees (NUTS: batched subtrees built, tuning
    included, one per doubling of the deepest tree of each draw; ChEES: 0)
    and sampling_host_syncs (the syncs of the sampler's loops while
    drawing: NUTS one per leapfrog and per tree doubling, and one per
    draw; ChEES the reads of its number of leapfrogs, counted as they are
    made: one a draw); with ChEES also trajectory_length, the adapted T at
    the end; with a full mass inv_mass, the final Sigma (numpy); with an
    ADVI init init_time, init_loss (the loss history) and init_host_reads
    (one a chunk of 100 steps); with init="map" init_time and
    init_evaluations (scipy's logp+grad evaluations).
    """
    if draws < 1:
        raise ValueError("draws must be >= 1")
    _refuse_unported(
        discard_tuned_samples=not discard_tuned_samples,
        callback=callback is not None, trace=trace is not None, resume=bool(resume),
        chunk_size=chunk_size is not None, postprocessing_chunks=postprocessing_chunks is not None,
        mesh=mesh is not None, keep_warning_stat=bool(keep_warning_stat),
        idata_kwargs=any(k != "log_likelihood" or v for k, v in (idata_kwargs or {}).items()),
        chain_method=chain_method != "vectorized",
    )
    model = modelcontext(model)
    if step is not None or model.discrete_value_vars:
        from ..step_methods.compound import sample_with_steps

        return sample_with_steps(
            draws=draws, tune=tune, chains=chains, model=model, step=step,
            random_seed=random_seed, compute_convergence_checks=compute_convergence_checks,
            return_inferencedata=return_inferencedata, initvals=initvals,
            jitter_max_retries=jitter_max_retries, var_names=var_names, device=device,
        )
    init = _resolve_init(init)
    for name, value in (("mass_adapt", mass_adapt), ("step_adapt", step_adapt)):
        if value not in ("per_chain", "pooled"):
            raise ValueError(f"{name} must be 'per_chain' or 'pooled', got {value!r}")
    if str(sampler).lower() not in ("nuts", "chees"):
        raise ValueError(f"Unknown sampler {sampler!r}: expected 'nuts' or 'chees'")
    use_chees = str(sampler).lower() == "chees"
    if nuts:
        target_accept = nuts.get("target_accept", target_accept)
        max_treedepth = nuts.get("max_treedepth", max_treedepth)
    if mass_matrix is None:
        mass_matrix = "full" if ("adapt_full" in init or init == "map") else "diag"
    if mass_matrix not in ("diag", "full"):
        raise ValueError(f"mass_matrix must be 'diag' or 'full', got {mass_matrix!r}")
    full_mass = mass_matrix == "full"
    # the static-mass inits keep the mass their init seeds (the reference's
    # non-adapting QuadPotentialDiag/Full, mcmc.py:1959-1989); grad_mass
    # adapts the diagonal continuously from exp-weighted variances
    static_mass = init in ("advi", "advi_map", "map")
    grad_mass = init == "jitter+adapt_diag_grad"
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

    init_record = {}
    q0, advi_var, map_cov = _initial_state(
        init, model, logp_grad, chains, gen, device, dtype, n_init=n_init, initvals=initvals,
        jitter_max_retries=jitter_max_retries, progressbar=progressbar, record=init_record,
    )
    logp0, grad0 = logp_grad(q0)
    calls_before_leapfrogs = logp_grad.calls
    bad = torch.nonzero(~torch.isfinite(logp0)).flatten().tolist()
    if bad:
        raise SamplingError(
            f"Initial evaluation of model at starting point failed for chains {bad}"
        )
    if full_mass:
        cov = map_cov if map_cov is not None else torch.eye(D, dtype=dtype, device=device)
        inv_mass = DenseMass(cov)
    elif advi_var is not None:
        inv_mass = advi_var.to(dtype).expand(chains, D).contiguous()
    else:
        inv_mass = torch.ones((chains, D), dtype=dtype, device=device)
    xi = torch.randn((chains, D), generator=gen, dtype=dtype, device=device)
    eps0 = find_reasonable_step_size(logp_grad, q0, logp0, grad0, xi, inv_mass)
    n_step_search = logp_grad.calls - calls_before_leapfrogs
    if step_adapt == "pooled":
        eps0 = eps0.mean().expand(chains).clone()
    state = SamplerState(q0, logp0, grad0, inv_mass, eps0)
    da = da_init(eps0)
    wf = welford_init(chains, D, dtype=dtype, device=device, full=full_mass)
    if static_mass or grad_mass:
        schedule = {k: np.zeros(tune, dtype=bool) for k in ("update_mass", "switch_mass")}
    else:
        schedule = build_schedule(tune)
    if grad_mass:
        ew = expw_init((chains, D), dtype=dtype, device=device)
        # discard window, and the end of the continuous adaptation
        # (pymc_tpu/sampling/mcmc.py:449-450)
        disc = 50
        stop_adapt = (tune - 50) if tune > 250 else tune + 1
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
        if grad_mass:
            # exp-weighted variances of draws and grads, applied every
            # warmup draw after two discard windows (reference
            # QuadPotentialDiagAdaptExp, quadpotential.py:493-580)
            if i == disc:
                ew = expw_seed(q, grad)
            if disc < i < stop_adapt:
                ew = expw_update(ew, q, grad)
            if i > 2 * disc:
                state = state._replace(inv_mass=expw_inv_mass(ew))
            continue
        if schedule["update_mass"][i]:
            wf = welford_update_batch(wf, q) if full_mass else welford_update(wf, q)
        if schedule["switch_mass"][i]:
            if full_mass:
                new_inv = DenseMass(welford_covariance(wf))
            else:
                new_inv = welford_variance(wf)
                if mass_adapt == "pooled":
                    new_inv = new_inv.mean(dim=0, keepdim=True).expand(chains, D)
                new_inv = new_inv.contiguous()
            state = state._replace(inv_mass=new_inv)
            wf = welford_init(chains, D, dtype=dtype, device=device, full=full_mass)
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
    extra = dict(init_record)
    if use_chees:
        extra["trajectory_length"] = float(torch.exp(chees_extra[0]))
    if full_mass:
        extra["inv_mass"] = state.inv_mass.cov.cpu().numpy()
    idata = to_inference_data(
        model,
        posterior=posterior,
        sample_stats=sample_stats,
        attrs={
            **extra,
            "max_treedepth": max_treedepth,
            "sampler": "chees" if use_chees else "nuts",
            "init": init,
            "mass_matrix": mass_matrix,
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


def init_nuts(init="jitter+adapt_diag", chains=1, random_seed=None, model=None, initvals=None,
              device=None, **kwargs):
    """The chains' starting points under `init` (reference mcmc.py:1759):
    ({value_name: (chains, *shape)} tensors on `device`, the init's name).
    Unknown inits raise ValueError; the ADVI and MAP inits run ADVI / MAP
    (`n_init` steps of ADVI, default 10,000)."""
    init = _resolve_init(init)
    model = modelcontext(model)
    device = resolve_device(device)
    dtype = floatX(device)
    if random_seed is None:
        random_seed = int(np.random.default_rng().integers(2**30))
    gen = torch.Generator(device=device).manual_seed(int(random_seed))
    q0, _, _ = _initial_state(
        init, model, model.logp_dlogp_fn(device=device, dtype=dtype), chains, gen, device,
        dtype, n_init=int(kwargs.get("n_init", 10_000)), initvals=initvals,
    )
    return unravel_vector(q0, model.raveled_info()), init
