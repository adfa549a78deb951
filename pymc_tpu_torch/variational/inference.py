"""Variational inference: the fit loops.

Counterpart of `pymc_tpu/variational/inference.py` (reference
pymc/variational/inference.py: Inference.fit:106 with its NaN diagnostics,
ADVI:353, FullRankADVI:497, SVGD:542, ASVGD:610, the functional fit:695).

The JAX package scans 100 steps in one jitted program and reads the
chunk's losses once. Here a chunk is a host loop of eager steps whose
losses and NaN-guard flags stay on the device, in one buffer that is read
once a chunk (`Inference.host_reads` counts the reads, as
`sampling.chees.HostReads` does). A step is one logp+grad of the model at
the `obj_n_mc` points q gives (`Model.logp_dlogp_fn`), the chain rule back
to the approximation's parameters through autograd on a small graph, and
the optimizer's update, all on the parameters' device; nothing in it
reads the device. `fit` raises FloatingPointError when every step of a
chunk was non-finite, as the JAX package does.

Randomness is an input: each step takes its noise from a draw source,
`draws(step, approx_cls, params, n)` (default `TorchVIDraws` on the
inference's torch.Generator), so a test can feed the JAX package's
normals (`fold_in(key, done)`, `split(m)`, `split(k)` into `(k_q, k_mb)`,
`normal(k_q, (obj_n_mc, D))`) and ask for the same parameters. The port
has no Minibatch yet (it waits for `data.py`), so there is no minibatch
branch.
"""

from __future__ import annotations

import logging
import time

import numpy as np
import torch

from ..blocking import ravel_point
from ..config import floatX, resolve_device
from ..initial_point import support_point_values
from ..model.core import modelcontext
from ..sampling.chees import HostReads
from .approximations import Approximation, Empirical, FullRank, MeanField
from .operators import Stein
from .updates import apply_updates, chain, clip_by_global_norm, get_optimizer, tree_leaves, \
    tree_map

__all__ = ["ADVI", "FullRankADVI", "SVGD", "ASVGD", "KLqp", "ImplicitGradient", "fit",
           "Inference", "TorchVIDraws"]

_log = logging.getLogger("pymc_tpu_torch")


class TorchVIDraws:
    """The noise of each fit step from a torch.Generator (the step index is
    not used: fresh draws on every call are independent)."""

    def __init__(self, generator):
        self.gen = generator

    def __call__(self, step, approx_cls, params, n):
        return approx_cls.noise(params, n, self.gen)


def _as_cpu(v):
    return v.detach().cpu().to(torch.float64) if torch.is_tensor(v) else torch.as_tensor(
        np.asarray(v, dtype=np.float64))


def _start_flat(model, info, start, device, dtype):
    """A (possibly partial, rv-name-keyed, constrained) start dict as a flat
    value-space vector; missing entries come from the model's initial point
    (reference Inference start handling)."""
    if start is None:
        return None
    names = {rv.name for rv in model.free_RVs}
    unknown = set(start) - names
    if unknown:
        raise KeyError(
            f"start contains unknown variable(s) {sorted(unknown)}; free variables are "
            f"{sorted(names)}"
        )
    base = model.constrain(support_point_values(model))
    merged = {**base, **{k: _as_cpu(v) for k, v in start.items()}}
    merged = {k: torch.broadcast_to(v, base[k].shape) for k, v in merged.items()}
    return ravel_point(model.unconstrain(merged), info).to(device=device, dtype=dtype)


def _sigma_flat(model, info, start_sigma):
    """start_sigma (a scalar, or a value-space dict keyed by rv or value
    name) as a flat (D,) vector; unnamed entries keep the 0.1 default."""
    if start_sigma is None or np.isscalar(start_sigma) or not isinstance(start_sigma, dict):
        return start_sigma
    flat = np.full((info.total_size,), 0.1, dtype=np.float64)
    slices = info.slices()
    alias = {rv.value_name: rv.value_name for rv in model.free_RVs}
    alias.update({rv.name: rv.value_name for rv in model.free_RVs})
    for k, v in start_sigma.items():
        name = alias.get(k)
        if name is None:
            raise KeyError(f"start_sigma contains unknown variable {k!r}")
        flat[slices[name]] = np.broadcast_to(np.asarray(v, dtype=np.float64).reshape(-1)
                                             if np.ndim(v) else np.asarray(v),
                                             flat[slices[name]].shape)
    return flat


def _generator(random_seed, device):
    if random_seed is None:
        random_seed = int(np.random.default_rng().integers(2**30))
    return torch.Generator(device=device).manual_seed(int(random_seed))


def _all_finite(tree):
    return torch.stack([torch.isfinite(x).all() for x in tree_leaves(tree)]).all()


class Inference:
    """The base fit loop (reference inference.py:48). Runs on the card
    unless `device="cpu"` is asked for (or `approx` lives elsewhere)."""

    approx_cls = MeanField

    def __init__(self, approx=None, model=None, random_seed=None, start=None, start_sigma=None,
                 obj_n_mc=1, total_grad_norm_constraint=None, device=None, **kwargs):
        self.total_grad_norm_constraint = total_grad_norm_constraint
        if approx is not None and not isinstance(approx, Approximation):
            raise TypeError(f"approx must be an Approximation, got {type(approx).__name__}")
        if approx is not None:
            # adopt an existing (e.g. Group-built) approximation (reference
            # KLqp(approx), inference.py:324)
            self.model, self.info = approx.model, approx.info
            self.approx_cls = type(approx)
            self.params = approx.params
            device = approx.device
        else:
            self.model = modelcontext(model)
            device = resolve_device(device)
            self.info = self.model.raveled_info()
            D = self.info.total_size
            dtype = floatX(device)
            start_flat = _start_flat(self.model, self.info, start, device, dtype)
            self.params = self.approx_cls.init_params(
                D, start=start_flat, start_sigma=_sigma_flat(self.model, self.info, start_sigma),
                device=device, dtype=dtype,
            )
        self._setup(device, random_seed, obj_n_mc)

    def _setup(self, device, random_seed, obj_n_mc):
        self.device = torch.device(device)
        self.dtype = tree_leaves(self.params)[0].dtype
        self.gen = _generator(random_seed, self.device)
        self.obj_n_mc = obj_n_mc
        self.host_reads = HostReads()
        self._logp_grad = self.model.logp_dlogp_fn(device=self.device, dtype=self.dtype)

    def objective(self, params, noise):
        """The negative ELBO (the KL operator, reference operators.py:33) at
        the points the draws `noise` give."""
        return self.loss_and_grad(params, noise)[0]

    def loss_and_grad(self, params, noise):
        """(-ELBO, its gradient in params) at the points the draws `noise`
        give: one batched logp+grad of the model, then autograd through
        sample_q and the entropy only."""
        with torch.enable_grad():
            p = tree_map(lambda v: v.detach().requires_grad_(True), params)
            z = self.approx_cls.sample_q(p, noise)
            logp, g = self._logp_grad(z.detach())
            entropy = self.approx_cls.entropy(p)
            surrogate = -(torch.sum(z * g) / z.shape[0] + entropy)
            grads = iter(torch.autograd.grad(surrogate, tree_leaves(p)))
        loss = -(torch.mean(logp) + entropy.detach())
        return loss, tree_map(lambda _: next(grads), p)

    def _make_opt(self, obj_optimizer, default=None, default_lr=None):
        kw = {"default": default, "default_lr": default_lr} if default is not None else {}
        opt = get_optimizer(obj_optimizer, **kw)
        c = self.total_grad_norm_constraint
        if c is not None:
            # clip the global gradient norm before the optimizer update
            opt = chain(clip_by_global_norm(float(c)), opt)
        return opt

    def _step(self, opt, params, opt_state, noise):
        loss, g = self.loss_and_grad(params, noise)
        updates, opt_state = opt.update(g, opt_state, params)
        new_params = apply_updates(params, updates)
        # NaN guard (reference inference.py:228): skip the update when the
        # loss or any updated parameter is not finite
        ok = torch.isfinite(loss) & _all_finite(new_params)
        params = tree_map(lambda new, old: torch.where(ok, new, old), new_params, params)
        return params, opt_state, loss, ok

    def fit(self, n=10000, obj_optimizer=None, callbacks=None, progressbar=True, chunk=100,
            score=None, draws=None, **kwargs):
        """Run n optimizer steps in chunks of `chunk`; returns the fitted
        approximation with its loss history in `.hist`. `draws`: the draw
        source (default: TorchVIDraws on this inference's generator)."""
        opt = self._make_opt(obj_optimizer)
        opt_state = opt.init(self.params)
        draws = draws or TorchVIDraws(self.gen)
        params = self.params
        losses = []
        callbacks = callbacks or []
        t0 = time.perf_counter()
        done = 0
        while done < n:
            m = min(chunk, n - done)
            buf = torch.empty((2, m), dtype=self.dtype, device=self.device)
            for j in range(m):
                noise = draws(done + j, self.approx_cls, params, self.obj_n_mc)
                params, opt_state, buf[0, j], buf[1, j] = self._step(opt, params, opt_state,
                                                                     noise)
            chunk_losses, chunk_ok = self.host_reads.numpy(buf)  # the chunk's one read
            if not (chunk_ok > 0).any():
                raise FloatingPointError(
                    f"NaN occurred in optimization: all {m} update(s) of the last window "
                    "were non-finite (check the learning rate and the model's initial energy)"
                )
            losses.append(chunk_losses)
            done += m
            hist = np.concatenate(losses)
            stop = False
            for cb in callbacks:
                try:
                    cb(self._wrap(params, hist), hist, done)
                except StopIteration:
                    stop = True
            if stop:
                _log.info(f"Convergence achieved at {done}")
                break
        self.params = params
        hist = np.concatenate(losses) if losses else np.asarray([])
        if hist.size and not np.isfinite(hist[-1]):
            _log.warning("VI loss is non-finite at the last iteration")
        if hist.size:
            _log.info(f"Finished [100%]: Average Loss = {hist[-min(1000, hist.size):].mean():,.4g} "
                      f"({time.perf_counter() - t0:.1f}s)")
        return self._wrap(params, hist)

    def run_profiling(self, n=1000, chunk=100, obj_optimizer=None, **kwargs):
        """A timed dry run of fit (reference Inference.run_profiling) on a
        copy of the parameters; returns a profile whose `summary()` prints
        the first chunk's wall (kernel builds included) and the steady
        wall per step. The inference's state is not changed."""
        prof = _VIProfile()
        opt = self._make_opt(obj_optimizer)
        params, opt_state = self.params, opt.init(self.params)
        draws = TorchVIDraws(_generator(0, self.device))

        def run(steps, start):
            nonlocal params, opt_state
            for j in range(steps):
                noise = draws(start + j, self.approx_cls, params, self.obj_n_mc)
                params, opt_state, _, _ = self._step(opt, params, opt_state, noise)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

        t0 = time.perf_counter()
        first = min(chunk, n)
        run(first, 0)
        prof.compile_and_first_chunk_s = time.perf_counter() - t0
        steady = max(n - first, first)
        t1 = time.perf_counter()
        run(steady, first)
        prof.steady_s = time.perf_counter() - t1
        prof.n, prof.chunk = n, chunk
        prof.per_step_us = prof.steady_s / steady * 1e6
        return prof

    def _wrap(self, params, hist):
        approx = self.approx_cls(self.model, self.info, params)
        approx.hist = np.asarray(hist)
        return approx


class _VIProfile:
    """run_profiling's result: `.summary()` prints the timing table."""

    compile_and_first_chunk_s = None
    steady_s = None
    per_step_us = None
    n = 0
    chunk = 0

    def summary(self, stream=None):
        import sys

        lines = [
            "VI fit profile (eager steps, one host read a chunk)",
            f"  iterations          : {self.n} (chunk={self.chunk})",
            f"  first chunk         : {self.compile_and_first_chunk_s:.3f} s",
            f"  steady-state wall   : {self.steady_s:.3f} s",
            f"  per-iteration       : {self.per_step_us:.1f} µs",
        ]
        print("\n".join(lines), file=stream or sys.stdout)
        return self


class KLqp(Inference):
    """Reference inference.py:324."""


class ADVI(KLqp):
    """Mean-field ADVI (reference inference.py:353)."""

    approx_cls = MeanField


class FullRankADVI(KLqp):
    """Reference inference.py:497."""

    approx_cls = FullRank


class ImplicitGradient(Inference):
    """The base of the implicit-gradient (particle) methods (reference
    inference.py:526)."""


class SVGD(ImplicitGradient):
    """Stein variational gradient descent (reference inference.py:542,
    stein.py:27): the RBF kernel with the median heuristic; a step is one
    logp+grad of the model at every particle and the Stein update."""

    approx_cls = Empirical

    def __init__(self, n_particles=100, jitter=1.0, model=None, random_seed=None, start=None,
                 total_grad_norm_constraint=None, device=None, **kwargs):
        self.total_grad_norm_constraint = total_grad_norm_constraint
        self.model = modelcontext(model)
        device = resolve_device(device)
        dtype = floatX(device)
        self.info = self.model.raveled_info()
        D = self.info.total_size
        start_flat = _start_flat(self.model, self.info, start, device, dtype)
        if start_flat is None:
            start_flat = ravel_point(support_point_values(self.model), self.info).to(device, dtype)
        gen = _generator(random_seed, device)
        noise = torch.randn((n_particles, D), generator=gen, dtype=dtype, device=device)
        self.params = Empirical.init_params(D, start=start_flat, noise=noise, jitter=jitter,
                                            device=device, dtype=dtype)
        self._setup(device, None, 1)
        self.gen = gen

    def _phi(self, particles):
        """The SVGD direction phi(x) = mean_j [k(x_j, x) grad logp(x_j) +
        grad_{x_j} k] (operators.Stein with the rbf kernel)."""
        return Stein(lambda x: self._logp_grad(x)[1]).phi(particles)

    def fit(self, n=10000, obj_optimizer=None, callbacks=None, progressbar=True, chunk=100,
            score=None, **kwargs):
        """Whole chunks of `chunk` steps until n are done (so n rounds up
        to a multiple of `chunk`, as in the JAX package); the loss history
        is each step's mean |phi|."""
        opt = self._make_opt(obj_optimizer, default="adagrad", default_lr=1e-1)
        opt_state = opt.init(self.params)
        params = self.params
        losses = []
        done = 0
        while done < n:
            buf = torch.empty((chunk,), dtype=self.dtype, device=self.device)
            for j in range(chunk):
                phi = self._phi(params["particles"])
                updates, opt_state = opt.update({"particles": -phi}, opt_state, params)
                params = apply_updates(params, updates)
                buf[j] = torch.mean(torch.abs(phi))
            losses.append(self.host_reads.numpy(buf))
            done += chunk
        self.params = params
        return self._wrap(params, np.concatenate(losses) if losses else np.asarray([]))


class ASVGD(SVGD):
    """Amortized SVGD (reference inference.py:610), with SVGD's particle
    dynamics (non-amortized). Like the reference it takes no `start`
    (TypeError) and warns that the operator is experimental."""

    def __init__(self, *args, start=None, **kwargs):
        import warnings

        warnings.warn(
            "ASVGD is an experimental inference Operator; results may be unstable "
            "(reference opvi.py ObjectiveFunction warning)",
            UserWarning,
            stacklevel=2,
        )
        if start is not None:
            raise TypeError("ASVGD does not support the start argument (reference "
                            "inference.py:610)")
        super().__init__(*args, **kwargs)


def fit(n=10000, method="advi", model=None, random_seed=None, start=None, start_sigma=None,
        inf_kwargs=None, obj_optimizer=None, callbacks=None, progressbar=True, obj_n_mc=None,
        device=None, **kwargs):
    """The functional entry point (reference inference.py:695); runs on the
    card unless device="cpu" is asked for."""
    inf_kwargs = dict(inf_kwargs or {})
    if obj_n_mc is not None:
        inf_kwargs["obj_n_mc"] = obj_n_mc
    if isinstance(method, str):
        method = method.lower()
        registry = {"advi": ADVI, "fullrank_advi": FullRankADVI, "svgd": SVGD, "asvgd": ASVGD}
        if method not in registry:
            raise KeyError(f"method should be one of {list(registry)} or an Inference "
                           f"instance, got {method}")
        inference = registry[method](model=model, random_seed=random_seed, start=start,
                                     start_sigma=start_sigma, device=device, **inf_kwargs)
    elif isinstance(method, Inference):
        inference = method
    else:
        raise TypeError(f"Bad VI method: {method}")
    # no callbacks by default, as the reference's fit (inference.py:695);
    # pass CheckParametersConvergence for early stopping
    return inference.fit(n, obj_optimizer=obj_optimizer, callbacks=callbacks,
                         progressbar=progressbar, **kwargs)
