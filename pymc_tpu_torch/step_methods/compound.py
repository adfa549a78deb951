"""Compound stepping and competence-based assignment.

Counterpart of `pymc_tpu/step_methods/compound.py` (Competence :33,
BlockedStep :42, CompoundStep :86, assign_step_methods :120,
sample_with_steps :162, _postprocess_points :246; reference
pymc/step_methods/compound.py and pymc/sampling/mcmc.py:256). A step method
is a batched kernel step(draws, point, state, flags) -> (point, state,
stats) over value dicts {value_name: (chains, *shape)}: continuous values
in the sampling float type, discrete ones int64. A CompoundStep applies its
steps in turn. The JAX sampling loop is one `lax.scan` over draws; here it is one
Python loop over draws whose flags (tuning, the tune interval) are host
booleans. Draws and stats stay on the device until the end.

Every step evaluates the model's density through one `FlatDensity` per
(model, device, dtype): the model's own flat logp and logp+grad
(`Model.logp_flat_fn`, `Model.logp_dlogp_fn`), functions of one (N, D)
flat tensor in the model's raveled layout with the discrete entries
carried as floats and rounded inside, replayed from a CUDA graph per input
shape on the card (ops/cuda_graph.py). A step never closes a captured function over the
values it holds fixed: it writes its block into a copy of the flat point
and slices the gradient back.

Randomness comes from a draw source (`StepDraws` on a torch.Generator): a
step asks it for normals, uniforms and the like in a fixed order, so a test
can feed a step the draws that the JAX step makes.
"""

from __future__ import annotations

import enum
import logging
import time
import weakref

import numpy as np
import torch

from ..blocking import unravel_vector
from ..config import floatX, intX, resolve_device
from ..graph import FreeRV, ObservedRV, ancestors, evaluate
from ..model.core import modelcontext

__all__ = ["Competence", "BlockedStep", "CompoundStep", "StepDraws", "FlatDensity",
           "assign_step_methods", "sample_with_steps", "flat_point"]

_log = logging.getLogger("pymc_tpu_torch")

# integers above this are not exact in float32, the flat vector's type on the card
_FLOAT32_EXACT = 2**24


class Competence(enum.IntEnum):
    """Reference compound.py:47."""

    INCOMPATIBLE = 0
    COMPATIBLE = 1
    PREFERRED = 2
    IDEAL = 3


class StepDraws:
    """The random draws of the step methods from a torch.Generator. Each
    method returns fresh draws of `shape` in the sampling float type (int64
    for randint): the steps document the order in which they ask."""

    def __init__(self, generator, dtype, device):
        self.gen = generator
        self.dtype, self.device = dtype, device

    def _u(self, shape):
        return torch.rand(shape, generator=self.gen, dtype=self.dtype, device=self.device)

    def normal(self, shape):
        return torch.randn(shape, generator=self.gen, dtype=self.dtype, device=self.device)

    def uniform(self, shape):
        return self._u(shape)

    def exponential(self, shape):
        return -torch.log1p(-self._u(shape))

    def cauchy(self, shape):
        return torch.tan(torch.pi * (self._u(shape) - 0.5))

    def laplace(self, shape):
        u = self._u(shape) - 0.5
        return -torch.sign(u) * torch.log1p(-2.0 * torch.abs(u))

    def gumbel(self, shape):
        tiny = torch.finfo(self.dtype).tiny
        return -torch.log(-torch.log(torch.clamp(self._u(shape), min=tiny)))

    def poisson(self, lam):
        return torch.poisson(lam, generator=self.gen)

    def randint(self, high, shape):
        """Integers in [0, high); `high` an int or a tensor that broadcasts
        to `shape`."""
        return torch.floor(self._u(shape) * high).to(intX())

    def nuts(self, chains, dim):
        """The draw source of one NUTS transition (sampling/nuts.py)."""
        from ..sampling.nuts import TorchDraws

        return TorchDraws(self.gen, chains, dim, self.dtype, self.device)


class FlatDensity:
    """The model's densities over (N, D) flat points in the layout of
    `model.raveled_info()`, as the steps call them: `logp(q) -> logp (N,)`
    (`Model.logp_flat_fn`) and `logp_grad(q) -> (logp (N,), grad (N, D))`
    (`Model.logp_dlogp_fn` with the discrete entries rounded), each a
    GraphedFunction. `calls` counts the batched evaluations of each."""

    def __init__(self, model, device, dtype):
        self.info = model.raveled_info()
        self.device, self.dtype = device, dtype
        self._logp = model.logp_flat_fn(device, dtype)
        self._logp_grad = model.logp_dlogp_fn(device, dtype, round_discrete=True)
        self.calls = {"logp": 0, "logp_grad": 0}

    def logp(self, q):
        self.calls["logp"] += 1
        return self._logp(q)[0]

    def logp_grad(self, q):
        self.calls["logp_grad"] += 1
        return self._logp_grad(q)


_DENSITIES = weakref.WeakKeyDictionary()


def flat_density(model, device, dtype):
    """The FlatDensity of `model` on `device` in `dtype`, made once and
    shared by every step, so each input shape is captured once ("cuda" and
    the current card's "cuda:N" are one device)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    per_model = _DENSITIES.setdefault(model, {})
    key = (device, dtype, len(model.free_RVs), len(model.observed_RVs),
           len(model.potentials))
    if key not in per_model:
        per_model[key] = FlatDensity(model, device, dtype)
    return per_model[key]


def flat_point(point, info, dtype):
    """{value_name: (C, *shape)} -> (C, D) in `dtype`, the model's layout."""
    parts = [point[n].reshape(point[n].shape[0], -1).to(dtype) for n in info.names]
    return torch.cat(parts, dim=1)


def point_from_flat(q, model):
    """(C, D) flat -> {value_name: (C, *shape)}, discrete values rounded to
    int64."""
    vals = unravel_vector(q, model.raveled_info())
    for rv in model.free_RVs:
        if rv.dist.is_discrete:
            vals[rv.value_name] = torch.round(vals[rv.value_name]).to(intX())
    return vals


def _check_exact(rv):
    """A discrete variable's values must be exact in float32, which carries
    them on the card: its bounds (DiscreteUniform) or categories
    (Categorical) below 2**24."""
    from ..distributions.discrete import Categorical, DiscreteUniform

    if isinstance(rv.dist, Categorical):
        bounds = [rv.dist.n_categories]
    elif isinstance(rv.dist, DiscreteUniform):
        if any(isinstance(n, (FreeRV, ObservedRV))
               for n in ancestors([rv.dist.lower, rv.dist.upper])):
            return
        bounds = [evaluate(rv.dist.lower), evaluate(rv.dist.upper)]
    else:
        return
    worst = max(float(torch.as_tensor(b).abs().max()) for b in bounds)
    if not worst < _FLOAT32_EXACT:
        raise ValueError(
            f"{rv.name}: values up to {worst:g} are not exact in float32, which "
            "carries discrete values on the card (limit 2**24)"
        )


def _block_info(rvs):
    """(value names, value shapes, sizes, discrete flags) of a block."""
    names, shapes, sizes, discrete = [], [], [], []
    for rv in rvs:
        if rv.dist.is_discrete:
            _check_exact(rv)
        names.append(rv.value_name)
        shapes.append(tuple(rv.value_shape))
        sizes.append(int(np.prod(rv.value_shape)) if rv.value_shape else 1)
        discrete.append(rv.dist.is_discrete)
    return names, shapes, sizes, discrete


def _ravel_block(point, names, dtype):
    """The block's values as one (C, D_block) float tensor."""
    return torch.cat([point[n].reshape(point[n].shape[0], -1).to(dtype) for n in names], dim=1)


def _unravel_block(q, point, names, shapes, sizes, discrete):
    """`point` with the block's values taken from q (C, D_block); discrete
    values rounded to int64."""
    out = dict(point)
    off = 0
    C = q.shape[0]
    for n, s, size, disc in zip(names, shapes, sizes, discrete):
        v = q[:, off: off + size].reshape((C,) + tuple(s))
        out[n] = torch.round(v).to(intX()) if disc else v
        off += size
    return out


class BlockedStep:
    """Base class of the batched step methods.

    A subclass sets `self.rvs` (the free RVs it updates; every free RV when
    `vars` is None) and implements init_state(point, chains, draws) and
    step(draws, point, state, flags). `flags` holds host values: step_i,
    is_tune and tune_now (True every 100th tuning draw).
    """

    stats_names: tuple = ()
    name = "step"

    def __init__(self, vars=None, model=None, **kwargs):
        model = modelcontext(model)
        self.model = model
        if vars is None:
            rvs = list(model.free_RVs)
        else:
            rvs = [model.named_vars[v] if isinstance(v, str) else v for v in vars]
        self.rvs = rvs
        self.value_names = [rv.value_name for rv in rvs]
        self.names, self.shapes, self.sizes, self.discrete = _block_info(rvs)
        self.D = sum(self.sizes)
        info = model.raveled_info()
        cols = info.slices()
        self._cols = np.concatenate([np.arange(cols[n].start, cols[n].stop) for n in self.names])
        self._whole = np.array_equal(self._cols, np.arange(info.total_size))
        self._placed = {}

    @classmethod
    def competence(cls, var, has_grad):
        return Competence.INCOMPATIBLE

    def init_state(self, point, chains, draws):  # pragma: no cover - abstract
        raise NotImplementedError

    def step(self, draws, point, state, flags):  # pragma: no cover - abstract
        raise NotImplementedError

    # ------------------------------------------------------------ helpers
    def _density(self, point):
        """The model's FlatDensity on the point's device."""
        device = next(iter(point.values())).device
        return flat_density(self.model, device, floatX(device))

    def _on(self, name, value, like):
        """A numpy constant of the step on `like`'s device, placed once:
        floats in `like`'s float type, integers as int64, booleans as
        bool."""
        key = (name, like.device, like.dtype)
        if key not in self._placed:
            arr = np.asarray(value)
            dtype = {"b": torch.bool, "i": intX(), "u": intX()}.get(arr.dtype.kind, like.dtype)
            self._placed[key] = torch.as_tensor(arr).to(device=like.device, dtype=dtype)
        return self._placed[key]

    def _block_logp_grad(self, density, full):
        """qb (C, D_block) -> (logp (C,), grad (C, D_block)) with the other
        variables held at their values in `full` (C, D): the block goes into
        a copy of `full`, the captured logp+grad sees one (C, D) tensor."""
        if self._whole:
            return density.logp_grad
        cols = self._on("cols", self._cols, full)

        def fn(qb):
            logp, grad = density.logp_grad(full.index_copy(1, cols, qb))
            return logp, grad.index_select(1, cols)

        return fn

    def __repr__(self):
        return f"{type(self).__name__}({[rv.name for rv in self.rvs]})"


class CompoundStep:
    """Several steps applied in turn (reference compound.py:280). Records
    the host seconds each step's calls took in `host_seconds`."""

    def __init__(self, methods):
        self.methods = list(methods)
        self.host_seconds = [0.0] * len(self.methods)

    @property
    def value_names(self):
        return [n for m in self.methods for n in m.value_names]

    def init_state(self, point, chains, draws):
        return tuple(m.init_state(point, chains, draws) for m in self.methods)

    def step(self, draws, point, states, flags):
        new_states = []
        all_stats = {}
        for i, (m, st) in enumerate(zip(self.methods, states)):
            t0 = time.perf_counter()
            point, st, stats = m.step(draws, point, st, flags)
            self.host_seconds[i] += time.perf_counter() - t0
            new_states.append(st)
            for k, v in stats.items():
                all_stats[f"{m.name}{i}_{k}" if len(self.methods) > 1 else k] = v
        return point, tuple(new_states), all_stats

    def __repr__(self):
        return f"CompoundStep({self.methods})"


def assign_step_methods(model, step=None, methods=None):
    """Competence-based assignment (reference mcmc.py:256-347): the given
    steps keep their variables; the remaining continuous variables go to
    one NUTS block, each remaining Bernoulli to BinaryGibbsMetropolis, each
    Categorical to CategoricalGibbsMetropolis and any other discrete
    variable to Metropolis. One step is returned as it is, several as a
    CompoundStep."""
    from ..distributions.discrete import Bernoulli, Categorical
    from .hmc import NUTS
    from .metropolis import BinaryGibbsMetropolis, CategoricalGibbsMetropolis, Metropolis

    assigned = set()
    methods_out = []
    if step is not None:
        for s in step if isinstance(step, (list, tuple)) else [step]:
            for m in s.methods if isinstance(s, CompoundStep) else [s]:
                methods_out.append(m)
                assigned.update(rv.name for rv in m.rvs)
    rest = [rv for rv in model.free_RVs if rv.name not in assigned]
    cont = [rv for rv in rest if not rv.dist.is_discrete]
    if cont:
        methods_out.append(NUTS(vars=cont, model=model))
    for rv in rest:
        if not rv.dist.is_discrete:
            continue
        if isinstance(rv.dist, Bernoulli):
            methods_out.append(BinaryGibbsMetropolis(vars=[rv], model=model))
        elif isinstance(rv.dist, Categorical):
            methods_out.append(CategoricalGibbsMetropolis(vars=[rv], model=model))
        else:
            methods_out.append(Metropolis(vars=[rv], model=model))
    if len(methods_out) == 1:
        return methods_out[0]
    return CompoundStep(methods_out)


def _stat_array(values):
    """A stat's per-draw (C,) tensors -> (chain, draw) numpy."""
    return torch.stack(values).cpu().numpy().swapaxes(0, 1)


def sample_with_steps(draws=1000, tune=1000, chains=4, model=None, step=None,
                      random_seed=None, discard_tuned_samples=True,
                      compute_convergence_checks=True, return_inferencedata=True,
                      initvals=None, jitter_max_retries=10, var_names=None, device=None,
                      idata_kwargs=None):
    """MCMC with compound or explicit step methods (pymc_tpu
    compound.py:162): every chain batched on one device, one Python loop
    over tune + draws draws. The starting points are jittered on the
    continuous entries only. With discard_tuned_samples=False the warmup
    draws come back as the warmup_posterior and warmup_sample_stats groups
    (every step's stats), PyMC's semantics: `pymc_tpu` ignores the argument
    here (`pymc_tpu/step_methods/compound.py:218-223`, ROADMAP.md §3).
    idata_kwargs={"log_likelihood": True} adds the log_likelihood group,
    which `pymc_tpu`'s compound route leaves out; return_inferencedata=False
    returns a MultiTrace.

    The posterior's attrs hold sampling_time, tuning_time, the stepper,
    step_host_ms (each step's host ms a draw, tuning included), n_logp and
    n_logp_grad (the batched evaluations of the model's density, tuning
    included), and for each NUTS or HamiltonianMC block `{name}{i}_leapfrogs`
    (batched leapfrogs, tuning included: NUTS's lock-step leaves, HMC's
    per-draw maximum of n_steps), NUTS's `{name}{i}_subtrees` and
    `{name}{i}_host_reads` (the host reads of a NUTS, HMC or Slice step's
    loops); the prefix is left out for a single step. sample_stats holds each step's stats under the JAX
    package's names ({name}{i}_{stat} for a compound)."""
    from ..backends.arviz import to_inference_data
    from ..backends.base import multitrace_from_idata
    from ..initial_point import make_initial_points_per_chain
    from ..sampling.mcmc import _postprocess, _refuse_unported, _synchronize
    from ..stats.convergence import log_warnings, run_convergence_checks

    _refuse_unported(idata_kwargs=idata_kwargs)
    if draws < 1:
        raise ValueError("draws must be >= 1")
    model = modelcontext(model)
    device = resolve_device(device)
    dtype = floatX(device)
    if random_seed is None:
        random_seed = int(np.random.default_rng().integers(2**30))
    gen = torch.Generator(device=device)
    gen.manual_seed(int(random_seed))

    stepper = assign_step_methods(model, step)
    if not isinstance(stepper, CompoundStep):
        stepper = CompoundStep([stepper])
    stepper.host_seconds = [0.0] * len(stepper.methods)
    _log.info(f"Compound sampling with {stepper.methods}")
    density = flat_density(model, device, dtype)
    calls0 = dict(density.calls)
    info = model.raveled_info()

    t0 = time.perf_counter()
    q0 = make_initial_points_per_chain(
        model, density.logp, chains, gen, device=device, dtype=dtype, jitter=1.0,
        overrides=initvals, jitter_max_retries=jitter_max_retries,
    )
    point = point_from_flat(q0, model)
    counters = ("leapfrogs", "subtrees", "host_reads")
    counts0 = [{k: getattr(m, k) for k in counters if hasattr(m, k)} for m in stepper.methods]
    source = StepDraws(gen, dtype, device)
    states = stepper.init_state(point, chains, source)

    tune_now = np.zeros(tune + draws, dtype=bool)
    tune_now[99::100] = True  # the reference's tune_interval of 100
    warm = 0 if discard_tuned_samples else tune  # the warmup draws kept
    q_draws = torch.empty((warm + draws, chains, info.total_size), dtype=dtype, device=device)
    stat_draws = []
    for i in range(tune + draws):
        is_tune = i < tune
        if i == tune:
            _synchronize(device)
            t1 = time.perf_counter()
        flags = {"step_i": i, "is_tune": is_tune, "tune_now": bool(tune_now[i] and is_tune)}
        point, states, stats = stepper.step(source, point, states, flags)
        if i >= tune - warm:
            q_draws[i - tune + warm] = flat_point(point, info, dtype)
            stat_draws.append(stats)
    _synchronize(device)
    t2 = time.perf_counter()

    posterior = _postprocess(model, q_draws[warm:], var_names)
    sample_stats = {k: _stat_array([s[k] for s in stat_draws[warm:]]) for k in stat_draws[0]}
    warmup_groups = {}
    if warm:
        warmup_groups = {
            "warmup_posterior": _postprocess(model, q_draws[:warm], var_names),
            "warmup_sample_stats": {k: _stat_array([s[k] for s in stat_draws[:warm]])
                                    for k in stat_draws[0]},
        }
    extra = {}
    for i, (m, c0) in enumerate(zip(stepper.methods, counts0)):
        prefix = f"{m.name}{i}_" if len(stepper.methods) > 1 else ""
        for k, v in c0.items():
            extra[prefix + k] = getattr(m, k) - v
    attrs = {
        **extra,
        "stepper": repr(stepper),
        "step_host_ms": {repr(m): 1e3 * s / (tune + draws)
                         for m, s in zip(stepper.methods, stepper.host_seconds)},
        "n_logp": density.calls["logp"] - calls0["logp"],
        "n_logp_grad": density.calls["logp_grad"] - calls0["logp_grad"],
        "sampling_time": t2 - t1 if draws else 0.0,
        "tuning_time": t1 - t0,
        "device": str(device),
        "inference_library": "pymc_tpu_torch",
    }
    idata = to_inference_data(
        model, posterior=posterior, sample_stats=sample_stats, warmup_groups=warmup_groups,
        attrs=attrs, include_log_likelihood=bool((idata_kwargs or {}).get("log_likelihood")),
        device=device,
    )
    _log.info(f"Compound sampling of {draws} draws x {chains} chains took {t2 - t1:.2f}s")
    if compute_convergence_checks:
        log_warnings(run_convergence_checks(idata, model))
    if not return_inferencedata:
        return multitrace_from_idata(idata)
    return idata
