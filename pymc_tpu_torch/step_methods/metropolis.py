"""Metropolis-family step methods.

Counterpart of `pymc_tpu/step_methods/metropolis.py` (the proposals :39-95,
_tune_scaling :124, Metropolis :135, BinaryMetropolis :228,
BinaryGibbsMetropolis :277, CategoricalGibbsMetropolis :332, DEMetropolis
:413, DEMetropolisZ :512; reference pymc/step_methods/metropolis.py). Every
step is batched over the chains, which are the leading axis; DEMetropolis
reads the whole chain batch as its population.

Each step's density evaluations are batched calls of the model's
FlatDensity (compound.py): Metropolis-type steps evaluate the current and
the proposed points of every chain in one (2C, D) call, so the acceptance
ratio is taken against the current point's logp, whatever other steps of a
compound moved since (PyMC's semantics; the JAX steps keep the logp of
their own last draw in their state, which is stale in a compound,
ROADMAP.md §3). So no step keeps a logp in its state.

The Gibbs steps visit their block's elements in turn, one batched density
call per element (BinaryGibbsMetropolis: the (2C, D) points with the
element at 0 and at 1; CategoricalGibbsMetropolis: (C K, D), one point per
category), so their cost per draw grows with the block's size D.

The draws each step asks its source for, in order:
  Metropolis           proposal (C, D), uniform (C,)
  BinaryMetropolis     uniform (C, D) (the flips), uniform (C,)
  BinaryGibbs          uniform (C,) for each element
  CategoricalGibbs     gumbel (C, K) for each element
  DEMetropolis         randint (C,) below C-1, randint (C,) below C-2,
                       normal (C, D), uniform (C,)
  DEMetropolisZ        normal (C, D), randint (C,) twice, uniform (C,)
where a proposal is normal, uniform, cauchy or laplace (C, D), or poisson.
"""

from __future__ import annotations

import numpy as np
import torch

from .compound import BlockedStep, Competence, _ravel_block, _unravel_block, flat_point

__all__ = [
    "Metropolis",
    "BinaryMetropolis",
    "BinaryGibbsMetropolis",
    "CategoricalGibbsMetropolis",
    "DEMetropolis",
    "DEMetropolisZ",
    "NormalProposal",
    "UniformProposal",
    "CauchyProposal",
    "LaplaceProposal",
    "PoissonProposal",
    "MultivariateNormalProposal",
]


class Proposal:
    """A proposal distribution with scale `s` (a stddev vector, a rate or a
    covariance): `proposal(draws, shape)` draws perturbations of `shape`
    from the draw source `draws`."""

    def __init__(self, s=1.0):
        self.s = torch.as_tensor(np.asarray(s, dtype=np.float64))
        self._placed = {}

    def scale(self, like):
        """`s` on `like`'s device and in its float type, placed once."""
        key = (like.device, like.dtype)
        if key not in self._placed:
            self._placed[key] = self.s.to(device=like.device, dtype=like.dtype)
        return self._placed[key]

    def __call__(self, draws, shape):
        raise NotImplementedError


class NormalProposal(Proposal):
    def __call__(self, draws, shape):
        z = draws.normal(shape)
        return self.scale(z) * z


class UniformProposal(Proposal):
    def __call__(self, draws, shape):
        u = draws.uniform(shape)
        s = self.scale(u)
        return u * (s - -s) + -s


class CauchyProposal(Proposal):
    def __call__(self, draws, shape):
        z = draws.cauchy(shape)
        return self.scale(z) * z


class LaplaceProposal(Proposal):
    def __call__(self, draws, shape):
        z = draws.laplace(shape)
        return self.scale(z) * z


class PoissonProposal(Proposal):
    """poisson(s) - s: integer-valued, roughly symmetric (reference
    metropolis.py:110)."""

    def __init__(self, s=1.0):
        super().__init__(s)
        self._lam = {}

    def __call__(self, draws, shape):
        lam = self._lam.get(tuple(shape))
        if lam is None:
            lam = self._lam[tuple(shape)] = torch.broadcast_to(
                self.s.to(dtype=draws.dtype, device=draws.device), shape).contiguous()
        return draws.poisson(lam) - lam


class MultivariateNormalProposal(Proposal):
    """`s` is a full covariance (reference metropolis.py:115)."""

    def __init__(self, s):
        super().__init__(s)
        self._chol = torch.linalg.cholesky(self.s)

    def __call__(self, draws, shape):
        z = draws.normal(tuple(shape[:-1]) + (self._chol.shape[-1],))
        chol = self._chol.to(device=z.device, dtype=z.dtype)
        return torch.einsum("ij,...j->...i", chol, z)


def _tune_scaling(scaling, acc_rate):
    """The reference Metropolis.tune ladder (metropolis.py:212-240)."""
    scaling = torch.where(acc_rate < 0.001, scaling * 0.1, scaling)
    scaling = torch.where((acc_rate >= 0.001) & (acc_rate < 0.05), scaling * 0.5, scaling)
    scaling = torch.where((acc_rate >= 0.05) & (acc_rate < 0.2), scaling * 0.9, scaling)
    scaling = torch.where((acc_rate > 0.5) & (acc_rate <= 0.75), scaling * 1.1, scaling)
    scaling = torch.where((acc_rate > 0.75) & (acc_rate <= 0.95), scaling * 2.0, scaling)
    return torch.where(acc_rate > 0.95, scaling * 10.0, scaling)


def _select(accept, new, old):
    """Per chain: `new` where accepted, else `old` (value dicts)."""
    return {
        k: torch.where(accept.reshape((-1,) + (1,) * (new[k].ndim - 1)), new[k], old[k])
        if new[k] is not old[k] else old[k]
        for k in old
    }


def _current_and_proposed(density, point, proposed, info, dtype):
    """logp of the current and the proposed point of every chain, in one
    (2C, D) call."""
    both = torch.cat([flat_point(point, info, dtype), flat_point(proposed, info, dtype)])
    lp = density.logp(both)
    C = lp.shape[0] // 2
    return lp[:C], lp[C:]


def _acceptance_counts(state, accepted, flags, tune_enabled, key="scaling"):
    """The running acceptance rate, and `state[key]` tuned by the ladder
    on a tune-interval draw (after which the counts restart)."""
    accept_sum = state["accept_sum"] + accepted.to(state["accept_sum"].dtype)
    steps = state["steps"] + 1.0
    acc_rate = accept_sum / torch.clamp(steps, min=1.0)
    tuned = state[key]
    if flags["tune_now"] and tune_enabled:
        tuned = _tune_scaling(state[key], acc_rate)
        accept_sum = torch.zeros_like(accept_sum)
        steps = torch.zeros_like(steps)
    return acc_rate, tuned, accept_sum, steps


class Metropolis(BlockedStep):
    """Random-walk Metropolis with the scaling tuned every tune interval
    (reference metropolis.py:143); a discrete entry's perturbation is
    rounded (the reference's DiscreteMetropolis)."""

    name = "metropolis"
    stats_names = ("accept_rate", "scaling", "accepted")

    def __init__(self, vars=None, S=None, proposal_dist=None, scaling=1.0, tune=True,
                 tune_interval=100, model=None, **kwargs):
        super().__init__(vars, model)
        self.initial_scaling = float(scaling)
        self.tune = tune
        if proposal_dist is not None:
            self.proposal = (proposal_dist if isinstance(proposal_dist, Proposal)
                             else proposal_dist(S if S is not None else 1.0))
        else:
            self.proposal = NormalProposal(S if S is not None else 1.0)
        self._disc_mask = np.concatenate(
            [np.full(sz, d) for sz, d in zip(self.sizes, self.discrete)]
        )

    @classmethod
    def competence(cls, var, has_grad):
        return Competence.COMPATIBLE

    def init_state(self, point, chains, draws):
        density = self._density(point)
        zeros = torch.zeros((chains,), dtype=density.dtype, device=density.device)
        return {
            "scaling": torch.full_like(zeros, self.initial_scaling),
            "accept_sum": zeros,
            "steps": zeros,
        }

    def step(self, draws, point, state, flags):
        density = self._density(point)
        q = _ravel_block(point, self.names, density.dtype)
        eps = state["scaling"][:, None] * self.proposal(draws, q.shape)
        if self._disc_mask.any():
            eps = torch.where(self._on("disc", self._disc_mask, q), torch.round(eps), eps)
        proposed = _unravel_block(q + eps, point, self.names, self.shapes, self.sizes,
                                  self.discrete)
        lp, lp_new = _current_and_proposed(density, point, proposed, density.info,
                                           density.dtype)
        accept = torch.log(draws.uniform(lp.shape)) < lp_new - lp
        point = _select(accept, proposed, point)
        acc_rate, scaling, accept_sum, steps = _acceptance_counts(state, accept, flags,
                                                                  self.tune)
        new_state = {"scaling": scaling, "accept_sum": accept_sum, "steps": steps}
        return point, new_state, {"accept_rate": acc_rate, "scaling": scaling,
                                  "accepted": accept}


class BinaryMetropolis(BlockedStep):
    """Metropolis with bit flips for binary variables (reference
    metropolis.py:418): each bit flips with probability min(0.5,
    scaling / D)."""

    name = "binary_metropolis"
    stats_names = ("accepted",)

    def __init__(self, vars=None, scaling=1.0, tune=True, tune_interval=100, model=None,
                 **kwargs):
        super().__init__(vars, model)
        self.scaling = float(scaling)

    @classmethod
    def competence(cls, var, has_grad):
        from ..distributions.discrete import Bernoulli

        return Competence.COMPATIBLE if isinstance(var.dist, Bernoulli) else Competence.INCOMPATIBLE

    def init_state(self, point, chains, draws):
        return {}

    def step(self, draws, point, state, flags):
        density = self._density(point)
        q = _ravel_block(point, self.names, density.dtype)
        p_flip = min(0.5, self.scaling / max(self.D, 1))
        flips = draws.uniform(q.shape) < p_flip
        proposed = _unravel_block(torch.where(flips, 1.0 - q, q), point, self.names,
                                  self.shapes, self.sizes, [True] * len(self.names))
        lp, lp_new = _current_and_proposed(density, point, proposed, density.info,
                                           density.dtype)
        accept = torch.log(draws.uniform(lp.shape)) < lp_new - lp
        return _select(accept, proposed, point), state, {"accepted": accept}


class BinaryGibbsMetropolis(BlockedStep):
    """Gibbs over binary variables, element by element (reference
    metropolis.py:543): each element is drawn from its full conditional,
    one (2C, D) density call per element."""

    name = "binary_gibbs"
    stats_names = ()

    def __init__(self, vars=None, order="random", transit_p=0.8, model=None, **kwargs):
        super().__init__(vars, model)

    @classmethod
    def competence(cls, var, has_grad):
        from ..distributions.discrete import Bernoulli

        return Competence.IDEAL if isinstance(var.dist, Bernoulli) else Competence.INCOMPATIBLE

    def init_state(self, point, chains, draws):
        return {}

    def step(self, draws, point, state, flags):
        density = self._density(point)
        full = flat_point(point, density.info, density.dtype)
        C = full.shape[0]
        for col in self._cols:
            both = torch.cat([full, full])
            both[:C, col] = 0.0
            both[C:, col] = 1.0
            lp = density.logp(both)
            p1 = torch.sigmoid(lp[C:] - lp[:C])
            full = full.clone()
            full[:, col] = (draws.uniform((C,)) < p1).to(full.dtype)
        q = full.index_select(1, self._on("cols", self._cols, full))
        return _unravel_block(q, point, self.names, self.shapes, self.sizes,
                              [True] * len(self.names)), state, {}


class CategoricalGibbsMetropolis(BlockedStep):
    """Gibbs over categorical variables, element by element, from the full
    conditional (the reference's `proportional` proposal,
    metropolis.py:675): one (C K, D) density call per element, K the most
    categories of the block."""

    name = "categorical_gibbs"
    stats_names = ()

    def __init__(self, vars=None, proposal="proportional", order="random", model=None,
                 **kwargs):
        super().__init__(vars, model)
        from ..distributions.discrete import Categorical, DiscreteUniform
        from ..graph import evaluate

        ks = []
        for rv in self.rvs:
            if isinstance(rv.dist, Categorical):
                k, lo = int(rv.dist.n_categories), 0
            elif isinstance(rv.dist, DiscreteUniform):
                lo = int(evaluate(rv.dist.lower))
                k = int(evaluate(rv.dist.upper)) - lo + 1
            else:
                raise ValueError(
                    "CategoricalGibbsMetropolis requires Categorical or DiscreteUniform variables"
                )
            ks.extend([(k, lo)] * (int(np.prod(rv.value_shape)) if rv.value_shape else 1))
        self.K = max(k for k, _ in ks)
        self.offsets = np.array([lo for _, lo in ks], dtype=np.float64)
        self.n_cats = np.array([k for k, _ in ks])

    @classmethod
    def competence(cls, var, has_grad):
        from ..distributions.discrete import Categorical, DiscreteUniform

        if isinstance(var.dist, (Categorical, DiscreteUniform)):
            return Competence.IDEAL
        return Competence.INCOMPATIBLE

    def init_state(self, point, chains, draws):
        return {}

    def step(self, draws, point, state, flags):
        density = self._density(point)
        full = flat_point(point, density.info, density.dtype)
        C, D = full.shape
        K = self.K
        cats = self._on("cats", np.arange(K, dtype=np.float64), full)
        for i, col in enumerate(self._cols):
            values = cats + float(self.offsets[i])
            cand = full[:, None, :].expand(C, K, D).clone()
            cand[:, :, col] = values
            lps = density.logp(cand.reshape(C * K, D)).reshape(C, K)
            if self.n_cats[i] < K:
                lps = torch.where(cats < float(self.n_cats[i]), lps, -torch.inf)
            new = torch.argmax(lps + draws.gumbel((C, K)), dim=1)
            full = full.clone()
            full[:, col] = values[new]
        q = full.index_select(1, self._on("cols", self._cols, full))
        return _unravel_block(q, point, self.names, self.shapes, self.sizes,
                              [True] * len(self.names)), state, {}


class _DifferentialEvolution(BlockedStep):
    """The state, tuning and acceptance that DEMetropolis and DEMetropolisZ
    share."""

    stats_names = ("accepted", "accept_rate", "scaling")

    def __init__(self, vars, lamb, scaling, tune, model):
        super().__init__(vars, model)
        self.lamb = float(lamb) if lamb is not None else 2.38 / np.sqrt(2 * self.D)
        self.initial_scaling = float(scaling)
        self.tune_target = tune

    @classmethod
    def competence(cls, var, has_grad):
        return Competence.COMPATIBLE

    def init_state(self, point, chains, draws):
        density = self._density(point)
        zeros = torch.zeros((chains,), dtype=density.dtype, device=density.device)
        return {
            "scaling": torch.full_like(zeros, self.initial_scaling),
            "lamb": torch.full_like(zeros, self.lamb),
            "accept_sum": zeros,
            "steps": zeros,
        }

    def _finish(self, draws, point, state, flags, q_new):
        """Accept or reject q_new (C, D_block) against the current point;
        tune lamb or the scaling on a tune-interval draw."""
        density = self._density(point)
        proposed = _unravel_block(q_new, point, self.names, self.shapes, self.sizes,
                                  self.discrete)
        lp, lp_new = _current_and_proposed(density, point, proposed, density.info,
                                           density.dtype)
        accept = torch.log(draws.uniform(lp.shape)) < lp_new - lp
        key = "lamb" if self.tune_target == "lambda" else "scaling"
        acc_rate, tuned, accept_sum, steps = _acceptance_counts(state, accept, flags, True,
                                                                key=key)
        new_state = dict(state, accept_sum=accept_sum, steps=steps)
        new_state[key] = tuned
        stats = {"accepted": accept, "accept_rate": acc_rate, "scaling": new_state["scaling"]}
        return _select(accept, proposed, point), new_state, stats, accept


class DEMetropolis(_DifferentialEvolution):
    """Differential-evolution Metropolis (reference metropolis.py:864):
    each chain proposes along the difference of two other chains' points,
    lamb * (x_r1 - x_r2) + scaling * N(0, 1); the population is the chain
    batch."""

    name = "DEMetropolis"

    def __init__(self, vars=None, S=None, proposal_dist=None, lamb=None, scaling=0.001,
                 tune="scaling", tune_interval=100, model=None, **kwargs):
        super().__init__(vars, lamb, scaling, tune, model)

    def init_state(self, point, chains, draws):
        if chains < 3:
            raise ValueError("DEMetropolis requires at least 3 chains")
        return super().init_state(point, chains, draws)

    def step(self, draws, point, state, flags):
        Q = _ravel_block(point, self.names, state["scaling"].dtype)
        C = Q.shape[0]
        chain = self._on("chain", np.arange(C), Q)
        # two distinct other chains per chain
        r1 = draws.randint(C - 1, (C,))
        r1 = torch.where(r1 >= chain, r1 + 1, r1)
        r2 = draws.randint(C - 2, (C,))
        lo, hi = torch.minimum(chain, r1), torch.maximum(chain, r1)
        r2 = torch.where(r2 >= lo, r2 + 1, r2)
        r2 = torch.where(r2 >= hi, r2 + 1, r2)
        eps = state["scaling"][:, None] * draws.normal(Q.shape)
        Q_new = Q + state["lamb"][:, None] * (Q[r1] - Q[r2]) + eps
        point, state, stats, _ = self._finish(draws, point, state, flags, Q_new)
        return point, state, stats


class DEMetropolisZ(_DifferentialEvolution):
    """DE-MCMC-Z (reference metropolis.py:1030): each chain proposes along
    the difference of two points of its own history, kept in a (C,
    max_history, D) ring buffer on the device; lamb is tuned by default."""

    name = "DEMetropolisZ"

    def __init__(self, vars=None, S=None, proposal_dist=None, lamb=None, scaling=0.001,
                 tune="lambda", tune_interval=100, tune_drop_fraction=0.9, model=None,
                 max_history=5000, **kwargs):
        super().__init__(vars, lamb, scaling, tune, model)
        self.max_history = int(max_history)

    def init_state(self, point, chains, draws):
        state = super().init_state(point, chains, draws)
        zeros = state["steps"]
        state["history"] = zeros.new_zeros((chains, self.max_history, self.D))
        state["hist_len"] = torch.zeros((chains,), dtype=torch.int64, device=zeros.device)
        return state

    def step(self, draws, point, state, flags):
        q = _ravel_block(point, self.names, state["scaling"].dtype)
        C = q.shape[0]
        rows = self._on("chain", np.arange(C), q)
        eps = state["scaling"][:, None] * draws.normal(q.shape)
        hist_len, history = state["hist_len"], state["history"]
        hist_cap = torch.clamp(hist_len, min=1, max=self.max_history)
        i1 = draws.randint(hist_cap, (C,))
        i2 = draws.randint(hist_cap, (C,))
        diff = history[rows, i1] - history[rows, i2]
        have_hist = (hist_len >= 2)[:, None]
        q_new = q + torch.where(have_hist, state["lamb"][:, None] * diff + eps, eps)
        point, state, stats, accept = self._finish(draws, point, state, flags, q_new)
        history = history.clone()
        history[rows, hist_len % self.max_history] = torch.where(accept[:, None], q_new, q)
        state.update(history=history, hist_len=hist_len + 1)
        return point, state, stats
