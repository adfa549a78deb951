"""Simulator distribution for likelihood-free (ABC) inference.

Counterpart of `pymc_tpu/distributions/simulator.py` (reference
pymc/distributions/simulator.py:63, KullbackLeibler :301). The
pseudo-likelihood of the observed data is a kernel of the distance between
the summary statistics of the data and of a fresh simulation:
-d^2 / (2 epsilon^2) - log epsilon - log(2 pi) / 2 (gaussian),
-|d| / epsilon - log(2 epsilon) (laplace), a 1-nearest-neighbour estimate
of the Kullback-Leibler divergence over epsilon, or a callable
distance(epsilon, s_obs, s_sim).

The user's function is called as `fn(rng, *params)`, where `rng` is a
`torch.Generator` on the model's device (the JAX package passes a key).
`sample_smc` puts its generator into the evaluation environment at
`SIMULATOR_KEY` and evaluates the particles' densities under
`torch.func.vmap(randomness="different")`, so every particle in every
sweep gets a simulation of its own. Without one in the environment the
logp simulates from a generator seeded 0, as the JAX package uses
PRNGKey(0).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .distribution import Distribution, as_param

__all__ = ["Simulator", "SIMULATOR_KEY"]

SIMULATOR_KEY = ("__simulator_key__",)


def _gaussian_kernel(eps, d2):
    return -0.5 * d2 / eps**2 - math.log(eps) - 0.5 * math.log(2.0 * math.pi)


def _laplace_kernel(eps, d):
    return -torch.abs(d) / eps - math.log(2.0 * eps)


def _median(x):
    """numpy's median of every entry (the mean of the two middle entries
    of an even count), as a (1,) tensor."""
    s = torch.sort(x.reshape(-1)).values
    n = s.shape[0]
    return (0.5 * (s[(n - 1) // 2] + s[n // 2])).reshape(1)


_SUM_STATS = {
    "identity": lambda x: x.reshape(-1),
    "mean": lambda x: torch.mean(x).reshape(1),
    "median": _median,
    "sort": lambda x: torch.sort(x.reshape(-1)).values,
}


def _kullback_leibler(eps, s_obs, s_sim):
    """1-NN estimate of KL(obs || sim) over epsilon (reference
    KullbackLeibler :301)."""
    obs, sim = s_obs.reshape(-1), s_sim.reshape(-1)
    nu_d = torch.min(torch.abs(obs[:, None] - sim[None, :]), dim=1).values
    obs_d = torch.sort(torch.abs(obs[:, None] - obs[None, :]), dim=1).values[:, 1]
    n, m = obs.shape[0], sim.shape[0]
    ratio = torch.clamp(nu_d / torch.clamp(obs_d, min=1e-12), min=1e-12)
    kl = torch.mean(torch.log(ratio)) + math.log(m / (n - 1.0))
    return -kl / eps


class Simulator(Distribution):
    """pm.Simulator(name, fn, *params, distance=, sum_stat=, epsilon=,
    observed=data): fn(rng, *params) returns a simulated data set."""

    param_names = ()

    def __dist_init__(self, fn, *params, distance="gaussian", sum_stat="identity",
                      epsilon=1.0, ndim_supp=None, ndims_params=None):
        if isinstance(distance, str) and distance not in (
                "gaussian", "laplace", "kullback_leibler"):
            raise ValueError(f"Unknown distance {distance}")
        self.fn = fn
        self.sim_params = tuple(as_param(p) for p in params)
        self.param_names = tuple(f"_p{i}" for i in range(len(self.sim_params)))
        self.distance = distance
        self.sum_stat = sum_stat if callable(sum_stat) else _SUM_STATS[sum_stat]
        self.epsilon = float(epsilon)

    def param_values(self):
        return list(self.sim_params)

    def _resolve_shapes(self, shape):
        """The shape requested (the observed data's), or that of one
        simulation at zero parameters on the CPU."""
        if shape is None:
            zeros = [torch.zeros(p.shape, dtype=torch.float64) for p in self.sim_params]
            shape = tuple(torch.as_tensor(self.fn(torch.Generator().manual_seed(0),
                                                  *zeros)).shape)
        self.batch_shape = tuple(shape)
        self.event_shape = ()
        self.shape = self.batch_shape

    def _simulate(self, generator, params, like):
        return torch.as_tensor(self.fn(generator, *params)).to(like)

    def logp(self, value, env=None, memo=None):
        """The kernel of the distance between the summary statistics of
        `value` and of one simulation: a scalar."""
        memo = {} if memo is None else memo
        params = self.resolve_params(env, memo)
        value = self._cast_value(value, params)
        generator = (env or {}).get(SIMULATOR_KEY)
        if generator is None:
            generator = torch.Generator(device=value.device).manual_seed(0)
        s_obs = self.sum_stat(value)
        s_sim = self.sum_stat(self._simulate(generator, params, value))
        eps = self.epsilon
        if callable(self.distance):
            return torch.as_tensor(self.distance(eps, s_obs, s_sim))
        if self.distance == "gaussian":
            return _gaussian_kernel(eps, torch.sum((s_obs - s_sim) ** 2))
        if self.distance == "laplace":
            return _laplace_kernel(eps, torch.sum(torch.abs(s_obs - s_sim)))
        return _kullback_leibler(eps, s_obs, s_sim)

    def sample(self, generator, sample_shape=(), env=None, memo=None):
        """Simulations at the parameters: one for each entry of
        `sample_shape`, each from the generator's own stream."""
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        params = self.resolve_params(env, memo)
        like = next((p for p in params if p.is_floating_point()),
                    torch.empty((), dtype=torch.float64))
        if not sample_shape:
            return self._simulate(generator, params, like)
        n = int(np.prod(sample_shape))
        draws = torch.func.vmap(lambda _: self._simulate(generator, params, like),
                                randomness="different")(torch.empty(n, device=like.device))
        return draws.reshape(tuple(sample_shape) + tuple(draws.shape[1:]))

    def support_point(self, env=None, memo=None):
        """The mean of 10 simulations at the parameters, from a generator
        seeded 42 (reference simulator.py:258 simulator_support_point)."""
        params = self.resolve_params(env, memo)
        device = next((p.device for p in params), torch.device("cpu"))
        draws = self.sample(torch.Generator(device=device).manual_seed(42), (10,), env, memo)
        return torch.mean(draws, dim=0)
