"""Utilities.

Counterpart of `pymc_tpu/util.py` (reference pymc/util.py). The name
helpers are the JAX package's; its RNG helpers, which map numpy Generators
onto JAX keys, map them here onto `torch.Generator`s: where the JAX package
hands a key, the port hands a generator. A seed gives a generator on the
requested device (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from .config import resolve_device

__all__ = [
    "get_transformed_name",
    "is_transformed_name",
    "get_untransformed_name",
    "get_default_varnames",
    "get_random_generator",
    "RandomGeneratorState",
    "random_generator_to_key",
    "hashable",
    "makeiter",
    "get_var_name",
    "chains_and_samples",
    "drop_warning_stat",
    "check_dist_not_registered",
    "get_transformed",
]


def get_transformed_name(name, transform):
    """Reference util.py:138: '<name>_<transform>__'."""
    return f"{name}_{transform.name}__"


def is_transformed_name(name):
    return name.endswith("__") and "_" in name[:-2]


def get_untransformed_name(name):
    if not is_transformed_name(name):
        raise ValueError(f"{name} does not appear to be a transformed name")
    return "_".join(name[:-2].split("_")[:-1])


def get_default_varnames(var_iterator, include_transformed):
    if include_transformed:
        return list(var_iterator)
    return [v for v in var_iterator if not is_transformed_name(str(v))]


def _seeded(seed, device=None):
    gen = torch.Generator(device=resolve_device(device))
    if seed is None:
        gen.seed()
    else:
        gen.manual_seed(int(seed))
    return gen


class RandomGeneratorState:
    """Serializable RNG state (reference util.py:522-560): a numpy
    bit-generator's state, or a torch.Generator's state and device."""

    def __init__(self, state):
        self.state = state

    @classmethod
    def from_generator(cls, rng):
        if isinstance(rng, np.random.Generator):
            return cls(("numpy", rng.bit_generator.state))
        return cls(("torch", rng.get_state().tolist(), str(rng.device)))

    def restore(self):
        kind, payload, *device = self.state
        if kind == "numpy":
            rng = np.random.default_rng()
            rng.bit_generator.state = payload
            return rng
        gen = torch.Generator(device=resolve_device(device[0]))
        gen.set_state(torch.tensor(payload, dtype=torch.uint8))
        return gen


def get_random_generator(seed=None):
    """numpy Generator resolution (reference util.py:522)."""
    if isinstance(seed, np.random.Generator):
        return seed
    return np.random.default_rng(seed)


def random_generator_to_key(rng, device=None):
    """A torch.Generator (returned as it is), a numpy Generator (a seed
    drawn from it) or a seed (None: 0) as a torch.Generator on `device`
    (the JAX package's key)."""
    if isinstance(rng, torch.Generator):
        return rng
    if isinstance(rng, np.random.Generator):
        return _seeded(int(rng.integers(2**31)), device)
    return _seeded(0 if rng is None else int(rng), device)


def hashable(a):
    try:
        hash(a)
        return a
    except TypeError:
        return str(a)


def makeiter(a):
    """Wrap non-list values in a list (reference util.py:makeiter)."""
    return a if isinstance(a, (list, tuple)) else [a]


def get_var_name(var):
    """Name of a model variable or a string (reference util.py)."""
    return getattr(var, "name", str(var))


def chains_and_samples(data):
    """(n_chains, n_samples) from an InferenceData posterior
    (reference util.py:chains_and_samples)."""
    post = data.posterior if hasattr(data, "posterior") else data
    for v in post.values():
        return int(v.values.shape[0]), int(v.values.shape[1])
    raise ValueError("posterior group has no variables")


def drop_warning_stat(idata):
    """Remove the sampler 'warning' stat where present (reference util.py:
    drop_warning_stat; the port's sample_stats hold no such stat)."""
    ss = getattr(idata, "sample_stats", None)
    if ss is not None and "warning" in ss:
        ss._vars.pop("warning", None)
    return idata


def check_dist_not_registered(dist, model=None):
    """Raise if a model's random variable is passed where an unnamed
    `.dist()` object belongs (reference util.py:check_dist_not_registered)."""
    from .graph import FreeRV, ObservedRV

    if isinstance(dist, (FreeRV, ObservedRV)):
        raise ValueError(
            f"The distribution {dist} belongs to a model. Pass an unnamed "
            "distribution created with `.dist()` instead."
        )


def get_transformed(rv):
    """The value-space name of a free RV (reference util.py:get_transformed)."""
    return getattr(rv, "value_name", getattr(rv, "name", rv))
