"""Variational approximation families.

Counterpart of `pymc_tpu/variational/approximations.py` (reference
pymc/variational/approximations.py: MeanFieldGroup:41 (mu, rho -> softplus
sigma), FullRankGroup:118 (packed L), EmpiricalGroup:191 particle
histogram) and opvi.py:1237 (the sampling machinery). Every family is a
dict of tensors over the model's flat unconstrained space, on one device.

Randomness is an input: `noise(params, n, generator)` draws what
`sample_q(params, noise)` maps to n points of q: (n, D) standard normals
for the Gaussian families (a Blocked family's columns go to its groups),
(n,) particle indices for Empirical. So a test can feed the JAX package's
normals and ask for the same points.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..backends.arviz import _var_dims
from ..blocking import ravel_point, unravel_vector
from ..config import floatX, resolve_device
from ..distributions.dist_math import softplus

__all__ = ["Approximation", "MeanField", "FullRank", "Empirical", "Blocked", "VIState"]

_LOG_2PI = 1.8378770664093453


class VIState(NamedTuple):
    """Fitted-state snapshot (reference opvi.py:122 VIState): per-variable
    mean/std DataVars in the CONSTRAINED space (std is None for families
    without a density, e.g. Empirical)."""

    mean: dict
    std: dict | None


def _softplus_inv(x):
    return float(np.log(np.expm1(x)))


class Approximation:
    """Base: a fitted posterior approximation over the flat space."""

    include_transformed = False

    def __init__(self, model, info, params):
        self.model = model
        self.info = info
        self.params = params
        self.hist = np.asarray([])

    # subclass API ---------------------------------------------------------
    @classmethod
    def init_params(cls, D, start=None, start_sigma=None, device=None, dtype=None):
        raise NotImplementedError

    @staticmethod
    def noise(params, n, generator):
        """The draws behind n points of q: (n, D) standard normals."""
        mu = params["mu"]
        return torch.randn((n, mu.shape[-1]), generator=generator, dtype=mu.dtype,
                           device=mu.device)

    @staticmethod
    def sample_q(params, noise):
        """(n, D) points of q from the draws `noise`."""
        raise NotImplementedError

    @staticmethod
    def entropy(params):
        raise NotImplementedError

    @staticmethod
    def logq(params, z):
        raise NotImplementedError

    # common ----------------------------------------------------------------
    @property
    def ndim(self):
        return self.info.total_size

    @property
    def device(self):
        return _first_leaf(self.params).device

    @property
    def dtype(self):
        return _first_leaf(self.params).dtype

    def _generator(self, random_seed):
        gen = torch.Generator(device=self.device)
        if random_seed is None:
            random_seed = int(np.random.default_rng().integers(2**30))
        return gen.manual_seed(int(random_seed))

    def mean_dict(self):
        return unravel_vector(self._mean_flat(), self.info)

    def sample(self, draws=1000, random_seed=None, return_inferencedata=True, model=None,
               **kwargs):
        """Draws from the approximation as InferenceData with one chain
        (reference Approximation.sample), postprocessed on the parameters'
        device against `model` (default: the active model, else the
        approximation's)."""
        from ..backends.arviz import to_inference_data
        from ..model.core import _MODEL_CONTEXT

        target = model or (_MODEL_CONTEXT.stack[-1] if _MODEL_CONTEXT.stack else self.model)
        gen = self._generator(random_seed)
        z = self.sample_q(self.params, self.noise(self.params, draws, gen))
        out = target.postprocess_fn(device=self.device, dtype=self.dtype)(z)
        posterior = {k: v.cpu().numpy()[None] for k, v in out.items()}
        if not return_inferencedata:
            return posterior
        return to_inference_data(target, posterior=posterior)

    def sample_dict_fn(self, draws=1):
        """fn(generator) -> {value_name: (draws, *shape)} draws of q."""

        def fn(generator):
            z = self.sample_q(self.params, self.noise(self.params, draws, generator))
            return unravel_vector(z, self.info)

        return fn

    # -- expression sampling (reference opvi.py Approximation.sample_node) ---
    def sample_node(self, node, size=None, deterministic=False, more_replacements=None,
                    random_seed=None):
        """Evaluate a model expression under the approximation: the free RVs
        `node` reaches are replaced by draws from q, or by the mean with
        `deterministic`. With size=k the result gains a leading (k,) axis;
        without it one draw comes back at the expression's own shape.
        `more_replacements` maps graph Nodes to values evaluated in their
        place. An unseeded call uses fresh randomness."""
        from ..graph import Node, as_node, evaluate

        node = node if isinstance(node, Node) else as_node(node)
        placed = self.model.placed_constants(self.device, self.dtype)
        for k, v in (more_replacements or {}).items():
            v = torch.as_tensor(np.asarray(v), device=self.device)
            placed[id(k)] = v.to(self.dtype) if v.is_floating_point() else v

        def eval_at(z):
            memo = dict(placed)
            env = self.model.constrain(unravel_vector(z, self.info), memo)
            return evaluate(node, env, memo)

        if deterministic:
            out = eval_at(self._mean_flat())
            if size is not None:
                out = out.expand((int(size),) + tuple(out.shape))
            return out
        n = 1 if size is None else int(size)
        z = self.sample_q(self.params, self.noise(self.params, n, self._generator(random_seed)))
        out = torch.func.vmap(eval_at)(z)
        return out[0] if size is None else out

    # -- named fitted-state views (reference opvi.py:1184-1229) -------------
    def _std_flat(self):
        raise NotImplementedError(f"{type(self).__name__} approximation has no parametric std")

    def _dims_coords(self, name, shape):
        coords_map = self.model.coords
        dims = list(_var_dims(self.model, name, shape))
        if dims and all(d.startswith(f"{name}_dim_") for d in dims):
            # a transformed value name borrows its RV's dims where the value
            # has the RV's shape (elementwise transforms)
            for rv in self.model.free_RVs:
                if rv.value_name == name and rv.name != name:
                    if tuple(rv.value_shape) == tuple(rv.shape):
                        dims = [
                            d.replace(rv.name, name) if d.startswith(f"{rv.name}_dim_") else d
                            for d in _var_dims(self.model, rv.name, shape)
                        ]
                    break
        coords = {d: list(coords_map[d]) for d in dims if coords_map.get(d) is not None}
        return tuple(dims), coords

    def _named_data(self, flat):
        """flat value-space vector -> {value_name: DataVar} (reference
        mean_data/std_data: keyed by the TRANSFORMED names)."""
        from ..backends.inference_data import DataVar

        out = {}
        for name, v in unravel_vector(flat, self.info).items():
            arr = v.detach().cpu().numpy()
            dims, coords = self._dims_coords(name, arr.shape)
            out[name] = DataVar(name, arr, dims=dims, coords=coords)
        return out

    @property
    def mean_data(self):
        """Per-variable means in the VALUE space (reference opvi.py:1184)."""
        return self._named_data(self._mean_flat())

    @property
    def std_data(self):
        """Per-variable stds in the VALUE space (reference opvi.py:1193);
        NotImplementedError for families without a density."""
        return self._named_data(self._std_flat())

    @property
    def state(self):
        """VIState(mean, std) in the CONSTRAINED space: the mean and std
        vectors mapped through the value transforms (for a monotone
        transform the mean entry is the posterior median)."""
        from ..backends.inference_data import DataVar

        placed = self.model.placed_constants(self.device, self.dtype)

        def constrained(flat):
            env = self.model.constrain(unravel_vector(flat, self.info), dict(placed))
            out = {}
            for rv in self.model.free_RVs:
                arr = env[rv.name].detach().cpu().numpy()
                dims, coords = self._dims_coords(rv.name, arr.shape)
                out[rv.name] = DataVar(rv.name, arr, dims=dims, coords=coords)
            return out

        mean = constrained(self._mean_flat())
        try:
            std = constrained(self._std_flat())
        except NotImplementedError:
            std = None
        if self.include_transformed:
            for k, v in self._named_data(self._mean_flat()).items():
                mean.setdefault(k, v)
            if std is not None:
                for k, v in self._named_data(self._std_flat()).items():
                    std.setdefault(k, v)
        return VIState(mean=mean, std=std)


def _first_leaf(params):
    while isinstance(params, dict):
        params = params[sorted(params)[0]]
    return params


def _vector(x, D, device, dtype):
    return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x).to(
        device=device, dtype=dtype).expand(D).clone()


class MeanField(Approximation):
    """A diagonal Gaussian over the unconstrained space (reference
    MeanFieldGroup:41): mu and rho, sigma = softplus(rho)."""

    name = "mean_field"

    @classmethod
    def init_params(cls, D, start=None, start_sigma=None, device=None, dtype=None):
        device = resolve_device(device)
        dtype = dtype or floatX(device)
        mu = torch.zeros((D,), dtype=dtype, device=device) if start is None else _vector(
            start, D, device, dtype)
        sigma0 = 0.1 if start_sigma is None else start_sigma
        if np.isscalar(sigma0):
            rho = torch.full((D,), _softplus_inv(sigma0), dtype=dtype, device=device)
        else:
            s = _vector(sigma0, D, device, dtype)
            rho = torch.log(torch.expm1(s))
        return {"mu": mu, "rho": rho}

    @staticmethod
    def sample_q(params, noise):
        return params["mu"] + softplus(params["rho"]) * noise

    @staticmethod
    def entropy(params):
        sigma = softplus(params["rho"])
        return torch.sum(torch.log(sigma)) + 0.5 * sigma.shape[0] * (1.0 + _LOG_2PI)

    @staticmethod
    def logq(params, z):
        sigma = softplus(params["rho"])
        return torch.sum(
            -0.5 * ((z - params["mu"]) / sigma) ** 2 - torch.log(sigma) - 0.5 * _LOG_2PI, dim=-1
        )

    @staticmethod
    def mean_of(params):
        return params["mu"]

    def _mean_flat(self):
        return self.params["mu"]

    def _std_flat(self):
        return softplus(self.params["rho"])

    @property
    def mean(self):
        return unravel_vector(self.params["mu"], self.info)

    @property
    def std(self):
        return unravel_vector(softplus(self.params["rho"]), self.info)


class FullRank(Approximation):
    """A full-covariance Gaussian: L packed lower-triangular (row-major),
    its diagonal through softplus (reference FullRankGroup:118)."""

    name = "full_rank"

    @classmethod
    def init_params(cls, D, start=None, start_sigma=None, device=None, dtype=None):
        device = resolve_device(device)
        dtype = dtype or floatX(device)
        mu = torch.zeros((D,), dtype=dtype, device=device) if start is None else _vector(
            start, D, device, dtype)
        packed = torch.zeros((D * (D + 1) // 2,), dtype=dtype, device=device)
        diag_idx = torch.as_tensor(np.cumsum(np.arange(1, D + 1)) - 1, device=device)
        packed[diag_idx] = _softplus_inv(0.1)
        return {"mu": mu, "L_packed": packed}

    @staticmethod
    def _chol(params):
        mu = params["mu"]
        D = mu.shape[0]
        rows, cols = torch.tril_indices(D, D, device=mu.device)
        L = mu.new_zeros((D, D)).index_put((rows, cols), params["L_packed"])
        eye = torch.eye(D, dtype=mu.dtype, device=mu.device)
        diag = torch.diagonal(L)
        return L - diag * eye + eye * softplus(diag)

    @staticmethod
    def sample_q(params, noise):
        return params["mu"] + noise @ FullRank._chol(params).T

    @staticmethod
    def entropy(params):
        L = FullRank._chol(params)
        return torch.sum(torch.log(torch.diagonal(L))) + 0.5 * L.shape[0] * (1.0 + _LOG_2PI)

    @staticmethod
    def logq(params, z):
        L = FullRank._chol(params)
        w = torch.linalg.solve_triangular(L, (z - params["mu"]).mT, upper=False).mT
        return (-0.5 * torch.sum(w**2, dim=-1) - torch.sum(torch.log(torch.diagonal(L)))
                - 0.5 * L.shape[0] * _LOG_2PI)

    @staticmethod
    def mean_of(params):
        return params["mu"]

    def _mean_flat(self):
        return self.params["mu"]

    def _std_flat(self):
        L = self._chol(self.params)
        return torch.sqrt(torch.sum(L * L, dim=1))

    @property
    def mean(self):
        return unravel_vector(self.params["mu"], self.info)

    @property
    def cov(self):
        L = self._chol(self.params)
        return L @ L.T


class Empirical(Approximation):
    """A particle histogram (reference EmpiricalGroup:191; the SVGD family).

    `Empirical(trace)` builds it from posterior draws (reference
    approximations.py:368), in the unconstrained space, so `.sample()`
    resamples the trace."""

    name = "empirical"

    def __init__(self, trace=None, info=None, params=None, model=None, size=None,
                 random_seed=None, device=None):
        if info is not None and params is not None:
            # the internal path (SVGD, ASVGD): positional (model, info, params)
            super().__init__(trace, info, params)
            return
        from ..model.core import modelcontext

        model = modelcontext(model)
        device = resolve_device(device)
        info_ = model.raveled_info()
        post = trace.posterior
        arrs = {rv.name: np.asarray(post[rv.name].values) for rv in model.free_RVs}
        first = next(iter(arrs.values()))
        n = first.shape[0] * first.shape[1]
        point = {k: torch.as_tensor(a.reshape((n,) + a.shape[2:]), dtype=torch.float64)
                 for k, a in arrs.items()}
        particles = ravel_point(model.unconstrain(point), info_)
        if size is not None and size < n:
            gen = torch.Generator().manual_seed(0 if random_seed is None else int(random_seed))
            particles = particles[torch.randperm(n, generator=gen)[:size]]
        super().__init__(model, info_, {"particles": particles.to(device, floatX(device))})

    @classmethod
    def init_params(cls, D, start=None, start_sigma=None, n_particles=100, noise=None,
                    jitter=1.0, device=None, dtype=None):
        """start + jitter * noise, noise (n_particles, D) standard normals."""
        device = resolve_device(device)
        dtype = dtype or floatX(device)
        start = torch.zeros((D,), dtype=dtype, device=device) if start is None else _vector(
            start, D, device, dtype)
        return {"particles": start + jitter * noise.to(device=device, dtype=dtype)}

    @staticmethod
    def noise(params, n, generator):
        """(n,) particle indices, uniform."""
        P = params["particles"].shape[0]
        return torch.randint(P, (n,), generator=generator, device=params["particles"].device)

    @staticmethod
    def sample_q(params, noise):
        return params["particles"][noise]

    @staticmethod
    def entropy(params):
        return params["particles"].new_zeros(())

    @staticmethod
    def logq(params, z):
        raise NotImplementedError("Empirical approximation has no density")

    @staticmethod
    def mean_of(params):
        return torch.mean(params["particles"], dim=0)

    def _mean_flat(self):
        return torch.mean(self.params["particles"], dim=0)

    @property
    def mean(self):
        return unravel_vector(self._mean_flat(), self.info)


class Blocked(Approximation):
    """One family per subset of the latent variables, each over its slice
    of the flat space (reference opvi.py:582 Group + :1237 Approximation
    over several groups). `Blocked.make(families, indices, D)` builds the
    class; its params are {"g0": <family 0's>, "g1": ...}, so one
    optimizer updates every group in the one ELBO. Its noise is (n, D)
    standard normals; group j takes the columns of its indices."""

    name = "blocked"
    _families: tuple = ()
    _indices: tuple = ()
    _D: int = 0

    @classmethod
    def make(cls, families, indices, D):
        idx = tuple(np.asarray(i, dtype=np.int64) for i in indices)
        cover = np.concatenate(idx) if idx else np.zeros(0, np.int64)
        if len(np.unique(cover)) != cover.size:
            raise ValueError("groups overlap: each latent belongs to one group")
        if cover.size != D:
            raise ValueError(
                f"groups cover {cover.size} of {D} latent dimensions; add a Group(None) rest "
                "group"
            )
        return type("Blocked", (cls,), {"_families": tuple(families), "_indices": idx,
                                        "_D": int(D)})

    @classmethod
    def init_params(cls, D, start=None, start_sigma=None, group_kwargs=None, device=None,
                    dtype=None):
        group_kwargs = group_kwargs or [{}] * len(cls._families)
        params = {}
        for j, (fam, idx, kw) in enumerate(zip(cls._families, cls._indices, group_kwargs)):
            s = None if start is None else torch.as_tensor(np.asarray(start))[idx]
            params[f"g{j}"] = fam.init_params(len(idx), start=s, device=device, dtype=dtype,
                                              **kw)
        return params

    @classmethod
    def _index(cls, j, like):
        return torch.as_tensor(cls._indices[j], device=like.device)

    @classmethod
    def noise(cls, params, n, generator):
        mu = _first_leaf(params)
        return torch.randn((n, cls._D), generator=generator, dtype=mu.dtype, device=mu.device)

    @classmethod
    def sample_q(cls, params, noise):
        z = noise.new_zeros((noise.shape[0], cls._D))
        for j, fam in enumerate(cls._families):
            idx = cls._index(j, noise)
            z = z.index_copy(1, idx, fam.sample_q(params[f"g{j}"], noise[:, idx]))
        return z

    @classmethod
    def entropy(cls, params):
        return sum(fam.entropy(params[f"g{j}"]) for j, fam in enumerate(cls._families))

    @classmethod
    def logq(cls, params, z):
        return sum(
            fam.logq(params[f"g{j}"], z[..., cls._index(j, z)])
            for j, fam in enumerate(cls._families)
        )

    def _mean_flat(self):
        mu = _first_leaf(self.params)
        out = mu.new_zeros((self._D,))
        for j, fam in enumerate(self._families):
            out = out.index_copy(0, self._index(j, mu), fam.mean_of(self.params[f"g{j}"]))
        return out

    @property
    def mean(self):
        return unravel_vector(self._mean_flat(), self.info)

    def group_of(self, j):
        """The j-th sub-approximation as its own family instance, sharing
        this one's fitted parameters."""
        sub = object.__new__(self._families[j])
        sub.model, sub.info, sub.hist = self.model, None, np.asarray([])
        sub.params = self.params[f"g{j}"]
        return sub

