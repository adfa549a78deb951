"""Analytic distribution means.

Counterpart of `pymc_tpu/distributions/moments.py` (reference
pymc/distributions/moments/means.py, `mean(rv)`): closed-form expressions
of the resolved parameters. A mathematically undefined mean raises
UndefinedMomentException (Cauchy, Flat, Categorical, ... — reference
means.py:133-226), a family with no registered form NotImplementedError.
The result broadcasts to the distribution's full (batch + event) shape. The
parameters are evaluated under `env` on `device` (default: the card), with
the distribution's constants placed there in the device's float type, as
`functions.draw` places them.
"""

from __future__ import annotations

import math

import torch

from ..config import floatX, resolve_device
from ..exceptions import UndefinedMomentException
from ..graph import FreeRV, ObservedRV, evaluate, place_constants
from .dist_math import i0e, i1e

__all__ = ["mean", "UndefinedMomentException"]


def _laguerre_half(x):
    """L_{1/2}(x) for x <= 0 through the scaled Bessels (stable for large
    |x|): e^{x/2} [(1 - x) I0(-x/2) - x I1(-x/2)], with e^{x/2} I_k(-x/2) =
    i_ke(-x/2). The Rice mean reads it."""
    z = -x / 2.0
    return (1.0 - x) * i0e(z) - x * i1e(z)


def _params(dist, env, memo, dtype):
    """{name: value}, integer parameters cast to `dtype`: a mean is a float."""
    return {n: v if v is None or v.is_floating_point() else v.to(dtype)
            for n, v in zip(dist.param_names, dist.resolve_params(env, memo))}


_MEANS = {
    "Normal": lambda p: p["mu"] + 0.0 * p["sigma"],
    "TruncatedNormal": None,
    "HalfNormal": lambda p: p["sigma"] * math.sqrt(2.0 / math.pi),
    "Uniform": lambda p: 0.5 * (p["lower"] + p["upper"]),
    "Beta": lambda p: p["alpha"] / (p["alpha"] + p["beta"]),
    "Exponential": lambda p: 1.0 / p["lam"],
    "Laplace": lambda p: p["mu"] + 0.0 * p["b"],
    "StudentT": lambda p: p["mu"] + 0.0 * p["nu"],
    "Gamma": lambda p: p["alpha"] / p["beta"],
    "InverseGamma": lambda p: p["beta"] / (p["alpha"] - 1.0),
    "Weibull": lambda p: p["beta"] * torch.exp(torch.lgamma(1.0 + 1.0 / p["alpha"])),
    "LogNormal": lambda p: torch.exp(p["mu"] + 0.5 * p["sigma"] ** 2),
    "ChiSquared": lambda p: p["nu"],
    "Wald": lambda p: p["mu"],
    "Pareto": lambda p: torch.where(
        p["alpha"] > 1, p["alpha"] * p["m"] / (p["alpha"] - 1.0), torch.inf
    ),
    "ExGaussian": lambda p: p["mu"] + p["nu"],
    "VonMises": lambda p: p["mu"] + 0.0 * p["kappa"],
    "SkewNormal": lambda p: p["mu"] + p["sigma"] * math.sqrt(2.0 / math.pi)
    * p["alpha"] / torch.sqrt(1.0 + p["alpha"] ** 2),
    "Triangular": lambda p: (p["lower"] + p["c"] + p["upper"]) / 3.0,
    "Gumbel": lambda p: p["mu"] + 0.5772156649015329 * p["beta"],
    "Logistic": lambda p: p["mu"] + 0.0 * p["s"],
    "Rice": lambda p: p["sigma"] * math.sqrt(math.pi / 2.0)
    * _laguerre_half(-(p["nu"] ** 2) / (2.0 * p["sigma"] ** 2)),
    "Moyal": lambda p: p["mu"] + p["sigma"]
    * (0.5772156649015329 + math.log(2.0)),
    "Kumaraswamy": lambda p: p["b"] * torch.exp(
        torch.lgamma(1.0 + 1.0 / p["a"]) + torch.lgamma(p["b"])
        - torch.lgamma(1.0 + 1.0 / p["a"] + p["b"])
    ),
    # discrete
    "Binomial": lambda p: p["n"] * p["p"],
    "BetaBinomial": lambda p: p["n"] * p["alpha"] / (p["alpha"] + p["beta"]),
    "Bernoulli": lambda p: p["p"],
    "Poisson": lambda p: p["mu"],
    "NegativeBinomial": lambda p: p["n"] * (1.0 - p["p"]) / p["p"],
    "Geometric": lambda p: 1.0 / p["p"],
    "DiscreteUniform": lambda p: 0.5 * (p["lower"] + p["upper"]),
    "HyperGeometric": lambda p: p["n"] * p["k"] / p["N"],
    "AsymmetricLaplace": lambda p: p["mu"]
    + (1.0 / p["kappa"] - p["kappa"]) / p["b"],
    "HalfStudentT": lambda p: 2.0 * p["sigma"] * torch.sqrt(p["nu"] / math.pi)
    * torch.exp(torch.lgamma((p["nu"] + 1.0) / 2.0) - torch.lgamma(p["nu"] / 2.0))
    / (p["nu"] - 1.0),
    "SkewStudentT": lambda p: p["mu"] + p["sigma"]
    * (p["a"] - p["b"]) * torch.sqrt(p["a"] + p["b"]) / 2.0
    * torch.exp(
        torch.lgamma(p["a"] - 0.5) + torch.lgamma(p["b"] - 0.5)
        - torch.lgamma(p["a"]) - torch.lgamma(p["b"])
    ),
    "PolyaGamma": lambda p: torch.where(
        p["z"] == 0.0,
        p["h"] / 4.0 + 0.0 * p["z"],
        p["h"] / (2.0 * torch.where(p["z"] == 0.0, 1.0, p["z"]))
        * torch.tanh(p["z"] / 2.0),
    ),
    "DiracDelta": lambda p: p["c"],
    # multivariate
    "MvNormal": lambda p: p["mu"] + 0.0 * p["chol"][..., 0],
    "MvStudentT": lambda p: p["mu"] + 0.0 * p["chol"][..., 0],
    "MatrixNormal": lambda p: p["mu"]
    + 0.0 * p["rowchol"][..., :1, :1] * p["colchol"][..., :1, :1],
    "CAR": lambda p: p["mu"] + 0.0 * p["alpha"],
    "KroneckerNormal": lambda p: p["mu"],
    "Dirichlet": lambda p: p["a"] / torch.sum(p["a"], -1, keepdim=True),
    "Multinomial": lambda p: p["n"][..., None]
    * p["p"] / torch.sum(p["p"], -1, keepdim=True)
    if p["n"].ndim else p["n"] * p["p"] / torch.sum(p["p"], -1, keepdim=True),
    "DirichletMultinomial": lambda p: (
        p["n"][..., None] if p["n"].ndim else p["n"]
    ) * p["a"] / torch.sum(p["a"], -1, keepdim=True),
}

# families whose mean is mathematically undefined (the reference's
# dispatcher raises UndefinedMomentException)
_UNDEFINED_MEAN = {
    "Cauchy", "HalfCauchy", "Flat", "HalfFlat", "Categorical", "LogitNormal",
}


def _composite_mean(dist, env, memo, device):
    """Means that need more than the flat parameter dict."""
    name = type(dist).__name__
    if name.startswith("ZeroInflated"):
        # a point mass at 0 (weight 1 - psi) and the base (weight psi)
        return evaluate(dist.psi, env, memo) * _mean(dist.base, env, memo, device)
    if name == "StickBreakingWeights":
        alpha = evaluate(dist.alpha, env, memo)
        frac = alpha / (1.0 + alpha)
        k = torch.arange(dist.K, dtype=alpha.dtype, device=alpha.device)
        w = frac[..., None] ** k / (1.0 + alpha[..., None])
        return torch.cat([w, frac[..., None] ** dist.K], dim=-1)
    if name == "LKJCorr":
        # E[C] = I; the packed strictly-lower form is zeros
        dtype = floatX(device)
        if dist.return_matrix:
            return torch.broadcast_to(torch.eye(dist.n, dtype=dtype, device=device), dist.shape)
        return torch.zeros(dist.shape, dtype=dtype, device=device)
    if name == "Mixture":
        w = evaluate(dist.w, env, memo)
        if dist.comp_list is not None:
            comp_means = torch.stack(torch.broadcast_tensors(
                *[_mean(c, env, memo, device) for c in dist.comp_list]), dim=-1)
        else:
            comp_means = _mean(dist.comp_single, env, memo, device)
        return torch.sum(w * comp_means, dim=-1)
    return None


def mean(rv, env=None, device=None):
    """Analytic mean of a distribution or random-variable node (reference
    moments.mean) on `device` (default: the card; raises without one):
    UndefinedMomentException where the mean does not exist,
    NotImplementedError where no closed form is registered; broadcast to
    the distribution's full shape."""
    dist = rv.dist if isinstance(rv, (FreeRV, ObservedRV)) else rv
    device = resolve_device(device)
    memo = place_constants(dist.inputs(), device, floatX(device))
    return _mean(dist, env, memo, device)


def _mean(dist, env, memo, device):
    name = type(dist).__name__
    if name in _UNDEFINED_MEAN:
        raise UndefinedMomentException(f"The mean of the {name} distribution is undefined")
    out = _composite_mean(dist, env, memo, device)
    if out is None:
        fn = _MEANS.get(name)
        if fn is None:
            raise NotImplementedError(
                f"No analytic mean registered for {name}; "
                "use support_point() for a finite representative value"
            )
        out = torch.as_tensor(fn(_params(dist, env, memo, floatX(device))), device=device)
    shape = tuple(dist.shape)
    return torch.broadcast_to(out, shape) if shape else out
