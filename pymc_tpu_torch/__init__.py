"""pymc_tpu_torch — the PyTorch/CUDA port of pymc_tpu.

Three slices so far. The radon-GLM main path of `bench.py`: the model
graph, Normal and HalfCauchy with the log transform, jittered starting
points, dual averaging and diagonal Welford adaptation, batched NUTS whose
leapfrog runs through hand-written CUDA kernels on the card, and R-hat/ESS.
The GP path: Gamma, HalfNormal, MvNormal, `gp.Marginal.marginal_likelihood`
and `gp.Latent.prior` with the ExpQuad kernel algebra, whose covariance is
factored by a hand-written batched Cholesky kernel on the card. The ChEES
path: Bernoulli and `sample(..., sampler="chees")`, which samples the
10,004-parameter stress GLM at 1024 chains through the leapfrog kernels,
and `var_names`, which keeps the chosen variables on the card until they
are postprocessed. The package
imports torch and never jax; kernels are built at first use, never at
import. Entry points run on the card unless `device="cpu"` is asked for.

    import pymc_tpu_torch as pm
    with pm.Model() as model:
        ls = pm.Gamma("ls", 2, 1)
        eta = pm.HalfNormal("eta", 2)
        gp = pm.gp.Marginal(cov_func=eta**2 * pm.gp.cov.ExpQuad(1, ls=ls))
        gp.marginal_likelihood("y", X=X, y=y, sigma=pm.HalfNormal("sigma", 1))
    idata = pm.sample(draws=300, tune=300, chains=64, mass_adapt="pooled")
"""

from . import distributions, gp
from .distributions import (
    Bernoulli, Dirichlet, Gamma, HalfCauchy, HalfNormal, Mixture, MvNormal, Normal,
    NormalMixture,
)
from .model import Deterministic, Model
from .sampling.mcmc import sample
from .smc.sampling import sample_smc
from .stats.convergence import ess, rhat

__all__ = [
    "Model", "Normal", "HalfNormal", "HalfCauchy", "Gamma", "MvNormal", "Bernoulli",
    "Dirichlet", "Mixture", "NormalMixture", "Deterministic", "distributions",
    "gp", "sample", "sample_smc", "rhat", "ess",
]
