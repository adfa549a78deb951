"""pymc_tpu_torch — the PyTorch/CUDA port of pymc_tpu.

The radon-GLM main path of `bench.py`: the model
graph, Normal and HalfCauchy with the log transform, jittered starting
points, dual averaging and diagonal Welford adaptation, batched NUTS whose
leapfrog runs through hand-written CUDA kernels on the card, and R-hat/ESS.
The GP path: Gamma, HalfNormal, MvNormal, `gp.Marginal.marginal_likelihood`
and `gp.Latent.prior` with the ExpQuad kernel algebra, whose covariance is
factored by a hand-written batched Cholesky kernel on the card. The ChEES
path: Bernoulli and `sample(..., sampler="chees")`, which samples the
10,004-parameter stress GLM at 1024 chains through the leapfrog kernels,
and `var_names`, which keeps the chosen variables on the card until they
are postprocessed. Tempered SMC (`sample_smc`) on the mixture models.
The rest of the GP module (every covariance, TP, the sparse, Kronecker and
Hilbert-space GPs, `conditional` and `predict`) and prior and posterior
predictive sampling. The init family of `sample` (every init of the JAX
package, full and gradient-based mass), VI (`fit`, ADVI, FullRankADVI,
SVGD, ASVGD and the approximations), `find_MAP`/`find_hessian` and
`find_constrained_prior`. The univariate distribution library (every
class of the JAX package's continuous.py and discrete.py, the
zero-inflated and hurdle mixtures), the log-odds, interval, log-expm1 and
circular transforms, and `pm.math`. Step methods (NUTS, HamiltonianMC,
Metropolis, the Gibbs and differential-evolution steps, Slice) and compound
sampling, which `sample` uses for models with discrete free variables or
when `step=` is given, and the imputation of missing observed values. The
rest of `sample` (warmup groups, callbacks, chunked FileTrace checkpoints
and resume, MultiTrace) and the results layer: pointwise log densities,
`summary`/`hdi`, `loo`/`waic`/`compare`, the functional API (`logp`,
`logcdf`, `logccdf`, `draw`) and functions of a posterior
(`compute_deterministics`, `vectorize_over_posterior`,
`compile_forward_sampling_function`). CustomDist, Simulator (with the ABC
branch of `sample_smc`), the derived densities (Discretized, the order
statistics, CumSum, Compared), analytic means, `Mixture.logcdf`, the
Bessel functions of `pm.math`, and the rest of `Model`: nested models,
coords, the compiled functions, `Point`, initial points and checks. The
package
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

from . import (
    backends, distributions, gp, math, stats, step_methods, tuning, util, variational, vartypes,
)
from .backends import FileTrace, InferenceData, MultiTrace
from .backends.arviz import predictions_to_inference_data, to_inference_data
from .backends.report import SamplerReport
from .distributions import *  # noqa: F401,F403
from .distributions import __all__ as _dist_all
from .func_utils import find_constrained_prior
from .functions import draw, icdf, logccdf, logcdf, logp
from .model import (
    Deterministic, Model, Point, Potential, compile, compile_fn, modelcontext, set_data,
)
from .sampling.forward import (
    compile_forward_sampling_function, compute_deterministics, sample_posterior_predictive,
    sample_prior_predictive, vectorize_over_posterior,
)
from .sampling.mcmc import init_nuts, sample
from .smc.sampling import sample_smc
from .stats import (
    compare, compute_log_likelihood, compute_log_prior, ess, hdi, loo, rhat, summary, waic,
)
from .step_methods import (
    NUTS, BinaryGibbsMetropolis, BinaryMetropolis, CategoricalGibbsMetropolis, CompoundStep,
    DEMetropolis, DEMetropolisZ, HamiltonianMC, Metropolis, Slice,
)
from .tuning import find_hessian, find_MAP
from .variational import (
    ADVI, ASVGD, KL, KSD, SVGD, Approximation, FullRankADVI, Group, ImplicitGradient, KLqp,
    ObjectiveFunction, Operator, Stein, TestFunction, adadelta, adagrad, adagrad_window, adam,
    adamax, apply_momentum, apply_nesterov_momentum, fit, momentum, nesterov_momentum,
    norm_constraint, rmsprop, sample_approx, sgd, total_norm_constraint,
)
from .variational.approximations import Empirical, FullRank, MeanField

__all__ = [
    *[n for n in _dist_all
      if n not in ("Distribution", "Continuous", "Discrete", "transforms", "moments",
                   "shape_utils")],
    "Model", "Deterministic", "Potential", "modelcontext", "set_data", "compile", "compile_fn",
    "Point", "util", "vartypes", "distributions", "math", "gp", "sample", "sample_smc",
    "sample_prior_predictive", "sample_posterior_predictive", "rhat", "ess", "init_nuts",
    "tuning", "variational", "find_MAP", "find_hessian", "find_constrained_prior", "fit", "ADVI",
    "ASVGD", "SVGD", "FullRankADVI", "KLqp", "ImplicitGradient", "KL", "KSD", "Operator",
    "ObjectiveFunction", "TestFunction", "Stein", "Group", "Approximation", "sample_approx",
    "MeanField", "FullRank", "Empirical", "sgd", "momentum", "nesterov_momentum", "adagrad",
    "adagrad_window", "rmsprop", "adadelta", "adam", "adamax", "apply_momentum",
    "apply_nesterov_momentum", "norm_constraint", "total_norm_constraint", "step_methods",
    "NUTS", "HamiltonianMC", "Metropolis", "BinaryMetropolis", "BinaryGibbsMetropolis",
    "CategoricalGibbsMetropolis", "DEMetropolis", "DEMetropolisZ", "Slice", "CompoundStep",
    "backends", "stats", "InferenceData", "MultiTrace", "SamplerReport", "FileTrace",
    "to_inference_data", "predictions_to_inference_data", "logp", "logcdf", "logccdf", "icdf",
    "draw", "compute_deterministics", "vectorize_over_posterior",
    "compile_forward_sampling_function", "compute_log_likelihood", "compute_log_prior",
    "summary", "hdi", "loo", "waic", "compare",
]
