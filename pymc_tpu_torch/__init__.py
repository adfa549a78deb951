"""pymc_tpu_torch — the PyTorch/CUDA port of pymc_tpu.

The first slice: the radon-GLM main path of `bench.py` — the model graph,
Normal and HalfCauchy with the log transform, jittered starting points,
dual averaging and diagonal Welford adaptation, batched NUTS whose leapfrog
runs through hand-written CUDA kernels on the card, and R-hat/ESS. The
package imports torch and never jax; kernels are built at first use, never
at import.

    import pymc_tpu_torch as pm
    with pm.Model(coords={"g": range(3)}) as model:
        mu = pm.Normal("mu", 0.0, 5.0)
        tau = pm.HalfCauchy("tau", 5.0)
        pm.Normal("y", mu, tau, observed=[1.0, 2.0, 0.5])
    idata = pm.sample(draws=500, tune=500, chains=4, device="cuda")
"""

from .distributions import HalfCauchy, Normal
from .model import Deterministic, Model
from .sampling.mcmc import sample
from .stats.convergence import ess, rhat

__all__ = ["Model", "Normal", "HalfCauchy", "Deterministic", "sample", "rhat", "ess"]
