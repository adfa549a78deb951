"""Model builders shared by `chip_smoke.py`, the fixture scripts and the tests.

`gp_marginal_model` is BASELINE config #4 in the form the JAX package
benchmarks (`benchmarks/suite.py::case_gp_marginal`): a marginal GP with an
`eta**2 * ExpQuad` kernel and Gaussian noise on n sorted inputs;
`gp_latent_model` is the same config in its named, latent form
(`suite.py::case_gp`) and `gp_hsgp_model` in its basis-function form
(`suite.py::case_gp_hsgp`).
`stress_glm_model` is BASELINE config #3 (`suite.py::_stress_model`): the
hierarchical logistic GLM with 10,004 free parameters that
`suite.py::case_stress_chees` samples with ChEES. `smc_mixture_model` is
BASELINE config #5 (`suite.py::case_smc`), the bimodal mixture that
`sample_smc` samples, and `mixture_model` the three-component mixture of
`suite.py::case_mixture`, which it samples with NUTS. Each builder takes the
package to build with (`pymc_tpu_torch` by default), so the reference
package builds the same model from the same data. The radon GLM's builder
is `bench.build_model`; its sampling arguments are here.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "gp_data", "gp_marginal_model", "gp_latent_model", "gp_latent_logp_plain",
    "gp_hsgp_model", "gp_tp_model",
    "gp_approx_model", "gp_grid_data", "gp_kron_model", "GP_SAMPLE_KWARGS",
    "GP_SMOKE_KWARGS", "GP_LATENT_SAMPLE_KWARGS", "GP_SCALARS",
    "RADON_SAMPLE_KWARGS",
    "stress_glm_model", "STRESS_HYPERS", "STRESS_SAMPLE_KWARGS",
    "smc_mixture_model", "SMC_SAMPLE_KWARGS", "SMC_SEEDS", "smc_chain_estimates",
    "mixture_model",
]

# bench.py's many-chain configuration (pooled mass and step, target_accept
# 0.95) at 64 chains, its depth cut from tune 300 / draws 256 so that
# chip_smoke.py, which also samples the GP, stays well inside its time limit
RADON_SAMPLE_KWARGS = dict(
    chains=64, tune=200, draws=128, random_seed=0, mass_adapt="pooled",
    step_adapt="pooled", target_accept=0.95,
)

# case_gp_marginal's keyword arguments to `sample` at 64 chains
GP_SAMPLE_KWARGS = dict(draws=300, tune=300, chains=64, random_seed=0, mass_adapt="pooled")
# chip_smoke.py's, cut in depth to tune 200 / draws 200: with the stress GLM
# the script took 990 s uncut on the H100's slower hosts, against a 1,200 s
# limit. The stress phase's depth, to be cut first, cannot be: tune 600 is
# the least that converges it, and its 128 draws take some 35 s
GP_SMOKE_KWARGS = dict(GP_SAMPLE_KWARGS, draws=200, tune=200)
GP_SCALARS = ("ls", "eta", "sigma")
# the latent GP (case_gp) at 64 chains as scripts/probe_torch_gp_latent.py
# samples it: the suite's arguments cut in depth from 300/300 to 100/100,
# the least the tests allow. Its 64 lock-step trees take ~1,000 leapfrogs a
# draw (mean depth 8.16, the deepest tree at the limit of 10), so 100/100
# took 2,685 s of sampling on the H100, past chip_smoke.py's whole limit;
# it runs in that script instead
GP_LATENT_SAMPLE_KWARGS = dict(GP_SAMPLE_KWARGS, draws=100, tune=100)


def gp_data(n=150):
    """(n, X (n, 1), y (n,)): sorted inputs on [0, 10] and a noisy 2 sin(x),
    from seed 5 (`benchmarks/suite.py::_gp_data`)."""
    rng = np.random.default_rng(5)
    X = np.sort(rng.uniform(0, 10, n))[:, None]
    y = np.sin(X[:, 0]) * 2 + rng.normal(0, 0.3, n)
    return n, X, y


def gp_marginal_model(n=150, pm=None, return_gp=False):
    """ls ~ Gamma(2, 1), eta ~ HalfNormal(2), sigma ~ HalfNormal(1);
    y ~ MvNormal(0, eta^2 ExpQuad(X; ls) + sigma^2 I + 1e-6 I). With
    return_gp=True, (model, gp), so that `gp.conditional` and `gp.predict`
    can be called on it."""
    if pm is None:
        import pymc_tpu_torch as pm
    _, X, y = gp_data(n)
    with pm.Model() as m:
        ls = pm.Gamma("ls", 2, 1)
        eta = pm.HalfNormal("eta", 2)
        gp = pm.gp.Marginal(cov_func=eta**2 * pm.gp.cov.ExpQuad(1, ls=ls))
        sigma = pm.HalfNormal("sigma", 1)
        gp.marginal_likelihood("y", X=X, y=y, sigma=sigma)
    return (m, gp) if return_gp else m


def gp_latent_model(n=150, pm=None, jitter=None):
    """ls ~ Gamma(2, 1), eta ~ HalfNormal(2), sigma ~ HalfNormal(1);
    f = L v with v ~ N(0, I) and L L^T = eta^2 ExpQuad(X; ls) + jitter I
    (the default jitter is dtype-aware: 1e-6 in float64, at least 1e-4 and
    `gp.gp.F32_PRIOR_JITTER` eta^2 in float32, unless `jitter` is given);
    y ~ Normal(f, sigma) (`benchmarks/suite.py::case_gp`). n + 3 free
    parameters; one Cholesky a logp."""
    if pm is None:
        import pymc_tpu_torch as pm
    _, X, y = gp_data(n)
    with pm.Model() as m:
        ls = pm.Gamma("ls", 2, 1)
        eta = pm.HalfNormal("eta", 2)
        gp = pm.gp.Latent(cov_func=eta**2 * pm.gp.cov.ExpQuad(1, ls=ls))
        f = gp.prior("f", X=X, jitter=jitter)
        sigma = pm.HalfNormal("sigma", 1)
        pm.Normal("y", f, sigma, observed=y)
    return m


def gp_latent_logp_plain(q, n=150, jitter_rel=0.0, jitter_min=1e-6):
    """gp_latent_model's logp and gradient at q (C, n + 3), the flat points
    [log ls, log eta, v (n), log sigma], written out in float64 apart from
    the port's GP classes and its Cholesky kernel, with the prior jitter
    max(jitter_min, jitter_rel eta^2): the defaults give float64's model,
    (gp.gp.F32_PRIOR_JITTER, 1e-4) float32's. Returns (logp (C,), grad (C,
    n + 3)) on the CPU."""
    import torch

    from .ops.linalg import cholesky_plain

    _, X, y = gp_data(n)
    x, y = torch.as_tensor(X[:, 0]), torch.as_tensor(y)
    q = torch.as_tensor(q, dtype=torch.float64).detach().cpu().requires_grad_(True)
    log_ls, log_eta, v, log_sigma = q[:, 0], q[:, 1], q[:, 2:-1], q[:, -1]
    ls, eta, sigma = log_ls.exp(), log_eta.exp(), log_sigma.exp()
    d2 = (x[:, None] - x[None, :]) ** 2
    eta2 = (eta**2)[:, None, None]
    j = torch.clamp_min(jitter_rel * eta2, jitter_min)
    K = eta2 * torch.exp(-0.5 * d2 / ls[:, None, None] ** 2) + j * torch.eye(n, dtype=q.dtype)
    f = (cholesky_plain(K) @ v[..., None])[..., 0]
    D = torch.distributions
    logp = (
        D.Gamma(2.0, 1.0).log_prob(ls) + log_ls
        + D.HalfNormal(2.0).log_prob(eta) + log_eta
        + D.Normal(0.0, 1.0).log_prob(v).sum(-1)
        + D.HalfNormal(1.0).log_prob(sigma) + log_sigma
        + D.Normal(f, sigma[:, None]).log_prob(y).sum(-1)
    )
    (grad,) = torch.autograd.grad(logp.sum(), q)
    return logp.detach(), grad


def gp_hsgp_model(n=150, m=32, pm=None):
    """case_gp's model with f from the Hilbert-space approximation of the
    same kernel, m basis functions on 1.5 times the inputs' half-range
    (`benchmarks/suite.py::case_gp_hsgp`); no Cholesky."""
    if pm is None:
        import pymc_tpu_torch as pm
    _, X, y = gp_data(n)
    with pm.Model() as model:
        ls = pm.Gamma("ls", 2, 1)
        eta = pm.HalfNormal("eta", 2)
        gp = pm.gp.HSGP(m=[m], c=1.5, cov_func=eta**2 * pm.gp.cov.ExpQuad(1, ls=ls))
        f = gp.prior("f", X=X)
        sigma = pm.HalfNormal("sigma", 1)
        pm.Normal("y", f, sigma, observed=y)
    return model


def gp_tp_model(n=150, nu=5.0, pm=None, jitter=None):
    """case_gp's model with f from a Student-t process (`gp.TP`, nu degrees
    of freedom) in place of the latent GP: n + 4 free parameters."""
    if pm is None:
        import pymc_tpu_torch as pm
    _, X, y = gp_data(n)
    with pm.Model() as m:
        ls = pm.Gamma("ls", 2, 1)
        eta = pm.HalfNormal("eta", 2)
        tp = pm.gp.TP(cov_func=eta**2 * pm.gp.cov.ExpQuad(1, ls=ls), nu=nu)
        f = tp.prior("f", X=X, jitter=jitter)
        pm.Normal("y", f, pm.HalfNormal("sigma", 1), observed=y)
    return m


def gp_approx_model(approx="VFE", n=150, n_inducing=20, pm=None, jitter=None):
    """case_gp_marginal's model with the sparse `gp.MarginalApprox` (FITC,
    VFE or DTC) on n_inducing inducing points evenly spaced on [0, 10]."""
    if pm is None:
        import pymc_tpu_torch as pm
    _, X, y = gp_data(n)
    Xu = np.linspace(0.0, 10.0, n_inducing)[:, None]
    with pm.Model() as m:
        ls = pm.Gamma("ls", 2, 1)
        eta = pm.HalfNormal("eta", 2)
        gp = pm.gp.MarginalApprox(approx=approx, cov_func=eta**2 * pm.gp.cov.ExpQuad(1, ls=ls))
        gp.marginal_likelihood("y", X=X, Xu=Xu, y=y, sigma=pm.HalfNormal("sigma", 1),
                               jitter=jitter)
    return m


def gp_grid_data(n1=15, n2=10):
    """(x1 (n1, 1) on [0, 10], x2 (n2, 1) on [0, 5], y (n1 n2,)): a noisy
    sin(x1) + cos(x2) on their grid, x1 the slow axis, from seed 5."""
    rng = np.random.default_rng(5)
    x1 = np.linspace(0.0, 10.0, n1)[:, None]
    x2 = np.linspace(0.0, 5.0, n2)[:, None]
    f = np.sin(x1[:, 0])[:, None] + np.cos(x2[:, 0])[None, :]
    return x1, x2, f.reshape(-1) + rng.normal(0, 0.3, n1 * n2)


def gp_kron_model(kind="latent", n1=15, n2=10, pm=None, jitter=None):
    """A GP on gp_grid_data's grid with the kernel eta^2 ExpQuad(x1; ls1)
    (x) ExpQuad(x2; ls2): `gp.LatentKron` with Normal noise (kind="latent",
    one Cholesky a factor) or `gp.MarginalKron` (kind="marginal", one
    eigendecomposition a factor)."""
    if pm is None:
        import pymc_tpu_torch as pm
    x1, x2, y = gp_grid_data(n1, n2)
    with pm.Model() as m:
        ls1 = pm.Gamma("ls1", 2, 1)
        ls2 = pm.Gamma("ls2", 2, 1)
        eta = pm.HalfNormal("eta", 2)
        covs = [eta**2 * pm.gp.cov.ExpQuad(1, ls=ls1), pm.gp.cov.ExpQuad(1, ls=ls2)]
        sigma = pm.HalfNormal("sigma", 1)
        if kind == "latent":
            f = pm.gp.LatentKron(cov_funcs=covs).prior("f", Xs=[x1, x2], jitter=jitter)
            pm.Normal("y", f, sigma, observed=y)
        else:
            pm.gp.MarginalKron(cov_funcs=covs).marginal_likelihood("y", Xs=[x1, x2], y=y,
                                                                   sigma=sigma)
    return m


STRESS_HYPERS = ("mu_a", "sd_a", "mu_b", "sd_b")

# case_stress_chees's keyword arguments to `sample` at its many-chain count
# (1024 chains: pooled mass and step, target_accept 0.95, draws 128, only
# the four hyperparameters kept), with tune 600 for its 300. 300 tuning
# draws do not converge this model with ChEES in either package: pymc_tpu
# at 64 chains (CPU, float64, seeds 0 and 1) ends them with R-hat 1.14-2.99
# on the four and step 0.040 / 0.026; the port ends them at step
# 0.025-0.027 at 64, 256 and 1024 chains, in float32 and float64, and at
# 1024 chains the first 128 draws put sd_a some 7 MCSE below its later mean
# with R-hat up to 1.75. From tune 600 on the means settle (PERF.md §6)
STRESS_SAMPLE_KWARGS = dict(
    chains=1024, tune=600, draws=128, random_seed=0, mass_adapt="pooled",
    step_adapt="pooled", target_accept=0.95, sampler="chees", var_names=STRESS_HYPERS,
)


def stress_glm_model(n_groups=5000, n_obs=20000, seed=0, pm=None):
    """mu_a, mu_b ~ Normal(0, 1), sd_a, sd_b ~ HalfNormal(1), a_t, b_t ~
    Normal(0, 1) per group (non-centred); y ~ Bernoulli(logit_p = a[g] +
    b[g] x) on n_obs observations drawn from numpy's generator at `seed`,
    the data of `benchmarks/suite.py::_stress_model`. 2 n_groups + 4 free
    parameters."""
    if pm is None:
        import pymc_tpu_torch as pm
    rng = np.random.default_rng(seed)
    g = rng.integers(0, n_groups, n_obs)
    x = rng.normal(size=n_obs)
    true_a = rng.normal(0, 0.5, n_groups)
    true_b = rng.normal(0.3, 0.2, n_groups)
    logits = true_a[g] + true_b[g] * x
    y = (rng.uniform(size=n_obs) < 1 / (1 + np.exp(-logits))).astype(int)
    with pm.Model() as m:
        mu_a = pm.Normal("mu_a", 0, 1)
        sd_a = pm.HalfNormal("sd_a", 1)
        mu_b = pm.Normal("mu_b", 0, 1)
        sd_b = pm.HalfNormal("sd_b", 1)
        a_t = pm.Normal("a_t", 0, 1, shape=(n_groups,))
        b_t = pm.Normal("b_t", 0, 1, shape=(n_groups,))
        a = mu_a + sd_a * a_t
        b = mu_b + sd_b * b_t
        pm.Bernoulli("y", logit_p=a[g] + b[g] * x, observed=y)
    return m


# case_smc's keyword arguments to `sample_smc` (IMH, threshold 0.5,
# correlation_threshold 0.01 by default); the fixture and chip_smoke.py run
# it at each of SMC_SEEDS, for a spread over runs
SMC_SAMPLE_KWARGS = dict(draws=2000, chains=4, random_seed=0)
SMC_SEEDS = (0, 1, 2, 3, 4)


def smc_chain_estimates(idata):
    """{name: (chains,) float64}: each chain's posterior mean of mu[0],
    mu[1], w[0] and w[1], and its log marginal likelihood."""
    post = idata.posterior
    out = {}
    for name in ("mu", "w"):
        x = np.asarray(post[name].values, dtype=np.float64)
        for k in range(x.shape[-1]):
            out[f"{name}[{k}]"] = x[..., k].mean(axis=1)
    out["log_marginal_likelihood"] = np.asarray(
        idata.sample_stats["log_marginal_likelihood"].values[:, 0], dtype=np.float64
    )
    return out


def smc_mixture_model(pm=None):
    """w ~ Dirichlet(1, 1), mu ~ Normal(0, 3) ordered (initval (-1, 1));
    y ~ w_0 N(mu_0, 0.5) + w_1 N(mu_1, 0.5) on 120 observations, 60 around
    -2 and 60 around 2, from numpy's generator at seed 7
    (`benchmarks/suite.py::case_smc`)."""
    if pm is None:
        import pymc_tpu_torch as pm
    rng = np.random.default_rng(7)
    y = np.concatenate([rng.normal(-2, 0.5, 60), rng.normal(2, 0.5, 60)])
    with pm.Model() as m:
        w = pm.Dirichlet("w", np.ones(2))
        mu = pm.Normal("mu", 0, 3, shape=2,
                       transform=pm.distributions.transforms.ordered,
                       initval=np.array([-1.0, 1.0]))
        pm.Mixture("y", w, pm.Normal.dist(mu, 0.5), observed=y)
    return m


def mixture_model(pm=None):
    """w ~ Dirichlet(1, 1, 1), mu ~ Normal(0, 5) ordered (initval (-1, 0,
    1)), both on the dim "comp"; y ~ sum_k w_k N(mu_k, 1) on 1,500
    observations drawn with weights (0.35, 0.4, 0.25) around (0, 2, -1)
    from numpy's generator at seed 12345 (`benchmarks/suite.py::
    case_mixture`)."""
    if pm is None:
        import pymc_tpu_torch as pm
    rng = np.random.default_rng(12345)
    w_true = np.array([0.35, 0.4, 0.25])
    mu_true = np.array([0.0, 2.0, -1.0])
    comp = rng.choice(3, p=w_true, size=1500)
    y = rng.normal(mu_true[comp], 1.0)
    with pm.Model(coords={"comp": range(3)}) as m:
        w = pm.Dirichlet("w", np.ones(3), dims="comp")
        mu = pm.Normal("mu", 0.0, 5.0,
                       transform=pm.distributions.transforms.ordered,
                       initval=np.array([-1.0, 0.0, 1.0]), dims="comp")
        pm.Mixture("y", w, pm.Normal.dist(mu, 1.0), observed=y)
    return m
