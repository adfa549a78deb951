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
`suite.py::case_mixture`, which it samples with NUTS. `best_model` is
`suite.py::case_best`'s two-group Student-t comparison (BEST), and
`hierarchical_binomial_model` the Beta-Binomial partial pooling of
`examples/hierarchical_binomial.py`. `changepoint_model` is the structure
of PyMC's coal-mining change-point case study at its published size, on
synthetic counts, with two missing counts that are imputed: a discrete
switchpoint and discrete imputed counts, which compound step methods
sample. `radon_lkj_model` is PyMC's correlated-effects radon model (the
multilevel-modeling primer's "Covariation between intercepts and slopes":
an LKJ Cholesky prior on the county effects) on `bench.build_model`'s data,
and `lkj_corr_prior_model` an LKJ prior on a correlation matrix alone, whose
moments are known exactly; `multivariate_model` builds one small model
for each of the other classes of the multivariate slice.
`survival_model` is `examples/survival_analysis.py` (a Weibull regression
on 500 subjects, right-censored at t = 4 through `Censored`) and
`stochastic_volatility_model` `examples/stochastic_volatility.py` (a
200-step GaussianRandomWalk log-volatility under StudentT returns), each
on the example's own data and seed; `timeseries_model` builds one small
model for each time-series class. `radon_custom_model` is
`bench.build_model`'s radon GLM with its likelihood written by hand as a
`CustomDist`, built inside a named model (`radon::`); `abc_simulator_model`
is `examples/abc_simulator.py` (a Simulator under `sample_smc`), and
`derived_model` a model whose likelihoods are a rounded Normal
(`Discretized`) and the maximum of five Normals (`Max`). Each model
function takes the
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
    "RADON_SAMPLE_KWARGS", "RADON_ADVI_SAMPLE_KWARGS", "RADON_FULL_SAMPLE_KWARGS",
    "GP_MAP_SAMPLE_KWARGS",
    "stress_glm_model", "STRESS_HYPERS", "STRESS_SAMPLE_KWARGS",
    "smc_mixture_model", "SMC_SAMPLE_KWARGS", "SMC_SEEDS", "smc_chain_estimates",
    "mixture_model", "best_data", "best_model", "BEST_SAMPLE_KWARGS", "BEST_SMOKE_KWARGS",
    "BEST_SCALARS",
    "hierarchical_binomial_model", "BINOMIAL_SAMPLE_KWARGS", "BINOMIAL_SMOKE_KWARGS",
    "BINOMIAL_SCALARS",
    "changepoint_data", "changepoint_model", "changepoint_posterior", "CHANGEPOINT_SAMPLE_KWARGS",
    "CHANGEPOINT_SCALARS",
    "radon_data", "radon_lkj_model", "LKJ_RADON_SAMPLE_KWARGS", "LKJ_RADON_SCALARS",
    "lkj_radon_scalars",
    "lkj_corr_prior_model", "LKJ_CORR_SAMPLE_KWARGS", "MULTIVARIATE_MODELS",
    "multivariate_model", "MV_RING", "MV_ROWCOV", "MV_COLCOV",
    "survival_data", "survival_model", "survival_minimum_model", "STRUCTURAL_MODELS",
    "structural_model", "SURVIVAL_SAMPLE_KWARGS",
    "SURVIVAL_SMOKE_KWARGS",
    "SURVIVAL_SCALARS", "SURVIVAL_TRUTH",
    "stochastic_volatility_data", "stochastic_volatility_model", "SV_SAMPLE_KWARGS",
    "SV_SMOKE_KWARGS", "SV_SCALARS", "TIMESERIES_MODELS", "timeseries_model", "TS_COV",
    "radon_custom_model", "radon_lognormal_model", "RADON_SCALARS", "abc_data", "abc_simulate",
    "abc_simulator_model",
    "ABC_SMC_KWARGS", "ABC_SEEDS", "derived_data", "derived_model", "DERIVED_SAMPLE_KWARGS",
    "DERIVED_SMOKE_KWARGS", "DERIVED_SCALARS", "SLICE_MODELS", "slice_model",
]

# bench.py's many-chain configuration (pooled mass and step, target_accept
# 0.95) at 64 chains, its depth cut from tune 300 / draws 256 so that
# chip_smoke.py, which also samples the GP, stays well inside its time limit
RADON_SAMPLE_KWARGS = dict(
    chains=64, tune=200, draws=128, random_seed=0, mass_adapt="pooled",
    step_adapt="pooled", target_accept=0.95,
)

# BASELINE config #2, "radon multilevel regression, NUTS + ADVI init":
# RADON_SAMPLE_KWARGS (phase 5's depth, 200/128) with init="advi+adapt_diag"
# and the JAX package's n_init of 10,000 ADVI steps, as chip_smoke.py phase
# 10a runs it. Uncut: with the logp+grad replayed from a CUDA graph a
# radon leapfrog costs ~0.5 ms on the H100, not ~8 (PERF.md §6)
RADON_ADVI_SAMPLE_KWARGS = dict(RADON_SAMPLE_KWARGS, init="advi+adapt_diag", n_init=10_000)
# phase 10b: the same model and depth with a full mass (init=
# "jitter+adapt_full": the identity, then one pooled covariance window)
RADON_FULL_SAMPLE_KWARGS = dict(RADON_SAMPLE_KWARGS, init="jitter+adapt_full")

# case_gp_marginal's keyword arguments to `sample` at 64 chains
GP_SAMPLE_KWARGS = dict(draws=300, tune=300, chains=64, random_seed=0, mass_adapt="pooled")
# chip_smoke.py's, cut in depth to tune 200 / draws 200: with the stress GLM
# the script took 990 s uncut on the H100's slower hosts, against a 1,200 s
# limit. The stress phase's depth, to be cut first, cannot be: tune 600 is
# the least that converges it, and its 128 draws take some 35 s
GP_SMOKE_KWARGS = dict(GP_SAMPLE_KWARGS, draws=200, tune=200)
GP_SCALARS = ("ls", "eta", "sigma")
# the latent GP (case_gp) at 64 chains as chip_smoke.py phase 9c samples
# it: the suite's arguments cut in depth from 300/300 to 100/100, the least
# the tests allow. Its 64 lock-step trees take ~1,000 leapfrogs a draw (the
# deepest tree near the limit of 10), ~150 s on the H100 with the replayed
# logp+grad (PERF.md §6)
GP_LATENT_SAMPLE_KWARGS = dict(GP_SAMPLE_KWARGS, draws=100, tune=100)
# phase 10c: config #4's marginal GP started at its MAP point with the
# static full mass the Hessian there gives (init="map"); 100/100, cut from
# the suite's 300/300: with the MAP's mass only the step size is tuned, and
# 6,400 draws hold the means to the fixture
GP_MAP_SAMPLE_KWARGS = dict(GP_SAMPLE_KWARGS, draws=100, tune=100, init="map")


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


# case_best's keyword arguments to `sample` at its accelerator chain count
# (512 chains, pooled mass as the suite sets from 64 chains on)
BEST_SAMPLE_KWARGS = dict(chains=512, tune=1000, draws=5000, random_seed=0, mass_adapt="pooled")
# chip_smoke.py phase 11a's, cut in depth to tune 300 / draws 300: uncut,
# the phase took 159.0 s on the H100 (25 ms a draw), at draws 2000 92.7 to
# 110.5 s; the later cuts (draws 1000, then tune and draws 300) make room
# for phases 13 and 15 (min bulk ESS at 2000 draws was 658,180, so a
# mean's MCSE stays far below the fixture's)
BEST_SMOKE_KWARGS = dict(BEST_SAMPLE_KWARGS, tune=300, draws=300)
BEST_SCALARS = ("group1_mean", "group2_mean", "group1_std", "group2_std", "nu_minus_one",
                "difference of means")


def best_data():
    """(drug, placebo): the two groups' IQ scores of `benchmarks/suite.py::
    case_best` (Kruschke's BEST drug evaluation, 47 and 42 values)."""
    drug = np.array([101, 100, 102, 104, 102, 97, 105, 105, 98, 101, 100,
                     123, 105, 103, 100, 95, 102, 106, 109, 102, 82, 102,
                     100, 102, 102, 101, 102, 102, 103, 103, 97, 97, 103,
                     101, 97, 104, 96, 103, 124, 101, 101, 100, 101, 101,
                     104, 100, 101], dtype=float)
    placebo = np.array([99, 101, 100, 101, 102, 100, 97, 101, 104, 101,
                        102, 102, 100, 105, 88, 101, 100, 104, 100, 100,
                        100, 101, 102, 103, 97, 101, 101, 100, 101, 99,
                        101, 100, 100, 101, 100, 99, 101, 100, 102, 99,
                        100, 99], dtype=float)
    return drug, placebo


def best_model(pm=None):
    """group means ~ Normal(pooled mean, 2 pooled sd), group sds ~
    Uniform(1, 10), nu - 1 ~ Exponential(1/29); each group ~ StudentT(nu,
    mean, lam = sd^-2), and the deterministic `difference of means`
    (`benchmarks/suite.py::case_best`). 5 free parameters: two interval,
    one log, two real."""
    if pm is None:
        import pymc_tpu_torch as pm
    drug, placebo = best_data()
    yall = np.concatenate([drug, placebo])
    mu_m, mu_s = yall.mean(), yall.std() * 2
    with pm.Model() as m:
        g1m = pm.Normal("group1_mean", mu_m, mu_s)
        g2m = pm.Normal("group2_mean", mu_m, mu_s)
        g1s = pm.Uniform("group1_std", 1, 10)
        g2s = pm.Uniform("group2_std", 1, 10)
        nu = pm.Exponential("nu_minus_one", 1 / 29.0) + 1
        pm.StudentT("drug", nu=nu, mu=g1m, lam=g1s**-2, observed=drug)
        pm.StudentT("placebo", nu=nu, mu=g2m, lam=g2s**-2, observed=placebo)
        pm.Deterministic("difference of means", g1m - g2m)
    return m


# examples/hierarchical_binomial.py's arguments at 64 chains with a pooled
# mass (the example runs 4 chains at seed 3)
BINOMIAL_SAMPLE_KWARGS = dict(chains=64, tune=1000, draws=1000, random_seed=0,
                              mass_adapt="pooled")
# chip_smoke.py phase 11b's, cut in depth to 500/500 to make room for phase
# 14 within the script's time limit (at 300/300 its max R-hat read 1.0444,
# too near 1.05; PERF.md §6)
BINOMIAL_SMOKE_KWARGS = dict(BINOMIAL_SAMPLE_KWARGS, tune=500, draws=500)
BINOMIAL_SCALARS = ("phi", "kappa_log", "kappa")


def hierarchical_binomial_model(pm=None):
    """phi ~ Uniform(0, 1), kappa_log ~ Exponential(1.5), kappa = exp(
    kappa_log); theta ~ Beta(phi kappa, (1 - phi) kappa) for each of 18
    players; hits ~ Binomial(45, theta) on the Efron-Morris batting data
    (`examples/hierarchical_binomial.py`). 20 free parameters: logodds (18),
    interval and log."""
    if pm is None:
        import pymc_tpu_torch as pm
    hits = np.array([18, 17, 16, 15, 14, 14, 13, 12, 11, 11, 10, 10, 10, 10, 10, 9, 8, 7])
    at_bats = np.full(18, 45)
    with pm.Model(coords={"player": np.arange(18)}) as model:
        phi = pm.Uniform("phi", 0.0, 1.0)
        kappa_log = pm.Exponential("kappa_log", lam=1.5)
        kappa = pm.Deterministic("kappa", pm.math.exp(kappa_log))
        theta = pm.Beta("theta", alpha=phi * kappa, beta=(1.0 - phi) * kappa, dims="player")
        pm.Binomial("y", n=at_bats, p=theta, observed=hits, dims="player")
    return model


# the change-point model as chip_smoke.py phase 12a samples it: 64 chains,
# tune 1000, draws 1000, automatic step assignment (NUTS on the rates,
# Metropolis on the switchpoint and on the two imputed counts)
CHANGEPOINT_SAMPLE_KWARGS = dict(chains=64, tune=1000, draws=1000, random_seed=0)
# the scalars held to the reference; disasters_unobserved's two entries
# are held as disasters_unobserved[0] and [1]
CHANGEPOINT_SCALARS = ("early_rate", "late_rate", "switchpoint")
# the published series' missing years (1890 and 1934 of 1851-1961)
CHANGEPOINT_MISSING = (39, 83)


def changepoint_data(seed=0):
    """(years 0..110, counts): 111 Poisson counts drawn from `seed`, rate
    3.0 in the first 40 years and 1.0 after, with the published series'
    two missing years set to NaN."""
    years = np.arange(111)
    counts = np.random.default_rng(seed).poisson(np.where(years < 40, 3.0, 1.0)).astype(float)
    counts[list(CHANGEPOINT_MISSING)] = np.nan
    return years, counts


def changepoint_model(pm=None):
    """switchpoint ~ DiscreteUniform(0, 110); early_rate, late_rate ~
    Exponential(1); disasters ~ Poisson(switch(switchpoint >= years,
    early_rate, late_rate)) on `changepoint_data()`, whose two missing
    counts become the free variable disasters_unobserved (PyMC's coal-mining
    case study, at its size)."""
    if pm is None:
        import pymc_tpu_torch as pm
    years, counts = changepoint_data()
    with pm.Model() as model:
        switchpoint = pm.DiscreteUniform("switchpoint", lower=0, upper=110)
        early_rate = pm.Exponential("early_rate", 1.0)
        late_rate = pm.Exponential("late_rate", 1.0)
        rate = pm.math.switch(switchpoint >= years, early_rate, late_rate)
        pm.Poisson("disasters", rate, observed=counts)
    return model


def changepoint_posterior():
    """The change-point model's exact posterior means {name: mean}: the
    rates are conjugate (Gamma(1 + sum, 1 + n) for each segment), so the
    switchpoint's posterior is the product of two Gamma-Poisson marginal
    likelihoods, and each imputed count's mean is its year's expected rate."""
    from scipy.special import gammaln, logsumexp

    years, counts = changepoint_data()
    seen = ~np.isnan(counts)
    c = np.where(seen, counts, 0.0)
    log_w, early, late = [], [], []
    for s in range(111):
        parts = []
        for segment in (years <= s, years > s):
            k, n = c[segment & seen].sum(), (segment & seen).sum()
            parts.append((1.0 + k, 1.0 + n))
        # log of the marginal likelihood of the observed counts given s
        log_w.append(sum(gammaln(a) - a * np.log(b) for a, b in parts))
        early.append(parts[0][0] / parts[0][1])
        late.append(parts[1][0] / parts[1][1])
    w = np.exp(np.array(log_w) - logsumexp(log_w))
    early, late, s = np.array(early), np.array(late), np.arange(111)
    out = {"early_rate": float(w @ early), "late_rate": float(w @ late),
           "switchpoint": float(w @ s)}
    for i, year in enumerate(CHANGEPOINT_MISSING):
        out[f"disasters_unobserved[{i}]"] = float(w @ np.where(s >= year, early, late))
    return out


def radon_data(n_counties=85, n_obs=919, seed=1234):
    """(county (n_obs,), floor (n_obs,), log_radon (n_obs,)): the synthetic
    radon data of `bench.build_model`, drawn in the same order from the same
    seed."""
    rng = np.random.default_rng(seed)
    county = rng.integers(0, n_counties, size=n_obs)
    floor_x = rng.integers(0, 2, size=n_obs).astype(float)
    true_a = rng.normal(1.5, 0.5, size=n_counties)
    true_b = rng.normal(-0.7, 0.3, size=n_counties)
    log_radon = true_a[county] + true_b[county] * floor_x + rng.normal(0, 0.6, size=n_obs)
    return county, floor_x, log_radon


# the correlated-effects radon model as chip_smoke.py phase 14a samples it:
# phase 5's configuration (RADON_SAMPLE_KWARGS: 64 chains, pooled mass and
# step, target_accept 0.95) started from 3,000 ADVI steps, tune 400, draws
# 250. From phase 5's jittered starts some of the 64 chains drift to a
# standard deviation near 0 early in the warmup and stay there: with a
# pooled step every chain then runs trees of depth 10 (R-hat 2-11 on the
# card, 1.08-1.15 for pymc_tpu on the CPU at tune 500). From the ADVI
# approximation's draws every chain converges (PERF.md §6)
LKJ_RADON_SAMPLE_KWARGS = dict(RADON_SAMPLE_KWARGS, tune=400, draws=250,
                               init="advi+adapt_diag", n_init=3000)
# the scalars held to the reference (lkj_radon_scalars)
LKJ_RADON_SCALARS = ("mu_ab[0]", "mu_ab[1]", "chol_stds[0]", "chol_stds[1]", "chol_corr[0,1]",
                     "sigma")


def lkj_radon_scalars(posterior):
    """{name: (chain, draw) float64 draws} of LKJ_RADON_SCALARS from a
    posterior group of radon_lkj_model (either package's)."""
    mu_ab, stds, corr, sigma = (np.asarray(posterior[n].values, dtype=np.float64)
                                for n in ("mu_ab", "chol_stds", "chol_corr", "sigma"))
    return {"mu_ab[0]": mu_ab[..., 0], "mu_ab[1]": mu_ab[..., 1], "chol_stds[0]": stds[..., 0],
            "chol_stds[1]": stds[..., 1], "chol_corr[0,1]": corr[..., 0, 1], "sigma": sigma}


def radon_lkj_model(pm=None, n_counties=85, n_obs=919):
    """PyMC's correlated varying intercepts and slopes on the radon data:
    chol, corr, stds = LKJCholeskyCov(n=2, eta=2, sd_dist=Exponential(0.5));
    mu_ab ~ Normal(0, 5) (2); z ~ Normal(0, 1) (2, n_counties); ab =
    (chol @ z).T; y ~ Normal(mu_ab[0] + ab[county, 0] + (mu_ab[1] +
    ab[county, 1]) floor, sigma), sigma ~ Exponential(1). 176 free values at
    the published 85 counties: the packed factor (3), mu_ab, z and sigma."""
    if pm is None:
        import pymc_tpu_torch as pm
    county, floor_x, log_radon = radon_data(n_counties, n_obs)
    with pm.Model() as model:
        sd_dist = pm.Exponential.dist(0.5, shape=2)
        chol, _, _ = pm.LKJCholeskyCov("chol", n=2, eta=2.0, sd_dist=sd_dist)
        mu_ab = pm.Normal("mu_ab", 0.0, 5.0, shape=2)
        z = pm.Normal("z", 0.0, 1.0, shape=(2, n_counties))
        ab = pm.Deterministic("ab", (chol @ z).T)
        theta = mu_ab[0] + ab[county, 0] + (mu_ab[1] + ab[county, 1]) * floor_x
        sigma = pm.Exponential("sigma", 1.0)
        pm.Normal("y", theta, sigma, observed=log_radon)
    return model


# the LKJ prior of chip_smoke.py phase 14b: 64 chains, pooled mass and step
LKJ_CORR_SAMPLE_KWARGS = dict(chains=64, tune=200, draws=200, random_seed=0,
                              mass_adapt="pooled", step_adapt="pooled")


def lkj_corr_prior_model(n=10, eta=2.0, pm=None):
    """corr ~ LKJCorr(n, eta) alone: n (n - 1) / 2 free values, each
    correlation with mean 0 and variance 1 / (2 eta + n - 1) ((r + 1) / 2 ~
    Beta(eta - 1 + n / 2, eta - 1 + n / 2))."""
    if pm is None:
        import pymc_tpu_torch as pm
    with pm.Model() as model:
        pm.LKJCorr("corr", n=n, eta=eta)
    return model


# the constants of the small multivariate models: a ring of 5 areas, and a
# row and a column covariance
MV_RING = np.roll(np.eye(5), 1, axis=1) + np.roll(np.eye(5), -1, axis=1)
MV_ROWCOV = np.array([[2.5, 0.6, -0.4], [0.6, 1.8, 0.3], [-0.4, 0.3, 1.2]])
MV_COLCOV = np.array([[1.5, -0.5], [-0.5, 0.8]])


def _mv_lkj_corr(pm):
    eta = pm.Gamma("eta", 4.0, 2.0)
    pm.LKJCorr("c", n=3, eta=eta)


def _mv_lkj_cov(pm):
    pm.LKJCholeskyCov("chol", n=3, eta=2.0, sd_dist=pm.Exponential.dist(1.0, shape=3))


def _mv_wishart(pm):
    pm.Wishart("w", nu=5.0, V=MV_ROWCOV)


def _mv_multinomial(pm):
    p = pm.Dirichlet("p", np.ones(4))
    pm.Multinomial("y", n=20, p=p, observed=np.array([[3, 5, 8, 4], [6, 6, 2, 6]]))


def _mv_dirichlet_multinomial(pm):
    a = pm.HalfNormal("a", 2.0, shape=3)
    pm.DirichletMultinomial("y", n=10, a=a, observed=np.array([2, 5, 3]))


def _mv_ordered_multinomial(pm):
    eta = pm.Normal("eta", 0.0, 1.0)
    pm.OrderedMultinomial("y", eta=eta, cutpoints=np.array([-1.0, 0.5, 2.0]), n=15,
                          observed=np.array([3, 4, 6, 2]))


def _mv_matrix_normal(pm):
    pm.MatrixNormal("x", mu=np.arange(6.0).reshape(3, 2), rowcov=MV_ROWCOV, colcov=MV_COLCOV)


def _mv_car(pm):
    alpha = pm.Uniform("alpha", 0.0, 1.0)
    tau = pm.Gamma("tau", 2.0, 1.0)
    pm.CAR("phi", mu=np.zeros(5), W=MV_RING, alpha=alpha, tau=tau)


def _mv_icar(pm):
    sigma = pm.HalfNormal("sigma", 1.0)
    pm.ICAR("phi", W=MV_RING, sigma=sigma)


def _mv_stick_breaking(pm):
    alpha = pm.Gamma("alpha", 2.0, 1.0)
    pm.StickBreakingWeights("w", alpha=alpha, K=4)


def _mv_zero_sum_normal(pm):
    sigma = pm.HalfNormal("sigma", 1.0)
    pm.ZeroSumNormal("z", sigma=sigma, n_zerosum_axes=2, shape=(3, 4))


# one small model for each class of the multivariate slice: the class as a
# free variable through its default transform, or, for the discrete
# classes, as a likelihood whose parameters are free
MULTIVARIATE_MODELS = {
    "LKJCorr": _mv_lkj_corr, "LKJCholeskyCov": _mv_lkj_cov, "Wishart": _mv_wishart,
    "Multinomial": _mv_multinomial, "DirichletMultinomial": _mv_dirichlet_multinomial,
    "OrderedMultinomial": _mv_ordered_multinomial, "MatrixNormal": _mv_matrix_normal,
    "CAR": _mv_car, "ICAR": _mv_icar, "StickBreakingWeights": _mv_stick_breaking,
    "ZeroSumNormal": _mv_zero_sum_normal,
}


def multivariate_model(name, pm=None):
    """The small model of MULTIVARIATE_MODELS[name] in `pm`."""
    if pm is None:
        import pymc_tpu_torch as pm
    with pm.Model() as model:
        MULTIVARIATE_MODELS[name](pm)
    return model


# examples/survival_analysis.py samples 4 chains, tune 800, draws 800, seed 1
SURVIVAL_SAMPLE_KWARGS = dict(chains=4, tune=800, draws=800, random_seed=1)
# chip_smoke.py phase 15a's: 64 chains in lock-step with a pooled mass
SURVIVAL_SMOKE_KWARGS = dict(chains=64, tune=250, draws=150, random_seed=0, mass_adapt="pooled")
SURVIVAL_SCALARS = ("alpha", "b0", "b1")
# the example's true Weibull shape and log-scale regression
SURVIVAL_TRUTH = {"alpha": 1.6, "b0": 1.2, "b1": -0.6}


def survival_data(n=500, seed=7, t_end=4.0):
    """(x, observed times, censored mask, t_end) of
    `examples/survival_analysis.py:16-28`: event times Weibull(1.6) scaled
    by exp(1.2 - 0.6 x), right-censored at t_end."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, n)
    t_event = np.exp(1.2 - 0.6 * x) * rng.weibull(1.6, n)
    return x, np.minimum(t_event, t_end), t_event > t_end, t_end


def survival_model(pm=None):
    """alpha ~ Gamma(2, 1), b0, b1 ~ Normal(0, 2); t ~ Censored(Weibull(
    alpha, exp(b0 + b1 x)), upper=4) on `survival_data()`
    (`examples/survival_analysis.py:30-40`). 3 free values."""
    if pm is None:
        import pymc_tpu_torch as pm
    x, observed_t, _, t_end = survival_data()
    with pm.Model() as model:
        alpha = pm.Gamma("alpha", alpha=2.0, beta=1.0)
        b0 = pm.Normal("b0", 0.0, 2.0)
        b1 = pm.Normal("b1", 0.0, 2.0)
        lam = pm.math.exp(b0 + b1 * x)
        pm.Censored("t", pm.Weibull.dist(alpha=alpha, beta=lam), lower=None, upper=t_end,
                    observed=observed_t)
    return model


def survival_minimum_model(pm=None):
    """`survival_model` with its likelihood written as an expression: a
    CustomDist whose `dist=` returns minimum(Weibull(alpha, lam), t_end),
    which the logprob engine derives as Censored(Weibull, upper=t_end), so
    its density is survival_model's. 3 free values."""
    if pm is None:
        import pymc_tpu_torch as pm
    x, observed_t, _, t_end = survival_data()
    with pm.Model() as model:
        alpha = pm.Gamma("alpha", alpha=2.0, beta=1.0)
        b0 = pm.Normal("b0", 0.0, 2.0)
        b1 = pm.Normal("b1", 0.0, 2.0)
        lam = pm.math.exp(b0 + b1 * x)
        pm.CustomDist("t", alpha, lam, observed=observed_t,
                      dist=lambda a, l, size: pm.math.minimum(pm.Weibull.dist(a, l, size=size),
                                                              t_end))
    return model


# examples/stochastic_volatility.py samples 4 chains, tune 1000, draws 1000,
# seed 1, at target_accept 0.95
SV_SAMPLE_KWARGS = dict(chains=4, tune=1000, draws=1000, random_seed=1, target_accept=0.95)
# chip_smoke.py phase 15b's: lock-step chains pay for the deepest tree of
# any chain at every draw (some 270 leapfrogs at 8 chains on the H100, 0.35
# ms each), so 8 chains and a short run; at tune 300 the R-hats of
# step_sigma / h read 1.208 / 1.049 at 350 draws, 1.117 / 1.035 at 450,
# 1.072 / 1.023 at 500 and 1.061 / 1.016 at 600 (PERF.md §6)
SV_SMOKE_KWARGS = dict(chains=8, tune=300, draws=500, random_seed=0, target_accept=0.95,
                       mass_adapt="pooled")
SV_SCALARS = ("step_sigma", "nu")


def stochastic_volatility_data(T=200, seed=8):
    """(returns, true log-volatility) of `examples/stochastic_volatility.py:
    14-17`: a Gaussian random walk h with steps of sd 0.12 from -1, and
    Student-t(6) returns scaled by exp(h)."""
    rng = np.random.default_rng(seed)
    true_h = np.cumsum(rng.normal(0, 0.12, T)) - 1.0
    returns = rng.standard_t(6, T) * np.exp(true_h)
    return returns, true_h


def stochastic_volatility_model(pm=None):
    """step_sigma ~ Exponential(10), nu ~ Exponential(0.1); h ~
    GaussianRandomWalk(0, step_sigma, 199 steps, init Normal(0, 1)); vol =
    exp(h); r ~ StudentT(nu, 0, vol) on `stochastic_volatility_data()`
    (`examples/stochastic_volatility.py:19-27`). 202 free values."""
    if pm is None:
        import pymc_tpu_torch as pm
    returns, _ = stochastic_volatility_data()
    T = len(returns)
    with pm.Model() as model:
        step_sigma = pm.Exponential("step_sigma", 10.0)
        nu = pm.Exponential("nu", 0.1)
        h = pm.GaussianRandomWalk("h", mu=0.0, sigma=step_sigma, steps=T - 1,
                                  init_dist=pm.Normal.dist(0.0, 1.0))
        vol = pm.Deterministic("vol", pm.math.exp(h))
        pm.StudentT("r", nu=nu, mu=0.0, sigma=vol, observed=returns)
    return model


TS_COV = np.array([[1.0, 0.3], [0.3, 0.5]])
# short observed series: three of eight steps
TS_OBS = np.random.default_rng(5).normal(0.0, 1.0, size=(3, 8)).cumsum(-1) * 0.3


def _ts_random_walk(pm, mu, s, sde_fn):
    pm.RandomWalk("x", innovation_dist=pm.Laplace.dist(mu, s),
                  init_dist=pm.Normal.dist(0.0, 2.0), steps=6)
    pm.RandomWalk("y", innovation_dist=pm.Normal.dist(mu, s),
                  init_dist=pm.Normal.dist(0.0, 2.0), observed=TS_OBS)


def _ts_gaussian_random_walk(pm, mu, s, sde_fn):
    pm.GaussianRandomWalk("x", mu=mu, sigma=s, init_dist=pm.Normal.dist(0.0, 2.0), steps=6)
    pm.GaussianRandomWalk("y", mu=mu, sigma=s, init_dist=pm.Normal.dist(mu, 2.0),
                          observed=TS_OBS)


def _ts_mv_gaussian_random_walk(pm, mu, s, sde_fn):
    # one Cholesky a logp+grad: x's innovation covariance; the inits and
    # y's innovations come as factors
    m2 = pm.Normal("m2", 0.0, 1.0, shape=2)
    pm.MvGaussianRandomWalk("x", mu=m2, cov=TS_COV, steps=5,
                            init_dist=pm.MvNormal.dist(np.zeros(2), chol=np.eye(2)))
    pm.MvGaussianRandomWalk("y", mu=m2, chol=np.linalg.cholesky(TS_COV),
                            init_dist=pm.MvNormal.dist(np.zeros(2), chol=np.eye(2)),
                            observed=TS_OBS.reshape(4, 3, 2))


def _ts_mv_student_t_random_walk(pm, mu, s, sde_fn):
    nu = pm.Gamma("nu", 4.0, 1.0)
    pm.MvStudentTRandomWalk("x", nu=nu, mu=np.zeros(2), scale=TS_COV, steps=5,
                            init_dist=pm.MvNormal.dist(np.zeros(2), cov=TS_COV))


def _ts_ar(pm, mu, s, sde_fn):
    rho = pm.Normal("rho", 0.0, 0.4, shape=2)
    pm.AR("x", rho=rho, sigma=s, init_dist=pm.Normal.dist(0.0, 1.0, shape=(2,)), steps=6)
    pm.AR("y", rho=rho, sigma=s, init_dist=pm.Normal.dist(0.0, 1.0, shape=(2,)),
          observed=TS_OBS)


def _ts_ar_constant(pm, mu, s, sde_fn):
    rho = pm.Normal("rho", 0.0, 0.4, shape=2)
    pm.AR("x", rho=rho, sigma=s, constant=True, init_dist=pm.Normal.dist(0.0, 1.0), steps=6)
    pm.AR("z", rho=rho, sigma=s, constant=True, ar_order=1,
          init_dist=pm.MvNormal.dist(np.zeros(1), cov=np.eye(1)), observed=TS_OBS)


def _ts_garch11(pm, mu, s, sde_fn):
    a1 = pm.Beta("a1", 2.0, 5.0)
    b1 = pm.Beta("b1", 2.0, 3.0)
    pm.GARCH11("x", omega=s, alpha_1=a1, beta_1=b1, initial_vol=1.2, steps=9)
    pm.GARCH11("y", omega=s, alpha_1=a1, beta_1=b1, initial_vol=0.8, observed=TS_OBS)


def _ts_euler_maruyama(pm, mu, s, sde_fn):
    k = pm.HalfNormal("k", 1.0)
    pm.EulerMaruyama("x", dt=0.1, sde_fn=sde_fn, sde_pars=(k,),
                     init_dist=pm.Normal.dist(0.0, 1.0), steps=7)
    pm.EulerMaruyama("y", dt=0.1, sde_fn=sde_fn, sde_pars=(k,),
                     init_dist=pm.Normal.dist(mu, 1.0), observed=TS_OBS)


TIMESERIES_MODELS = {
    "RandomWalk": _ts_random_walk,
    "GaussianRandomWalk": _ts_gaussian_random_walk,
    "MvGaussianRandomWalk": _ts_mv_gaussian_random_walk,
    "MvStudentTRandomWalk": _ts_mv_student_t_random_walk,
    "AR": _ts_ar,
    "AR constant": _ts_ar_constant,
    "GARCH11": _ts_garch11,
    "EulerMaruyama": _ts_euler_maruyama,
}


def timeseries_model(name, pm=None, sde_fn=None):
    """mu ~ Normal(0, 1), s ~ HalfNormal(1), and the class `name` of
    TIMESERIES_MODELS as a free variable whose parameters are free
    variables, and (all but MvStudentTRandomWalk) as observed data whose
    shape gives the steps. EulerMaruyama's sde_fn (x, k) -> (f, g) defaults
    to dx = -k tanh(x) dt + (0.3 + 0.1 x^2) dW through `pm.math`."""
    if pm is None:
        import pymc_tpu_torch as pm
    if sde_fn is None:
        def sde_fn(x, k):
            return -k * pm.math.tanh(x), 0.3 + 0.1 * x**2
    with pm.Model() as model:
        mu = pm.Normal("mu", 0.0, 1.0)
        s = pm.HalfNormal("s", 1.0)
        TIMESERIES_MODELS[name](pm, mu, s, sde_fn)
    return model


# the radon GLM's scalars, as tests/data/torch_radon_reference.json holds them
RADON_SCALARS = ("mu_a", "mu_b", "sigma_a", "sigma_b", "sigma_y")


def _normal_logp_by_hand(pm):
    """logp(value, mu, sigma) of a Normal, written out with `pm.math` so
    that either package evaluates it on its own arrays."""
    half_log_2pi = 0.5 * np.log(2.0 * np.pi)

    def logp(value, mu, sigma):
        return -0.5 * ((value - mu) / sigma) ** 2 - pm.math.log(sigma) - half_log_2pi

    return logp


def _radon_glm(pm, likelihood):
    """`bench.build_model`'s radon GLM (the same data, priors and 175 free
    values) in the current model, its likelihood `likelihood(mu_y,
    sigma_y, log_radon)`."""
    county, floor_x, log_radon = radon_data()
    mu_a = pm.Normal("mu_a", 0.0, 10.0)
    sigma_a = pm.HalfCauchy("sigma_a", 5.0)
    mu_b = pm.Normal("mu_b", 0.0, 10.0)
    sigma_b = pm.HalfCauchy("sigma_b", 5.0)
    a_t = pm.Normal("a_t", 0.0, 1.0, dims="county")
    b_t = pm.Normal("b_t", 0.0, 1.0, dims="county")
    a = pm.Deterministic("a", mu_a + sigma_a * a_t, dims="county")
    b = pm.Deterministic("b", mu_b + sigma_b * b_t, dims="county")
    sigma_y = pm.HalfCauchy("sigma_y", 5.0)
    likelihood(a[county] + b[county] * floor_x, sigma_y, log_radon)


def radon_custom_model(pm=None, name="radon"):
    """`bench.build_model`'s radon GLM inside `pm.Model(name=name)`, so
    every name carries "radon::", with its likelihood a CustomDist whose
    logp is the Normal log-density written by hand."""
    if pm is None:
        import pymc_tpu_torch as pm
    with pm.Model(name=name, coords={"county": np.arange(85)}) as model:
        _radon_glm(pm, lambda mu_y, sigma_y, log_radon: pm.CustomDist(
            "y", mu_y, sigma_y, logp=_normal_logp_by_hand(pm), observed=log_radon))
    return model


def radon_lognormal_model(pm=None):
    """`bench.build_model`'s radon GLM with its likelihood a CustomDist
    derived from exp of a Normal (`dist=`), observed on exp(log_radon): the
    lognormal density of the radon levels is the Normal one of their logs
    less sum(log y), a constant, so the posterior is the radon GLM's.
    Either package builds it (`pm`)."""
    if pm is None:
        import pymc_tpu_torch as pm
    with pm.Model(coords={"county": np.arange(85)}) as model:
        _radon_glm(pm, lambda mu_y, sigma_y, log_radon: pm.CustomDist(
            "y", mu_y, sigma_y,
            dist=lambda mu, s, size: pm.math.exp(pm.Normal.dist(mu, s, size=size)),
            observed=np.exp(log_radon)))
    return model


# examples/abc_simulator.py: sample_smc's draws and chains, and the seeds of
# the fixture's runs
ABC_SMC_KWARGS = dict(draws=1000, chains=2)
ABC_SEEDS = (0, 1, 2, 3, 4)


def abc_data(n=200, seed=1):
    """The example's 200 observations of Normal(1.5, 1)
    (`examples/abc_simulator.py:6`)."""
    return np.random.default_rng(seed).normal(1.5, 1.0, n)


def abc_simulate(rng, mu):
    """The example's simulation, `mu + N(0, 1)` of 200 values, drawn from
    the torch.Generator `rng` on mu's device (the example's `simulate(key,
    mu)`)."""
    import torch

    return mu + torch.randn(200, generator=rng, dtype=mu.dtype, device=mu.device)


def abc_simulator_model(pm=None, simulate=abc_simulate):
    """mu ~ Normal(0, 3); Simulator(simulate, mu, sum_stat="sort",
    epsilon=0.5) observed on `abc_data()` (`examples/abc_simulator.py:
    11-14`); `simulate` is the package's own (the JAX package's takes a
    key)."""
    if pm is None:
        import pymc_tpu_torch as pm
    with pm.Model() as model:
        mu = pm.Normal("mu", 0, 3)
        pm.Simulator("s", simulate, mu, sum_stat="sort", epsilon=0.5, observed=abc_data())
    return model


DERIVED_SCALARS = ("mu", "sigma")
# the fixture's run (pymc_tpu on the CPU in float64) and chip_smoke.py
# phase 16c's: 64 chains in lock-step with a pooled mass
DERIVED_SAMPLE_KWARGS = dict(chains=16, tune=1000, draws=1000, random_seed=0,
                             mass_adapt="pooled")
DERIVED_SMOKE_KWARGS = dict(chains=64, tune=200, draws=200, random_seed=0, mass_adapt="pooled")


def derived_data(seed=11):
    """(60 measurements of Normal(2.3, 1.4) rounded to integers, the
    maxima of 40 groups of 5 draws of it)."""
    rng = np.random.default_rng(seed)
    rounded = np.round(rng.normal(2.3, 1.4, 60))
    maxima = rng.normal(2.3, 1.4, size=(40, 5)).max(axis=1)
    return rounded, maxima


def derived_model(pm=None):
    """mu ~ Normal(0, 5), sigma ~ HalfNormal(3); the rounded measurements
    ~ Discretized(Normal(mu, sigma), "round") and the group maxima ~
    Max(Normal(mu, sigma), 5), on `derived_data()`. 2 free values."""
    if pm is None:
        import pymc_tpu_torch as pm
    rounded, maxima = derived_data()
    with pm.Model() as model:
        mu = pm.Normal("mu", 0.0, 5.0)
        sigma = pm.HalfNormal("sigma", 3.0)
        pm.Discretized("y_round", pm.Normal.dist(mu, sigma), "round", observed=rounded)
        pm.Max("y_max", pm.Normal.dist(mu, sigma), 5, observed=maxima)
    return model


def _slice_discretized(pm, method):
    mu = pm.Normal("mu", 0.0, 1.0)
    sigma = pm.HalfNormal("sigma", 1.0)
    pm.Discretized("y", pm.Normal.dist(mu, sigma), method,
                   observed=np.array([-2.0, -1.0, 0.0, 0.0, 1.0, 2.0, 3.0]))


def _slice_order_statistic(pm, kind):
    mu = pm.Normal("mu", 0.0, 1.0)
    sigma = pm.HalfNormal("sigma", 1.0)
    x = np.array([-0.8, 0.1, 0.4, 1.3, 2.1])
    if kind == "Max":
        pm.Max("y", pm.Normal.dist(mu, sigma), 4, observed=x)
    elif kind == "Min":
        pm.Min("y", pm.Normal.dist(mu, sigma), 4, observed=x)
    elif kind == "rank":
        pm.OrderStatistic("y", pm.Gumbel.dist(mu, sigma), 5, 2, observed=x)
    else:  # the discrete maximum and minimum
        lam = pm.Gamma("lam", 2.0, 1.0)
        pm.Max("y_max", pm.Poisson.dist(lam), 3, observed=np.array([1, 2, 4, 3]))
        pm.Min("y_min", pm.Poisson.dist(lam), 3, observed=np.array([0, 1, 1, 2]))


def _slice_cumsum(pm):
    mu = pm.Normal("mu", 0.0, 1.0)
    walk = pm.CumSum("walk", pm.Normal.dist(mu, 1.0, shape=(6,)))
    pm.Normal("y", walk, 0.5, observed=np.array([0.3, 0.1, 0.9, 1.4, 1.2, 2.0]))


def _slice_compared(pm):
    mu = pm.Normal("mu", 0.0, 1.0)
    sigma = pm.HalfNormal("sigma", 1.0)
    lam = pm.Gamma("lam", 2.0, 1.0)
    pm.Compared("above", pm.Normal.dist(mu, sigma), 0.5, ">", observed=np.array([1, 0, 1, 1, 0]))
    pm.Compared("below", pm.Normal.dist(mu, sigma), -0.2, "<=", observed=np.array([0, 1, 0]))
    pm.Compared("at_least", pm.Poisson.dist(lam), 2, ">=", observed=np.array([1, 1, 0, 1]))
    pm.Compared("less", pm.Poisson.dist(lam), 1, "<", observed=np.array([0, 1, 0]))


def _slice_mixture_logcdf(pm):
    """A censored mixture: its logp reads the mixture's logcdf, of a list
    of components and of one batched component."""
    w = pm.Dirichlet("w", np.ones(2))
    mu = pm.Normal("mu", np.array([-1.0, 1.0]), 1.0, transform=pm.distributions.transforms.ordered)
    x = np.array([-1.7, -0.4, 0.2, 1.1, 1.5, 2.0, 2.0])
    pm.Censored("y_list", pm.Mixture.dist(w, [pm.Normal.dist(mu[0], 0.7),
                                              pm.Normal.dist(mu[1], 0.7)]),
                lower=None, upper=2.0, observed=x)
    pm.Censored("y_batched", pm.Mixture.dist(w, pm.Normal.dist(mu, 0.7)),
                lower=-1.5, upper=None, observed=np.maximum(x, -1.5))


def _slice_custom_signature(pm):
    """A multivariate CustomDist given by `signature=`: each row's
    independent Normal log-density, summed over its last axis by hand."""
    mu = pm.Normal("mu", 0.0, 1.0, shape=3)
    sd = pm.HalfNormal("sd", 1.0)

    def logp(value, mu, sd):
        z = (value - mu) / sd
        return pm.math.sum(-0.5 * z * z - pm.math.log(sd) - 0.5 * np.log(2.0 * np.pi), axis=-1)

    pm.CustomDist("rows", mu, sd, logp=logp, signature="(n),()->(n)",
                  observed=np.array([[0.2, -0.5, 1.0], [0.4, 0.1, 0.7]]))


def _slice_custom_dist(pm):
    """A CustomDist whose `dist=` returns a distribution, free and
    observed."""
    mu = pm.Normal("mu", 0.0, 1.0)
    sigma = pm.HalfNormal("sigma", 1.0)
    pm.CustomDist("z", mu, dist=lambda mu, size: pm.Normal.dist(mu, 1.0, size=size))
    pm.CustomDist("y", mu, sigma,
                  dist=lambda mu, sigma, size: pm.LogNormal.dist(mu, sigma, size=size),
                  observed=np.array([0.5, 1.2, 2.4]))


def _slice_bessel(pm):
    """Bessel functions in a Potential: log K_1.5(x) + log I_2.5(x) and
    I_-1.5(x) on a positive x."""
    x = pm.Gamma("x", 3.0, 1.0)
    pm.Potential("bessel", pm.math.log(pm.math.kv(1.5, x)) + pm.math.log(pm.math.iv(2.5, x))
                 + 0.1 * pm.math.iv(-1.5, x))


# one small model for each class and form of the CustomDist / derived /
# Bessel slice, for chip_smoke.py phase 16d and the tests
SLICE_MODELS = {
    **{f"Discretized {m}": (lambda pm, m=m: _slice_discretized(pm, m))
       for m in ("round", "floor", "ceil", "trunc")},
    "Max": lambda pm: _slice_order_statistic(pm, "Max"),
    "Min": lambda pm: _slice_order_statistic(pm, "Min"),
    "OrderStatistic rank 2 of 5": lambda pm: _slice_order_statistic(pm, "rank"),
    "Max and Min of Poisson": lambda pm: _slice_order_statistic(pm, "discrete"),
    "CumSum": _slice_cumsum,
    "Compared": _slice_compared,
    "Mixture.logcdf": _slice_mixture_logcdf,
    "CustomDist signature": _slice_custom_signature,
    "CustomDist dist=": _slice_custom_dist,
    "bessel": _slice_bessel,
}


def slice_model(name, pm=None):
    """The model of SLICE_MODELS[name], built with `pm`."""
    if pm is None:
        import pymc_tpu_torch as pm
    with pm.Model() as model:
        SLICE_MODELS[name](pm)
    return model


def _structural_data(name):
    """Seeded observations of `structural_model(name)`."""
    rng = np.random.default_rng(18)
    if name == "censoring":
        return np.clip(rng.normal(0.3, 1.0, 40), -1.0, 1.5)
    if name == "join":
        x = rng.normal(0.3, 1.0, 20)
        return np.stack([x, rng.normal(x, 0.5)])
    if name == "switch mixture":
        return np.where(STRUCTURAL_MASK, rng.normal(0.3, 1.0, 30), rng.exponential(0.5, 30))
    return STRUCTURAL_A @ rng.normal(0.3, 1.0, (2, 10))


# the switch mixture's RV-free condition and the matmul's matrix
STRUCTURAL_MASK = np.random.default_rng(19).random(30) < 0.4
STRUCTURAL_A = np.array([[2.0, 0.5], [0.3, 1.5]])


def _structural_dist(pm, name):
    """The `dist=` of `structural_model(name)`: a structural form of
    `.dist()` objects in mu and s."""
    if name == "censoring":
        return lambda m, s, size: pm.math.clip(pm.Normal.dist(m, s, size=40), -1.0, 1.5)
    if name == "join":
        def join(m, s, size):
            first = pm.Normal.dist(m, s, size=20).to_node()
            return pm.math.stack([first, pm.Normal.dist(first, 0.5)])

        return join
    if name == "switch mixture":
        return lambda m, s, size: pm.math.where(STRUCTURAL_MASK, pm.Normal.dist(m, s, size=30),
                                                pm.Exponential.dist(2.0, size=30))
    return lambda m, s, size: STRUCTURAL_A @ pm.Normal.dist(m, s, size=(2, 10))


# chip_smoke.py phase 18b's models: a likelihood of each of these forms
STRUCTURAL_MODELS = ("censoring", "join", "switch mixture", "matmul")


def structural_model(name, pm=None):
    """mu ~ Normal(0, 1), s ~ HalfNormal(1); y ~ CustomDist(mu, s, dist=)
    of the structural form `name` of STRUCTURAL_MODELS (a clip, a stack
    with a dependent component, a switch mixture, A @ X) on seeded data. 2
    free values."""
    if pm is None:
        import pymc_tpu_torch as pm
    with pm.Model() as model:
        mu = pm.Normal("mu", 0.0, 1.0)
        s = pm.HalfNormal("s", 1.0)
        pm.CustomDist("y", mu, s, dist=_structural_dist(pm, name),
                      observed=_structural_data(name))
    return model
