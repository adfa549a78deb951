"""PSIS-LOO-CV, WAIC, and model comparison.

Parity: the reference delegates these to arviz (`pymc/stats/__init__.py`
__getattr__ -> arviz_stats: loo, waic, compare). arviz is not a dependency
here, so the estimators are implemented natively:

- PSIS-LOO: Vehtari, Gelman & Gabry (2017) "Practical Bayesian model
  evaluation using leave-one-out cross-validation and WAIC"; Pareto-smoothed
  importance sampling with the Zhang & Stephens (2009) GPD fit.
- WAIC: Watanabe (2010), elpd form with p_waic = posterior variance of the
  pointwise log-likelihood.
- compare(): stacking weights (Yao et al. 2018) on pointwise elpds.

All heavy lifting is host-side numpy on the (chain, draw, *obs) pointwise
log-likelihood already produced on-device by `compute_log_likelihood`.

A copy of `pymc_tpu/stats/model_comparison.py` (numpy and scipy; pandas
inside `compare`, as there), over the port's log_density.py and
convergence.py.
"""

from __future__ import annotations

import logging

import numpy as np

__all__ = ["loo", "waic", "compare", "ELPDData"]

_log = logging.getLogger("pymc_tpu_torch")


class ELPDData:
    """Result of loo()/waic(): elpd estimate, standard error, effective
    number of parameters, and pointwise values."""

    def __init__(self, kind, elpd, se, p, n_samples, n_data_points,
                 pointwise=None, pareto_k=None, warning=False):
        self.kind = kind
        self.elpd = float(elpd)
        self.se = float(se)
        self.p = float(p)
        self.n_samples = int(n_samples)
        self.n_data_points = int(n_data_points)
        self.pointwise = pointwise
        self.pareto_k = pareto_k
        self.warning = bool(warning)

    # arviz-compatible attribute aliases (elpd_loo / elpd_waic / p_loo ...)
    def __getattr__(self, name):
        kind = object.__getattribute__(self, "kind")
        if name == f"elpd_{kind}":
            return self.elpd
        if name == f"p_{kind}":
            return self.p
        if name == f"elpd_{kind}_i":
            return self.pointwise
        raise AttributeError(name)

    def __repr__(self):
        lines = [
            f"Computed from {self.n_samples} posterior samples and "
            f"{self.n_data_points} observations log-likelihood matrix.",
            "",
            f"{'':>12} Estimate       SE",
            f"elpd_{self.kind:<7} {self.elpd:8.2f}  {self.se:7.2f}",
            f"p_{self.kind:<10} {self.p:8.2f}        -",
        ]
        if self.pareto_k is not None:
            k = np.asarray(self.pareto_k)
            n_bad = int((k > 0.7).sum())
            lines.append("")
            lines.append(
                f"Pareto k diagnostic: {n_bad}/{k.size} observations with "
                f"k > 0.7" + (" (unreliable)" if n_bad else " (all good)")
            )
        return "\n".join(lines)


def _get_log_likelihood(idata, var_name=None, model=None):
    """(S, N) pointwise log-likelihood matrix from idata (computing the
    group on demand if the model is available)."""
    if not hasattr(idata, "log_likelihood"):
        from .log_density import compute_log_likelihood

        compute_log_likelihood(idata, model=model, progressbar=False)
    ll = idata.log_likelihood
    names = [var_name] if var_name is not None else list(ll.keys())
    mats = []
    for n in names:
        v = np.asarray(ll[n].values, dtype=np.float64)  # (C, D, *obs)
        C, D = v.shape[:2]
        mats.append(v.reshape(C * D, -1))
    return np.concatenate(mats, axis=1)  # (S, N)


def _gpdfit(x):
    """Generalized-Pareto (k, sigma) fit to exceedances `x` (ascending),
    Zhang & Stephens (2009) quasi-Bayesian profile estimator as used by
    Vehtari et al. (2017) appendix C."""
    n = x.size
    prior_bs, prior_k = 3.0, 10.0
    m = 30 + int(np.sqrt(n))
    b = 1.0 - np.sqrt(m / (np.arange(1, m + 1) - 0.5))
    b /= prior_bs * x[int(n / 4 + 0.5) - 1]
    b += 1.0 / x[-1]
    k = np.log1p(-b[:, None] * x[None, :]).mean(axis=1)  # negative
    L = n * (np.log(-(b / k)) - k - 1.0)
    # softmax of profile likelihoods, logsumexp-stabilized: widely separated
    # L values overflowed the naive 1/sum(exp(L-L')) form
    w = np.exp(L - L.max())
    w /= w.sum()
    b_post = (b * w).sum()
    k_post = np.log1p(-b_post * x).mean()
    # sigma from the raw k (before regularization: the weak prior pulling k
    # toward 0.5 can flip its sign, which would make sigma negative)
    sigma = -k_post / b_post
    k_post = (n * k_post + prior_k * 0.5) / (n + prior_k)
    return k_post, sigma


def _gpinv(p, k, sigma):
    """Inverse CDF of the generalized Pareto (location 0)."""
    p = np.asarray(p)
    if abs(k) < 1e-15:
        x = -np.log1p(-p)
    else:
        x = np.expm1(-k * np.log1p(-p)) / k
    return sigma * x


def _psislw(log_ratios, reff=1.0):
    """Pareto-smoothed log importance weights for ONE observation.

    log_ratios: (S,) log of raw importance ratios (-log p(y_i|theta_s) for
    LOO). Returns (smoothed normalized log-weights, k-hat).
    """
    S = log_ratios.size
    lw = log_ratios - log_ratios.max()
    M = int(min(S / 5.0, 3.0 * np.sqrt(S / reff)))
    if M < 5:
        return lw - _logsumexp(lw), -np.inf
    srt = np.argsort(lw)
    tail_ids = srt[S - M:]
    cutoff = lw[srt[S - M - 1]]
    tail = lw[tail_ids]
    exceed = np.exp(tail) - np.exp(cutoff)
    if np.ptp(exceed) <= 0:
        return lw - _logsumexp(lw), -np.inf
    k, sigma = _gpdfit(np.sort(exceed))
    if np.isfinite(k):
        # replace tail by expected GPD order statistics
        probs = (np.arange(1, M + 1) - 0.5) / M
        smoothed = np.log(_gpinv(probs, k, sigma) + np.exp(cutoff))
        # keep original order within the tail
        order = np.argsort(np.argsort(tail))
        lw = lw.copy()
        lw[tail_ids] = np.minimum(smoothed[order], 0.0)
    return lw - _logsumexp(lw), k


def _logsumexp(a, axis=None):
    amax = np.max(a, axis=axis, keepdims=True)
    out = np.log(np.sum(np.exp(a - amax), axis=axis)) + np.squeeze(amax, axis)
    return out if axis is not None else float(out)


def loo(idata, pointwise=False, var_name=None, model=None, reff=None):
    """PSIS-LOO-CV expected log pointwise predictive density.

    Parity: arviz-delegated `pm.stats.loo` (reference stats/__init__.py).
    """
    ll = _get_log_likelihood(idata, var_name=var_name, model=model)  # (S, N)
    S, N = ll.shape
    if reff is None:
        if hasattr(idata, "posterior"):
            C = np.asarray(
                idata.log_likelihood[
                    list(idata.log_likelihood.keys())[0]
                ].values
            ).shape[0]
            reff = _relative_eff(ll, C) if C > 1 else 1.0
        else:
            reff = 1.0

    elpd_i = np.empty(N)
    ks = np.empty(N)
    for i in range(N):
        lw, k = _psislw(-ll[:, i], reff)
        elpd_i[i] = _logsumexp(lw + ll[:, i])
        ks[i] = k
    lpd_i = np.array([_logsumexp(ll[:, i]) - np.log(S) for i in range(N)])
    p_loo = float(np.sum(lpd_i - elpd_i))
    elpd = float(elpd_i.sum())
    se = float(np.sqrt(N * np.var(elpd_i)))
    warn = bool((ks > 0.7).any())
    if warn:
        _log.warning(
            f"{int((ks > 0.7).sum())}/{N} Pareto k estimates > 0.7: PSIS-LOO "
            "may be unreliable for these observations"
        )
    return ELPDData(
        "loo", elpd, se, p_loo, S, N,
        pointwise=elpd_i,
        pareto_k=ks, warning=warn,
    )


def _relative_eff(ll, n_chains):
    """Mean relative ESS of the pointwise log-likelihood draws."""
    from .convergence import ess

    S, N = ll.shape
    D = S // n_chains
    sub = ll[:, : min(N, 50)]  # cap the diagnostic cost
    vals = sub.reshape(n_chains, D, -1).transpose(0, 1, 2)
    e = ess(vals)
    return float(np.clip(np.nanmean(e) / S, 1e-3, 1.0))


def waic(idata, pointwise=False, var_name=None, model=None):
    """Widely-applicable information criterion (elpd form).

    Parity: arviz-delegated `pm.stats.waic`.
    """
    ll = _get_log_likelihood(idata, var_name=var_name, model=model)
    S, N = ll.shape
    lpd_i = _logsumexp(ll, axis=0) - np.log(S)
    p_i = np.var(ll, axis=0, ddof=1)
    if (p_i > 0.4).any():
        _log.warning(
            f"{int((p_i > 0.4).sum())}/{N} p_waic values > 0.4: WAIC may be "
            "unreliable; prefer loo()"
        )
    elpd_i = lpd_i - p_i
    return ELPDData(
        "waic", float(elpd_i.sum()),
        float(np.sqrt(N * np.var(elpd_i))), float(p_i.sum()), S, N,
        pointwise=elpd_i, warning=bool((p_i > 0.4).any()),
    )


def _stacking_weights(elpd_mat):
    """Log-score stacking weights (Yao et al. 2018). elpd_mat: (N, K)."""
    from scipy import optimize

    N, K = elpd_mat.shape
    # work with exp of centered pointwise elpds for stability
    z = elpd_mat - elpd_mat.max(axis=1, keepdims=True)
    ez = np.exp(z)

    def neg_score(theta):
        w = np.concatenate([theta, [1.0 - theta.sum()]])
        mix = ez @ w
        return -np.sum(np.log(np.maximum(mix, 1e-300)))

    def grad(theta):
        w = np.concatenate([theta, [1.0 - theta.sum()]])
        mix = np.maximum(ez @ w, 1e-300)
        g_full = -(ez / mix[:, None]).sum(axis=0)
        return g_full[:-1] - g_full[-1]

    theta0 = np.full(K - 1, 1.0 / K)
    cons = [{"type": "ineq", "fun": lambda t: 1.0 - t.sum()}]
    bounds = [(0.0, 1.0)] * (K - 1)
    res = optimize.minimize(
        neg_score, theta0, jac=grad, bounds=bounds, constraints=cons,
        method="SLSQP",
    )
    w = np.concatenate([res.x, [1.0 - res.x.sum()]])
    return np.clip(w, 0.0, 1.0) / max(np.clip(w, 0.0, 1.0).sum(), 1e-12)


def compare(compare_dict, ic="loo", method="stacking", model_dict=None):
    """Rank models by out-of-sample predictive accuracy.

    Parity: arviz-delegated `pm.stats.compare`. Returns a pandas DataFrame
    with rank, elpd, p, elpd_diff, weight, se, dse, warning.
    """
    import pandas as pd

    ic_fn = loo if ic == "loo" else waic
    results = {}
    for name, idata in compare_dict.items():
        mdl = (model_dict or {}).get(name)
        results[name] = ic_fn(idata, pointwise=True, model=mdl)

    names = sorted(results, key=lambda n: results[n].elpd, reverse=True)
    best = results[names[0]]
    elpd_mat = np.stack(
        [results[n].pointwise for n in names], axis=1
    )  # (N, K)
    if method == "stacking" and len(names) > 1:
        weights = _stacking_weights(elpd_mat)
    else:  # pseudo-BMA
        e = np.array([results[n].elpd for n in names])
        w = np.exp(e - e.max())
        weights = w / w.sum()

    rows = []
    for rank, n in enumerate(names):
        r = results[n]
        diff = best.pointwise - r.pointwise
        dse = float(np.sqrt(len(diff) * np.var(diff))) if rank else 0.0
        rows.append({
            "rank": rank, f"elpd_{ic}": r.elpd, f"p_{ic}": r.p,
            "elpd_diff": float(diff.sum()), "weight": float(weights[rank]),
            "se": r.se, "dse": dse, "warning": r.warning,
        })
    return pd.DataFrame(rows, index=names)
