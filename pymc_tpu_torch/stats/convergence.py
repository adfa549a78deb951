"""Convergence diagnostics: rank-normalized split-R-hat, bulk/tail ESS, MCSE.

Parity: reference pymc/stats/convergence.py:64-133 (run_convergence_checks
delegates R-hat/ESS to arviz_stats). Here the estimators themselves are
implemented natively (Vehtari, Gelman, Simpson, Carpenter, Bürkner 2021),
numpy on host — they run once per fit on (chain, draw, ...) arrays.

A copy of `pymc_tpu/stats/convergence.py` (numpy and scipy only): the JAX
package cannot be imported where the port runs, because its `__init__`
imports jax. Two changes (ROADMAP.md §3): tied values get the mean of
their ranks before the normal scores, as Vehtari et al. (2021) and arviz
rank them (the JAX package ranks ties by position, which makes R-hat and
ESS of a discrete variable read badly even on independent draws: 64 x
4000 iid Poisson(1.29) draws give R-hat 1.099 and bulk ESS 745 by
position); and R-hat and ESS leave a (chain, draw) float64 input as it
was (the JAX package's overwrite it with its normal scores).
"""

from __future__ import annotations

import dataclasses
import enum
import logging

import numpy as np
from scipy.special import ndtri

__all__ = [
    "rhat",
    "ess",
    "mcse_mean",
    "mcse_sd",
    "time_to_rhat",
    "grad_evals_per_sec",
    "SamplerWarning",
    "WarningType",
    "run_convergence_checks",
    "log_warnings",
]

_log = logging.getLogger("pymc_tpu_torch")


def _split_chains(x):
    """(chain, draw, ...) -> (2*chain, draw//2, ...)"""
    c, n = x.shape[:2]
    half = n // 2
    first = x[:, :half]
    second = x[:, n - half : n]
    return np.concatenate([first, second], axis=0)


def _normal_scores(row, lut):
    """Write the normal scores ndtri((r - 3/8)/(s + 1/4)) of `row`'s ranks
    into `row` in place. Without ties the ranks are the integers 1..s, whose
    scores `lut` holds, scattered through one sort order; tied values share
    the mean of their ranks."""
    s = row.shape[0]
    order = np.argsort(row, kind="stable")
    ordered = row[order]
    first = np.empty(s, dtype=bool)
    first[0] = True
    np.not_equal(ordered[1:], ordered[:-1], out=first[1:])
    if first.all():
        row[order] = lut
        return
    starts = np.flatnonzero(first)
    ends = np.append(starts[1:], s)
    mean_rank = (starts + 1 + ends) / 2.0
    row[order] = ndtri((mean_rank - 3.0 / 8.0) / (s + 1.0 / 4.0))[np.cumsum(first) - 1]


def _rank_normalize(x):
    """Fractional ranks -> normal scores over (chain, draw) jointly, ties
    at their mean rank. The ranks of an s-sample without ties are the
    integers 1..s, so their scores are computed ONCE as a lookup table and
    scattered through each column's sort order."""
    shp = x.shape
    flat = x.reshape(-1, int(np.prod(shp[2:])) if x.ndim > 2 else 1)
    s = flat.shape[0]
    lut = ndtri((np.arange(1, s + 1) - 3.0 / 8.0) / (s + 1.0 / 4.0))
    out = np.array(flat, dtype=np.float64, order="F")
    for j in range(flat.shape[1]):
        col = np.ascontiguousarray(out[:, j])
        _normal_scores(col, lut)
        out[:, j] = col
    return out.reshape(shp)


def _rhat_base(x):
    """Split R-hat on (chain, draw, ...) without rank-normalization."""
    x = _split_chains(np.asarray(x, dtype=np.float64))
    c, n = x.shape[:2]
    if n < 2 or c < 2:
        return np.full(x.shape[2:], np.nan)
    chain_mean = x.mean(axis=1)
    chain_var = x.var(axis=1, ddof=1)
    between = n * chain_mean.var(axis=0, ddof=1)
    within = chain_var.mean(axis=0)
    vhat = (n - 1.0) / n * within + between / n
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.sqrt(vhat / within)


def _to_param_major(x, C, S, K):
    """(C, S, *extra) -> private WRITABLE param-major (K, C, S) buffer.

    ascontiguousarray alone aliases the input when K == 1 (the transpose
    of a (C, S, 1) array is already C-contiguous): the in-place rank
    scatter would then write the normal scores into the caller's draws (the
    JAX package's copy does, for a writable float64 input), or crash on a
    read-only one. So an alias is copied."""
    xt = np.ascontiguousarray(x.reshape(C, S, K).transpose(2, 0, 1))
    if not xt.flags.writeable or np.shares_memory(xt, x):
        xt = xt.copy()
    return xt


def _rank_rows_inplace(xt, lut):
    """Normal scores of each contiguous (C*S,) row, in place."""
    for j in range(xt.shape[0]):
        _normal_scores(xt[j].reshape(-1), lut)


def _rhat_from_t(xt, C, S):
    """Split R-hat on param-major (K, C, S) layout (contiguous reductions)."""
    half = S // 2
    if S % 2 == 0:
        xs = xt.reshape(-1, 2 * C, half)
    else:
        xs = np.concatenate([xt[:, :, :half], xt[:, :, S - half:]], axis=2)
        xs = xs.reshape(-1, 2 * C, half)
    c, n = 2 * C, half
    if n < 2 or c < 2:
        return np.full(xt.shape[0], np.nan)
    chain_mean = xs.mean(axis=2)
    chain_var = xs.var(axis=2, ddof=1)
    between = n * chain_mean.var(axis=1, ddof=1)
    within = chain_var.mean(axis=1)
    vhat = (n - 1.0) / n * within + between / n
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.sqrt(vhat / within)


def rhat(x):
    """Rank-normalized split-R-hat: max of bulk and folded estimators
    (Vehtari et al. 2021). Same fused param-major pipeline as ESS (one
    transpose, in-place rank scatters) — minimal passes over the array."""
    x = np.asarray(x, dtype=np.float64)
    C, S = x.shape[:2]
    extra = x.shape[2:]
    K = int(np.prod(extra)) if extra else 1
    xt = _to_param_major(x, C, S, K)
    s = C * S
    lut = ndtri((np.arange(1, s + 1) - 3.0 / 8.0) / (s + 1.0 / 4.0))

    med = np.median(xt.reshape(K, -1), axis=1)  # per-param median over (c,d)
    folded_t = np.abs(xt - med[:, None, None])
    _rank_rows_inplace(folded_t, lut)
    folded = _rhat_from_t(folded_t, C, S)

    _rank_rows_inplace(xt, lut)  # xt is our private copy
    bulk = _rhat_from_t(xt, C, S)

    out = np.maximum(bulk, folded)
    return out.reshape(extra) if extra else out[0]


def _autocov_fft(x):
    """Per-chain autocovariance via FFT; x: (chain, draw, ...)."""
    c, n = x.shape[:2]
    xc = x - x.mean(axis=1, keepdims=True)
    m = 2 ** int(np.ceil(np.log2(2 * n)))
    f = np.fft.rfft(xc, n=m, axis=1)
    acov = np.fft.irfft(f * np.conj(f), n=m, axis=1)[:, :n].real
    return acov / n


def _ess_base(x):
    """Geyer initial-monotone-sequence ESS on (chain, draw, ...).

    Vectorized across the parameter axis: one batched FFT autocovariance and
    the Geyer positive-monotone pair sequence expressed as
    cumprod(pairs > 0) masking + running-minimum accumulate — identical
    results to the per-parameter loop form."""
    x = _split_chains(np.asarray(x, dtype=np.float64))
    c, n = x.shape[:2]
    if n < 4 or c < 1:
        return np.full(x.shape[2:], np.nan)
    extra = x.shape[2:]
    xf = x.reshape(c, n, -1)

    # autocovariance in param chunks: the FFT intermediates for a full-width
    # model are GBs, and on this host fresh pages fault at ~10 MB/ms; equal-
    # size chunks reuse the allocator's warm pages (first chunk pays, rest
    # run at memory speed). One up-front transpose makes the draw axis the
    # contiguous FFT axis. Only the (n, k) reductions are kept.
    k = xf.shape[2]
    xt = np.ascontiguousarray(xf.transpose(2, 0, 1))  # (k, c, n)
    kc = max(1, int(4_000_000 // max(c * n, 1)))
    mean_var = np.empty(k)
    acov_mean = np.empty((k, n))
    m = 2 ** int(np.ceil(np.log2(2 * n)))
    for j0 in range(0, k, kc):
        sl = slice(j0, min(j0 + kc, k))
        xc = xt[sl] - xt[sl].mean(axis=2, keepdims=True)
        f = np.fft.rfft(xc, n=m, axis=2)
        acov = np.fft.irfft(f * np.conj(f), n=m, axis=2)[:, :, :n].real / n
        mean_var[sl] = acov[:, :, 0].mean(axis=1) * n / (n - 1.0)
        acov_mean[sl] = acov.mean(axis=1)
    acov_mean = acov_mean.T  # (n, k)
    var_plus = mean_var * (n - 1.0) / n
    if c > 1:
        var_plus = var_plus + xt.mean(axis=2).var(axis=1, ddof=1)

    with np.errstate(invalid="ignore", divide="ignore"):
        rho = 1.0 - (mean_var[None, :] - acov_mean) / var_plus[None, :]
        # pair sums Gamma_t = rho_{2t} + rho_{2t+1} (drop a trailing odd lag)
        n_even = n - (n % 2)
        pairs = rho[0:n_even:2] + rho[1:n_even:2]  # (n_even//2, k)
        # initial positive sequence: keep until the first non-positive pair
        keep = np.cumprod(pairs > 0, axis=0).astype(bool)
        # initial monotone sequence: running minimum over kept prefix
        mono = np.minimum.accumulate(pairs, axis=0)
        pair_sum = np.where(keep, mono, 0.0).sum(axis=0)
        tau = np.maximum(-1.0 + 2.0 * pair_sum, 1.0 / np.log10(c * n + 10.0))
        out = np.where(
            np.isfinite(var_plus) & (var_plus != 0), c * n / tau, np.nan
        )
    return out.reshape(extra) if extra else out[0]


def _ess_fused(x, rank_normalize):
    """Minimal-memory-traffic ESS: ONE transpose to (K, C, S) param-major
    layout, then per-param contiguous rank scatter (in place), split-chains
    as a pure reshape (even S), and chunked contiguous FFTs. The host is a
    single vCPU with ~15 MB/s fresh-page bandwidth, so wall time is passes
    over the array — this path makes ~4 instead of ~10 (and avoids the
    85-pass strided column gather the naive layout costs)."""
    x = np.asarray(x, dtype=np.float64)
    C, S = x.shape[:2]
    extra = x.shape[2:]
    if S < 4 or C < 1:
        return np.full(extra, np.nan)
    K = int(np.prod(extra)) if extra else 1
    xt = _to_param_major(x, C, S, K)

    if rank_normalize:
        s = C * S
        lut = ndtri((np.arange(1, s + 1) - 3.0 / 8.0) / (s + 1.0 / 4.0))
        _rank_rows_inplace(xt, lut)

    half = S // 2
    if S % 2 == 0:
        xs = xt.reshape(K, 2 * C, half)
    else:
        xs = np.concatenate([xt[:, :, :half], xt[:, :, S - half:]], axis=2)
        xs = xs.reshape(K, 2 * C, half)
    c, n = 2 * C, half
    if n < 4:
        return np.full(extra, np.nan)

    kc = max(1, int(4_000_000 // max(c * n, 1)))
    mean_var = np.empty(K)
    acov_mean = np.empty((K, n))
    m = 2 ** int(np.ceil(np.log2(2 * n)))
    for j0 in range(0, K, kc):
        sl = slice(j0, min(j0 + kc, K))
        xc = xs[sl] - xs[sl].mean(axis=2, keepdims=True)
        f = np.fft.rfft(xc, n=m, axis=2)
        acov = np.fft.irfft(f * np.conj(f), n=m, axis=2)[:, :, :n].real / n
        mean_var[sl] = acov[:, :, 0].mean(axis=1) * n / (n - 1.0)
        acov_mean[sl] = acov.mean(axis=1)
    var_plus = mean_var * (n - 1.0) / n
    if c > 1:
        var_plus = var_plus + xs.mean(axis=2).var(axis=1, ddof=1)

    with np.errstate(invalid="ignore", divide="ignore"):
        rho = 1.0 - (mean_var[:, None] - acov_mean) / var_plus[:, None]
        n_even = n - (n % 2)
        pairs = rho[:, 0:n_even:2] + rho[:, 1:n_even:2]  # (K, n_even//2)
        keep = np.cumprod(pairs > 0, axis=1).astype(bool)
        mono = np.minimum.accumulate(pairs, axis=1)
        pair_sum = np.where(keep, mono, 0.0).sum(axis=1)
        tau = np.maximum(-1.0 + 2.0 * pair_sum, 1.0 / np.log10(c * n + 10.0))
        out = np.where(
            np.isfinite(var_plus) & (var_plus != 0), c * n / tau, np.nan
        )
    return out.reshape(extra) if extra else out[0]


def ess(x, method="bulk", prob=None):
    """Effective sample size (bulk by default; tail = min over the 5%/95%
    exceedance indicators; mean/sd/quantile variants supported)."""
    x = np.asarray(x, dtype=np.float64)
    if method == "bulk":
        return _ess_fused(x, rank_normalize=True)
    if method == "mean":
        return _ess_fused(x, rank_normalize=False)
    if method == "sd":
        return np.minimum(
            _ess_fused(x, rank_normalize=False),
            _ess_fused(x**2, rank_normalize=False),
        )
    if method == "tail":
        # min ESS of the 5%/95% quantile-indicator means (no rank-norm on
        # binary indicators — ties make ranks meaningless; matches arviz)
        probs = (0.05, 0.95) if prob is None else prob
        esses = []
        for p in probs:
            q = np.quantile(x.reshape(-1, *x.shape[2:]), p, axis=0)
            ind = (x <= q).astype(np.float64)
            esses.append(_ess_fused(ind, rank_normalize=False))
        return np.minimum(*esses)
    if method == "quantile":
        q = np.quantile(x.reshape(-1, *x.shape[2:]), prob, axis=0)
        ind = (x <= q).astype(np.float64)
        return _ess_fused(ind, rank_normalize=False)
    raise ValueError(f"Unknown ess method {method}")


def mcse_mean(x):
    x = np.asarray(x, dtype=np.float64)
    e = _ess_base(x)
    return x.std(axis=(0, 1), ddof=1) / np.sqrt(e)


def mcse_sd(x):
    x = np.asarray(x, dtype=np.float64)
    e = np.minimum(_ess_base(x), _ess_base(x**2))
    sd = x.std(axis=(0, 1), ddof=1)
    fac = np.sqrt(np.exp(1.0) * (1.0 - 1.0 / e) ** (e - 1.0) - 1.0)
    return sd * fac


# -------------------------------------------------- benchmark scorecard
def time_to_rhat(idata, threshold=1.01, n_grid=12, var_names=None,
                 include_compile=True):
    """Wall-clock seconds (warmup + sampling prefix) until the max
    rank-normalized split-R-hat across all posterior variables first drops
    below ``threshold`` (BASELINE.json metric "time-to-R-hat<1.01").

    Scans ~n_grid draw-count prefixes (geometric, min 4 draws so split-R-hat
    is defined) and linearly attributes sampling time per draw. Returns nan
    if the threshold is never reached within the available draws.

    ``include_compile=False`` subtracts the recorded one-time XLA compile
    wall (``posterior.attrs["compile_time"]``) from the warmup attribution —
    the remote TPU compile service latency is wildly variable (20-400 s for
    the same program), so the compile-included number swings 10x between
    identical runs while the compile-excluded one measures convergence.
    """
    post = idata.posterior
    names = list(var_names) if var_names is not None else list(post.data_vars)
    arrays = [np.asarray(post[n].values) for n in names]
    S = arrays[0].shape[1]
    tune_t = float(post.attrs.get("tuning_time", 0.0) or 0.0)
    samp_t = float(post.attrs.get("sampling_time", 0.0) or 0.0)
    if not include_compile:
        tune_t = max(0.0, tune_t - float(post.attrs.get("compile_time", 0.0)
                                         or 0.0))

    grid = np.unique(
        np.geomspace(4, S, num=min(n_grid, S)).astype(int)
    )
    for n in grid:
        worst = 0.0
        for arr in arrays:
            r = rhat(arr[:, :n])
            worst = max(worst, float(np.nanmax(r)))
        if worst < threshold:
            return tune_t + samp_t * (n / S)
    return float("nan")


def grad_evals_per_sec(idata):
    """Gradient-logp evaluations per second during sampling: one leapfrog
    step = one fused logp+grad evaluation (BASELINE.json metric
    "grad-logp evals/sec at 1k-chain NUTS"). Uses the recorded per-draw
    ``n_steps`` sampler stat; nan when absent (non-HMC steppers)."""
    try:
        n_steps = np.asarray(idata.sample_stats["n_steps"].values)
    except (AttributeError, KeyError):
        return float("nan")
    samp_t = float(idata.posterior.attrs.get("sampling_time", 0.0) or 0.0)
    if samp_t <= 0:
        return float("nan")
    return float(n_steps.sum()) / samp_t


# ---------------------------------------------------------------- warnings
class WarningType(enum.Enum):
    """Reference stats/convergence.py:37."""

    DIVERGENCE = 1
    TUNING_DIVERGENCE = 2
    DIVERGENCES = 3
    TREEDEPTH = 4
    BAD_PARAMS = 5
    BAD_ACCEPTANCE = 6
    BAD_ENERGY = 7
    CONVERGENCE = 8


@dataclasses.dataclass
class SamplerWarning:
    kind: WarningType
    message: str
    level: str
    extra: object = None


def run_convergence_checks(idata, model=None):
    """R-hat / ESS / divergences / treedepth checks (reference
    stats/convergence.py:64-133)."""
    warns = []
    post = getattr(idata, "posterior", None)
    if post is None:
        return warns
    n_draws = post.dims.get("draw", 0)
    n_chains = post.dims.get("chain", 1)
    if n_draws < 100:
        warns.append(
            SamplerWarning(
                WarningType.BAD_PARAMS,
                "The number of samples is too small to check convergence reliably.",
                "info",
            )
        )
    else:
        rhat_max = 0.0
        ess_min = np.inf
        for name, var in post.items():
            vals = var.values
            if vals.ndim < 2 or not np.issubdtype(vals.dtype, np.floating):
                continue
            r = rhat(vals)
            e = ess(vals, "bulk")
            rhat_max = max(rhat_max, float(np.nanmax(r)))
            ess_min = min(ess_min, float(np.nanmin(e)))
        if rhat_max > 1.01:
            warns.append(
                SamplerWarning(
                    WarningType.CONVERGENCE,
                    f"The rhat statistic is larger than 1.01 for some parameters "
                    f"(max={rhat_max:.3f}). This indicates problems during sampling.",
                    "info",
                )
            )
        if n_chains > 1 and ess_min < 100 * n_chains:
            warns.append(
                SamplerWarning(
                    WarningType.CONVERGENCE,
                    f"The effective sample size per chain is smaller than 100 "
                    f"for some parameters (min total ess={ess_min:.0f}). A higher "
                    "number of samples is needed for reliable estimates.",
                    "error",
                )
            )
    stats = getattr(idata, "sample_stats", None)
    if stats is not None and "diverging" in stats:
        n_div = int(stats["diverging"].values.sum())
        if n_div:
            warns.append(
                SamplerWarning(
                    WarningType.DIVERGENCES,
                    f"There were {n_div} divergences after tuning. Increase "
                    "`target_accept` or reparameterize.",
                    "error",
                )
            )
    if stats is not None and "tree_depth" in stats:
        # max_treedepth saturations
        td = stats["tree_depth"].values
        mt = stats.attrs.get("max_treedepth") if hasattr(stats, "attrs") else None
        if mt is not None:
            n_sat = int((td >= mt).sum())
            if n_sat > 0.05 * td.size:
                warns.append(
                    SamplerWarning(
                        WarningType.TREEDEPTH,
                        f"The chain reached the maximum tree depth in "
                        f"{100*n_sat/td.size:.0f}% of draws. Increase "
                        "max_treedepth or reparameterize.",
                        "warn",
                    )
                )
    return warns


def log_warnings(warns):
    for w in warns:
        if w.level == "error":
            _log.warning(w.message)
        else:
            _log.info(w.message)
