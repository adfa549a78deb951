"""Posterior summary table and highest-density intervals.

A copy of `pymc_tpu/stats/summary.py` (numpy; pandas inside `summary`, as
there) over the port's own convergence.py (arviz.summary as the reference's
workflow uses it). That copy ranks tied draws at their mean rank, so the
R-hat and ESS of a discrete variable may differ from `pymc_tpu`'s by design
(ROADMAP.md §3); continuous draws give the same table.
"""

from __future__ import annotations

import numpy as np

from .convergence import ess, mcse_mean, mcse_sd, rhat

__all__ = ["summary", "hdi"]


def hdi(x, prob=0.94):
    """Highest-density interval over the sample axis (flattened chains)."""
    x = np.asarray(x)
    flat = np.sort(x.reshape(-1, *x.shape[2:]), axis=0) if x.ndim >= 2 else np.sort(x)
    n = flat.shape[0]
    m = max(int(np.floor(prob * n)), 1)
    starts = flat[: n - m]
    ends = flat[m:]
    widths = ends - starts
    idx = np.argmin(widths, axis=0)
    lo = np.take_along_axis(starts, idx[None], axis=0)[0]
    hi = np.take_along_axis(ends, idx[None], axis=0)[0]
    return lo, hi


def summary(idata, var_names=None, hdi_prob=0.94, round_to=3, kind="all"):
    """Summary statistics table: mean, sd, hdi bounds, mcse, ess, rhat.

    Returns a pandas DataFrame indexed by flattened variable coordinates.
    """
    import pandas as pd

    post = idata.posterior if hasattr(idata, "posterior") else idata
    rows = {}
    for name in post.keys():
        if var_names is not None and name not in set(var_names):
            continue
        vals = post[name].values
        if not np.issubdtype(vals.dtype, np.number):
            continue
        vals = np.asarray(vals, dtype=np.float64)
        extra_shape = vals.shape[2:]
        idx_iter = (
            [()] if not extra_shape else list(np.ndindex(*extra_shape))
        )
        r = rhat(vals) if kind in ("all", "diagnostics") else None
        e_bulk = ess(vals, "bulk") if kind in ("all", "diagnostics") else None
        e_tail = ess(vals, "tail") if kind in ("all", "diagnostics") else None
        mm = mcse_mean(vals) if kind in ("all", "diagnostics") else None
        ms = mcse_sd(vals) if kind in ("all", "diagnostics") else None
        lo, hi = hdi(vals, hdi_prob)
        for ix in idx_iter:
            label = name if not ix else f"{name}[{', '.join(map(str, ix))}]"
            sl = (slice(None), slice(None)) + ix
            row = {
                "mean": vals[sl].mean(),
                "sd": vals[sl].std(ddof=1),
                f"hdi_{(1-hdi_prob)/2*100:g}%": np.asarray(lo)[ix] if ix else lo,
                f"hdi_{(1-(1-hdi_prob)/2)*100:g}%": np.asarray(hi)[ix] if ix else hi,
            }
            if kind in ("all", "diagnostics"):
                row.update({
                    "mcse_mean": np.asarray(mm)[ix] if ix else mm,
                    "mcse_sd": np.asarray(ms)[ix] if ix else ms,
                    "ess_bulk": np.asarray(e_bulk)[ix] if ix else e_bulk,
                    "ess_tail": np.asarray(e_tail)[ix] if ix else e_tail,
                    "r_hat": np.asarray(r)[ix] if ix else r,
                })
            rows[label] = row
    df = pd.DataFrame(rows).T
    return df.round(round_to) if round_to is not None else df
