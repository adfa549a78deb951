"""Sample the latent GP, BASELINE config #4 in its named form, on one CUDA
card: `benchmarks/suite.py::case_gp` (n = 150, `gp.Latent.prior` with an
`eta**2 * ExpQuad` kernel, 153 free parameters) with NUTS at 64 chains,
pooled mass, float32 (`pymc_tpu_torch.models.GP_LATENT_SAMPLE_KWARGS`).

Builds csrc/leapfrog.cu and csrc/cholesky.cu, samples, and checks: one
Cholesky launch a logp+grad and one for the draws' deterministic f (the
on-card postprocess), the leapfrog kernels' launch identities of
chip_smoke.py, every draw finite, R-hat < 1.05 on ls, eta and sigma, and
their means within 5 combined MCSE of
tests/data/torch_gp_latent_reference.json (`pymc_tpu` on the CPU,
scripts/make_torch_gp_latent_fixture.py). Prints min-ESS/s, grad-evals/s,
the walls, the mean tree depth and the leapfrogs a draw. This run is not
in chip_smoke.py: the 64 chains' lock-step trees take ~1,000 leapfrogs a
draw (the deepest chain's tree reaches the depth limit of 10 almost every
draw) at ~13 host ms each, so 100 tuning and 100 drawn draws take about 45
minutes on an H100, against that script's 20-minute limit.

Usage:
    python3 scripts/probe_torch_gp_latent.py
"""

from __future__ import annotations

import json
import math
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from pymc_tpu_torch.models import GP_LATENT_SAMPLE_KWARGS  # noqa: E402
from pymc_tpu_torch.sampling.mcmc import _POST_CHUNK  # noqa: E402

REFERENCE = os.path.join(ROOT, "tests", "data", "torch_gp_latent_reference.json")


def run_gp_latent(card, config):
    """Sample the latent GP on the card and check it; returns {kernel:
    launches}."""
    from pymc_tpu_torch.models import GP_SCALARS, gp_latent_model
    from pymc_tpu_torch.stats.convergence import ess, grad_evals_per_sec, mcse_mean, rhat

    cs.phase(f"latent GP sampling {config}")
    idata, launches = cs.sample_counted(gp_latent_model(150), config)
    post, stats, attrs = idata.posterior, idata.sample_stats, idata.posterior.attrs
    wall = attrs["sampling_time"]
    n_leapfrog, n_calls = attrs["n_leapfrog"], attrs["n_logp_grad"]
    min_ess = min(float(np.nanmin(ess(post[n].values))) for n in GP_SCALARS)
    rhats = {n: float(np.nanmax(rhat(post[n].values))) for n in GP_SCALARS}
    per_draw = (n_leapfrog - attrs["n_step_search"]) / (config["tune"] + config["draws"])
    print(f"min-ESS/s {min_ess / wall:.3f} (min ESS {min_ess:.1f}); grad-evals/s "
          f"{grad_evals_per_sec(idata):.1f}; sampling wall {wall:.2f} s; tuning wall "
          f"{attrs['tuning_time']:.2f} s  [{card}]")
    print(f"divergences {int(stats['diverging'].values.sum())}; leapfrogs {n_leapfrog} "
          f"({per_draw:.1f} a draw in lock-step, tuning included; "
          f"{(wall + attrs['tuning_time']) / n_leapfrog * 1e3:.2f} ms each); logp+grad calls "
          f"{n_calls}; mean tree depth {float(stats['tree_depth'].values.mean()):.2f}; step "
          f"size {float(stats['step_size'].values[0, 0]):.5f}; launches {launches}", flush=True)
    with open(REFERENCE) as f:
        ref = json.load(f)["params"]
    summary = {}
    for name in GP_SCALARS:
        x = post[name].values.astype(np.float64)
        se = float(np.hypot(mcse_mean(x), ref[name]["mcse"]))
        summary[name] = {"mean": float(x.mean()), "mcse": float(mcse_mean(x)),
                         "rhat": rhats[name], "z": (float(x.mean()) - ref[name]["mean"]) / se}
    print(f"posterior summary {json.dumps(summary)}", flush=True)
    # one logp+grad a Cholesky launch, and one more a postprocess chunk:
    # the deterministic f = L v of every draw is computed on the card
    chunks = math.ceil(config["chains"] * config["draws"] / _POST_CHUNK)
    if not (launches["cholesky"] == n_calls + chunks and n_calls >= n_leapfrog > 0):
        raise AssertionError(f"cholesky launches {launches['cholesky']} != logp+grad calls "
                             f"{n_calls} + postprocess chunks {chunks}")
    cs.check_launch_identities("latent GP", attrs, launches)
    for name in post.keys():
        if not np.isfinite(post[name].values).all():
            raise AssertionError(f"non-finite draws in {name}")
    for name in GP_SCALARS:
        z = summary[name]["z"]
        print(f"{name}: mean {summary[name]['mean']:.5f} (reference {ref[name]['mean']:.5f}), "
              f"{z:+.2f} combined MCSE; R-hat {rhats[name]:.4f}")
        if not abs(z) <= 5.0:
            raise AssertionError(f"latent GP {name} mean is {z:+.2f} MCSE off the reference")
        if not rhats[name] < 1.05:
            raise AssertionError(f"latent GP {name} R-hat {rhats[name]:.4f} >= 1.05")
    return launches


def main():
    card, _ = cs.check_device()
    cs.build_kernels()
    print(f"launches {run_gp_latent(card, GP_LATENT_SAMPLE_KWARGS)}")
    print(f"total wall {cs.time.perf_counter() - cs.T_START:.1f} s")


if __name__ == "__main__":
    main()
