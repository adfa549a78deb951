"""The log-odds, interval, log-expm1 and circular transforms of
pymc_tpu_torch against pymc_tpu's, float64 on the CPU.

Each transform: `backward` and `log_jac_det` at the same unconstrained
values against the JAX package's, rtol 1e-12, and `forward(backward(v))`
back to v (rtol 1e-12; the circular transform wraps v to (-pi, pi]). The
interval transform with both bounds, one bound, and bounds that are random
variables of a model (a Uniform whose bounds are other free variables),
where the model's logp and gradient must match at 8 points (rtol 1e-10;
bounds may be numbers too);
the reference's names (Interval, Chain); and the default transform of each
support: logodds for the unit interval, the interval transform with the
distribution's own bounds, circular for VonMises.
"""

import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from pymc_tpu.blocking import unravel_vector
from pymc_tpu.distributions import transforms as trj
from pymc_tpu_torch.distributions import transforms as trt

RTOL = 1e-12
V = np.array([-30.0, -4.0, -0.7, 0.0, 0.3, 2.5, 35.0])

TRANSFORMS = {
    "logodds": lambda tr: tr.logodds,
    "interval": lambda tr: tr.IntervalTransform(-1.5, 2.0),
    "interval_lower": lambda tr: tr.IntervalTransform(0.5, None),
    "interval_upper": lambda tr: tr.IntervalTransform(None, 3.0),
    "log_exp_m1": lambda tr: tr.log_exp_m1,
    "circular": lambda tr: tr.circular,
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_transform_matches(name):
    tj, tt = TRANSFORMS[name](trj), TRANSFORMS[name](trt)
    assert tt.name == tj.name and tt.event_ndim == tj.event_ndim == 0
    v = V if name != "log_exp_m1" else V[1:]
    x = tt.backward(torch.as_tensor(v))
    np.testing.assert_allclose(x.numpy(), np.asarray(tj.backward(jnp.asarray(v))), rtol=RTOL)
    np.testing.assert_allclose(tt.log_jac_det(torch.as_tensor(v)).numpy(),
                               np.asarray(tj.log_jac_det(jnp.asarray(v))), rtol=RTOL, atol=1e-300)
    # the round trip, where the constrained value is not saturated
    inner = np.abs(v) < 20.0
    back = tt.forward(x, {})[inner].numpy()
    want = np.arctan2(np.sin(v), np.cos(v)) if name == "circular" else v
    np.testing.assert_allclose(back, want[inner], rtol=RTOL, atol=1e-14)


def test_interval_needs_a_bound_and_has_the_reference_names():
    with pytest.raises(ValueError, match="cannot both be None"):
        trt.IntervalTransform(None, None)
    assert trt.Interval is trt.IntervalTransform and trt.Chain is trt.ChainedTransform


def _node_bound_model(pm):
    with pm.Model() as m:
        lo = pm.Normal("lo", 0.0, 1.0)
        width = pm.HalfNormal("width", 2.0)
        x = pm.Uniform("x", lower=lo, upper=lo + width, shape=3)
        pm.Normal("y", x, 0.5, observed=np.array([0.2, -0.3, 1.1]))
    return m


def test_interval_bounds_that_are_random_variables():
    mj, mt = _node_bound_model(pmj), _node_bound_model(pmt)
    assert [rv.value_name for rv in mt.free_RVs] == ["lo", "width_log__", "x_interval__"]
    q = np.random.default_rng(3).normal(0.0, 0.8, size=(8, mt.raveled_info().total_size))
    lp, grad = mt.logp_dlogp_fn(device="cpu")(torch.as_tensor(q))
    info = mj.raveled_info()
    f = jax.value_and_grad(lambda z: mj.logp_fn()(unravel_vector(z, info)))
    ref = [f(jnp.asarray(z)) for z in q]
    np.testing.assert_allclose(lp.numpy(), [float(r[0]) for r in ref], rtol=1e-10)
    np.testing.assert_allclose(grad.numpy(), np.stack([np.asarray(r[1]) for r in ref]),
                               rtol=1e-10, atol=1e-12)
    # the constrained values lie inside their own bounds
    post = mt.postprocess_fn(device="cpu")(torch.as_tensor(q))
    lo, hi = post["lo"][:, None], post["lo"][:, None] + post["width"][:, None]
    assert bool(((post["x"] > lo) & (post["x"] < hi)).all())


@pytest.mark.parametrize("dist, params, name", [
    ("Beta", dict(alpha=2.0, beta=3.0), "logodds"),
    ("LogitNormal", dict(mu=0.0, sigma=1.0), "logodds"),
    ("Uniform", dict(lower=-1.0, upper=4.0), "interval"),
    ("Triangular", dict(lower=0.0, c=1.0, upper=3.0), "interval"),
    ("Pareto", dict(alpha=2.0, m=1.5), "interval"),
    ("TruncatedNormal", dict(mu=0.0, sigma=1.0, upper=2.0), "interval"),
    ("VonMises", dict(mu=0.0, kappa=1.0), "circular"),
])
def test_default_transform_of_each_support(dist, params, name):
    t = getattr(pmt, dist).dist(**params).default_transform()
    assert t.name == name
    v = torch.linspace(-3.0, 3.0, 7, dtype=torch.float64)
    ref = getattr(pmj, dist).dist(**params).default_transform()
    np.testing.assert_allclose(t.backward(v).numpy(), np.asarray(ref.backward(jnp.asarray(v))),
                               rtol=RTOL)
    np.testing.assert_allclose(t.log_jac_det(v).numpy(),
                               np.asarray(ref.log_jac_det(jnp.asarray(v))), rtol=RTOL)
    if name == "circular":
        assert bool((t.backward(10 * v).abs() <= math.pi).all())
