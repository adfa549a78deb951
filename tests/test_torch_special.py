"""The Bessel functions I_v and K_v of the port (`ops/special.py`,
`pm.math.iv`/`kv`) against pymc_tpu's, float64 on the CPU.

The port keeps the JAX package's algorithm (the series/asymptotic switch,
the reflection for negative orders, the 250-node trapezoid for K_v), so it
is held to pymc_tpu's values at rtol 1e-12 over orders -2.5 to 30 and x
from 1e-3 to 1e3, and to scipy's where the algorithm is accurate (rtol
1e-10, as `tests/test_math.py` holds pymc_tpu). Gradients in x come from
autograd (against the recurrence K_v' = -(K_{v-1} + K_{v+1}) / 2 and
pymc_tpu's jax.grad, rtol 1e-10), under `torch.func.vmap` too. Where the
reference is inaccurate the port copies it (ROADMAP.md §3): at high order
the 12-term asymptotic expansion of I_v above the series cut (x >= 25 in
float64) is far off scipy's value.
"""

import numpy as np
import pytest
import scipy.special as sp
import torch

import jax
import jax.numpy as jnp

import pymc_tpu_torch as pmt
from pymc_tpu.ops.special import bessel_iv as iv_j
from pymc_tpu.ops.special import bessel_kv as kv_j
from pymc_tpu_torch.ops.special import bessel_iv, bessel_kv


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ORDERS = np.array([-2.5, -1.5, -0.7, 0.0, 0.5, 1.0, 1.5, 2.5, 7.3, 15.0, 30.0])
XS = np.geomspace(1e-3, 1e3, 31)
V, X = np.meshgrid(ORDERS, XS, indexing="ij")


@pytest.fixture(scope="module")
def references():
    """pymc_tpu's values and x-gradients on the grid, one jitted call."""

    @jax.jit
    def ref(v, x):
        out = {}
        for name, fn in (("iv", iv_j), ("kv", kv_j)):
            out[name] = fn(v, x)
            g = jax.vmap(jax.grad(lambda a, b, fn=fn: fn(a, b), argnums=1))(
                v.ravel(), x.ravel())
            out[f"d{name}"] = g.reshape(v.shape)
        return out

    return {k: np.asarray(a) for k, a in ref(jnp.asarray(V), jnp.asarray(X)).items()}


def _close(got, ref, rtol):
    """Equal where the reference is infinite or 0, within rtol elsewhere."""
    exact = ~np.isfinite(ref) | (ref == 0)
    np.testing.assert_array_equal(got[exact], ref[exact])
    np.testing.assert_allclose(got[~exact], ref[~exact], rtol=rtol)


@pytest.mark.parametrize("name", ["iv", "kv"])
def test_values_match_pymc_tpu(name, references):
    fn = {"iv": bessel_iv, "kv": bessel_kv}[name]
    got = fn(torch.tensor(V), torch.tensor(X)).numpy()
    _close(got, references[name], rtol=1e-12)


@pytest.mark.parametrize("name", ["iv", "kv"])
def test_gradients_in_x_match_pymc_tpu(name, references):
    fn = {"iv": bessel_iv, "kv": bessel_kv}[name]
    x = torch.tensor(X, requires_grad=True)
    out = fn(torch.tensor(V), x)
    (g,) = torch.autograd.grad(torch.where(torch.isfinite(out), out, 0.0).sum(), x)
    ref = references[f"d{name}"]
    finite = np.isfinite(ref)
    _close(g.numpy()[finite], ref[finite], rtol=1e-10)


@pytest.mark.parametrize("v", [0.0, 0.5, 1.0, 1.5, 2.5, -1.5])
def test_math_iv_kv_match_scipy(v):
    """tests/test_math.py::test_iv_kv_match_scipy's grid, through pm.math."""
    xs = np.array([0.01, 0.3, 1.0, 4.0, 10.0, 30.0, 80.0])
    np.testing.assert_allclose(pmt.math.iv(v, xs).numpy(), sp.iv(v, xs), rtol=1e-10)
    np.testing.assert_allclose(pmt.math.kv(v, xs).numpy(), sp.kv(v, xs), rtol=1e-10)


def test_edges():
    assert float(bessel_iv(0.0, 0.0)) == 1.0
    assert float(bessel_iv(1.5, 0.0)) == 0.0
    assert np.isinf(float(bessel_kv(1.5, 0.0)))
    np.testing.assert_allclose(float(bessel_kv(1.5, 600.0)), sp.kv(1.5, 600.0), rtol=1e-10)


def test_kv_gradient_is_the_recurrence():
    g = torch.func.grad(lambda x: bessel_kv(1.5, x))(torch.tensor(2.0, dtype=torch.float64))
    np.testing.assert_allclose(float(g), -(sp.kv(0.5, 2.0) + sp.kv(2.5, 2.0)) / 2.0, rtol=1e-10)


def test_vmap_and_float32():
    """Under vmap of grad, and in float32 (series cut 12) against float64
    at low order."""
    xs = torch.tensor([0.3, 2.0, 11.0, 14.0, 40.0], dtype=torch.float64)
    g = torch.func.vmap(torch.func.grad(lambda x: bessel_iv(2.5, x)))(xs)
    ref = (sp.iv(1.5, xs.numpy()) + sp.iv(3.5, xs.numpy())) / 2.0
    np.testing.assert_allclose(g.numpy(), ref, rtol=1e-10)
    f32 = bessel_iv(torch.tensor(1.0, dtype=torch.float32), xs.float())
    assert f32.dtype == torch.float32
    np.testing.assert_allclose(f32.double().numpy(), sp.iv(1.0, xs.numpy()), rtol=2e-5)


def test_math_iv_builds_a_node():
    """With a Node argument pm.math.iv is a node of the model's graph."""
    with pmt.Model() as m:
        x = pmt.Gamma("x", 3.0, 1.0)
        pmt.Potential("k", pmt.math.log(pmt.math.kv(1.5, x)))
    lp = m.compile_logp(device="cpu")({"x_log__": np.log(2.0)})
    expected = (sp.gammaln(3.0) * -1 + 2 * np.log(2.0) - 2.0) + np.log(2.0) + np.log(
        sp.kv(1.5, 2.0))
    np.testing.assert_allclose(float(lp), expected, rtol=1e-10)


def test_high_order_asymptotic_region_copies_the_reference(references):
    """At v = 30 and x in [25, 60) the reference's asymptotic expansion is
    far off scipy; the port returns the reference's value (ROADMAP §3)."""
    at = (V == 30.0) & (X >= 25.0) & (X < 60.0)
    got = bessel_iv(torch.tensor(V[at]), torch.tensor(X[at])).numpy()
    np.testing.assert_allclose(got, references["iv"][at], rtol=1e-12)
    assert np.max(np.abs(got / sp.iv(30.0, X[at]) - 1.0)) > 1e-3
