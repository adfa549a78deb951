"""The sum-to-1, zero-sum and Cholesky transforms of pymc_tpu_torch, and
LKJCorr's CorrPackedTransform, against pymc_tpu's, float64 on the CPU.

Each transform at a batch of seeded unconstrained values: `backward` and
`log_jac_det` against the JAX package's, rtol 1e-12; `forward` of the
constrained values against the JAX package's, rtol 1e-10 where it goes
through a Cholesky factorisation (CholeskyCovTransform, CorrPackedTransform),
1e-12 otherwise; the round trip forward(backward(v)) back to v (rtol
1e-10); and `value_shape`/`constrained_shape`/`event_ndim`/`name` as the
JAX package's. The Cholesky transforms at n = 2 and 5, the zero-sum
transform over one and two axes. Then the log-Jacobians against a
numerical one: log|det d backward(v)/dv| by torch.func.jacrev on the free
coordinates (the zero-sum transform's is 0 on the subspace; the
covariance transform's is taken over the packed lower triangle of X).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pymc_tpu.distributions import multivariate as mvj
from pymc_tpu.distributions import transforms as trj
from pymc_tpu_torch.distributions import multivariate as mvt
from pymc_tpu_torch.distributions import transforms as trt


def _tr(mod, mv, name, n):
    if name == "CorrPackedTransform":
        return mv.CorrPackedTransform(n)
    if name == "ZeroSumTransform":
        return mod.ZeroSumTransform(n)
    if name == "SumTo1Transform":
        return mod.SumTo1Transform()
    return getattr(mod, name)(n)


def _value_shape(name, n):
    """The unconstrained shape of a batch of 4."""
    return {
        "SumTo1Transform": (4, n),
        "ZeroSumTransform": (4, 3, 4) if n == 2 else (4, 5),
        "CholeskyCovPackedTransform": (4, n * (n + 1) // 2),
        "CholeskyCovTransform": (4, n * (n + 1) // 2),
        "CholeskyCorrTransform": (4, n * (n - 1) // 2),
        "CorrPackedTransform": (4, n * (n - 1) // 2),
    }[name]


CASES = [(name, n) for name in ("CholeskyCovPackedTransform", "CholeskyCovTransform",
                                "CholeskyCorrTransform", "CorrPackedTransform")
         for n in (2, 5)] + [("ZeroSumTransform", 1), ("ZeroSumTransform", 2),
                               ("SumTo1Transform", 4)]


@pytest.mark.parametrize("name, n", CASES)
def test_transform_matches(name, n):
    tj, tt = _tr(trj, mvj, name, n), _tr(trt, mvt, name, n)
    assert tt.name == tj.name and tt.event_ndim == tj.event_ndim
    v = np.random.default_rng(n).normal(0.0, 0.8, size=_value_shape(name, n))
    xj, ldj, fj = jax.jit(lambda u: (tj.backward(u), tj.log_jac_det(u),
                                     tj.forward(tj.backward(u))))(jnp.asarray(v))
    x = tt.backward(torch.as_tensor(v))
    np.testing.assert_allclose(x.numpy(), np.asarray(xj), rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(tt.log_jac_det(torch.as_tensor(v)).numpy(), np.asarray(ldj),
                               rtol=1e-12)
    rtol = 1e-10 if name in ("CholeskyCovTransform", "CorrPackedTransform") else 1e-12
    back = tt.forward(x).numpy()
    np.testing.assert_allclose(back, np.asarray(fj), rtol=rtol, atol=1e-14)
    np.testing.assert_allclose(back, v, rtol=1e-10, atol=1e-12)
    shape = tuple(x.shape)
    assert tt.value_shape(shape) == tuple(tj.value_shape(shape)) == v.shape
    assert tt.constrained_shape(v.shape) == tuple(tj.constrained_shape(v.shape)) == shape


def _free(x, name, n):
    """The free coordinates of a constrained value (one point)."""
    if name == "CholeskyCovTransform":
        r, c = np.tril_indices(n)
        return x[..., r, c]
    return x


@pytest.mark.parametrize("name, n", [("CholeskyCovPackedTransform", 3),
                                     ("CholeskyCovTransform", 3),
                                     ("CholeskyCorrTransform", 4), ("CorrPackedTransform", 4)])
def test_log_jac_det_is_the_jacobians(name, n):
    tt = _tr(trt, mvt, name, n)
    v = torch.as_tensor(np.random.default_rng(7).normal(0.0, 0.8, size=_value_shape(name, n)[1:]))
    J = torch.func.jacrev(lambda u: _free(tt.backward(u), name, n))(v)
    _, logdet = torch.linalg.slogdet(J)
    np.testing.assert_allclose(float(tt.log_jac_det(v)), float(logdet), rtol=1e-10)


def test_zero_sum_values_sum_to_zero_along_each_axis():
    v = torch.as_tensor(np.random.default_rng(3).normal(size=(6, 4, 5)))
    x = trt.ZeroSumTransform(2).backward(v)
    assert x.shape == (6, 5, 6)
    np.testing.assert_allclose(x.sum(-1).numpy(), 0.0, atol=1e-13)
    np.testing.assert_allclose(x.sum(-2).numpy(), 0.0, atol=1e-13)
    assert trt.CholeskyCovPacked is trt.CholeskyCovPackedTransform
    assert isinstance(trt.sum_to_1, trt.SumTo1Transform)
