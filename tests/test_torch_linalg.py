"""The port's batched Cholesky (`pymc_tpu_torch.ops.linalg`) against the JAX
package's on the CPU.

`cholesky_plain`, which CPU tensors take, is held against the Pallas kernel
`_pallas_chol` run in interpret mode (float32, atol 2e-5 * n, the bound of
tests/ops/test_linalg.py) and against `jnp.linalg.cholesky` in float64
(1e-12). The autograd Function is held against JAX under
vmap(grad_and_value(...)), the composition the model's logp+grad uses (float64,
1e-10), its backward against `_chol_rev`, and its forward mode (jvp, jacfwd,
hessian, under vmap too) against the JAX package's `custom_jvp` (float64,
1e-10). The CUDA kernel itself is checked against `cholesky_plain` on the
card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pymc_tpu.ops.pallas_kernels as pk
from pymc_tpu.ops.linalg import _chol_rev as chol_rev_jax
from pymc_tpu.ops.linalg import _pallas_chol
from pymc_tpu.ops.linalg import cholesky_batched as chol_jax
from pymc_tpu_torch.ops import linalg as la


@pytest.fixture
def interpret_mode():
    prev = pk._INTERPRET
    pk._INTERPRET = True
    yield
    pk._INTERPRET = prev


def _spd(C, n, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    B = rng.normal(size=(C, n, n))
    return (B @ np.swapaxes(B, -1, -2) + n * np.eye(n)).astype(dtype)


def _logdet(chol):
    return lambda a: 2 * torch.sum(torch.log(torch.diagonal(chol(a))))


def _logdet_jax(a):
    return 2 * jnp.sum(jnp.log(jnp.diagonal(chol_jax(a))))


def _sym(C, n, seed):
    B = np.random.default_rng(seed).normal(size=(C, n, n))
    return B + np.swapaxes(B, -1, -2)


@pytest.fixture
def spy_plain(monkeypatch):
    """The shapes `cholesky_plain` is called with."""
    seen = []
    plain = la.cholesky_plain

    def spy(a):
        seen.append(tuple(a.shape))
        return plain(a)

    monkeypatch.setattr(la, "cholesky_plain", spy)
    return seen


@pytest.mark.parametrize("C,n", [(8, 13), (16, 40)])
def test_plain_matches_pallas_kernel_float32(interpret_mode, C, n):
    A = _spd(C, n, seed=n, dtype=np.float32)
    L = la.cholesky_plain(torch.as_tensor(A)).numpy()
    Lref = np.asarray(_pallas_chol(jnp.asarray(A)))
    assert L.dtype == np.float32
    np.testing.assert_allclose(L, Lref, atol=2e-5 * n)
    assert np.all(np.triu(L, 1) == 0.0)


@pytest.mark.parametrize("shape", [(8, 13, 13), (3, 2, 7, 7), (5, 5), (4, 1, 1)])
def test_matches_jax_cholesky_float64(shape):
    n = shape[-1]
    A = _spd(int(np.prod(shape[:-2])), n, seed=1).reshape(shape)
    L = la.cholesky_batched(torch.as_tensor(A)).numpy()
    np.testing.assert_allclose(L, np.asarray(jnp.linalg.cholesky(A)), rtol=1e-12, atol=1e-12)
    assert la.cholesky_batched.launches == 0  # CPU tensors launch no kernel


def test_indefinite_matrix_gives_nan_and_does_not_raise():
    A = _spd(4, 6, seed=2)
    A[2] = -A[2]
    L = la.cholesky_batched(torch.as_tensor(A))
    bad = torch.isnan(L).flatten(1)
    assert bad[2].all()
    assert not bad[[0, 1, 3]].any()


def test_vmap_grad_and_value_matches_jax_in_one_batched_call(spy_plain):
    A = _spd(16, 24, seed=3)
    g, v = torch.func.vmap(torch.func.grad_and_value(_logdet(la.cholesky_batched)))(
        torch.as_tensor(A)
    )
    assert spy_plain == [(16, 24, 24)]

    def f_jax(a):
        return 2 * jnp.sum(jnp.log(jnp.diagonal(jnp.linalg.cholesky(a))))

    vr, gr = jax.vmap(jax.value_and_grad(f_jax))(A)
    np.testing.assert_allclose(v.numpy(), np.asarray(vr), rtol=1e-10)
    np.testing.assert_allclose(g.numpy(), np.asarray(gr), rtol=1e-10, atol=1e-10)


def test_unbatched_operand_under_vmap():
    A = torch.as_tensor(_spd(1, 9, seed=4)[0])
    s = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    out = torch.func.vmap(lambda x: la.cholesky_batched(A) * x)(s)
    L = torch.linalg.cholesky(A)
    assert out.shape == (3, 9, 9)
    torch.testing.assert_close(out, s[:, None, None] * L, rtol=1e-13, atol=1e-13)


def test_backward_matches_jax_chol_rev():
    A = _spd(8, 9, seed=5)
    L = np.linalg.cholesky(A)
    Lbar = np.random.default_rng(6).normal(size=A.shape) * np.tril(np.ones((9, 9)))
    At = torch.as_tensor(A).requires_grad_(True)
    la.cholesky_batched(At).backward(torch.as_tensor(Lbar))
    ref = np.asarray(chol_rev_jax(jnp.asarray(L), jnp.asarray(Lbar)))
    np.testing.assert_allclose(At.grad.numpy(), ref, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(la._chol_rev(torch.as_tensor(L), torch.as_tensor(Lbar)).numpy(),
                               ref, rtol=1e-10, atol=1e-12)


def test_meta_tensors_take_the_plain_version():
    out = la.cholesky_batched(torch.empty(4, 7, 7, device="meta"))
    assert out.device.type == "meta" and out.shape == (4, 7, 7)


def test_bad_shape_raises():
    with pytest.raises(ValueError, match="expected"):
        la.cholesky_batched(torch.ones(3, 4, 5))


def test_cuda_request_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: nothing to refuse")
    with pytest.raises((RuntimeError, AssertionError)):
        la.cholesky_batched(torch.eye(3, device="cuda"))


@pytest.mark.parametrize("shape,dtype,error", [
    ((0, 4, 4), torch.float32, NotImplementedError),
    ((3, 0, 0), torch.float32, NotImplementedError),
    ((2, 4, 4), torch.float16, TypeError),
])
def test_kernel_range_is_checked_before_launch(shape, dtype, error):
    with pytest.raises(error, match="cholesky_batched"):
        la._cholesky_cuda(torch.ones(shape, dtype=dtype))


@pytest.mark.parametrize("shape", [(6, 6), (4, 7, 7)])
def test_jvp_matches_jax(shape):
    C, n = int(np.prod(shape[:-2])), shape[-1]
    A = _spd(C, n, seed=7).reshape(shape)
    dA = _sym(C, n, seed=8).reshape(shape)
    L, dL = torch.func.jvp(la.cholesky_batched, (torch.as_tensor(A),), (torch.as_tensor(dA),))
    Lr, dLr = jax.jvp(chol_jax, (jnp.asarray(A),), (jnp.asarray(dA),))
    np.testing.assert_allclose(L.numpy(), np.asarray(Lr), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(dL.numpy(), np.asarray(dLr), rtol=1e-10, atol=1e-10)


def test_jacfwd_is_the_transpose_of_the_backward():
    # the jvp rule symmetrises dA, as `_chol_rev` does, so both modes give one
    # Jacobian, also in the directions that leave the symmetric matrices
    A = torch.as_tensor(_spd(1, 5, seed=9)[0])
    Jf = torch.func.jacfwd(la.cholesky_batched)(A)
    Jr = torch.func.jacrev(la.cholesky_batched)(A)
    torch.testing.assert_close(Jf, Jr, rtol=1e-10, atol=1e-12)


def test_hessian_of_logdet_matches_jax():
    A = _spd(1, 6, seed=11)[0]
    H = torch.func.hessian(_logdet(la.cholesky_batched))(torch.as_tensor(A))
    Hr = jax.hessian(_logdet_jax)(jnp.asarray(A))
    assert H.shape == (6, 6, 6, 6)
    np.testing.assert_allclose(H.numpy(), np.asarray(Hr), rtol=1e-10, atol=1e-10)


def test_vmap_jacfwd_matches_jax_in_one_batched_call(spy_plain):
    # the input is symmetrised inside, so every tangent the rule sees is
    # symmetric, where both packages' first-order rules agree
    A = _spd(5, 4, seed=12)
    J = torch.func.vmap(torch.func.jacfwd(
        lambda a: la.cholesky_batched(0.5 * (a + a.transpose(-1, -2)))
    ))(torch.as_tensor(A))
    Jr = jax.vmap(jax.jacfwd(lambda a: chol_jax(0.5 * (a + a.T))))(jnp.asarray(A))
    assert spy_plain == [(5, 4, 4)]
    assert J.shape == (5, 4, 4, 4, 4)
    np.testing.assert_allclose(J.numpy(), np.asarray(Jr), rtol=1e-10, atol=1e-10)


def test_vmap_of_jvp_factors_the_stack_in_one_call(spy_plain):
    A, dA = _spd(8, 5, seed=13), _sym(8, 5, seed=14)
    L, dL = torch.func.vmap(
        lambda a, da: torch.func.jvp(la.cholesky_batched, (a,), (da,))
    )(torch.as_tensor(A), torch.as_tensor(dA))
    assert spy_plain == [(8, 5, 5)]
    _, dLr = jax.vmap(lambda a, da: jax.jvp(chol_jax, (a,), (da,)))(jnp.asarray(A), jnp.asarray(dA))
    np.testing.assert_allclose(dL.numpy(), np.asarray(dLr), rtol=1e-10, atol=1e-10)


def test_forward_over_reverse_hessian_under_vmap_matches_jax():
    A = _spd(3, 4, seed=15)
    H = torch.func.vmap(torch.func.jacfwd(torch.func.jacrev(_logdet(la.cholesky_batched))))(
        torch.as_tensor(A)
    )
    Hr = jax.vmap(jax.hessian(_logdet_jax))(jnp.asarray(A))
    np.testing.assert_allclose(H.numpy(), np.asarray(Hr), rtol=1e-10, atol=1e-10)
