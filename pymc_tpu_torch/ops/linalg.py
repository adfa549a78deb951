"""Batched lower Cholesky factor, the dense-linalg kernel of the GP path.

Counterpart of `pymc_tpu/ops/linalg.py::cholesky_batched`, whose TPU path is
the Pallas kernel `_pallas_chol`. On the card `cholesky_batched` launches the
hand-written CUDA kernel of `csrc/cholesky.cu` (built for sm_90a at first
use), a blocked factorisation with one thread block per matrix, for any n,
or raises; there is no fallback. Where a matrix's tiles do not fit a
block's shared memory, the wrapper hands the kernel a device workspace.
`cholesky_plain` stands beside it and runs only for CPU and `meta` tensors
(the graph infers shapes on `meta`). The wrapper counts its kernel launches
in `cholesky_batched.launches`.

`cholesky_batched` is a `torch.autograd.Function` in the `setup_context`
form, so `torch.func` composes over it:
  - its `vmap` rule (the counterpart of the JAX package's `custom_vmap`)
    hands the whole batch to one call, so the model's per-point logp under
    `vmap(grad_and_value(...))` factors its (C, n, n) stack in one launch;
  - its backward is the level-3 reverse formula of `_chol_rev`, and its
    `jvp` the forward formula of `_chol_jvp`, dL = L Phi(L^-1 dA L^-T), both
    in triangular solves and matmuls, which the JAX package too leaves to
    the compiler's library calls. So `torch.func.jvp`, `jacfwd` and
    `hessian` go through it, under `vmap` too.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

__all__ = ["cholesky_batched", "cholesky_plain"]

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_INT_MAX = 2**31 - 1


def cholesky_plain(A):
    """Lower Cholesky factor of (..., n, n); a matrix that is not positive
    definite comes out all NaN instead of raising."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None], torch.nan, L)


@functools.cache
def _library():
    """`csrc/cholesky.cu`, built, with the ctypes signatures of its functions."""
    lib = _build.load_library("cholesky")
    lib.pt_cholesky_workspace.argtypes = [ctypes.c_int64] * 3
    lib.pt_cholesky_workspace.restype = ctypes.c_int64
    for suffix in _SUFFIX.values():
        fn = getattr(lib, f"pt_cholesky_{suffix}")
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def _cholesky_cuda(A):
    """Launch the kernel on a CUDA (..., n, n) stack."""
    n = A.shape[-1]
    C = A.numel() // (n * n) if n else 0
    if not (n >= 1 and 1 <= C <= _INT_MAX):
        raise NotImplementedError(
            f"cholesky_batched: the CUDA kernel takes n >= 1 and at least one matrix, "
            f"got shape {tuple(A.shape)}"
        )
    if A.dtype not in _SUFFIX:
        raise TypeError(f"cholesky_batched: dtype {A.dtype} not supported (float32, float64)")
    if A.device.index not in (None, torch.cuda.current_device()):
        raise ValueError(f"cholesky_batched: operand on {A.device}, not the current device")
    A = A.contiguous()
    L = torch.empty_like(A)
    lib = _library()
    # tiles that do not fit a block's shared memory live in this workspace
    work = lib.pt_cholesky_workspace(C, n, A.element_size())
    work = torch.empty(work, dtype=A.dtype, device=A.device) if work else None
    stream = torch.cuda.current_stream(A.device).cuda_stream
    rc = getattr(lib, f"pt_cholesky_{_SUFFIX[A.dtype]}")(
        A.data_ptr(), L.data_ptr(), None if work is None else work.data_ptr(), C, n, stream
    )
    if rc != 0:
        raise RuntimeError(f"CUDA launch of pt_cholesky failed: cudaError {rc}")
    cholesky_batched.launches += 1
    return L


def _phi(M):
    """tril with a halved diagonal (the Phi operator of the reverse formula)."""
    return torch.tril(M) - 0.5 * torch.tril(torch.triu(M))


def _chol_rev(L, Lbar):
    """Reverse-mode Cholesky (Murray 2016, level-3 form, batched):
    Abar = 0.5 * L^{-T} (Phi(L^T Lbar) + Phi(L^T Lbar)^T) L^{-1}."""
    Lt = L.transpose(-1, -2)
    P = _phi(Lt @ Lbar)
    S = P + P.transpose(-1, -2)
    X = torch.linalg.solve_triangular(Lt, S, upper=True)  # L^T X = S
    Abar = torch.linalg.solve_triangular(Lt, X.transpose(-1, -2), upper=True)
    return 0.5 * Abar.transpose(-1, -2)


def _chol_jvp(L, dA):
    """Forward-mode Cholesky, as `pymc_tpu/ops/linalg.py::_chol_jvp`:
    dL = L Phi(L^{-1} dA L^{-T}), with dA symmetrised first. For a symmetric
    tangent that is the JAX package's rule; the symmetrising makes it the
    transpose of `_chol_rev`, so jacfwd and jacrev agree, and matches the
    second derivatives of the JAX package, whose rule differentiates its
    inner factor through `jnp.linalg.cholesky`, which symmetrises."""
    dA = 0.5 * (dA + dA.transpose(-1, -2))
    Li_dA = torch.linalg.solve_triangular(L, dA, upper=False)  # L X = dA
    W = torch.linalg.solve_triangular(L, Li_dA.transpose(-1, -2), upper=False)
    return L @ _phi(W.transpose(-1, -2))


class _Cholesky(torch.autograd.Function):
    @staticmethod
    def forward(A):
        if A.device.type in ("cpu", "meta"):
            return cholesky_plain(A)
        if A.device.type != "cuda":
            raise ValueError(f"cholesky_batched: no kernel for device {A.device}")
        return _cholesky_cuda(A)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(output)
        ctx.save_for_forward(output)

    @staticmethod
    def backward(ctx, Lbar):
        (L,) = ctx.saved_tensors
        return _chol_rev(L, Lbar)

    @staticmethod
    def jvp(ctx, dA):
        (L,) = ctx.saved_tensors
        return _chol_jvp(L, dA)

    @staticmethod
    def vmap(info, in_dims, A):
        # the batch moves to the front and the whole (C, n, n) stack goes to
        # one call; an unbatched operand stays unbatched
        (bdim,) = in_dims
        if bdim is None:
            return _Cholesky.apply(A), None
        return _Cholesky.apply(A.movedim(bdim, 0)), 0


def cholesky_batched(A):
    """Lower Cholesky factor of a (..., n, n) stack of SPD matrices.

    CUDA tensors: the kernel of `csrc/cholesky.cu`, float32 or float64, any
    n >= 1 and number of matrices >= 1 (NotImplementedError for an empty
    stack). CPU and meta tensors: `cholesky_plain`. A matrix that is not
    positive definite gives NaN in its factor and never raises.
    """
    if A.ndim < 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"cholesky_batched: expected (..., n, n), got {tuple(A.shape)}")
    return _Cholesky.apply(A)


cholesky_batched.launches = 0
