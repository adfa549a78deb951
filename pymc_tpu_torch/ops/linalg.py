"""Batched lower Cholesky factor, the dense-linalg kernel of the GP path.

Counterpart of `pymc_tpu/ops/linalg.py::cholesky_batched`, whose TPU path is
the Pallas kernel `_pallas_chol`. On the card `cholesky_batched` launches the
hand-written CUDA kernel of `csrc/cholesky.cu` (built for sm_90a at first
use), one thread block per matrix, or raises; there is no fallback.
`cholesky_plain` stands beside it and runs only for CPU and `meta` tensors
(the graph infers shapes on `meta`). The wrapper counts its kernel launches
in `cholesky_batched.launches`.

`cholesky_batched` is a `torch.autograd.Function` in the `setup_context`
form, so `torch.func` composes over it:
  - its `vmap` rule (the counterpart of the JAX package's `custom_vmap`)
    hands the whole batch to one call, so the model's per-point logp under
    `vmap(grad_and_value(...))` factors its (C, n, n) stack in one launch;
  - its backward is the level-3 reverse formula of `_chol_rev`, in
    triangular solves and matmuls, which the JAX package too leaves to the
    compiler's library calls.
Forward mode (a `jvp` rule) is not ported.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["cholesky_batched", "cholesky_plain", "MAX_N"]

# the kernel keeps one (n, n) matrix in a block's shared memory: n <= 160 is
# 100 KB in float32 and 200 KB in float64, under the 227 KB a block may use
MAX_N = 160
_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_INT_MAX = 2**31 - 1


def cholesky_plain(A):
    """Lower Cholesky factor of (..., n, n); a matrix that is not positive
    definite comes out all NaN instead of raising."""
    L, info = torch.linalg.cholesky_ex(A)
    return torch.where((info != 0)[..., None, None], torch.nan, L)


_kernels = {}


def _kernel(dtype):
    if dtype not in _kernels:
        fn = getattr(_build.load_library("cholesky"), f"pt_cholesky_{_SUFFIX[dtype]}")
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _kernels[dtype] = fn
    return _kernels[dtype]


def _cholesky_cuda(A):
    """Launch the kernel on a CUDA (..., n, n) stack."""
    n = A.shape[-1]
    C = A.numel() // (n * n) if n else 0
    if not (1 <= n <= MAX_N and 1 <= C <= _INT_MAX):
        raise NotImplementedError(
            f"cholesky_batched: the CUDA kernel takes 1 <= n <= {MAX_N} and at least "
            f"one matrix, got shape {tuple(A.shape)}"
        )
    if A.dtype not in _SUFFIX:
        raise TypeError(f"cholesky_batched: dtype {A.dtype} not supported (float32, float64)")
    if A.device.index not in (None, torch.cuda.current_device()):
        raise ValueError(f"cholesky_batched: operand on {A.device}, not the current device")
    A = A.contiguous()
    L = torch.empty_like(A)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    rc = _kernel(A.dtype)(A.data_ptr(), L.data_ptr(), C, n, stream)
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

    @staticmethod
    def backward(ctx, Lbar):
        (L,) = ctx.saved_tensors
        return _chol_rev(L, Lbar)

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
    number of matrices, 1 <= n <= 160 (NotImplementedError outside). CPU and
    meta tensors: `cholesky_plain`. A matrix that is not positive definite
    gives NaN in its factor and never raises.
    """
    if A.ndim < 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"cholesky_batched: expected (..., n, n), got {tuple(A.shape)}")
    return _Cholesky.apply(A)


cholesky_batched.launches = 0
