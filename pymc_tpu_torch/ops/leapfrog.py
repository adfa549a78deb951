"""The two leapfrog halves of batched NUTS with a diagonal mass.

Counterpart of the Pallas kernels `leapfrog_kick_drift` and
`leapfrog_final_kick` in `pymc_tpu/ops/pallas_kernels.py`. On the card each
wrapper launches its hand-written CUDA kernel (`csrc/leapfrog.cu`, built for
sm_90a at first use) or raises; there is no fallback. Its plain PyTorch
version runs only when the tensors lie on the CPU, which is what the parity
tests exercise. Each wrapper counts its kernel launches in `.launches`.

Shapes: q, p, grad, inv_mass are (C, D); eps is (C,), the signed per-chain
step size; float32 or float64, all of one dtype, contiguous, on one device.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = [
    "leapfrog_kick_drift",
    "leapfrog_final_kick",
    "kick_drift_plain",
    "final_kick_plain",
]

_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
_INT_MAX = 2**31 - 1


def kick_drift_plain(q, p, grad, inv_mass, eps):
    """p_half = p + eps/2 * grad; q_new = q + eps * (inv_mass * p_half)."""
    p_half = p + 0.5 * eps[:, None] * grad
    return q + eps[:, None] * (inv_mass * p_half), p_half


def final_kick_plain(p_half, grad, inv_mass, eps):
    """p_new = p_half + eps/2 * grad; ke = 0.5 * sum_d p_new * inv_mass * p_new."""
    p_new = p_half + 0.5 * eps[:, None] * grad
    return p_new, 0.5 * torch.sum(p_new * inv_mass * p_new, dim=-1)


def _on_cpu(name, tensors, eps):
    """Validate the operands; True for CPU tensors, False for CUDA tensors."""
    ref = tensors[0]
    if ref.ndim != 2 or ref.shape[0] < 1 or ref.shape[1] < 1:
        raise ValueError(f"{name}: expected (C, D) with C, D >= 1, got {tuple(ref.shape)}")
    C, D = ref.shape
    if C > _INT_MAX or C * D > 2**62:
        raise ValueError(f"{name}: shape {tuple(ref.shape)} too large")
    if ref.dtype not in _SUFFIX:
        raise TypeError(f"{name}: dtype {ref.dtype} not supported (float32, float64)")
    for t in tensors:
        if t.shape != ref.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(ref.shape)}")
    if eps.shape != (C,):
        raise ValueError(f"{name}: eps shape {tuple(eps.shape)} != ({C},)")
    for t in (*tensors, eps):
        if t.dtype != ref.dtype:
            raise TypeError(f"{name}: mixed dtypes {t.dtype} and {ref.dtype}")
        if t.device != ref.device:
            raise ValueError(f"{name}: mixed devices {t.device} and {ref.device}")
    if ref.device.type == "cpu":
        return True
    if ref.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {ref.device}")
    if ref.device.index not in (None, torch.cuda.current_device()):
        raise ValueError(f"{name}: operands on {ref.device}, not the current device")
    for t in (*tensors, eps):
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    return False


_kernels = {}


def _kernel(prefix, dtype, n_ptrs):
    """The ctypes function `<prefix>_<f32|f64>`, typed on first use."""
    key = (prefix, dtype)
    if key not in _kernels:
        fn = getattr(_build.load_library("leapfrog"), f"{prefix}_{_SUFFIX[dtype]}")
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [
            ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _kernels[key] = fn
    return _kernels[key]


def _launch(prefix, tensors, C, D):
    fn = _kernel(prefix, tensors[0].dtype, len(tensors))
    stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
    rc = fn(*[t.data_ptr() for t in tensors], C, D, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {prefix} failed: cudaError {rc}")


def leapfrog_kick_drift(q, p, grad, inv_mass, eps):
    """(q, p) -> (q_new, p_half): half kick then drift, per chain row."""
    if _on_cpu("leapfrog_kick_drift", (q, p, grad, inv_mass), eps):
        return kick_drift_plain(q, p, grad, inv_mass, eps)
    C, D = q.shape
    q_new = torch.empty_like(q)
    p_half = torch.empty_like(p)
    _launch("pt_leapfrog_kick_drift", (q, p, grad, inv_mass, eps, q_new, p_half), C, D)
    leapfrog_kick_drift.launches += 1
    return q_new, p_half


def leapfrog_final_kick(p_half, grad, inv_mass, eps):
    """p_half -> (p_new, ke): final half kick and each chain's kinetic energy."""
    if _on_cpu("leapfrog_final_kick", (p_half, grad, inv_mass), eps):
        return final_kick_plain(p_half, grad, inv_mass, eps)
    C, D = p_half.shape
    p_new = torch.empty_like(p_half)
    ke = torch.empty((C,), dtype=p_half.dtype, device=p_half.device)
    _launch("pt_leapfrog_final_kick", (p_half, grad, inv_mass, eps, p_new, ke), C, D)
    leapfrog_final_kick.launches += 1
    return p_new, ke


leapfrog_kick_drift.launches = 0
leapfrog_final_kick.launches = 0
