"""The leapfrog of batched NUTS with a diagonal mass, and its fused leaf.

Counterpart of the Pallas kernels `leapfrog_kick_drift` and
`leapfrog_final_kick` in `pymc_tpu/ops/pallas_kernels.py`, and of one pass
of the leaf loop of `pymc_tpu/sampling/nuts.py::_build_subtree_b` (`body`,
:485-558) after its logp+grad. On the card each wrapper launches its
hand-written CUDA kernel (`csrc/leapfrog.cu`, built for sm_90a at first use)
or raises; there is no fallback. Its plain PyTorch version runs only when
the tensors lie on the CPU, which is what the parity tests exercise. Each
wrapper counts its kernel launches in `.launches`.

Shapes: q, p, grad, inv_mass are (C, D); eps is (C,), the signed per-chain
step size; float32 or float64, all of one dtype, contiguous, on one device.
"""

from __future__ import annotations

import copy
import ctypes

import torch

from . import _build

__all__ = [
    "leapfrog_kick_drift",
    "leapfrog_final_kick",
    "kick_drift_plain",
    "final_kick_plain",
    "SubtreeState",
    "nuts_leaf_step",
    "nuts_leaf_step_plain",
    "popcount",
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


MAX_ENERGY_ERROR = 1000.0  # divergence threshold (reference nuts.py:419-440)


def popcount(x):
    """Number of set bits of each int32 (x >= 0): torch has no popcount."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x + (x >> 8) + (x >> 16) + (x >> 24)) & 0x3F


# The pointers of `LeafBuffers` in csrc/leapfrog.cu, in its order: the
# subtree's fixed inputs, then the buffers that each leaf updates in place.
_LEAF_POINTERS = (
    "inv_mass", "eps", "h0", "active0", "n_target",
    "n", "q", "p", "grad", "logp",
    "prop_q", "prop_p", "prop_grad", "prop_logp", "prop_energy",
    "log_size", "sum_accept", "max_eerr",
    "p_sum", "p_ckpt", "psum_ckpt",
    "turning", "diverging", "act", "q_half", "p_half", "count",
)


class _LeafBuffers(ctypes.Structure):
    _fields_ = [(name, ctypes.c_void_p) for name in _LEAF_POINTERS] + [
        ("C", ctypes.c_int64), ("D", ctypes.c_int64), ("S", ctypes.c_int64),
    ]


class SubtreeState:
    """One NUTS subtree of C chains, in buffers that `nuts_leaf_step`
    updates in place, one leaf a call (the counterpart of `_SubtreeState`
    of the JAX package's nuts.py).

    Built from the subtree's start q0, p0, grad0 (C, D) and logp0 (C,); h0
    (C,), the energy at the trajectory's start; inv_mass (C, D); eps (C,),
    the signed step; active0 (C,) bool, the chains that build this subtree;
    depth (C,) int32 in [0, 30], so 2**depth leaves; and `slots`, the number S of
    checkpoint slots (max_treedepth + 1). Building it runs the first leaf's
    half kick and drift (`leapfrog_kick_drift`), so q_half holds the point
    whose logp+grad the first leaf needs.

    A row that does not step at a leaf keeps every buffer as it is: once a
    row stops, it never steps again within the subtree (turning, diverging
    and n >= n_target stay), so its q_half and p_half are dead.

    Buffers (BUFFERS, each written only in place):
      n (C,) int32            leaves built so far
      q, p, grad, logp        the last leaf
      prop_q, prop_p, prop_grad, prop_logp, prop_energy
                              the multinomial proposal
      log_size, sum_accept    logsumexp of the leaves' weights; summed accept
      max_eerr                signed max |energy error|
      p_sum (C, D)            momentum sum over the leaves
      p_ckpt, psum_ckpt       (C, S, D) leaf i's momentum and the exclusive
                              prefix sum, at slot popcount(i) for even i
      turning, diverging, act (C,) bool; act: the chains that step at the
                              next leaf
      q_half, p_half          the next leaf's half kick and drift (on the
                              rows that stepped at the last leaf)
      count (2,) int32        after leaf k, the number of chains in act
                              is count[k & 1]
    """

    BUFFERS = _LEAF_POINTERS[5:]

    def __init__(self, q0, p0, grad0, logp0, h0, inv_mass, eps, active0, depth, slots):
        _on_cpu("SubtreeState", (q0, p0, grad0, inv_mass), eps)
        C, D = q0.shape
        for name, t, dtype in (
            ("logp0", logp0, q0.dtype), ("h0", h0, q0.dtype),
            ("active0", active0, torch.bool), ("depth", depth, torch.int32),
        ):
            if t.shape != (C,) or t.dtype != dtype or t.device != q0.device:
                raise ValueError(
                    f"SubtreeState: {name} must be ({C},) {dtype} on {q0.device}, got "
                    f"{tuple(t.shape)} {t.dtype} on {t.device}"
                )
        if not 1 <= slots <= 32:
            raise ValueError(f"SubtreeState: slots must be in [1, 32], got {slots}")
        self.inv_mass, self.eps = inv_mass, eps
        self.n_target = torch.ones_like(depth) << depth
        self.n = torch.zeros((C,), dtype=torch.int32, device=q0.device)
        (self.q, self.p, self.grad, self.prop_q, self.prop_p, self.prop_grad,
         self.p_sum) = torch.stack(
            (q0, p0, grad0, q0, p0, grad0, torch.zeros_like(q0))
        ).unbind(0)
        (self.h0, self.logp, self.prop_logp, self.prop_energy, self.log_size,
         self.sum_accept, self.max_eerr) = torch.stack((
            h0, logp0, logp0, h0, torch.full_like(h0, -torch.inf),
            torch.zeros_like(h0), torch.zeros_like(h0),
        )).unbind(0)
        self.p_ckpt, self.psum_ckpt = torch.zeros(
            (2, C, slots, D), dtype=q0.dtype, device=q0.device
        ).unbind(0)
        no = torch.zeros_like(active0)
        self.active0, self.act, self.turning, self.diverging = torch.stack(
            (active0, active0, no, no)
        ).unbind(0)
        self.count = torch.zeros((2,), dtype=torch.int32, device=q0.device)
        self.leaf = 0  # leaves stepped: the parity picks the counter
        self.q_half, self.p_half = leapfrog_kick_drift(q0, p0, grad0, inv_mass, eps)
        self._buffers = None

    def clone(self):
        """A copy with buffers of its own: stepping it leaves this one as it is."""
        twin = copy.copy(self)
        for name in _LEAF_POINTERS:
            setattr(twin, name, getattr(self, name).clone())
        twin._buffers = None
        return twin

    def buffers(self):
        """The kernel's `LeafBuffers`, filled once (the tensors never move)."""
        if self._buffers is None:
            C, D = self.q.shape
            self._buffers = _LeafBuffers(
                *[getattr(self, f).data_ptr() for f in _LEAF_POINTERS],
                C, D, self.p_ckpt.shape[1],
            )
        return self._buffers


def _w(mask, new, old):
    """where(mask, new, old) with mask (C,) broadcast over trailing dims."""
    return torch.where(mask.reshape(mask.shape + (1,) * (new.ndim - 1)), new, old)


def nuts_leaf_step_plain(s, logp, grad, u):
    """One leaf of subtree `s` in plain PyTorch, in place: the body of the
    leaf loop after logp, grad = logp_grad(s.q_half), with the leaf's
    uniforms u (C,). The leaves at odd n check the completed subtrees ending
    there for a U-turn against their start slots. Then the next leaf's half
    kick and drift on the rows that stepped, and the active chains of the
    next leaf. Returns their number, count[k & 1] after leaf k.
    """
    act = s.act
    p, ke = final_kick_plain(s.p_half, grad, s.inv_mass, s.eps)
    q = s.q_half
    energy = -logp + ke
    eerr = energy - s.h0
    eerr_ok = torch.isfinite(eerr)
    diverging = act & (~eerr_ok | (eerr > MAX_ENERGY_ERROR))
    eerr_safe = torch.where(eerr_ok, eerr, torch.inf)

    log_w = -eerr_safe
    log_size_new = torch.logaddexp(s.log_size, log_w)
    accept_prob = torch.exp(torch.clamp(log_w, max=0.0))
    take = act & ~diverging & (torch.log(u) < log_w - log_size_new)

    n = s.n
    is_even = (n & 1) == 0
    pc = popcount(n)
    slots = torch.arange(s.p_ckpt.shape[1], dtype=torch.int32, device=n.device)
    sel = (slots[None, :] == pc[:, None]) & (is_even & act)[:, None]
    p_ckpt = torch.where(sel[..., None], p[:, None, :], s.p_ckpt)
    psum_ckpt = torch.where(sel[..., None], s.p_sum[:, None, :], s.psum_ckpt)
    p_sum = _w(act & ~diverging, s.p_sum + p, s.p_sum)

    # U-turn checks of the completed subtrees ending at odd leaves,
    # vectorised over chains and checkpoint slots
    t_ones = popcount(n ^ (n + 1)) - 1
    c_hi = pc - 1
    c_lo = pc - t_ones
    slot_active = (slots[None, :] >= c_lo[:, None]) & (slots[None, :] <= c_hi[:, None])
    rho_all = p_sum[:, None, :] - psum_ckpt  # (C, S, D)
    v_starts = s.inv_mass[:, None, :] * p_ckpt
    dot_start = torch.sum(v_starts * rho_all, dim=-1)  # (C, S)
    dot_leaf = torch.sum(rho_all * (s.inv_mass * p)[:, None, :], dim=-1)
    any_turn = torch.any(slot_active & ((dot_start <= 0.0) | (dot_leaf <= 0.0)), dim=-1)
    turning = torch.where(act & ~is_even & ~diverging, s.turning | any_turn, s.turning)
    abs_bigger = torch.abs(eerr_safe) > torch.abs(s.max_eerr)

    s.n.copy_(torch.where(act, n + 1, n))
    s.q.copy_(_w(act, q, s.q))
    s.p.copy_(_w(act, p, s.p))
    s.grad.copy_(_w(act, grad, s.grad))
    s.logp.copy_(torch.where(act, logp, s.logp))
    s.prop_q.copy_(_w(take, q, s.prop_q))
    s.prop_p.copy_(_w(take, p, s.prop_p))
    s.prop_grad.copy_(_w(take, grad, s.prop_grad))
    s.prop_logp.copy_(torch.where(take, logp, s.prop_logp))
    s.prop_energy.copy_(torch.where(take, energy, s.prop_energy))
    s.log_size.copy_(torch.where(act & ~diverging, log_size_new, s.log_size))
    s.sum_accept.copy_(torch.where(act, s.sum_accept + accept_prob, s.sum_accept))
    s.max_eerr.copy_(torch.where(act & abs_bigger, eerr_safe, s.max_eerr))
    s.p_sum.copy_(p_sum)
    s.p_ckpt.copy_(p_ckpt)
    s.psum_ckpt.copy_(psum_ckpt)
    s.turning.copy_(turning)
    s.diverging.copy_(torch.where(act, diverging, s.diverging))

    q_half, p_half = kick_drift_plain(s.q, s.p, s.grad, s.inv_mass, s.eps)
    s.q_half.copy_(_w(act, q_half, s.q_half))
    s.p_half.copy_(_w(act, p_half, s.p_half))
    s.act.copy_(s.active0 & (s.n < s.n_target) & ~s.turning & ~s.diverging)
    k = s.leaf
    s.count[k & 1] = s.act.sum()
    s.count[(k + 1) & 1] = 0
    s.leaf = k + 1
    return s.count[k & 1]


def nuts_leaf_step(s, logp, grad, u):
    """One leaf of subtree `s` (a SubtreeState), in place, after logp, grad
    = logp_grad(s.q_half); u (C,) holds the leaf's uniforms. Returns the
    number of chains that step at the next leaf, a 0-d int32 tensor on the
    state's device (reading it is the leaf's one host sync)."""
    C, D = s.q.shape
    for name, t, shape in (("logp", logp, (C,)), ("grad", grad, (C, D)), ("u", u, (C,))):
        if t.shape != shape:
            raise ValueError(f"nuts_leaf_step: {name} shape {tuple(t.shape)} != {shape}")
        if t.dtype != s.q.dtype:
            raise TypeError(f"nuts_leaf_step: {name} dtype {t.dtype} != {s.q.dtype}")
        if t.device != s.q.device:
            raise ValueError(f"nuts_leaf_step: {name} on {t.device}, state on {s.q.device}")
        if not t.is_contiguous():
            raise ValueError(f"nuts_leaf_step: {name} must be contiguous")
    if s.q.device.type == "cpu":
        return nuts_leaf_step_plain(s, logp, grad, u)
    fn = _leaf_kernel(s.q.dtype)
    k = s.leaf
    stream = torch.cuda.current_stream(s.q.device).cuda_stream
    rc = fn(ctypes.byref(s.buffers()), logp.data_ptr(), grad.data_ptr(), u.data_ptr(), k, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA launch of pt_nuts_leaf failed: cudaError {rc}")
    s.leaf = k + 1
    nuts_leaf_step.launches += 1
    return s.count[k & 1]


def _leaf_kernel(dtype):
    """The ctypes function `pt_nuts_leaf_<f32|f64>`, typed on first use."""
    key = ("pt_nuts_leaf", dtype)
    if key not in _kernels:
        lib = _build.load_library("leapfrog")
        size = lib.pt_nuts_leaf_buffers_size
        size.argtypes, size.restype = [], ctypes.c_int64
        if size() != ctypes.sizeof(_LeafBuffers):
            raise RuntimeError(
                f"_LeafBuffers is {ctypes.sizeof(_LeafBuffers)} bytes, the kernel's "
                f"LeafBuffers {size()}: the two structs differ"
            )
        fn = getattr(lib, f"pt_nuts_leaf_{_SUFFIX[dtype]}")
        fn.argtypes = [
            ctypes.POINTER(_LeafBuffers), ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _kernels[key] = fn
    return _kernels[key]


nuts_leaf_step.launches = 0
