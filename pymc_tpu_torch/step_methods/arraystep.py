"""Array-step names and the functional Metropolis selection.

Counterpart of `pymc_tpu/step_methods/arraystep.py` (ArrayStep :20,
ArrayStepShared :25, metrop_select :29; reference
pymc/step_methods/arraystep.py). A custom step subclasses
`compound.BlockedStep`, whose step works on batched value dicts; these
names keep code written against the reference importable.
"""

from __future__ import annotations

import torch

from .compound import BlockedStep

__all__ = ["ArrayStep", "ArrayStepShared", "metrop_select"]


class ArrayStep(BlockedStep):
    """BlockedStep under the reference's name: implement `init_state` and
    `step` on batched value dicts."""


class ArrayStepShared(ArrayStep):
    """ArrayStep (the reference's shared variables live in the graph
    here)."""


def metrop_select(u, mr, q, q0):
    """Metropolis accept/reject (reference arraystep.py:158): accept where
    log(u) < mr; returns (q where accepted else q0, accepted). `u` are the
    uniforms, of mr's shape (the reference draws them from a global rng);
    q and q0 are tensors or dicts of tensors whose leading axes are mr's."""
    mr = torch.as_tensor(mr)
    accept = torch.log(torch.as_tensor(u, dtype=mr.dtype)) < mr

    def pick(a, b):
        a, b = torch.as_tensor(a), torch.as_tensor(b)
        mask = accept.reshape(accept.shape + (1,) * (a.ndim - accept.ndim))
        return torch.where(mask, a, b)

    if isinstance(q, dict):
        return {k: pick(q[k], q0[k]) for k in q}, accept
    return pick(q, q0), accept
