"""Value-space transforms (bijectors).

Counterpart of `pymc_tpu/distributions/transforms.py`, cut to the log
transform. Same convention as the reference: `forward` maps constrained ->
unconstrained, `backward` maps unconstrained -> constrained, and
`log_jac_det(v)` is log|d backward(v) / dv| at the unconstrained value `v`.
"""

from __future__ import annotations

import torch

__all__ = ["Transform", "LogTransform", "log"]


class Transform:
    name: str = "transform"

    def forward(self, x):
        raise NotImplementedError

    def backward(self, v):
        raise NotImplementedError

    def log_jac_det(self, v):
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}()"


class LogTransform(Transform):
    name = "log"

    def forward(self, x):
        return torch.log(x)

    def backward(self, v):
        return torch.exp(v)

    def log_jac_det(self, v):
        return v


log = LogTransform()
