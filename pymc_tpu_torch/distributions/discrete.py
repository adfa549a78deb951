"""Discrete distributions: Bernoulli.

Counterpart of `pymc_tpu/distributions/discrete.py` (Bernoulli :156;
reference pymc/distributions/discrete.py:296), logp and support point. The
JAX package also matches a sigmoid node handed in as `p` and uses its
logit (`_sigmoid_logit`, :41); the port's graph has no sigmoid node to
match yet, so `p` is always taken as a probability.
"""

from __future__ import annotations

import torch

from ..config import intX
from ..graph import apply, evaluate
from .dist_math import check_parameters, safe_log, softplus
from .distribution import Discrete, as_param, standard_uniform

__all__ = ["Bernoulli"]


class Bernoulli(Discrete):
    """Reference discrete.py:296; `p` or `logit_p`."""

    param_names = ("p",)

    def __dist_init__(self, p=None, logit_p=None):
        if p is not None and logit_p is not None:
            raise ValueError(
                "Incompatible parametrization. Can't specify both p and logit_p."
            )
        if p is None and logit_p is None:
            raise ValueError(
                "Incompatible parametrization. Must specify either p or logit_p."
            )
        if p is None:
            self.logit_p = as_param(logit_p)
            p = apply(torch.sigmoid, self.logit_p)
        else:
            self.logit_p = None
        self.p = as_param(p)

    def logp(self, value, env=None, memo=None):
        # with logit_p the density is a function of the logit and never
        # reads p, whose sigmoid eager PyTorch would compute all the same
        if self.logit_p is not None:
            return self._logp(value, None, logit_p=evaluate(self.logit_p, env, memo))
        return super().logp(value, env, memo)

    def _logp(self, value, p, logit_p=None):
        if logit_p is not None:
            # -softplus(-logit_p) at 1 and -softplus(logit_p) at 0, with one
            # softplus over the sign-flipped logit (the flip is exact)
            res = -softplus(torch.where(value == 1, -logit_p, logit_p))
            return torch.where((value == 0) | (value == 1), res, -torch.inf)
        res = torch.where(value == 1, safe_log(p), safe_log(1.0 - p))
        res = torch.where((value == 0) | (value == 1), res, -torch.inf)
        return check_parameters(res, p >= 0, p <= 1)

    def _sample(self, generator, shape, p):
        return (standard_uniform(generator, shape, p) < p).to(intX())

    def _support_point(self, p):
        return (p > 0.5).to(intX())
