"""Truncated distribution combinator.

Counterpart of `pymc_tpu/distributions/truncated.py:23-218` (reference
pymc/distributions/truncated.py:279): the base's density over the bounds,
less the log of the mass between them. Draws invert the cdf: uniforms in
[eps, 1 - eps] mapped into [F(lower^-), F(upper)] and through the base's
quantile, with no rejection loop; a discrete base with no quantile function
is inverted by an integer bisection on its cdf (`_icdf_discrete_scan`).
Those draws run some hundreds of eager launches a call (the bisections);
no log-density goes through them.
"""

from __future__ import annotations

import torch

from ..config import intX
from .censored import Bounded, _clip
from .dist_math import check_icdf_value, log1mexp
from .distribution import standard_uniform

__all__ = ["Truncated"]


class Truncated(Bounded):
    """The base restricted to [lower, upper] (either may be None)."""

    _kind = "Truncation"

    def __dist_init__(self, dist, lower=None, upper=None):
        super().__dist_init__(dist, lower, upper)
        if lower is None and upper is None:
            raise ValueError("Truncated requires lower and/or upper")

    @property
    def support(self):
        return "discrete" if self.is_discrete else "interval"

    def _lower_logcdf(self, lower, env, memo):
        """log F(lower^-): F(lower - 1) for a discrete base."""
        return self.base.logcdf(lower - 1 if self.is_discrete else lower, env, memo)

    def _log_norm(self, env, memo):
        """log(F(upper) - F(lower^-))."""
        lower, upper = self._bounds(env, memo)
        hi = self.base.logcdf(upper, env, memo) if upper is not None else 0.0
        if lower is None:
            return hi
        lo = self._lower_logcdf(lower, env, memo)
        return hi + log1mexp(torch.clamp(lo - hi, max=-1e-15))

    def logp(self, value, env=None, memo=None):
        memo = {} if memo is None else memo
        value = self._value(value, env, memo)
        res = self.base.logp(value, env, memo) - self._log_norm(env, memo)
        lower, upper = self._bounds(env, memo)
        if lower is not None:
            res = torch.where(value < lower, -torch.inf, res)
        if upper is not None:
            res = torch.where(value > upper, -torch.inf, res)
        return res

    def logcdf(self, value, env=None, memo=None):
        memo = {} if memo is None else memo
        value = self._value(value, env, memo)
        lower, upper = self._bounds(env, memo)
        num = self.base.logcdf(value, env, memo)
        if lower is not None:
            lo = self._lower_logcdf(lower, env, memo)
            num = num + log1mexp(torch.clamp(lo - num, max=-1e-15))
        res = torch.clamp(num - self._log_norm(env, memo), max=0.0)
        if lower is not None:
            res = torch.where(value < lower, -torch.inf, res)
        if upper is not None:
            res = torch.where(value >= upper, 0.0, res)
        return res

    def _cdf_range(self, env, memo):
        """(F(lower^-), F(upper)), 0 and 1 where a bound is None."""
        lower, upper = self._bounds(env, memo)
        lo_u = torch.exp(self._lower_logcdf(lower, env, memo)) if lower is not None else 0.0
        hi_u = torch.exp(self.base.logcdf(upper, env, memo)) if upper is not None else 1.0
        return lo_u, hi_u

    def icdf(self, q, env=None, memo=None):
        """The base's quantile at F(lower^-) + q (F(upper) - F(lower^-));
        NaN for q outside [0, 1], which the JAX package maps to a finite
        quantile inside the base's range."""
        memo = {} if memo is None else memo
        like = next(b for b in self._bounds(env, memo) if b is not None)
        q = torch.as_tensor(q).to(like)
        lo_u, hi_u = self._cdf_range(env, memo)
        return check_icdf_value(self.base.icdf(lo_u + q * (hi_u - lo_u), env, memo), q)

    def sample(self, generator, sample_shape=(), env=None, memo=None):
        """Inverse-cdf draws in the cdf's domain: exact, and rejection-free
        for any base with a quantile function (out of place, so that vmap
        draws anew for each point)."""
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        memo = {} if memo is None else memo
        full = tuple(sample_shape) + self.shape
        lower, upper = self._bounds(env, memo)
        like = lower if lower is not None else upper
        eps = torch.finfo(like.dtype).eps
        u = eps + (1.0 - 2.0 * eps) * standard_uniform(generator, full, like)
        lo_u, hi_u = self._cdf_range(env, memo)
        u = torch.clamp(lo_u + u * (hi_u - lo_u), eps, 1.0 - eps)
        try:
            draw = self.base.icdf(u, env, memo)
        except NotImplementedError:
            if not self.is_discrete:
                raise
            draw = self._icdf_discrete_scan(u, env, memo)
        if self.is_discrete:
            # the continuous-relaxed quantile ceiled onto the support
            return _clip(torch.ceil(draw - 1e-9), lower, upper).to(intX())
        return draw

    def _icdf_discrete_scan(self, u, env, memo):
        """The discrete quantile at `u` by a bisection on the integers: 40
        doublings of the bracket's top, then 60 halvings
        (`pymc_tpu/distributions/truncated.py:179-196`)."""
        logu = torch.log(u)
        lo = torch.full_like(u, -1.0)
        hi = torch.full_like(u, 1.0)
        for _ in range(40):
            hi = torch.where(self.base.logcdf(hi, env, memo) < logu, hi * 2.0, hi)
        for _ in range(60):
            mid = torch.floor((lo + hi) / 2.0)
            lt = self.base.logcdf(mid, env, memo) < logu
            lo, hi = torch.where(lt, mid, lo), torch.where(lt, hi, mid)
        return hi

    def support_point(self, env=None, memo=None):
        memo = {} if memo is None else memo
        lower, upper = self._bounds(env, memo)
        like = lower if lower is not None else upper
        pt = self.base.support_point(env, memo).to(like.dtype)
        step = 0.0 if self.is_discrete else 1.0
        if lower is not None:
            pt = torch.maximum(pt, lower + step)
        if upper is not None:
            pt = torch.minimum(pt, upper - step)
        if lower is not None and upper is not None:
            pt = _clip(pt, lower, upper)
            pt = torch.where((pt <= lower) | (pt >= upper), (lower + upper) / 2.0, pt)
        if self.is_discrete:
            pt = torch.round(pt).to(intX())
        return torch.broadcast_to(pt, self.shape)
