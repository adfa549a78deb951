"""Discrete distributions.

Counterpart of `pymc_tpu/distributions/discrete.py` (Binomial :67 through
OrderedProbit :721; reference pymc/distributions/discrete.py). Values are
int64; a density casts them to its parameters' float type. A probability
given as a sigmoid node of the graph (`pm.math.sigmoid(z)`, or `logit_p=`)
is matched once, at construction (`_sigmoid_logit`), and the density then
reads the logit in the stable -softplus(-/+z) forms. Draws come from an
explicit `torch.Generator`: Binomial and Poisson through `torch.binomial`
and `torch.poisson`, NegativeBinomial as a gamma-Poisson mixture, the
categorical ones by the Gumbel-max trick, DiscreteWeibull and Geometric
by inverting a uniform. A discrete free variable cannot be sampled with
NUTS (its step methods are not ported): these classes serve observed data,
forward sampling and the mixtures. `_icdf` is not ported yet.
"""

from __future__ import annotations

import math
import warnings

import numpy as np
import torch

from ..graph import DeterministicNode, Node, apply
from .dist_math import (
    betainc, betaln, binomln, check_parameters, factln, gammaincc, log1mexp, logpow,
    normal_lcdf, safe_log, softplus,
)
from .continuous import standard_exponential, standard_gamma
from .distribution import Discrete, as_param, standard_uniform

__all__ = [
    "Binomial", "BetaBinomial", "Bernoulli", "DiscreteWeibull", "Poisson",
    "NegativeBinomial", "Geometric", "HyperGeometric", "DiscreteUniform",
    "Categorical", "OrderedLogistic", "OrderedProbit",
]


def _sigmoid_logit(p):
    """The logit node when `p` is sigmoid(z) in the graph, else None
    (pymc_tpu discrete.py:41): the density then takes the stable forms in
    z, which stay finite where p underflows."""
    if (
        isinstance(p, DeterministicNode)
        and not p.kwargs
        and len(p.args) == 1
        and p.fn in (torch.sigmoid, torch.special.expit)
    ):
        return p.args[0]
    return None


def _p_or_logit(p, logit_p):
    """(p node, logit node or None) from the `p`/`logit_p` arguments."""
    if p is not None and logit_p is not None:
        raise ValueError("Incompatible parametrization. Can't specify both p and logit_p.")
    if p is None and logit_p is None:
        raise ValueError("Incompatible parametrization. Must specify either p or logit_p.")
    if p is None:
        logit_p = as_param(logit_p)
        return apply(torch.sigmoid, logit_p), logit_p
    return as_param(p), _sigmoid_logit(p)


def _xlogy0(m, logx):
    """m * logx with the convention 0 * (-inf) = 0."""
    return torch.where(m == 0, 0.0, m * logx)


def _float(value, like):
    """`value` in `like`'s float type."""
    return value.to(like.dtype)


def _categorical(generator, logits):
    """Draws from the categorical of `logits` over their last axis, by the
    Gumbel-max trick (argmax of logits + Gumbel noise)."""
    gumbel = -torch.log(standard_exponential(generator, logits.shape, logits))
    return torch.argmax(logits + gumbel, dim=-1)


class Binomial(Discrete):
    """Reference discrete.py:73; `p` or `logit_p`."""

    param_names = ("n", "p")
    aux_param_names = ("logit_p",)

    def __dist_init__(self, n, p=None, logit_p=None):
        self.n = as_param(n)
        self.p, self.logit_p = _p_or_logit(p, logit_p)

    def _logp(self, value, n, p, logit_p=None):
        v = _float(value, n)
        if logit_p is not None:
            res = (
                binomln(n, v)
                + _xlogy0(v, -softplus(-logit_p))
                + _xlogy0(n - v, -softplus(logit_p))
            )
            res = torch.where((v >= 0) & (v <= n), res, -torch.inf)
            return check_parameters(res, n >= 0)
        res = binomln(n, v) + logpow(p, v) + logpow(1.0 - p, n - v)
        res = torch.where((v >= 0) & (v <= n), res, -torch.inf)
        return check_parameters(res, n >= 0, p >= 0, p <= 1)

    def _logcdf(self, value, n, p, logit_p=None):
        v = torch.floor(_float(value, n))
        safe_v = torch.clamp(torch.minimum(v, n), min=0.0)
        # CDF(k) = I_{1-p}(n - k, k + 1)
        a, b, x = torch.broadcast_tensors(torch.clamp(n - safe_v, min=1e-12), safe_v + 1.0, 1.0 - p)
        res = safe_log(betainc(a, b, x))
        res = torch.where(v < 0, -torch.inf, torch.where(v >= n, 0.0, res))
        return check_parameters(res, n >= 0, p >= 0, p <= 1)

    def _sample(self, generator, shape, n, p):
        n_b, p_b = torch.broadcast_to(n, shape), torch.broadcast_to(p, shape)
        return torch.binomial(n_b.contiguous(), p_b.contiguous(), generator=generator)

    def _support_point(self, n, p):
        return torch.round(n * p)


class BetaBinomial(Discrete):
    """Reference discrete.py:178."""

    param_names = ("n", "alpha", "beta")

    def __dist_init__(self, alpha, beta, n):
        self.n = as_param(n)
        self.alpha = as_param(alpha)
        self.beta = as_param(beta)

    def _logp(self, value, n, alpha, beta):
        v = _float(value, n)
        res = binomln(n, v) + betaln(v + alpha, n - v + beta) - betaln(alpha, beta)
        res = torch.where((v >= 0) & (v <= n), res, -torch.inf)
        return check_parameters(res, alpha > 0, beta > 0, n >= 0)

    def _sample(self, generator, shape, n, alpha, beta):
        ga = standard_gamma(generator, alpha.expand(shape))
        gb = standard_gamma(generator, beta.expand(shape))
        p = ga / (ga + gb)
        return torch.binomial(torch.broadcast_to(n, shape).contiguous(), p, generator=generator)

    def _support_point(self, n, alpha, beta):
        return torch.round(n * alpha / (alpha + beta))


class Bernoulli(Discrete):
    """Reference discrete.py:296; `p` or `logit_p`."""

    param_names = ("p",)
    aux_param_names = ("logit_p",)

    def __dist_init__(self, p=None, logit_p=None):
        self.p, self.logit_p = _p_or_logit(p, logit_p)

    def _logp(self, value, p, logit_p=None):
        if logit_p is not None:
            # -softplus(-logit_p) at 1 and -softplus(logit_p) at 0, with one
            # softplus over the sign-flipped logit (the flip is exact)
            res = -softplus(torch.where(value == 1, -logit_p, logit_p))
            return torch.where((value == 0) | (value == 1), res, -torch.inf)
        res = torch.where(value == 1, safe_log(p), safe_log(1.0 - p))
        res = torch.where((value == 0) | (value == 1), res, -torch.inf)
        return check_parameters(res, p >= 0, p <= 1)

    def _logcdf(self, value, p, logit_p=None):
        if logit_p is not None:
            res = torch.where(value >= 1, 0.0, -softplus(logit_p))
            return torch.where(value < 0, -torch.inf, res)
        res = torch.where(value >= 1, 0.0, safe_log(1.0 - p))
        res = torch.where(value < 0, -torch.inf, res)
        return check_parameters(res, p >= 0, p <= 1)

    def _sample(self, generator, shape, p):
        return standard_uniform(generator, shape, p) < p

    def _support_point(self, p):
        return p > 0.5


class DiscreteWeibull(Discrete):
    """Reference discrete.py:430 (q, beta parametrization)."""

    param_names = ("q", "beta")

    def __dist_init__(self, q, beta):
        self.q = as_param(q)
        self.beta = as_param(beta)

    def _logp(self, value, q, beta):
        safe = torch.clamp(_float(value, q), min=0.0)
        lq = torch.log(q)
        a = lq * safe**beta
        b = lq * (safe + 1.0) ** beta
        res = a + log1mexp(b - a)
        res = torch.where(value >= 0, res, -torch.inf)
        return check_parameters(res, q > 0, q < 1, beta > 0)

    def _logcdf(self, value, q, beta):
        safe = torch.clamp(torch.floor(_float(value, q)), min=0.0)
        res = log1mexp(torch.log(q) * (safe + 1.0) ** beta)
        res = torch.where(value >= 0, res, -torch.inf)
        return check_parameters(res, q > 0, q < 1, beta > 0)

    def _sample(self, generator, shape, q, beta):
        # the smallest k with 1 - q^((k + 1)^beta) >= u
        u = standard_uniform(generator, shape, q)
        k = torch.ceil((torch.log1p(-u) / torch.log(q)) ** (1.0 / beta) - 1.0)
        return torch.clamp(k, min=0.0)

    def _support_point(self, q, beta):
        # the median (log 0.5 / log q)^(1/beta) - 1, floored
        k = (math.log(0.5) / torch.log(q)) ** (1.0 / beta) - 1.0
        return torch.clamp(torch.floor(k), min=0.0)


class Poisson(Discrete):
    """Reference discrete.py:522."""

    param_names = ("mu",)

    def __dist_init__(self, mu):
        self.mu = as_param(mu)

    def _logp(self, value, mu):
        v = _float(value, mu)
        res = logpow(mu, v) - factln(v) - mu
        res = torch.where(value >= 0, res, -torch.inf)
        return check_parameters(res, mu >= 0)

    def _logcdf(self, value, mu):
        v = torch.floor(_float(value, mu))
        safe = torch.clamp(v, min=0.0)
        # CDF(k) = Q(k + 1, mu); Q(inf, mu) is 0, CDF(inf) exactly 1
        a, x = torch.broadcast_tensors(safe + 1.0, mu)
        res = safe_log(gammaincc(a, x))
        res = torch.where(v >= 0, res, -torch.inf)
        res = torch.where(v == torch.inf, 0.0, res)
        return check_parameters(res, mu >= 0)

    def _sample(self, generator, shape, mu):
        return torch.poisson(torch.broadcast_to(mu, shape).contiguous(), generator=generator)

    def _support_point(self, mu):
        return torch.floor(mu)


class NegativeBinomial(Discrete):
    """Reference discrete.py:618; (mu, alpha) or (p, n), mixed pairs valid.
    With mu given, the density reads mu itself (p = n / (mu + n) rounds to
    1 at a large n, and mu cannot be had back from it)."""

    param_names = ("n", "p")
    aux_param_names = ("logit_p", "mu")

    def __dist_init__(self, mu=None, alpha=None, p=None, n=None):
        n_, p_ = self.get_n_p(mu=mu, alpha=alpha, p=p, n=n)
        self.n = as_param(n_)
        self.p = as_param(p_)
        self.logit_p = _sigmoid_logit(self.p)
        self.mu = as_param(mu) if (p is None and mu is not None) else None

    @classmethod
    def get_n_p(cls, mu=None, alpha=None, p=None, n=None):
        """Resolve the (mu, alpha) / (p, n) parametrizations; a role given
        twice raises (reference discrete.py:703-721)."""
        if n is None:
            if alpha is None:
                raise ValueError("Incompatible parametrization. Must specify either alpha or n.")
            n = alpha
        elif alpha is not None:
            raise ValueError("Incompatible parametrization. Can't specify both alpha and n.")
        if p is None:
            if mu is None:
                raise ValueError("Incompatible parametrization. Must specify either mu or p.")
            p = apply(lambda nn, mm: nn / (mm + nn), as_param(n), as_param(mu))
        elif mu is not None:
            raise ValueError("Incompatible parametrization. Can't specify both mu and p.")
        return n, p

    def _logp(self, value, n, p, logit_p=None, mu=None):
        v = _float(value, n)
        if logit_p is not None:
            log_p, log1m_p = -softplus(-logit_p), -softplus(logit_p)
        elif mu is not None:
            log_mu_n = torch.log(mu + n)
            log_p, log1m_p = safe_log(n) - log_mu_n, safe_log(mu) - log_mu_n
        else:
            log_p, log1m_p = safe_log(p), torch.log1p(-p)
        # the Poisson(mu) limit at a large n, where binomln's difference of
        # lgammas falls below their ulp; the unused branch stays NaN-free
        # under grad through the clamped exponent
        mu_val = mu if mu is not None else n * torch.exp(
            torch.clamp(log1m_p - log_p, -700.0, 700.0))
        poisson_res = logpow(mu_val, v) - mu_val - factln(v)
        nb_res = binomln(v + n - 1.0, v) + _xlogy0(n, log_p) + _xlogy0(v, log1m_p)
        res = torch.where(n > 1e10, poisson_res, nb_res)
        res = torch.where(value >= 0, res, -torch.inf)
        if logit_p is not None:
            return check_parameters(res, n > 0)
        if mu is not None:
            return check_parameters(res, n > 0, mu >= 0)
        # a valid tiny p can round to 0 (sigmoid(-800) is 0.0): p >= 0 keeps
        # it, at the cost of the limiting -inf for a degenerate p == 0
        return check_parameters(res, n > 0, p >= 0, p <= 1)

    def _logcdf(self, value, n, p, logit_p=None, mu=None):
        safe = torch.clamp(torch.floor(_float(value, n)), min=0.0)
        a, b, x = torch.broadcast_tensors(n, safe + 1.0, p)
        res = safe_log(betainc(a, b, x))
        res = torch.where(value >= 0, res, -torch.inf)
        return check_parameters(res, n > 0, p >= 0, p <= 1)

    def _sample(self, generator, shape, n, p):
        # the gamma-Poisson mixture
        g = standard_gamma(generator, n.expand(shape)) * (1.0 - p) / p
        return torch.poisson(g, generator=generator)

    def _support_point(self, n, p):
        return torch.floor(n * (1.0 - p) / p)


class Geometric(Discrete):
    """Reference discrete.py:765; support {1, 2, ...}."""

    param_names = ("p",)
    aux_param_names = ("logit_p",)

    def __dist_init__(self, p):
        self.p = as_param(p)
        self.logit_p = _sigmoid_logit(self.p)

    def _logp(self, value, p, logit_p=None):
        if logit_p is not None:
            v = _float(value, logit_p)
            res = -softplus(-logit_p) + _xlogy0(v - 1.0, -softplus(logit_p))
            return torch.where(value >= 1, res, -torch.inf)
        res = torch.log(p) + logpow(1.0 - p, _float(value, p) - 1.0)
        res = torch.where(value >= 1, res, -torch.inf)
        return check_parameters(res, p > 0, p <= 1)

    def _logcdf(self, value, p, logit_p=None):
        like = p if logit_p is None else logit_p
        safe = torch.clamp(torch.floor(_float(value, like)), min=1.0)
        log1m_p = -softplus(logit_p) if logit_p is not None else torch.log1p(-p)
        res = log1mexp(safe * log1m_p)
        res = torch.where(value >= 1, res, -torch.inf)
        if logit_p is not None:
            return res
        return check_parameters(res, p > 0, p <= 1)

    def _sample(self, generator, shape, p):
        u = standard_uniform(generator, shape, p)
        return torch.clamp(torch.ceil(torch.log1p(-u) / torch.log1p(-p)), min=1.0)

    def _support_point(self, p):
        return torch.clamp(torch.round(1.0 / p), min=1.0)


class HyperGeometric(Discrete):
    """Reference discrete.py:859: N population, k successes, n draws."""

    param_names = ("N", "k", "n")

    def __dist_init__(self, N, k, n):
        self.N = as_param(N)
        self.k = as_param(k)
        self.n = as_param(n)

    @staticmethod
    def _table(v, N, k, n):
        res = binomln(k, v) + binomln(N - k, n - v) - binomln(N, n)
        lower = torch.clamp(n - (N - k), min=0.0)
        return torch.where((v >= lower) & (v <= torch.minimum(k, n)), res, -torch.inf)

    def _logp(self, value, N, k, n):
        res = self._table(_float(value, N), N, k, n)
        return check_parameters(res, N >= 0, k >= 0, n >= 0, k <= N, n <= N)

    def _sample(self, generator, shape, N, k, n):
        # a categorical over the support 0 .. max(min(k, n)), read once
        # from the host (the support's length is the table's width)
        kmax = int(torch.max(torch.minimum(k, n)).item())
        ks = torch.arange(kmax + 1, dtype=N.dtype, device=N.device)
        logits = self._table(ks, N[..., None], k[..., None], n[..., None])
        logits = torch.broadcast_to(logits, tuple(shape) + (kmax + 1,))
        return _categorical(generator, logits)

    def _support_point(self, N, k, n):
        return torch.floor(n * k / N)


class DiscreteUniform(Discrete):
    """Reference discrete.py:1000."""

    param_names = ("lower", "upper")

    def __dist_init__(self, lower, upper):
        self.lower = as_param(lower)
        self.upper = as_param(upper)

    def _logp(self, value, lower, upper):
        res = -torch.log(upper - lower + 1.0)
        res = torch.where((value >= lower) & (value <= upper), res, -torch.inf)
        return check_parameters(res, lower <= upper)

    def _logcdf(self, value, lower, upper):
        v = torch.floor(_float(value, lower))
        frac = (torch.minimum(torch.maximum(v, lower), upper) - lower + 1.0) / (upper - lower + 1.0)
        res = torch.log(frac)
        res = torch.where(v < lower, -torch.inf, torch.where(v >= upper, 0.0, res))
        return check_parameters(res, lower <= upper)

    def _sample(self, generator, shape, lower, upper):
        u = standard_uniform(generator, shape, lower)
        return lower + torch.floor(u * (upper - lower + 1.0))

    def _support_point(self, lower, upper):
        return torch.floor((lower + upper) / 2.0)


def _take_value(table, value, k):
    """table[..., value] with the batch dims of both the value and the
    table (a scalar value against a batch of tables broadcasts)."""
    batch = torch.broadcast_shapes(value.shape, table.shape[:-1])
    v = torch.broadcast_to(torch.clamp(value, 0, k - 1), batch).to(torch.int64)
    return torch.take_along_dim(torch.broadcast_to(table, batch + (k,)), v[..., None],
                                dim=-1)[..., 0]


class Categorical(Discrete):
    """Reference discrete.py:1099; `p` (or `logit_p`) along the last axis.
    A constant `p` with a negative entry raises; one that does not sum to 1
    is rescaled with a warning. A symbolic `p` is held to its sum at logp
    time."""

    param_names = ("p",)
    param_event_ndims = (1,)

    def __dist_init__(self, p=None, logit_p=None):
        if p is not None and logit_p is not None:
            raise ValueError("Incompatible parametrization. Can't specify both p and logit_p.")
        if p is None and logit_p is None:
            raise ValueError("Incompatible parametrization. Must specify either p or logit_p.")
        if p is None:
            p = apply(lambda lp: torch.softmax(lp, dim=-1), as_param(logit_p))
        elif not isinstance(p, Node):
            p_ = np.asarray(p, dtype=float)
            if np.any(p_ < 0):
                raise ValueError(f"Negative `p` parameters are not valid, got: {p_}")
            p_sum = np.sum(p_, axis=-1)
            if not np.all(np.isclose(p_sum, 1.0)):
                warnings.warn(
                    f"`p` parameters sum to {p_sum}, instead of 1.0. "
                    "They will be automatically rescaled.",
                    UserWarning,
                )
                p = p_ / np.sum(p_, axis=-1, keepdims=True)
        self.p = as_param(p)

    @property
    def n_categories(self):
        return self.p.shape[-1]

    @staticmethod
    def _checks(p):
        return (torch.all(p >= 0, dim=-1), torch.all(p <= 1, dim=-1),
                torch.isclose(torch.sum(p, dim=-1), torch.ones((), dtype=p.dtype, device=p.device)))

    def _logp(self, value, p):
        k = p.shape[-1]
        res = _take_value(safe_log(p), value, k)
        res = torch.where((value >= 0) & (value <= k - 1), res, -torch.inf)
        return check_parameters(res, *self._checks(p))

    def _logcdf(self, value, p):
        k = p.shape[-1]
        res = _take_value(safe_log(torch.cumsum(p, dim=-1)), value, k)
        res = torch.where(value < 0, -torch.inf, torch.where(value >= k - 1, 0.0, res))
        return check_parameters(res, *self._checks(p))

    def _sample(self, generator, shape, p):
        logits = torch.broadcast_to(safe_log(p), tuple(shape) + (p.shape[-1],))
        return _categorical(generator, logits)

    def _support_point(self, p):
        return torch.argmax(p, dim=-1)


class _OrderedBase(Discrete):
    """P(y = k) = F(c_k - eta) - F(c_{k-1} - eta) for the link's cdf F. On
    the named path `compute_p` (default True) registers `{name}_probs`, a
    Deterministic of the category probabilities (reference
    discrete.py:1301-1306)."""

    _named_only_kwargs = ("compute_p",)
    param_names = ("eta", "cutpoints")
    param_event_ndims = (0, 1)

    def __dist_init__(self, eta, cutpoints):
        self.eta = as_param(eta)
        self.cutpoints = as_param(cutpoints)

    @staticmethod
    def _link_logcdf(z):  # pragma: no cover - abstract
        raise NotImplementedError

    @classmethod
    def _category_logits(cls, eta, cutpoints, sigma=None):
        z = cutpoints - eta[..., None]
        if sigma is not None:
            z = z / sigma[..., None]
        lcdf = cls._link_logcdf(z)
        lo = torch.cat([torch.full_like(lcdf[..., :1], -torch.inf), lcdf], dim=-1)
        hi = torch.cat([lcdf, torch.zeros_like(lcdf[..., :1])], dim=-1)
        return hi + log1mexp(torch.clamp(lo - hi, max=-1e-15))

    @classmethod
    def compute_p(cls, eta, cutpoints, sigma=None):
        """The category probabilities (reference OrderedLogistic.compute_p
        discrete.py:1313, OrderedProbit.compute_p :1419)."""
        args = [as_param(eta), as_param(cutpoints)]
        if sigma is not None:
            args.append(as_param(sigma))
        return apply(lambda *xs: torch.exp(cls._category_logits(*xs)), *args)

    @classmethod
    def _post_register(cls, model, name, dist, rv, compute_p=True):
        if not compute_p:
            return
        from ..model.core import Deterministic

        probs = cls.compute_p(*[getattr(dist, n) for n in dist.param_names])
        Deterministic(f"{name}_probs", probs, model=model)

    def _logp(self, value, eta, cutpoints, sigma=None):
        logits = self._category_logits(eta, cutpoints, sigma)
        k = logits.shape[-1]
        res = _take_value(logits, value, k)
        return torch.where((value >= 0) & (value <= k - 1), res, -torch.inf)

    def _logcdf(self, value, eta, cutpoints, sigma=None):
        logits = self._category_logits(eta, cutpoints, sigma)
        k = logits.shape[-1]
        res = _take_value(torch.log(torch.cumsum(torch.exp(logits), dim=-1)), value, k)
        return torch.where(value < 0, -torch.inf, torch.where(value >= k - 1, 0.0, res))

    def _sample(self, generator, shape, eta, cutpoints, sigma=None):
        logits = self._category_logits(eta, cutpoints, sigma)
        return _categorical(generator, torch.broadcast_to(logits, tuple(shape) + logits.shape[-1:]))

    def _support_point(self, eta, cutpoints, sigma=None):
        return torch.argmax(self._category_logits(eta, cutpoints, sigma), dim=-1)


class OrderedLogistic(_OrderedBase):
    """Reference discrete.py:1231."""

    @staticmethod
    def _link_logcdf(z):
        return -softplus(-z)


class OrderedProbit(_OrderedBase):
    """Reference discrete.py:1329; a probit scale `sigma`."""

    param_names = ("eta", "cutpoints", "sigma")
    param_event_ndims = (0, 1, 0)

    def __dist_init__(self, eta, cutpoints, sigma=1.0):
        super().__dist_init__(eta, cutpoints)
        self.sigma = as_param(sigma)

    @staticmethod
    def _link_logcdf(z):
        return normal_lcdf(0.0, 1.0, z)
