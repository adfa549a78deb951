"""Numeric helpers shared by distribution log-densities.

Counterpart of `pymc_tpu/distributions/dist_math.py` (factln :92, binomln
:96, betaln :100, normal_lcdf/normal_lccdf :108/:115, log_diff_normal_cdf
:126, i0e/i1e/log_i0 :135-147, clipped_beta_rvs_logit :148), with the
regularised incomplete gamma and beta functions the JAX package takes from
`jax.scipy.special`. Everything is a tensor operation with no host branch on
a value, so `torch.func.vmap` runs through it and a CUDA graph can capture
it. `check_icdf_parameters`, `check_icdf_value` and `icdf_bisection` (:60,
:67, :155) give the quantile functions; the bisection is a Python loop of
eager tensor steps, the JAX package's step counts, meant for forward draws
and `icdf` calls, never for a log-density.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "check_parameters", "check_icdf_parameters", "check_icdf_value", "icdf_bisection",
    "gammainc", "gammaincc", "betainc", "log_normal", "logpow", "safe_log",
    "safe_sqrt", "softplus", "log1mexp", "factln", "binomln", "betaln", "normal_lcdf",
    "normal_lccdf", "log_diff_normal_cdf", "i0e", "i1e", "log_i0", "clipped_beta_rvs_logit",
]

_LOG_SQRT_2PI = 0.9189385332046727  # log(sqrt(2*pi))


def check_parameters(logp, *conditions):
    """Return -inf where any parameter condition fails (the reference raises
    ParameterValueError, dist_math.py:50; -inf is sampler-safe)."""
    ok = conditions[0]
    for c in conditions[1:]:
        ok = ok & c
    return torch.where(ok, logp, -torch.inf)


def check_icdf_parameters(icdf, *conditions):
    """NaN where any parameter condition fails: PyMC's icdf semantics
    (reference dist_math.py check_icdf_parameters, whose assertion the
    logprob rewrites replace by NaN)."""
    if not conditions:
        return icdf
    ok = conditions[0]
    for c in conditions[1:]:
        ok = ok & c
    return torch.where(ok, icdf, torch.nan)


def check_icdf_value(icdf, q):
    """NaN where the probability `q` lies outside [0, 1]; the result in
    q's float type (a discrete quantile comes as an integer-valued float)."""
    return torch.where((q >= 0) & (q <= 1), icdf.to(q.dtype), torch.nan)


def icdf_bisection(logcdf_fn, q, support="real", lower=None, upper=None, logpdf_fn=None,
                   bisect_iters=70, newton_iters=4):
    """The quantile at `q` of a distribution with a log-cdf and no closed
    form inverse (`pymc_tpu/distributions/dist_math.py:155-218`): bisection
    in a warped coordinate u in (eps, 1 - eps) mapped onto the support
    (sinh(tan(pi (u - 1/2))) on the real line, which spans e^(+-1e15);
    exp(tan(pi (u - 1/2))) on the positive half-line; lower + (upper -
    lower) u on an interval), then Newton steps on the log scale where a
    log-density is given, each kept only where it stays finite and inside
    the support. The step counts are the JAX package's, so float64 results
    agree with it; every step is a few eager launches, so one call costs
    some hundreds of them."""
    q = torch.as_tensor(q)
    if not q.is_floating_point():
        q = q.to(torch.float64)
    if support == "real":
        def to_x(u):
            return torch.sinh(torch.tan(math.pi * (u - 0.5)))
    elif support == "positive":
        def to_x(u):
            return torch.exp(torch.tan(math.pi * (u - 0.5)))
    else:
        def to_x(u):
            return lower + (upper - lower) * u
    eps = torch.finfo(q.dtype).eps
    logq = torch.log(torch.clamp(q, eps, 1.0))
    lo = torch.full_like(logq, eps)
    hi = torch.full_like(logq, 1.0 - eps)
    for _ in range(bisect_iters):
        mid = 0.5 * (lo + hi)
        go_right = logcdf_fn(to_x(mid)) < logq
        lo, hi = torch.where(go_right, mid, lo), torch.where(go_right, hi, mid)
    x = to_x(0.5 * (lo + hi))
    if logpdf_fn is not None:
        for _ in range(newton_iters):
            lp = logpdf_fn(x)
            # x' = x - (cdf - q) / pdf, on the log scale
            xn = x - (torch.exp(logcdf_fn(x) - lp) - torch.exp(logq - lp))
            ok = torch.isfinite(xn)
            if support == "positive":
                ok = ok & (xn > 0)
            elif support != "real":
                ok = ok & (xn > lower) & (xn < upper)
            x = torch.where(ok, xn, x)
    return x


def log_normal(x, mean, std):
    """log N(x | mean, std^2)."""
    return -0.5 * ((x - mean) / std) ** 2 - torch.log(std) - _LOG_SQRT_2PI


def safe_log(x):
    """log x, -inf where x <= 0, with a NaN-free gradient there (reference
    dist_math.py:72)."""
    safe = torch.where(x > 0, x, 1.0)
    return torch.where(x > 0, torch.log(safe), -torch.inf)


def safe_sqrt(x):
    """sqrt x, 0 where x <= 0, with a NaN-free gradient there."""
    safe = torch.where(x > 0, x, 1.0)
    return torch.where(x > 0, torch.sqrt(safe), 0.0)


def log1mexp(x):
    """log(1 - e^x) for x <= 0 (x above 0 is taken as 0), the two-branch
    form of Maechler (2012) that the JAX package uses (`pymc_tpu/math.py::
    _log1mexp_jax`)."""
    x = torch.clamp(x, max=0.0)
    return torch.where(
        x > -0.6931471805599453, torch.log(-torch.expm1(x)), torch.log1p(-torch.exp(x))
    )


def factln(n):
    """log n!"""
    return torch.lgamma(n + 1.0)


def binomln(n, k):
    """log of the binomial coefficient n over k."""
    return factln(n) - factln(k) - factln(n - k)


def betaln(a, b):
    """log B(a, b)."""
    return torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b)


def normal_lcdf(mu, sigma, x):
    """log Phi((x - mu) / sigma), stable in the lower tail."""
    return torch.special.log_ndtr((x - mu) / sigma)


def normal_lccdf(mu, sigma, x):
    """log(1 - Phi((x - mu) / sigma))."""
    return torch.special.log_ndtr(-(x - mu) / sigma)


def log_diff_normal_cdf(mu, sigma, x, y):
    """log(Phi((x - mu) / sigma) - Phi((y - mu) / sigma)) for x > y."""
    a = normal_lcdf(mu, sigma, x)
    b = normal_lcdf(mu, sigma, y)
    return a + torch.log1p(-torch.exp(torch.clamp(b - a, max=-1e-12)))


def i0e(x):
    """The exponentially scaled modified Bessel function I0(x) e^-|x|."""
    return torch.special.i0e(x)


def i1e(x):
    """The exponentially scaled modified Bessel function I1(x) e^-|x|."""
    return torch.special.i1e(x)


def log_i0(x):
    """log I0(x), stable for large x."""
    return torch.log(torch.special.i0e(x)) + torch.abs(x)


def clipped_beta_rvs_logit(generator, alpha, beta, shape, dtype):
    """Beta(alpha, beta) draws of `shape`, clipped to [eps, 1 - eps] of
    `dtype`, from two gamma draws on `generator`."""
    alpha = torch.broadcast_to(torch.as_tensor(alpha, dtype=dtype), shape).contiguous()
    beta = torch.broadcast_to(torch.as_tensor(beta, dtype=dtype, device=alpha.device),
                              shape).contiguous()
    ga = torch._standard_gamma(alpha, generator=generator)
    gb = torch._standard_gamma(beta, generator=generator)
    eps = torch.finfo(dtype).eps
    return torch.clamp(ga / (ga + gb), eps, 1.0 - eps)


def softplus(x):
    """log(1 + e^x) as logaddexp(x, 0), the JAX package's `jax.nn.softplus`
    (torch's own returns x itself above x = 20, 2e-9 off there)."""
    return torch.logaddexp(x, x.new_zeros(()))


def logpow(x, m):
    """m * log(x) with the convention 0**0 = 1 (reference dist_math.py:92).
    x == 0 with m > 0 gives -inf; the double where keeps the gradient
    NaN-free."""
    is_zero = x == 0
    log_x = torch.where(is_zero, -torch.inf, torch.log(torch.where(is_zero, 1.0, x)))
    return torch.where(m == 0, 0.0, m * log_x)


def _sum_to(grad, shape):
    """Sum a broadcast gradient back to an operand's shape."""
    while grad.ndim > len(shape):
        grad = grad.sum(0)
    for i, n in enumerate(shape):
        if n == 1 and grad.shape[i] != 1:
            grad = grad.sum(i, keepdim=True)
    return grad


_GAMMAINC_TERMS = 400


def _gammainc_grads(a, x):
    """(dP/da, dP/dx) of the regularized lower incomplete gamma, in a's and
    x's broadcast shape and float64."""
    a_b, x_b = torch.broadcast_tensors(a, x)
    a64, x64 = a_b.double(), torch.clamp(x_b.double(), min=1e-300)
    log_x = torch.log(x64)
    d_x = torch.exp((a64 - 1.0) * log_x - x64 - torch.lgamma(a64))
    n = torch.arange(_GAMMAINC_TERMS, dtype=torch.float64, device=a.device)
    an = a64[..., None] + n + 1.0
    log_term = (a64[..., None] + n) * log_x[..., None] - x64[..., None] - torch.lgamma(an)
    d_a = torch.sum(torch.exp(log_term) * (log_x[..., None] - torch.digamma(an)), dim=-1)
    return torch.where(x_b > 0, d_a, 0.0), torch.where(x_b > 0, d_x, 0.0)


class _GammaInc(torch.autograd.Function):
    """The regularized lower incomplete gamma P(a, x) with gradients in both
    arguments (torch's has none in a). d/da from the series P = x^a e^-x
    sum_n x^n / Gamma(a + n + 1): sum_n term_n (log x - digamma(a + n + 1)),
    whose terms fall geometrically once n > x, in float64. Its vmap rule is
    generated, so a log-density that reads it (Gamma's, Poisson's and
    InverseGamma's log-cdf: a censored or truncated likelihood) runs under
    the samplers' vmap."""

    generate_vmap_rule = True

    @staticmethod
    def forward(a, x):
        return torch.special.gammainc(a, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        a, x = ctx.saved_tensors
        d_a, d_x = _gammainc_grads(a, x)
        return (_sum_to((g * d_a).to(a.dtype), a.shape),
                _sum_to((g * d_x).to(x.dtype), x.shape))


def gammainc(a, x):
    """P(a, x), differentiable in a and x (series for d/da: x up to about
    a hundred)."""
    return _GammaInc.apply(a, x)


class _GammaIncC(torch.autograd.Function):
    """The regularized upper incomplete gamma Q(a, x) = 1 - P(a, x), taken
    from `torch.special.gammaincc` (exact in the upper tail, where 1 - P
    loses every digit); its gradients are those of P with the sign turned."""

    generate_vmap_rule = True

    @staticmethod
    def forward(a, x):
        return torch.special.gammaincc(a, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        return _GammaInc.backward(ctx, -g)


def gammaincc(a, x):
    """Q(a, x) = 1 - P(a, x), differentiable in a and x."""
    return _GammaIncC.apply(a, x)


# continued-fraction terms of betainc: the fraction converges in O(sqrt(max
# (a, b))) terms, so 300 hold float64 for a and b up to some 10^4
_BETAINC_TERMS = 300
# the terms' coefficients are computed this many at a time, as one
# vectorised expression over a trailing axis
_BETACF_CHUNK = 50


def _betacf(a, b, x):
    """The continued fraction of I_x(a, b), 1 / (1 + d_1 / (1 + d_2 / (1 +
    ...))) truncated after a fixed number of terms and evaluated from its
    tail inwards, every element alike (no branch on a value). The terms'
    coefficients d_2m = m (b - m) x / ((a + 2m - 1)(a + 2m)) and d_2m+1 =
    -(a + m)(a + b + m) x / ((a + 2m)(a + 2m + 1)) come a chunk at a time
    from one vectorised expression, so each term costs two elementwise
    launches: some 1,300 a call, where the forward (Lentz) evaluation took
    about 12,000 (an icdf's bisection calls it 74 times)."""
    m_all = torch.arange(1, _BETAINC_TERMS + 1, dtype=x.dtype, device=x.device)
    a_, b_, x_ = a[..., None], b[..., None], x[..., None]
    t = torch.zeros_like(x)
    for stop in range(_BETAINC_TERMS, 0, -_BETACF_CHUNK):
        m = m_all[max(stop - _BETACF_CHUNK, 0):stop]
        d_even = m * (b_ - m) * x_ / ((a_ + (2.0 * m - 1.0)) * (a_ + 2.0 * m))
        d_odd = -(a_ + m) * (a_ + b_ + m) * x_ / ((a_ + 2.0 * m) * (a_ + (2.0 * m + 1.0)))
        for j in range(m.shape[0] - 1, -1, -1):
            t = d_odd[..., j] / (1.0 + t)
            t = d_even[..., j] / (1.0 + t)
    t = -(a + b) * x / (a + 1.0) / (1.0 + t)
    return 1.0 / (1.0 + t)


def _betainc_value(a, b, x):
    """I_x(a, b) for a, b > 0 and x in [0, 1]; NaN for other parameters.
    The fraction is evaluated on the side of (a + 1) / (a + b + 2) where it
    converges fast, with the symmetry I_x(a, b) = 1 - I_{1-x}(b, a)."""
    a, b, x = torch.broadcast_tensors(a, b, x)
    inside = (x > 0) & (x < 1)
    xs = torch.where(inside, x, 0.5)
    flip = xs > (a + 1.0) / (a + b + 2.0)
    aa, bb = torch.where(flip, b, a), torch.where(flip, a, b)
    xx = torch.where(flip, 1.0 - xs, xs)
    log_front = aa * torch.log(xx) + bb * torch.log1p(-xx) - betaln(aa, bb) - torch.log(aa)
    val = torch.exp(log_front) * _betacf(aa, bb, xx)
    val = torch.where(flip, 1.0 - val, val)
    val = torch.where(x <= 0, 0.0, torch.where(x >= 1, 1.0, val))
    return torch.where((a > 0) & (b > 0) & (x >= 0) & (x <= 1), val, torch.nan)


class _BetaInc(torch.autograd.Function):
    """The regularized incomplete beta I_x(a, b) with its gradient in x,
    x^(a-1) (1 - x)^(b-1) / B(a, b); like `jax.scipy.special.betainc`, it
    has none in a or b, and asking for one raises."""

    generate_vmap_rule = True

    @staticmethod
    def forward(a, b, x):
        return _betainc_value(a, b, x)

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        a, b, x = ctx.saved_tensors
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            raise NotImplementedError(
                "betainc has a gradient in x only (as jax.scipy.special.betainc)"
            )
        inside = (x > 0) & (x < 1)
        xs = torch.where(inside, x, 0.5)
        dx = torch.exp((a - 1.0) * torch.log(xs) + (b - 1.0) * torch.log1p(-xs) - betaln(a, b))
        dx = torch.where(inside, dx, 0.0)
        return None, None, _sum_to(g * dx, x.shape)


def betainc(a, b, x):
    """I_x(a, b), differentiable in x."""
    return _BetaInc.apply(a, b, x)
