"""Time-series distributions.

Counterpart of `pymc_tpu/distributions/timeseries.py` (reference
pymc/distributions/timeseries.py: RandomWalk:122, GaussianRandomWalk:264,
MvGaussianRandomWalk:301, MvStudentTRandomWalk:345, AR:475, GARCH11:746,
EulerMaruyama:898). Where the recursion is linear (the random walks, AR,
EulerMaruyama) the density is one vectorised expression over shifted
slices of the value. GARCH11's volatility recursion is the one sequential
density: a Python loop over the T steps, about five small launches a step
eagerly, which a CUDA graph of the logp+grad replays as one. The draws of
AR, GARCH11 and EulerMaruyama loop over the steps the same way, drawing
their noise out of place from the generator first. The multivariate walks'
innovations are MvNormal or MvStudentT, whose covariance is factored by
the Cholesky kernel on the card.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..graph import evaluate
from .continuous import Normal
from .dist_math import check_parameters, log_normal
from .distribution import Continuous, Distribution, as_param, standard_normal
from .multivariate import MvNormal, MvStudentT

__all__ = [
    "RandomWalk", "GaussianRandomWalk", "MvGaussianRandomWalk", "MvStudentTRandomWalk", "AR",
    "GARCH11", "EulerMaruyama",
]


def _steps_from_shape(shape_arg, steps, extra_event=0, offset=1):
    """The number of steps, from `steps` or from a requested shape whose
    time axis holds steps + offset values (offset 1 for the walks, GARCH11
    and EulerMaruyama, the AR order for AR; reference shape_utils.py
    get_support_shape_1d); both given must agree."""
    if shape_arg is not None:
        inferred = int(shape_arg[-1 - extra_event]) - offset
        if steps is not None and int(steps) != inferred:
            raise ValueError(
                f"Inconsistent steps={steps} and shape={tuple(shape_arg)}: "
                f"the support length implies steps={inferred}"
            )
        return inferred
    if steps is not None:
        return int(steps)
    raise ValueError("Provide steps= or shape= for timeseries distributions")


def _warn_default_init(what):
    warnings.warn(
        f"Initial distribution not specified, defaulting to `{what}`. You can specify an "
        "init_dist manually to suppress this warning.",
        UserWarning,
    )


def _extra(target, dist):
    """The leading dims of `target` that `dist`'s own shape does not hold."""
    n = len(dist.shape)
    return tuple(target[: len(target) - n]) if n <= len(target) else ()


class RandomWalk(Continuous):
    """The cumulative sum of an init draw and `steps` iid innovations
    (reference timeseries.py:122)."""

    param_names = ()
    event_ndim = 1

    def __dist_init__(self, innovation_dist=None, init_dist=None, steps=None):
        if innovation_dist is None or not isinstance(innovation_dist, Distribution):
            raise ValueError("RandomWalk requires innovation_dist=Distribution")
        self.innovation_dist = innovation_dist
        if init_dist is None or not isinstance(init_dist, Distribution):
            raise TypeError("init_dist must be a distribution (use .dist())")
        if init_dist.event_ndim != innovation_dist.event_ndim:
            raise TypeError(
                "init_dist and innovation_dist must have the same support dimensionality"
            )
        self.init_dist = init_dist
        self.steps = _steps_from_shape(self._shape_arg, steps,
                                       extra_event=innovation_dist.event_ndim)
        self.event_ndim = 1 + innovation_dist.event_ndim

    def inputs(self):
        return self.init_dist.inputs() + self.innovation_dist.inputs()

    def _resolve_shapes(self, shape):
        ev = (self.steps + 1,) + tuple(self.innovation_dist.event_shape)
        if shape is not None:
            batch = tuple(shape[: len(shape) - len(ev)])
        else:
            batch = tuple(np.broadcast_shapes(self.innovation_dist.batch_shape,
                                              self.init_dist.batch_shape))
        self.batch_shape, self.event_shape = batch, ev
        self.shape = batch + ev

    def _time_axis(self, value):
        return value.ndim - 1 - self.innovation_dist.event_ndim

    def logp(self, value, env=None, memo=None):
        memo = {} if memo is None else memo
        ax = self._time_axis(value)
        init_lp = self.init_dist.logp(value.select(ax, 0), env, memo)
        # time leads, so that batched innovation parameters broadcast per
        # walk and not per step (reference timeseries.py:236-247)
        diffs = torch.movedim(torch.diff(value, dim=ax), ax, 0)
        return init_lp + torch.sum(self.innovation_dist.logp(diffs, env, memo), dim=0)

    def sample(self, generator, sample_shape=(), env=None, memo=None):
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        memo = {} if memo is None else memo
        batch = tuple(sample_shape) + self.batch_shape
        inner = tuple(self.innovation_dist.event_shape)
        init_target = batch + inner
        init = torch.broadcast_to(
            self.init_dist.sample(generator, _extra(init_target, self.init_dist), env, memo),
            init_target)
        # the innovations with time leading, so that batched parameters
        # stay aligned with `batch`, then time moved into place
        innov_target = (self.steps,) + batch + inner
        innov = torch.broadcast_to(
            self.innovation_dist.sample(generator, _extra(innov_target, self.innovation_dist),
                                        env, memo),
            innov_target)
        ax = len(batch)
        path = torch.cat([init.unsqueeze(ax), torch.movedim(innov, 0, ax)], dim=ax)
        return torch.cumsum(path, dim=ax)

    def support_point(self, env=None, memo=None):
        memo = {} if memo is None else memo
        target = tuple(self.batch_shape) + tuple(self.innovation_dist.event_shape)
        init = self.init_dist.support_point(env, memo)
        innov = self.innovation_dist.support_point(env, memo)
        dtype = init.dtype if init.is_floating_point() else torch.float64
        path = torch.cat([torch.broadcast_to(init.to(dtype), (1,) + target),
                          torch.broadcast_to(innov.to(dtype), (self.steps,) + target)], dim=0)
        pt = torch.movedim(torch.cumsum(path, dim=0), 0, len(self.batch_shape))
        return torch.broadcast_to(pt, self.shape)


class GaussianRandomWalk(RandomWalk):
    """Normal(mu, sigma) innovations (reference timeseries.py:264); the
    init defaults to Normal(0, 100) with a warning."""

    def __dist_init__(self, mu=0.0, sigma=1.0, *, init_dist=None, steps=None):
        if init_dist is None:
            _warn_default_init("Normal.dist(0, 100)")
            init_dist = Normal.dist(0.0, 100.0)
        super().__dist_init__(innovation_dist=Normal.dist(mu=mu, sigma=sigma),
                              init_dist=init_dist, steps=steps)


def _mv_default_init(innovation):
    _warn_default_init("MvNormal.dist(0, I*100)")
    k = innovation.shape[-1]
    return MvNormal.dist(mu=np.zeros(k), cov=100.0 * np.eye(k))


class MvGaussianRandomWalk(RandomWalk):
    """MvNormal innovations (reference timeseries.py:301); the init
    defaults to MvNormal(0, 100 I) with a warning."""

    def __dist_init__(self, mu=0.0, cov=None, tau=None, chol=None, init_dist=None, steps=None):
        innovation = MvNormal.dist(mu=mu, cov=cov, tau=tau, chol=chol)
        if init_dist is None:
            init_dist = _mv_default_init(innovation)
        super().__dist_init__(innovation_dist=innovation, init_dist=init_dist, steps=steps)


class MvStudentTRandomWalk(RandomWalk):
    """MvStudentT innovations (reference timeseries.py:345); the init
    defaults to MvNormal(0, 100 I) with a warning."""

    def __dist_init__(self, nu, mu=0.0, scale=None, tau=None, chol=None, init_dist=None,
                      steps=None):
        innovation = MvStudentT.dist(nu, mu=mu, scale=scale, tau=tau, chol=chol)
        if init_dist is None:
            init_dist = _mv_default_init(innovation)
        super().__dist_init__(innovation_dist=innovation, init_dist=init_dist, steps=steps)


class AR(Continuous):
    """Autoregressive process of order p (reference timeseries.py:475):
    x_t ~ N(c + sum_k rho_k x_{t-1-k}, sigma), the first p values from
    `init_dist`; `constant=True` takes rho[..., 0] as c. The density is a
    product of the lagged slices with rho, with no loop over time."""

    param_names = ("rho", "sigma")
    param_event_ndims = (1, 0)
    event_ndim = 1

    def __dist_init__(self, rho, sigma=1.0, *, init_dist=None, steps=None, constant=False,
                      ar_order=None):
        self.rho = as_param(rho)
        self.sigma = as_param(sigma)
        self.constant = bool(constant)
        self.ar_order = int(ar_order if ar_order is not None
                            else self.rho.shape[-1] - (1 if constant else 0))
        if init_dist is None:
            _warn_default_init("Normal.dist(0, 100, shape=...)")
            init_dist = Normal.dist(0.0, 100.0, shape=(self.ar_order,))
        self.init_dist = init_dist
        self.steps = _steps_from_shape(self._shape_arg, steps, offset=self.ar_order)

    def inputs(self):
        return super().inputs() + self.init_dist.inputs()

    def _event_shape(self, rho_shape, sigma_shape):
        return (self.steps + self.ar_order,)

    def _split_rho(self, rho):
        if self.constant:
            return rho[..., 0], rho[..., 1:]
        return torch.zeros_like(rho[..., 0]), rho

    def logp(self, value, env=None, memo=None):
        memo = {} if memo is None else memo
        rho, sigma = self.resolve_params(env, memo)
        const, coefs = self._split_rho(rho)
        p, T = self.ar_order, value.shape[-1]
        init_lp = self.init_dist.logp(value[..., :p], env, memo)
        if self.init_dist.event_ndim == 0:
            # a multivariate init has already summed over its p values
            init_lp = torch.sum(torch.atleast_1d(init_lp), dim=-1)
        lags = torch.stack([value[..., p - 1 - k: T - 1 - k] for k in range(p)], dim=-1)
        mean = const[..., None] + torch.sum(lags * coefs[..., None, :], dim=-1)
        innov_lp = torch.sum(log_normal(value[..., p:], mean, sigma[..., None]), dim=-1)
        return check_parameters(init_lp + innov_lp, sigma > 0)

    def sample(self, generator, sample_shape=(), env=None, memo=None):
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        memo = {} if memo is None else memo
        rho, sigma = self.resolve_params(env, memo)
        const, coefs = self._split_rho(rho)
        p = self.ar_order
        batch = tuple(sample_shape) + self.batch_shape
        init_target = batch + (p,)
        init = torch.broadcast_to(
            self.init_dist.sample(generator, _extra(init_target, self.init_dist), env, memo),
            init_target).to(rho.dtype)
        noise = sigma[..., None] * standard_normal(generator, batch + (self.steps,), rho)
        coefs = torch.broadcast_to(coefs, batch + (p,)).flip(-1)
        const = torch.broadcast_to(const, batch)
        # carry: the last p values, the newest last
        carry, path = init, []
        for t in range(self.steps):
            new = const + torch.sum(carry * coefs, dim=-1) + noise[..., t]
            carry = torch.cat([carry[..., 1:], new[..., None]], dim=-1)
            path.append(new)
        return torch.cat([init] + [x[..., None] for x in path], dim=-1)

    def support_point(self, env=None, memo=None):
        # the last entry of the init's support point over the whole series
        # (reference timeseries.py:679-682)
        init = torch.atleast_1d(self.init_dist.support_point(env, memo))
        return torch.broadcast_to(init[..., -1:], self.shape)


class GARCH11(Continuous):
    """GARCH(1, 1) (reference timeseries.py:746): x_t ~ N(0, sigma_t) with
    sigma_t^2 = omega + alpha_1 x_{t-1}^2 + beta_1 sigma_{t-1}^2 and
    sigma_0 = initial_vol. No stationarity check: a GARCH with alpha_1 +
    beta_1 >= 1 has a finite density (reference garch11_logp)."""

    param_names = ("omega", "alpha_1", "beta_1", "initial_vol")
    event_ndim = 1

    def __dist_init__(self, omega, alpha_1, beta_1, initial_vol, *, steps=None):
        self.omega = as_param(omega)
        self.alpha_1 = as_param(alpha_1)
        self.beta_1 = as_param(beta_1)
        self.initial_vol = as_param(initial_vol)
        self.steps = _steps_from_shape(self._shape_arg, steps)

    def _event_shape(self, *param_shapes):
        return (self.steps + 1,)

    @staticmethod
    def _vols(value, omega, alpha_1, beta_1, initial_vol):
        """sigma_0 .. sigma_{T-1}: one step of the recursion a time step."""
        x = torch.movedim(value, -1, 0)
        sigma2 = torch.broadcast_to(initial_vol**2, x[0].shape)
        vols = [torch.broadcast_to(initial_vol, x[0].shape)]
        for t in range(1, x.shape[0]):
            sigma2 = omega + alpha_1 * x[t - 1] ** 2 + beta_1 * sigma2
            vols.append(torch.sqrt(torch.clamp(sigma2, min=1e-30)))
        return torch.stack(vols, dim=-1)

    def _logp(self, value, omega, alpha_1, beta_1, initial_vol):
        vols = self._vols(value, omega, alpha_1, beta_1, initial_vol)
        res = torch.sum(log_normal(value, 0.0, vols), dim=-1)
        return check_parameters(res, omega > 0, alpha_1 >= 0, beta_1 >= 0, initial_vol > 0)

    def _sample(self, generator, shape, omega, alpha_1, beta_1, initial_vol):
        noise = standard_normal(generator, shape, omega)
        iv = torch.broadcast_to(initial_vol, shape[:-1])
        x, sigma2 = noise[..., 0] * iv, iv**2
        xs = [x]
        for t in range(1, shape[-1]):
            sigma2 = omega + alpha_1 * x**2 + beta_1 * sigma2
            x = noise[..., t] * torch.sqrt(torch.clamp(sigma2, min=1e-30))
            xs.append(x)
        return torch.stack(xs, dim=-1)

    def _support_point(self, omega, alpha_1, beta_1, initial_vol):
        return torch.zeros(self.shape, dtype=omega.dtype, device=omega.device)


class EulerMaruyama(Continuous):
    """The Euler-Maruyama discretisation of an SDE (reference
    timeseries.py:898): x_{t+1} ~ N(x_t + f(x_t) dt, g(x_t) sqrt(dt)), with
    (f, g) = sde_fn(x, *sde_pars), a function of the port's tensors. The
    density is one expression over the shifted slices; the parameters get
    a trailing time axis there, so that batched ones broadcast against
    x[..., t]."""

    param_names = ()
    event_ndim = 1

    def __dist_init__(self, dt, sde_fn, sde_pars, *, init_dist=None, steps=None):
        self.dt = float(dt)
        self.sde_fn = sde_fn
        self.sde_pars = tuple(as_param(p) for p in sde_pars)
        if init_dist is None:
            _warn_default_init("Normal.dist(0, 100, shape=...)")
            # shaped like the first parameter (reference timeseries.py:964)
            par0_shape = tuple(self.sde_pars[0].shape) if self.sde_pars else ()
            init_dist = Normal.dist(0.0, 100.0, shape=par0_shape or None)
        self.init_dist = init_dist
        self.steps = _steps_from_shape(self._shape_arg, steps)

    def inputs(self):
        return list(self.sde_pars) + self.init_dist.inputs()

    def _resolve_shapes(self, shape):
        if shape is not None:
            batch, ev = tuple(shape[:-1]), (shape[-1],)
        else:
            batch = tuple(np.broadcast_shapes(*[tuple(p.shape) for p in self.sde_pars],
                                              self.init_dist.batch_shape))
            ev = (self.steps + 1,)
        self.batch_shape, self.event_shape = batch, ev
        self.shape = batch + ev

    def _fg(self, x, pars):
        f, g = self.sde_fn(x, *pars)
        f = torch.as_tensor(f, dtype=x.dtype, device=x.device)
        g = torch.as_tensor(g, dtype=x.dtype, device=x.device)
        return f, torch.sqrt(torch.clamp(g**2 * self.dt, min=1e-30))

    def logp(self, value, env=None, memo=None):
        memo = {} if memo is None else memo
        pars = [evaluate(p, env, memo)[..., None] for p in self.sde_pars]
        xt = value[..., :-1]
        f, sd = self._fg(xt, pars)
        innov = torch.sum(log_normal(value[..., 1:], xt + f * self.dt, sd), dim=-1)
        return self.init_dist.logp(value[..., 0], env, memo) + innov

    def sample(self, generator, sample_shape=(), env=None, memo=None):
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        memo = {} if memo is None else memo
        pars = [evaluate(p, env, memo) for p in self.sde_pars]
        batch = tuple(sample_shape) + self.batch_shape
        x = torch.broadcast_to(
            self.init_dist.sample(generator, _extra(batch, self.init_dist), env, memo), batch)
        noise = standard_normal(generator, batch + (self.steps,), x)
        path = [x]
        for t in range(self.steps):
            f, sd = self._fg(x, pars)
            x = x + f * self.dt + noise[..., t] * sd
            path.append(x)
        return torch.stack(path, dim=-1)

    def support_point(self, env=None, memo=None):
        init = self.init_dist.support_point(env, memo)
        return torch.broadcast_to(init[..., None], self.shape)
