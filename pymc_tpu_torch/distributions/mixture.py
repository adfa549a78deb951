"""Mixture distributions: Mixture, NormalMixture, and the zero-inflated
and hurdle classes.

Counterpart of `pymc_tpu/distributions/mixture.py` (Mixture :71-347,
NormalMixture :349-358, the zero-inflated classes :360-457, the hurdle
classes :460-631; reference pymc/distributions/mixture.py:356, :497,
:577-1037). A mixture is a combinator: its logp is a logsumexp over the
components' logps, its draw a categorical pick among the components'
draws. The components are `.dist` objects, given as a list (one per
component) or as one distribution whose rightmost batch axis indexes the
components. `inputs` lists the components' parameters besides the
weights, so the graph finds the random variables the components read and
the constants to place on the device.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..config import intX
from ..graph import ConstantNode, DeterministicNode, Node, evaluate
from .continuous import Gamma, LogNormal, Normal
from .discrete import Binomial, NegativeBinomial, Poisson
from .dist_math import check_parameters, log1mexp
from .distribution import Continuous, Discrete, Distribution, as_param, standard_uniform

__all__ = [
    "Mixture", "NormalMixture", "MixtureTransformWarning", "ZeroInflatedPoisson",
    "ZeroInflatedBinomial", "ZeroInflatedNegativeBinomial", "HurdlePoisson",
    "HurdleNegativeBinomial", "HurdleGamma", "HurdleLogNormal",
]


class MixtureTransformWarning(UserWarning):
    """Reference mixture.py:288."""


def _same_expr(a, b):
    """Structural equality of two bound expressions (the reference's
    equal_computations check in mixture_default_transform; pymc_tpu
    mixture.py:46): the same leaf, equal constants, or the same function of
    equal arguments."""
    if a is b:
        return True
    if isinstance(a, DeterministicNode) and isinstance(b, DeterministicNode):
        return (a.fn is b.fn and a.kwargs == b.kwargs and len(a.args) == len(b.args)
                and all(_same_expr(x, y) for x, y in zip(a.args, b.args)))
    if isinstance(a, ConstantNode) and isinstance(b, ConstantNode):
        return bool(np.array_equal(a.value.numpy(), b.value.numpy()))
    if isinstance(a, Node) or isinstance(b, Node):
        return False
    return bool(np.array_equal(np.asarray(a), np.asarray(b)))


class Mixture(Distribution):
    """Finite mixture: the last axis of `w` indexes the components.

    comp_dists: a list of Distribution instances, one per component, or one
    Distribution whose rightmost batch axis is the component axis.
    """

    param_names = ("w",)

    def __dist_init__(self, w, comp_dists):
        self.w = as_param(w)
        if isinstance(comp_dists, (tuple, list)) and len(comp_dists) == 1:
            # reference mixture.py:165-173
            warnings.warn(
                "Single component will be treated as a mixture across the "
                "last size dimension.\nTo disable this warning do not wrap "
                "the single component inside a list or tuple",
                UserWarning,
            )
            comp_dists = comp_dists[0]
        if isinstance(comp_dists, Distribution):
            self.comp_single, self.comp_list = comp_dists, None
            ev_n = comp_dists.event_ndim
            cb = comp_dists.shape[: len(comp_dists.shape) - ev_n]
            self._n_comp = cb[-1] if cb else None
            self.is_discrete = comp_dists.is_discrete
            self.event_ndim = ev_n
            if ev_n and self._n_comp is None:
                raise ValueError(
                    "single-dist Mixture over multivariate components needs "
                    "an explicit component (last batch) axis"
                )
        else:
            comp_dists = list(comp_dists)
            if len({d.is_discrete for d in comp_dists}) > 1:
                # reference mixture.py:175-184
                raise ValueError(
                    "All distributions in comp_dists must be either discrete "
                    "or continuous.\nSee the following issue for more "
                    "information: https://github.com/pymc-devs/pymc/issues/4511."
                )
            self.comp_single, self.comp_list = None, comp_dists
            self._n_comp = len(comp_dists)
            self.is_discrete = all(d.is_discrete for d in comp_dists)
            ev_ns = {d.event_ndim for d in comp_dists}
            if len(ev_ns) > 1:
                # reference mixture.py:198-201
                raise ValueError(
                    "Mixture components must all have the same support "
                    f"dimensionality, got {sorted(ev_ns)}"
                )
            self.event_ndim = ev_ns.pop()
        w_shape = tuple(self.w.shape)
        if w_shape and self._n_comp is not None and w_shape[-1] != self._n_comp:
            raise ValueError(
                f"Mixture weights last axis {w_shape[-1]} != number of "
                f"components {self._n_comp}"
            )

    def _components(self):
        return self.comp_list if self.comp_list is not None else [self.comp_single]

    def inputs(self):
        return [self.w] + [p for d in self._components() for p in d.inputs()]

    @property
    def dtype(self):
        return intX() if self.is_discrete else torch.float64

    def default_transform(self):
        """The components' shared transform, or None with a
        MixtureTransformWarning where their supports differ, or where
        interval components' bounds are not the same expressions
        ([Uniform(0, 1), Uniform(0, 2)] gets none; reference
        mixture.py:292-345)."""
        comps = self._components()
        sups = {c.support for c in comps}
        same = len(sups) == 1
        if same and sups.pop() == "interval" and len(comps) > 1:
            b0 = comps[0]._interval_bounds()
            same = all(_same_expr(b0[0], b[0]) and _same_expr(b0[1], b[1])
                       for b in (c._interval_bounds() for c in comps[1:]))
        if not same:
            warnings.warn(
                "No safe default transform found for Mixture distribution. This "
                "can happen when components have different supports or default "
                "transforms.\nIf appropriate, you can specify a custom transform "
                "for more efficient sampling.",
                MixtureTransformWarning,
                stacklevel=2,
            )
            return None
        return comps[0].default_transform()

    def _resolve_shapes(self, shape):
        # the batch comes from w and the components; the single-dist form's
        # last batch axis is the component axis, not the mixture's
        ev_n = self.event_ndim
        w_batch = tuple(self.w.shape)[:-1]
        if self.comp_list is not None:
            ev = (
                tuple(np.broadcast_shapes(*[d.event_shape for d in self.comp_list]))
                if ev_n else ()
            )
            comp_batch = [d.batch_shape for d in self.comp_list]
        else:
            ev = tuple(self.comp_single.event_shape)
            comp_batch = [self.comp_single.batch_shape[:-1]]
        batch = tuple(np.broadcast_shapes(w_batch, *comp_batch))
        if shape is not None:
            batch = shape[: len(shape) - len(ev)] if ev else shape
        self.batch_shape = batch
        self.event_shape = ev
        self.shape = batch + ev

    def _comp_logps(self, value, env, memo):
        """Each component's logp of `value`, stacked on a new last axis (the
        event dims collapsed; reference mixture.py:476-484)."""
        if self.comp_list is not None:
            lps = torch.broadcast_tensors(*[d.logp(value, env, memo) for d in self.comp_list])
            return torch.stack(lps, dim=-1)
        # the component axis sits at -(event_ndim + 1) of the single dist
        value = torch.unsqueeze(value, -(self.event_ndim + 1))
        return self.comp_single.logp(value, env, memo)

    def logp(self, value, env=None, memo=None):
        if memo is None:
            memo = {}
        w = evaluate(self.w, env, memo)
        comp_logps = self._comp_logps(value, env, memo)
        log_w = torch.log(torch.clamp(w, min=1e-30)) - torch.log(
            torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-30)
        )
        res = torch.logsumexp(log_w + comp_logps, dim=-1)
        return check_parameters(
            res,
            torch.all(w >= 0, dim=-1),
            torch.abs(torch.sum(w, dim=-1) - 1.0) < 1e-6,
        )

    def logcdf(self, value, env=None, memo=None):
        """logsumexp over the components of log w + their log-cdfs, for a
        list of components or one batched over its last axis
        (pymc_tpu/distributions/mixture.py:253-269); a multivariate mixture
        has none."""
        if self.event_ndim:
            raise NotImplementedError("logcdf of a multivariate mixture is not defined")
        memo = {} if memo is None else memo
        w = evaluate(self.w, env, memo)
        value = self._cast_value(value, [w])
        if self.comp_list is not None:
            comp = torch.stack(torch.broadcast_tensors(
                *[d.logcdf(value, env, memo) for d in self.comp_list]), dim=-1)
        else:
            comp = self.comp_single.logcdf(value[..., None], env, memo)
        return torch.logsumexp(torch.log(torch.clamp(w, min=1e-30)) + comp, dim=-1)

    def sample(self, generator, sample_shape=(), env=None, memo=None):
        """A categorical pick among the components' draws (reference
        mixture.py:115-129)."""
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        if memo is None:
            memo = {}
        w = evaluate(self.w, env, memo)
        ev_n = self.event_ndim
        batch_full = tuple(sample_shape) + tuple(self.batch_shape)
        stacked = batch_full + (self._n_comp,) + tuple(self.event_shape)
        mix_axis = -(ev_n + 1)
        probs = torch.clamp(w, min=1e-30)
        cum = torch.cumsum(probs / torch.sum(probs, dim=-1, keepdim=True), dim=-1)
        u = standard_uniform(generator, batch_full + (1,), cum)
        idx = torch.clamp(torch.sum(u > cum, dim=-1), max=self._n_comp - 1)
        if self.comp_list is not None:
            tgt = batch_full + tuple(self.event_shape)
            draws = []
            for d in self.comp_list:
                # draw at the extra dims only, then broadcast: a draw at
                # sample_shape alone would share one draw across the batch
                extra = tgt[: len(tgt) - len(d.shape)]
                draws.append(torch.broadcast_to(d.sample(generator, extra, env, memo), tgt))
            draws = torch.stack(draws, dim=mix_axis)
        else:
            d = self.comp_single
            extra = stacked[: len(stacked) - len(d.shape)]
            draws = torch.broadcast_to(d.sample(generator, extra, env, memo), stacked)
        idx = idx.reshape(idx.shape + (1,) * (ev_n + 1))
        idx = idx.expand(idx.shape[:len(batch_full) + 1] + tuple(self.event_shape))
        taken = torch.take_along_dim(draws, idx, dim=mix_axis).squeeze(mix_axis)
        return taken.to(intX()) if self.is_discrete else taken

    def support_point(self, env=None, memo=None):
        """The w-weighted mean of the components' support points (reference
        mixture.py:227-240), rounded for a discrete mixture."""
        if memo is None:
            memo = {}
        w = evaluate(self.w, env, memo)
        ev_n = self.event_ndim
        mix_axis = -(ev_n + 1)
        stacked = tuple(self.batch_shape) + (self._n_comp,) + tuple(self.event_shape)
        if self.comp_list is not None:
            pts = torch.stack(
                [torch.broadcast_to(d.support_point(env, memo).to(w.dtype), self.shape)
                 for d in self.comp_list],
                dim=mix_axis,
            )
        else:
            pts = torch.broadcast_to(self.comp_single.support_point(env, memo).to(w.dtype),
                                     stacked)
        wp = torch.broadcast_to(w, tuple(self.batch_shape) + (self._n_comp,))
        wp = wp.reshape(wp.shape + (1,) * ev_n)
        mean = torch.sum(wp * pts, dim=mix_axis)
        return torch.round(mean).to(intX()) if self.is_discrete else mean


def NormalMixture(name, w, mu, sigma=None, tau=None, **kwargs):
    """Reference mixture.py:497: a Mixture of Normal(mu, sigma) components
    along mu's and sigma's last axis."""
    return Mixture(name, w, Normal.dist(mu=mu, sigma=sigma, tau=tau), **kwargs)


def _normal_mixture_dist(w, mu, sigma=None, tau=None, **kwargs):
    return Mixture.dist(w, Normal.dist(mu=mu, sigma=sigma, tau=tau), **kwargs)


NormalMixture.dist = _normal_mixture_dist


class _ZeroInflated(Discrete):
    """A point mass at 0 with weight 1 - psi and the base distribution with
    weight psi (psi is the probability of the base process)."""

    param_names = ("psi",)
    base_cls = None

    def __dist_init__(self, psi, **base_params):
        self.psi = as_param(psi)
        self.base = self.base_cls.dist(**base_params)

    def inputs(self):
        return [self.psi] + self.base.inputs()

    def _resolve_shapes(self, shape):
        batch = tuple(np.broadcast_shapes(tuple(self.psi.shape), self.base.shape))
        self.batch_shape = tuple(shape) if shape is not None else batch
        self.event_shape = ()
        self.shape = self.batch_shape

    def logp(self, value, env=None, memo=None):
        if memo is None:
            memo = {}
        psi = evaluate(self.psi, env, memo)
        base_lp = self.base.logp(value, env, memo)
        log_psi = torch.log(torch.clamp(psi, 1e-30, 1.0))
        res = torch.where(value == 0, torch.logaddexp(torch.log1p(-psi), log_psi + base_lp),
                          log_psi + base_lp)
        res = torch.where(value >= 0, res, -torch.inf)
        return check_parameters(res, psi >= 0, psi <= 1)

    def logcdf(self, value, env=None, memo=None):
        if memo is None:
            memo = {}
        psi = evaluate(self.psi, env, memo)
        base = self.base.logcdf(value, env, memo)
        res = torch.logaddexp(torch.log1p(-psi), torch.log(torch.clamp(psi, 1e-30, 1.0)) + base)
        res = torch.where(value < 0, -torch.inf, torch.clamp(res, max=0.0))
        return check_parameters(res, psi >= 0, psi <= 1)

    def _base_draw(self, generator, full, env, memo):
        # the base drawn at the full batch shape: a draw at the sample shape
        # alone, broadcast, would give every element one candidate
        extra = full[: len(full) - len(self.base.shape)]
        return torch.broadcast_to(self.base.sample(generator, extra, env, memo), full)

    def sample(self, generator, sample_shape=(), env=None, memo=None):
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        if memo is None:
            memo = {}
        psi = evaluate(self.psi, env, memo)
        full = tuple(sample_shape) + self.shape
        nonzero = standard_uniform(generator, full, psi) < psi
        draw = self._base_draw(generator, full, env, memo)
        return torch.where(nonzero, draw, 0).to(intX())

    def support_point(self, env=None, memo=None):
        if memo is None:
            memo = {}
        psi = evaluate(self.psi, env, memo)
        pt = torch.round(psi * self.base.support_point(env, memo)).to(intX())
        return torch.broadcast_to(pt, self.shape)


class ZeroInflatedPoisson(_ZeroInflated):
    """Reference mixture.py:577."""

    base_cls = Poisson

    def __dist_init__(self, psi, mu):
        super().__dist_init__(psi, mu=mu)


class ZeroInflatedBinomial(_ZeroInflated):
    """Reference mixture.py:641."""

    base_cls = Binomial

    def __dist_init__(self, psi, n, p):
        super().__dist_init__(psi, n=n, p=p)


class ZeroInflatedNegativeBinomial(_ZeroInflated):
    """Reference mixture.py:705."""

    base_cls = NegativeBinomial

    def __dist_init__(self, psi, mu=None, alpha=None, p=None, n=None):
        super().__dist_init__(psi, mu=mu, alpha=alpha, p=p, n=n)


class _HurdleDiscrete(_ZeroInflated):
    """P(0) = 1 - psi; the positive values follow the base truncated at
    zero (reference mixture.py:790-871)."""

    def logp(self, value, env=None, memo=None):
        if memo is None:
            memo = {}
        psi = evaluate(self.psi, env, memo)
        base_lp = self.base.logp(value, env, memo)
        log_trunc = log1mexp(torch.clamp(self.base.logp(torch.zeros_like(value), env, memo),
                                         max=-1e-15))
        res = torch.where(value == 0, torch.log1p(-psi),
                          torch.log(torch.clamp(psi, 1e-30, 1.0)) + base_lp - log_trunc)
        res = torch.where(value >= 0, res, -torch.inf)
        return check_parameters(res, psi >= 0, psi <= 1)

    def logcdf(self, value, env=None, memo=None):
        raise NotImplementedError(f"logcdf not implemented for {type(self).__name__}")

    def sample(self, generator, sample_shape=(), env=None, memo=None):
        # the zero-truncated base by 32 masked rounds of redrawing
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        if memo is None:
            memo = {}
        psi = evaluate(self.psi, env, memo)
        full = tuple(sample_shape) + self.shape
        nonzero = standard_uniform(generator, full, psi) < psi
        draw = torch.zeros(full, dtype=intX(), device=psi.device)
        got = torch.zeros(full, dtype=torch.bool, device=psi.device)
        for _ in range(32):
            cand = self._base_draw(generator, full, env, memo).to(intX())
            draw = torch.where(~got & (cand > 0), cand, draw)
            got = got | (cand > 0)
        draw = torch.where(got, draw, 1)  # all 32 rounds at 0: vanishingly rare
        return torch.where(nonzero, draw, 0).to(intX())

    def support_point(self, env=None, memo=None):
        if memo is None:
            memo = {}
        psi = evaluate(self.psi, env, memo)
        base_pt = torch.clamp(self.base.support_point(env, memo), min=1)
        return torch.broadcast_to(torch.round(psi * base_pt).to(intX()), self.shape)


class _HurdleContinuous(Continuous):
    """A point mass at 0 with weight 1 - psi and the positive base with
    weight psi (reference HurdleGamma :981, HurdleLogNormal :1037). A
    mixed discrete-continuous value has no transform: observed only."""

    param_names = ("psi",)
    support = "positive"
    base_cls = None
    __dist_init__ = _ZeroInflated.__dist_init__
    inputs = _ZeroInflated.inputs
    _resolve_shapes = _ZeroInflated._resolve_shapes
    _base_draw = _ZeroInflated._base_draw

    def default_transform(self):
        return None

    def logp(self, value, env=None, memo=None):
        if memo is None:
            memo = {}
        psi = evaluate(self.psi, env, memo)
        base_lp = self.base.logp(value, env, memo)
        res = torch.where(value == 0, torch.log1p(-psi),
                          torch.log(torch.clamp(psi, 1e-30, 1.0)) + base_lp)
        res = torch.where(value >= 0, res, -torch.inf)
        return check_parameters(res, psi >= 0, psi <= 1)

    def sample(self, generator, sample_shape=(), env=None, memo=None):
        if isinstance(sample_shape, int):
            sample_shape = (sample_shape,)
        if memo is None:
            memo = {}
        psi = evaluate(self.psi, env, memo)
        full = tuple(sample_shape) + self.shape
        nonzero = standard_uniform(generator, full, psi) < psi
        draw = self._base_draw(generator, full, env, memo)
        return torch.where(nonzero, draw, 0.0)

    def support_point(self, env=None, memo=None):
        if memo is None:
            memo = {}
        psi = evaluate(self.psi, env, memo)
        return torch.broadcast_to(psi * self.base.support_point(env, memo), self.shape)


class HurdlePoisson(_HurdleDiscrete):
    """Reference mixture.py:873."""

    base_cls = Poisson

    def __dist_init__(self, psi, mu):
        super().__dist_init__(psi, mu=mu)


class HurdleNegativeBinomial(_HurdleDiscrete):
    """Reference mixture.py:925."""

    base_cls = NegativeBinomial

    def __dist_init__(self, psi, mu=None, alpha=None, p=None, n=None):
        super().__dist_init__(psi, mu=mu, alpha=alpha, p=p, n=n)


class HurdleGamma(_HurdleContinuous):
    """Reference mixture.py:981."""

    base_cls = Gamma

    def __dist_init__(self, psi, alpha=None, beta=None, mu=None, sigma=None):
        _ZeroInflated.__dist_init__(self, psi, alpha=alpha, beta=beta, mu=mu, sigma=sigma)


class HurdleLogNormal(_HurdleContinuous):
    """Reference mixture.py:1037."""

    base_cls = LogNormal

    def __dist_init__(self, psi, mu=0.0, sigma=None, tau=None):
        _ZeroInflated.__dist_init__(self, psi, mu=mu, sigma=sigma, tau=tau)
