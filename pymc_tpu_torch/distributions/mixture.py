"""Mixture distributions: Mixture and NormalMixture.

Counterpart of `pymc_tpu/distributions/mixture.py` (Mixture :71-347,
NormalMixture :349-358; reference pymc/distributions/mixture.py:356, :497).
A mixture is a combinator: its logp is a logsumexp over the components'
logps, its draw a categorical pick among the components' draws. The
components are `.dist` objects, given as a list (one per component) or as
one distribution whose rightmost batch axis indexes the components.
`Mixture.inputs` lists the components' parameters besides `w`, so the
graph finds the random variables the components read and the constants to
place on the device. The zero-inflated and hurdle classes, and logcdf, are
not ported.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..config import intX
from ..graph import evaluate
from .continuous import Normal
from .dist_math import check_parameters
from .distribution import Distribution, as_param, standard_uniform

__all__ = ["Mixture", "NormalMixture", "MixtureTransformWarning"]


class MixtureTransformWarning(UserWarning):
    """Reference mixture.py:288."""


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
        MixtureTransformWarning where their supports differ (reference
        mixture.py:292-345)."""
        comps = self._components()
        if len({c.support for c in comps}) != 1:
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
