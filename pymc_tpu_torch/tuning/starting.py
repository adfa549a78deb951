"""MAP estimation and the Hessian at a point.

Counterpart of `pymc_tpu/tuning/starting.py` (reference
pymc/tuning/starting.py: find_MAP:52, scipy.optimize over the raveled
unconstrained vector; pymc/tuning/scaling.py: find_hessian:45,
guess_scaling:77). scipy runs on the host, as in the JAX package; each of
its evaluations is one logp+grad of the model at one point on the device
(by default the card), copied to the host in float64 in one transfer. MAP
maximises the constrained-space density (jacobian=False). The Hessian is
exact: `torch.func.hessian`, forward mode over reverse mode, which goes
through the Cholesky kernel's `jvp` and backward rules where the model has
a Cholesky.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from ..blocking import ravel_point, unravel_vector
from ..config import floatX, resolve_device
from ..initial_point import support_point_values
from ..model.core import modelcontext

__all__ = ["find_MAP", "find_hessian", "guess_scaling"]

_log = logging.getLogger("pymc_tpu_torch")


def _initial_point(model, device, dtype):
    return {k: v.to(device=device, dtype=dtype) for k, v in support_point_values(model).items()}


def _to_numpy(x):
    return x.detach().cpu().numpy()


def find_MAP(start=None, vars=None, method="L-BFGS-B", return_raw=False,
             include_transformed=True, progressbar=True, maxeval=5000, model=None, seed=None,
             device=None, **kwargs):
    """The maximum a posteriori point by scipy.optimize (reference
    starting.py:52): {rv name: constrained value, deterministic name: value
    at the point, and with include_transformed the value-space entries},
    numpy arrays. `start` maps rv names to constrained values (missing
    ones from the model's initial point). With return_raw, (point, scipy
    result)."""
    from scipy import optimize

    model = modelcontext(model)
    device = resolve_device(device)
    dtype = floatX(device)
    info = model.raveled_info()
    init = _initial_point(model, device, dtype)
    if start is not None:
        placed = model.placed_constants(device, dtype)
        constrained = model.constrain(init, dict(placed))
        constrained.update({k: torch.as_tensor(np.array(v), device=device, dtype=dtype)
                            for k, v in start.items()})
        q0 = ravel_point(model.unconstrain(constrained, placed), info)
    else:
        q0 = ravel_point(init, info)
    q0 = _to_numpy(q0).astype(np.float64)
    logp_grad = model.logp_dlogp_fn(device=device, dtype=dtype, jacobian=False)
    gradient_free = str(method).lower() in {"powell", "nelder-mead", "cobyla", "cobyqa"}

    def f(q):
        logp, grad = logp_grad(torch.as_tensor(q, device=device, dtype=dtype)[None])
        out = _to_numpy(torch.cat([-logp, -grad[0]])).astype(np.float64)
        v, g = float(out[0]), out[1:]
        if not np.isfinite(v):
            return 1e100, np.zeros_like(g)
        return v, g

    res = optimize.minimize((lambda q: f(q)[0]) if gradient_free else f, q0,
                            jac=not gradient_free, method=method,
                            options={"maxiter": maxeval, **kwargs})
    q_map = torch.as_tensor(res.x, device=device, dtype=dtype)
    post = model.postprocess_fn(device=device, dtype=dtype)(q_map[None])
    out = {k: _to_numpy(v[0]) for k, v in post.items()}
    if include_transformed:
        for k, v in unravel_vector(q_map, info).items():
            out[k] = _to_numpy(v)
    return (out, res) if return_raw else out


def _flat_point(model, info, point, device, dtype):
    if point is None:
        return ravel_point(_initial_point(model, device, dtype), info)
    if any(n in point for n in info.names):
        values = {**_initial_point(model, device, dtype),
                  **{k: torch.as_tensor(np.array(v), device=device, dtype=dtype)
                     for k, v in point.items() if k in info.names}}
        return ravel_point(values, info)
    constrained = {k: torch.as_tensor(np.array(v), device=device, dtype=dtype)
                   for k, v in point.items()}
    return ravel_point(model.unconstrain(constrained, model.placed_constants(device, dtype)),
                       info)


def find_hessian(point=None, vars=None, model=None, negate_output=True, device=None):
    """The Hessian of -logp (of logp with negate_output=False) at `point`
    over the unconstrained flat space (reference tuning/scaling.py:45), as
    a (D, D) numpy array; exact, by torch.func.hessian on the device."""
    model = modelcontext(model)
    device = resolve_device(device)
    dtype = floatX(device)
    info = model.raveled_info()
    logp = model.logp_fn(device=device, dtype=dtype)
    q0 = _flat_point(model, info, point, device, dtype)
    H = _to_numpy(torch.func.hessian(lambda q: logp(unravel_vector(q, info)))(q0))
    return -H if negate_output else H


def guess_scaling(point, vars=None, model=None, scaling_bound=1e-8, device=None):
    """A diagonal scaling from the Hessian (reference scaling.py:77)."""
    H = find_hessian(point, vars, model, device=device)
    d = np.clip(np.abs(np.diagonal(H)), scaling_bound, 1.0 / scaling_bound)
    return 1.0 / d
