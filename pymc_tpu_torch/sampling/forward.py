"""Forward sampling of a model's generative graph.

Counterpart of `pymc_tpu/sampling/forward.py::_generative_fn` (:46-110),
the one piece of that module ported so far: the prior draws that seed SMC's
particles. Prior and posterior predictive sampling are not ported.
"""

from __future__ import annotations

import torch

from ..graph import evaluate

__all__ = ["_generative_fn"]


def _generative_fn(model, device=None, dtype=None):
    """fn(generator, given=None) -> {name: value}: one draw of every free RV
    not in `given` (a free RV in `given` takes its value from there), of
    every observed RV at its data's shape, and every deterministic.

    The RVs are drawn in registration order, each from its distribution
    with its parents' values of this draw; the constants are placed once on
    `device` (default: the card) in `dtype` (default: `floatX(device)`),
    and `generator` lives there. Under `torch.func.vmap(...,
    randomness="different")` every point of the batch gets its own draws.
    """
    placed = model.placed_constants(device, dtype)
    reg_order = {name: i for i, name in enumerate(model.named_vars)}
    plan = sorted(
        [(True, rv) for rv in model.free_RVs] + [(False, rv) for rv in model.observed_RVs],
        key=lambda t: reg_order[t[1].name],
    )
    deterministics = list(model.deterministics)

    def fn(generator, given=None):
        given = given or {}
        env = {}
        memo = dict(placed)
        out = {}
        for free, rv in plan:
            if free:
                env[rv.name] = (
                    given[rv.name] if rv.name in given
                    else rv.dist.sample(generator, (), env, memo)
                )
            else:
                # an observed RV is drawn at its data's shape
                target = tuple(rv.shape)
                n = len(rv.dist.shape)
                extra = target[: len(target) - n] if n <= len(target) else ()
                env[rv.name] = torch.broadcast_to(
                    rv.dist.sample(generator, extra, env, memo), target
                )
            out[rv.name] = env[rv.name]
        for det in deterministics:
            out[det.name] = evaluate(det, env, memo)
        return out

    return fn
