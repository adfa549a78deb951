"""The VI optimizers of pymc_tpu_torch against pymc_tpu's (optax's
formulas), fed the same gradients: 20 updates of a two-leaf parameter dict
at rtol 1e-12 in float64, for every optimizer of `updates.py`, the norm
constraints and the momentum wrappers."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
import optax

from pymc_tpu.variational import updates as up_j
from pymc_tpu_torch.variational import updates as up_t

STEPS = 20


def _run(opt_j, opt_t, seed=0, scale=1.0):
    rng = np.random.default_rng(seed)
    p0 = {"mu": rng.normal(size=5), "rho": rng.normal(size=(2, 3))}
    pj = {k: jnp.asarray(v) for k, v in p0.items()}
    pt = {k: torch.as_tensor(v) for k, v in p0.items()}
    sj, st = opt_j.init(pj), opt_t.init(pt)
    for _ in range(STEPS):
        g = {k: rng.normal(size=v.shape) * scale for k, v in p0.items()}
        uj, sj = opt_j.update({k: jnp.asarray(v) for k, v in g.items()}, sj, pj)
        ut, st = opt_t.update({k: torch.as_tensor(v) for k, v in g.items()}, st, pt)
        pj, pt = optax.apply_updates(pj, uj), up_t.apply_updates(pt, ut)
        for k in p0:
            np.testing.assert_allclose(ut[k].numpy(), np.asarray(uj[k]), rtol=1e-12, atol=1e-15)
    for k in p0:
        np.testing.assert_allclose(pt[k].numpy(), np.asarray(pj[k]), rtol=1e-12)


OPTIMIZERS = [
    ("sgd", {}), ("sgd", {"learning_rate": 0.3}), ("momentum", {}),
    ("momentum", {"momentum": 0.5, "learning_rate": 0.1}), ("nesterov_momentum", {}),
    ("adagrad", {}), ("adagrad", {"learning_rate": 0.1, "epsilon": 1e-3}),
    ("adagrad_window", {}), ("adagrad_window", {"n_win": 3, "learning_rate": 0.05}),
    ("rmsprop", {}), ("rmsprop", {"rho": 0.5, "epsilon": 1e-3}), ("adadelta", {}),
    ("adadelta", {"rho": 0.7}), ("adam", {}), ("adam", {"beta1": 0.5, "learning_rate": 0.1}),
    ("adamax", {}), ("adamax", {"beta2": 0.9}),
]


@pytest.mark.parametrize("name, kwargs", OPTIMIZERS)
def test_optimizer_matches_optax(name, kwargs):
    _run(getattr(up_j, name)(**kwargs), getattr(up_t, name)(**kwargs))


@pytest.mark.parametrize("max_norm, scale", [(0.5, 1.0), (10.0, 1.0), (0.3, 0.01)])
def test_norm_constraints_match_optax(max_norm, scale):
    _run(up_j.norm_constraint(max_norm), up_t.norm_constraint(max_norm), scale=scale)
    _run(up_j.total_norm_constraint(max_norm), up_t.total_norm_constraint(max_norm),
         scale=scale)


@pytest.mark.parametrize("wrapper", ["apply_momentum", "apply_nesterov_momentum"])
def test_momentum_wrappers_match_optax(wrapper):
    _run(getattr(up_j, wrapper)(up_j.sgd(0.1), momentum=0.7),
         getattr(up_t, wrapper)(up_t.sgd(0.1), momentum=0.7))
    _run(getattr(up_j, wrapper)(), getattr(up_t, wrapper)())


def test_clipped_optimizer_chain_matches_optax():
    # Inference's total_grad_norm_constraint: clip, then the optimizer
    _run(optax.chain(optax.clip_by_global_norm(0.5), up_j.adagrad_window()),
         up_t.chain(up_t.clip_by_global_norm(0.5), up_t.adagrad_window()))


def test_get_optimizer():
    assert up_t.get_optimizer(None) is not None
    _run(up_j.get_optimizer(None, default="adagrad", default_lr=0.1),
         up_t.get_optimizer(None, default="adagrad", default_lr=0.1))
    _run(up_j.get_optimizer("adam"), up_t.get_optimizer("adam"))
    opt = up_t.sgd(0.2)
    assert up_t.get_optimizer(opt) is opt
    _run(up_j.get_optimizer(lambda: up_j.rmsprop(0.01)),
         up_t.get_optimizer(lambda: up_t.rmsprop(0.01)))
    with pytest.raises(TypeError):
        up_t.get_optimizer(3.0)
    with pytest.raises(KeyError):
        up_t.get_optimizer("lbfgs")


def test_nested_params():
    # a Blocked approximation's params are {"g0": {...}, "g1": {...}}
    p = {"g1": {"mu": torch.ones(2)}, "g0": {"mu": torch.zeros(3), "rho": torch.ones(1)}}
    assert [x.shape for x in up_t.tree_leaves(p)] == [(3,), (1,), (2,)]
    opt = up_t.adam(0.1)
    u, _ = opt.update(up_t.tree_map(torch.ones_like, p), opt.init(p), p)
    new = up_t.apply_updates(p, u)
    torch.testing.assert_close(new["g1"]["mu"], torch.full((2,), 0.9))
