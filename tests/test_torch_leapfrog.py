"""The port's leapfrog halves against the Pallas TPU kernels.

On the CPU the wrappers of pymc_tpu_torch.ops.leapfrog run their plain
PyTorch versions; here they are held against pymc_tpu's Pallas kernel
bodies in interpret mode (as tests/ops/test_pallas.py runs them), in
float64 to rtol 1e-12. The CUDA kernels themselves are checked against the
plain versions on the card by chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from pymc_tpu.ops import pallas_kernels as pk
from pymc_tpu_torch.ops import _build
from pymc_tpu_torch.ops import leapfrog as lf


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def interpret_mode():
    old = pk._INTERPRET
    pk._INTERPRET = True
    yield
    pk._INTERPRET = old


def _inputs(C, D, seed):
    rng = np.random.default_rng(seed)
    q, p, g = (rng.normal(size=(C, D)) for _ in range(3))
    im = rng.uniform(0.5, 2.0, size=(C, D))
    eps = rng.uniform(0.05, 0.3, size=C) * rng.choice([-1.0, 1.0], C)
    return q, p, g, im, eps


SHAPES = [(8, 175), (16, 256), (64, 175)]


@pytest.mark.parametrize("C,D", SHAPES)
def test_kick_drift_matches_pallas(interpret_mode, C, D):
    args = _inputs(C, D, seed=C + D)
    assert pk.pallas_available()
    q_j, ph_j = pk.leapfrog_kick_drift(*args)
    before = lf.leapfrog_kick_drift.launches
    q_t, ph_t = lf.leapfrog_kick_drift(*map(torch.as_tensor, args))
    assert lf.leapfrog_kick_drift.launches == before  # CPU: no kernel launch
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), rtol=1e-12)
    np.testing.assert_allclose(ph_t.numpy(), np.asarray(ph_j), rtol=1e-12)


@pytest.mark.parametrize("C,D", SHAPES)
def test_final_kick_matches_pallas(interpret_mode, C, D):
    _, p_half, g, im, eps = _inputs(C, D, seed=1 + C + D)
    p_j, ke_j = pk.leapfrog_final_kick(p_half, g, im, eps)
    before = lf.leapfrog_final_kick.launches
    p_t, ke_t = lf.leapfrog_final_kick(*map(torch.as_tensor, (p_half, g, im, eps)))
    assert lf.leapfrog_final_kick.launches == before
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-12)
    np.testing.assert_allclose(ke_t.numpy(), np.asarray(ke_j), rtol=1e-12)


def _cpu(C=4, D=3, dtype=torch.float64):
    q, p, g, im, eps = _inputs(C, D, seed=0)
    return [torch.as_tensor(x, dtype=dtype) for x in (q, p, g, im, eps)]


@pytest.mark.parametrize(
    "mutate, error",
    [
        (lambda a: a.__setitem__(1, a[1][:, :2]), ValueError),  # shape mismatch
        (lambda a: a.__setitem__(4, a[4][:3]), ValueError),  # eps not (C,)
        (lambda a: a.__setitem__(2, a[2].float()), TypeError),  # mixed dtypes
        (lambda a: a.__setitem__(0, a[0][:, :0]), ValueError),  # D == 0
        (lambda a: a.__setitem__(3, a[3].to("meta")), ValueError),  # mixed devices
    ],
)
def test_wrapper_rejects_bad_operands(mutate, error):
    args = _cpu()
    mutate(args)
    with pytest.raises(error):
        lf.leapfrog_kick_drift(*args)


def test_wrapper_rejects_integer_and_unsupported_devices():
    args = [a.to(torch.int64) for a in _cpu()]
    with pytest.raises(TypeError):
        lf.leapfrog_final_kick(*args[1:])
    meta = [a.to("meta") for a in _cpu()]
    with pytest.raises(ValueError, match="no kernel for device"):
        lf.leapfrog_kick_drift(*meta)


def test_float32_plain_path_keeps_dtype():
    p_new, ke = lf.leapfrog_final_kick(*_cpu(dtype=torch.float32)[1:])
    assert p_new.dtype == torch.float32 and ke.dtype == torch.float32
    assert ke.shape == (4,)


def test_build_path_is_keyed_by_source_hash(tmp_path, monkeypatch):
    src = tmp_path / "leapfrog.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(_build, "CSRC_DIR", str(tmp_path))
    first = _build.library_path("leapfrog")
    src.write_text("// two\n")
    second = _build.library_path("leapfrog")
    assert first != second
    assert first.startswith(_build.BUILD_DIR) and first.endswith(".so")


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_loaded", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load_library("leapfrog")
