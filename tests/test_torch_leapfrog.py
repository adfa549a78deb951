"""The port's leapfrog halves against the Pallas TPU kernels, and the
fused NUTS leaf's wrapper.

On the CPU the wrappers of pymc_tpu_torch.ops.leapfrog run their plain
PyTorch versions; here the halves are held against pymc_tpu's Pallas kernel
bodies in interpret mode (as tests/ops/test_pallas.py runs them), in
float64 to rtol 1e-12. The leaf's plain version is held against the JAX
package's NUTS transition in tests/test_torch_nuts.py. The CUDA kernels
themselves are checked against the plain versions on the card by
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from pymc_tpu.ops import pallas_kernels as pk
from pymc_tpu_torch.config import resolve_device
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


@pytest.mark.parametrize(
    "load",
    [lambda: _build.load_library("leapfrog"), lambda: lf._leaf_kernel(torch.float64)],
    ids=["library", "leaf-kernel"],
)
def test_build_without_nvcc_raises(tmp_path, monkeypatch, load):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(lf, "_kernels", {})
    with pytest.raises(RuntimeError, match="nvcc not found"):
        load()


def _leaf(C=4, D=3, dtype=torch.float64, device="cpu"):
    """A SubtreeState of depth 3 with 4 checkpoint slots, and one leaf's
    (logp, grad, u)."""
    rng = np.random.default_rng(5)

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=device)

    q, p, g, im, eps = (t(x) for x in _inputs(C, D, seed=0))
    s = lf.SubtreeState(
        q, p, g, t(rng.normal(size=C)), t(rng.normal(size=C)), im, eps,
        torch.ones(C, dtype=torch.bool, device=device),
        torch.full((C,), 3, dtype=torch.int32, device=device), 4,
    )
    return s, t(rng.normal(size=C)), t(rng.normal(size=(C, D))), t(rng.uniform(size=C))


@pytest.mark.parametrize(
    "mutate, error",
    [
        (lambda a: a.__setitem__(0, a[0][:-1]), ValueError),  # logp not (C,)
        (lambda a: a.__setitem__(1, a[1][:, :-1]), ValueError),  # grad not (C, D)
        (lambda a: a.__setitem__(2, a[2][None]), ValueError),  # u not (C,)
        (lambda a: a.__setitem__(1, a[1].float()), TypeError),  # dtype of the state
        (lambda a: a.__setitem__(2, a[2].to("meta")), ValueError),  # device of the state
        (lambda a: a.__setitem__(1, a[1].t().contiguous().t()), ValueError),  # strided
    ],
)
def test_leaf_wrapper_rejects_bad_operands(mutate, error):
    s, *args = _leaf()
    mutate(args)
    with pytest.raises(error):
        lf.nuts_leaf_step(s, *args)


@pytest.mark.parametrize("bad", ["logp0", "active0", "depth", "slots", "inv_mass"])
def test_subtree_state_rejects_bad_inputs(bad):
    q, p, g, im, eps = _cpu()
    args = dict(
        q0=q, p0=p, grad0=g, logp0=q[:, 0].clone(), h0=q[:, 1].clone(), inv_mass=im,
        eps=eps, active0=torch.ones(4, dtype=torch.bool),
        depth=torch.zeros(4, dtype=torch.int32), slots=3,
    )
    args[bad] = {
        "logp0": q[:3, 0], "active0": torch.ones(4), "depth": torch.zeros(4),
        "slots": 0, "inv_mass": im[:, :2],
    }[bad]
    with pytest.raises(ValueError):
        lf.SubtreeState(**args)


def test_leaf_on_cpu_takes_the_plain_path():
    s, logp, grad, u = _leaf()
    np.testing.assert_array_equal(
        s.q_half.numpy(), lf.kick_drift_plain(s.q, s.p, s.grad, s.inv_mass, s.eps)[0].numpy()
    )
    twin = s.clone()
    before = lf.nuts_leaf_step.launches
    for k in range(3):
        count = lf.nuts_leaf_step(s, logp, grad, u)
        count_plain = lf.nuts_leaf_step_plain(twin, logp, grad, u)
        assert count.dtype == torch.int32 and count.shape == ()
        assert int(count) == int(s.act.sum()) == int(count_plain)
        assert int(s.count[(k + 1) & 1]) == 0 and s.leaf == k + 1
        if k == 0:  # every chain stepped: leaf 0's momentum is at slot 0
            np.testing.assert_array_equal(s.p_ckpt[:, 0].numpy(), s.p.numpy())
        for name in lf.SubtreeState.BUFFERS:
            torch.testing.assert_close(
                getattr(s, name), getattr(twin, name), rtol=0, atol=0, equal_nan=True
            )
    assert lf.nuts_leaf_step.launches == before  # CPU: no kernel launch
    assert int(s.n.max()) <= 3


def test_leaf_state_on_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        _leaf(device=resolve_device("cuda"))


def test_leaf_buffers_struct_matches_the_kernel_source():
    """ctypes' _LeafBuffers and csrc/leapfrog.cu's LeafBuffers: the same
    fields in the same order, pointers where the kernel has pointers (the
    library also checks the sizes when the leaf kernel is first typed)."""
    import ctypes
    import os
    import re

    with open(os.path.join(_build.CSRC_DIR, "leapfrog.cu")) as f:
        body = re.search(r"struct LeafBuffers \{(.*?)\n\};", f.read(), re.S).group(1)
    fields = []
    for decl in re.sub(r"//[^\n]*", "", body).split(";"):
        m = re.fullmatch(r"\s*(?:const\s+)?(\w+)\s*(\*?)\s*([\w\s,]+?)\s*", decl)
        if m is None:
            assert not decl.strip(), decl
            continue
        kind = ctypes.c_void_p if m.group(2) else {"int64_t": ctypes.c_int64}[m.group(1)]
        fields += [(name.strip(), kind) for name in m.group(3).split(",")]
    assert fields == lf._LeafBuffers._fields_


def _leaf_teams():
    """The leaf kernel's team tables of csrc/leapfrog.cu, kFewRows and
    kManyRows: {name: [(largest D, warps a row), ...]}."""
    import os
    import re

    with open(os.path.join(_build.CSRC_DIR, "leapfrog.cu")) as f:
        src = f.read()
    teams = {}
    for name in ("kFewRows", "kManyRows"):
        body = re.search(rf"constexpr LeafTeam {name}\[\] = \{{(.*?)\}};", src).group(1)
        teams[name] = [(2**63 - 1 if d == "INT64_MAX" else int(d), int(w))
                       for d, w in re.findall(r"\{(\w+), (\d+)\}", body)]
    return teams


@pytest.mark.parametrize("D", [1, 45, 64, 65, 128, 129, 175, 512, 513, 2048, 2049, 10004])
def test_leaf_teams_hold_every_row(D):
    """Every D gets a team of 2, 4, 8 or 16 warps a row from each table (the
    last entry takes every longer row), and a batch with no more rows than
    SMs gets at least as many warps a row as a larger one."""
    teams = _leaf_teams()
    warps = {}
    for name, table in teams.items():
        limits = [d for d, _ in table]
        assert limits == sorted(limits) and limits[-1] == 2**63 - 1, table
        warps[name] = next(w for d, w in table if D <= d)
        assert warps[name] in (2, 4, 8, 16)
    assert warps["kFewRows"] >= warps["kManyRows"]
