"""The rest of `Model` in the port against pymc_tpu, float64 on the CPU:
nested models (names joined by "::", registries shared with the root, an
unnamed sub-model taking its parent's prefix, the free-variable layout the
same as the flat twin's), coords, `compile_logp`/`compile_dlogp`/
`compile_d2logp`/`compile_fn`, `Point` and `compile`, `initial_point`,
`check_start_vals`, `point_logps`, `debug`, `profile`, `set_initval`,
`check_bounds=False`, and `vartypes` and `util`. The specification is
`tests/model/test_core_contract.py`. Values are held to pymc_tpu's at
rtol 1e-12. `set_data` and `to_graphviz` raise, naming their ROADMAP items.
Prefixed names flow through imputation, `initval=`, sampling, FileTrace,
InferenceData and `summary`.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax

import pymc_tpu as pmj
import pymc_tpu_torch as pmt
from pymc_tpu_torch import util, vartypes
from pymc_tpu_torch.sampling.mcmc import SamplingError


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DATA = np.array([0.5, -0.3, 1.2])
POINT = {"mu": 0.4, "sd_log__": np.log(0.8)}


def _small(pm, name=""):
    with pm.Model(name=name) as m:
        mu = pm.Normal("mu", 0.0, 2.0)
        sd = pm.HalfNormal("sd", 1.0)
        pm.Normal("y", mu, sd, observed=DATA)
        pm.Deterministic("twice", 2.0 * mu)
    return m


@pytest.fixture(scope="module")
def pair():
    return _small(pmj), _small(pmt)


def _np(x):
    return {k: _np(v) for k, v in x.items()} if isinstance(x, dict) else np.asarray(x)


def test_compiled_logp_forms_match(pair):
    mj, mt = pair
    np.testing.assert_allclose(float(mt.compile_logp(device="cpu")(POINT)),
                               float(mj.compile_logp()(POINT)), rtol=1e-12)
    sub_t = mt.compile_logp(vars=[mt["y"]], device="cpu")(POINT)
    np.testing.assert_allclose(float(sub_t), float(mj.compile_logp(vars=[mj["y"]])(POINT)),
                               rtol=1e-12)
    elem_t = mt.compile_logp(sum=False, device="cpu")(POINT)
    elem_j = mj.compile_logp(sum=False)(POINT)
    assert set(elem_t) == set(elem_j)
    for k in elem_j:
        np.testing.assert_allclose(_np(elem_t[k]), _np(elem_j[k]), rtol=1e-12)
    nojac_t = mt.compile_logp(jacobian=False, device="cpu")(POINT)
    np.testing.assert_allclose(float(nojac_t), float(mj.compile_logp(jacobian=False)(POINT)),
                               rtol=1e-12)


def test_compiled_derivatives_match(pair):
    mj, mt = pair
    g_t = mt.compile_dlogp(device="cpu")(POINT)
    g_j = mj.compile_dlogp()({k: jax.numpy.asarray(v) for k, v in POINT.items()})
    for k in POINT:
        np.testing.assert_allclose(float(g_t[k]), float(g_j[k]), rtol=1e-12)
    h_t = mt.compile_d2logp(device="cpu")(POINT)
    h_j = mj.compile_d2logp()(POINT)
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_j), rtol=1e-12)
    np.testing.assert_allclose(mt.compile_d2logp(negate_output=True, device="cpu")(POINT).numpy(),
                               -np.asarray(h_j), rtol=1e-12)


def test_compile_fn_point_and_compile(pair):
    mj, mt = pair
    pt = {"mu": 0.7, "sd": 0.8}
    got = mt.compile_fn([mt["twice"], mt["mu"]], device="cpu")(pt)
    want = mj.compile_fn([mj["twice"], mj["mu"]])(pt)
    np.testing.assert_allclose([float(g) for g in got], [float(w) for w in want], rtol=1e-12)
    with mt:
        assert float(pmt.compile_fn(mt["twice"], device="cpu")(pt)) == 1.4
    fn = pmt.compile([mt["mu"]], [mt["twice"], mt["mu"] + 1.0], device="cpu")
    fj = pmj.compile([mj["mu"]], [mj["twice"], mj["mu"] + 1.0])
    np.testing.assert_allclose([float(v) for v in fn(0.25)], [float(v) for v in fj(0.25)])
    with pytest.raises(TypeError, match="expected 1 arguments"):
        fn(0.1, 0.2)
    p = pmt.model.Point({"mu": 1.0, "junk": 2.0, "sd_log__": torch.tensor(0.1)},
                        filter_model_vars=True, model=mt)
    assert set(p) == {"mu", "sd_log__"} and isinstance(p["sd_log__"], np.ndarray)


def test_initial_point_checks_and_point_logps(pair, capsys):
    mj, mt = pair
    ip_t, ip_j = mt.initial_point(device="cpu"), mj.initial_point()
    assert list(ip_t) == list(ip_j)
    for k in ip_j:
        np.testing.assert_allclose(float(ip_t[k]), float(ip_j[k]), rtol=1e-12)
    a = mt.initial_point(random_seed=1, jitter=0.5, device="cpu")
    b = mt.initial_point(random_seed=2, jitter=0.5, device="cpu")
    assert float(a["mu"]) != float(b["mu"]) and abs(float(a["mu"])) <= 0.5
    assert mt.point_logps(POINT, device="cpu") == mj.point_logps(POINT)
    mt.check_start_vals(POINT, device="cpu")
    with pytest.raises(SamplingError, match="Initial evaluation"):
        mt.check_start_vals([POINT, {"mu": np.inf, "sd_log__": 0.0}], device="cpu")
    assert mt.debug(POINT, device="cpu") == {}
    assert "No problems found" in capsys.readouterr().out
    bad = mt.debug({"mu": np.nan, "sd_log__": 0.0}, verbose=True, device="cpu")
    assert set(bad) == set(mj.debug({"mu": np.nan, "sd_log__": 0.0})) == {"mu", "y"}
    assert mt.eval_rv_shapes() == mj.eval_rv_shapes()


def test_profile_times_and_writes_a_trace(pair, tmp_path):
    _, mt = pair
    report = mt.profile(n=3, point=POINT, trace_dir=tmp_path, device="cpu")
    assert report["n_calls"] == 3 and report["logp_sec_per_call"] > 0
    with open(os.path.join(tmp_path, "trace.json")) as f:
        assert json.load(f)["traceEvents"]


def test_set_initval_and_what_waits(pair):
    _, mt = pair
    mt.set_initval(mt["mu"], 1.5)
    assert float(mt.initial_point(device="cpu")["mu"]) == 1.5
    mt.set_initval("mu", None)
    assert float(mt.initial_point(device="cpu")["mu"]) == 0.0
    with pytest.raises(KeyError):
        mt.set_initval("y", 1.0)
    with pytest.raises(NotImplementedError, match="item 7"):
        mt.set_data("x", np.ones(3))
    with pytest.raises(NotImplementedError, match="item 7"):
        pmt.set_data({"x": np.ones(3)}, model=mt)
    with pytest.raises(NotImplementedError, match="item 8"):
        mt.to_graphviz()


def _nested(pm):
    with pm.Model(coords={"g": ["a", "b"]}) as root:
        with pm.Model("outer"):
            with pm.Model("inner") as inner:
                x = pm.Normal("x", 0.0, 1.0, dims="g")
            with pm.Model():
                s = pm.HalfNormal("s", 1.0, initval=0.7)
            pm.Normal("y", x.sum(), s, observed=np.array([0.3, np.nan, 1.1]))
            pm.Deterministic("d", x * 2.0)
        with pm.Model("sibling"):
            pm.Normal("x", 0.0, 1.0)
    return root, inner


def test_nested_names_and_registries_match():
    with pytest.warns(UserWarning):
        (rj, ij), (rt, it) = _nested(pmj), _nested(pmt)
    assert list(rt.named_vars) == list(rj.named_vars)
    assert "outer::inner::x" in rt and "outer::s" in rt and "sibling::x" in rt
    assert "outer::y_unobserved" in rt and "outer::d" in rt
    assert rt.value_vars == rj.value_vars
    assert it.root is rt and not it.isroot and rt.isroot and it.parent.name == "outer"
    assert it.free_RVs is rt.free_RVs and it.x is rt["outer::inner::x"]
    assert rt.rvs_to_initial_values == {"outer::s": 0.7}
    assert it.point_logps(device="cpu").keys() >= {"x"}
    q = np.random.default_rng(0).normal(size=(3, rt.raveled_info().total_size))
    lp_t, g_t = rt.logp_dlogp_fn(device="cpu")(torch.tensor(q))
    lp_j, g_j = jax.jit(jax.vmap(rj.logp_dlogp_fn()))(q)
    np.testing.assert_allclose(lp_t.numpy(), np.asarray(lp_j), rtol=1e-12)
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), rtol=1e-12)


def test_name_and_coord_checks():
    with pytest.raises(KeyError):
        pmt.Model("::bad")
    with pmt.Model(coords={"g": [1, 2]}) as m:
        with pytest.raises(ValueError, match="conflicts"):
            pmt.Normal("g", 0.0, 1.0)
        with pytest.raises(ValueError, match="conflicting length"):
            m.add_coord("g", [1, 2, 3])
    m.add_coords({"h": [1, 2, 3]})
    m.add_coord("k", length=4)
    assert m.dim_lengths == {"g": 2, "h": 3, "k": 4}
    m.set_dim("k", 6)
    with pytest.raises(ValueError, match="coord_values"):
        m.set_dim("h", 5)
    m.set_dim("h", 2, coord_values=["x", "y"])
    assert m.coords["h"] == ("x", "y") and m.dim_lengths["k"] == 6


def test_class_based_model():
    class Linear(pmt.Model):
        def __init__(self, name=""):
            super().__init__(name)
            self.b = pmt.Normal("b", 0.0, 1.0)

    with pmt.Model() as root:
        lin = Linear("lin")
    assert "lin::b" in root and lin.b is root["lin::b"]


def test_a_nested_model_samples_with_its_prefix(tmp_path):
    """The flat layout does not depend on the prefix: the nested model's
    draws are the flat twin's, bit for bit; the names reach the FileTrace,
    the InferenceData and summary."""
    kw = dict(chains=2, tune=20, draws=5, random_seed=3, nuts={"max_treedepth": 3},
              device="cpu", progressbar=False, compute_convergence_checks=False)
    flat = pmt.sample(model=_small(pmt), **kw)
    nested = pmt.sample(model=_small(pmt, "m"), trace=pmt.FileTrace(str(tmp_path / "t")), **kw)
    assert sorted(nested.posterior.keys()) == ["m::mu", "m::sd", "m::twice"]
    for k in ("mu", "sd", "twice"):
        np.testing.assert_array_equal(nested.posterior[f"m::{k}"].values, flat.posterior[k].values)
    assert "m::mu" in pmt.summary(nested).index


def test_check_bounds_off_matches_pymc_tpu():
    """Mixture weights that do not sum to 1: -inf with the check, the
    normalised density without it."""
    def build(pm, check_bounds):
        with pm.Model(check_bounds=check_bounds) as m:
            pm.Mixture("x", np.array([0.3, 0.3]), [pm.Normal.dist(0.0, 1.0),
                                                   pm.Normal.dist(1.0, 1.0)])
        return m

    got = float(build(pmt, False).compile_logp(device="cpu")({"x": 0.5}))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, float(build(pmj, False).compile_logp()({"x": 0.5})),
                               rtol=1e-12)
    assert float(build(pmt, True).compile_logp(device="cpu")({"x": 0.5})) == -np.inf


def test_vartypes_and_util_match():
    from pymc_tpu import util as uj
    from pymc_tpu import vartypes as vj

    _, mt = _small(pmj), _small(pmt)
    assert vartypes.continuous_types == vj.continuous_types
    assert [v.name for v in vartypes.typefilter(mt.free_RVs, vartypes.float_types)] == ["mu", "sd"]
    assert vartypes.isgenerator(x for x in ()) and not vartypes.isgenerator([])
    for name in ("x_log__", "a_b_interval__", "plain", "radon::s_log__"):
        assert util.is_transformed_name(name) == uj.is_transformed_name(name)
        if uj.is_transformed_name(name):
            assert util.get_untransformed_name(name) == uj.get_untransformed_name(name)
    assert util.get_transformed_name("s", mt["sd"].transform) == "s_log__"
    assert util.get_default_varnames(["a", "b_log__"], False) == ["a"]
    assert util.hashable([1]) == "[1]" and util.makeiter(3) == [3]
    assert util.get_transformed(mt["sd"]) == "sd_log__" and util.get_var_name(mt["mu"]) == "mu"
    with pytest.raises(ValueError, match="belongs to a model"):
        util.check_dist_not_registered(mt["mu"])
    gen = util.random_generator_to_key(5, device="cpu")
    state = util.RandomGeneratorState.from_generator(gen)
    first = torch.rand(3, generator=gen)
    np.testing.assert_array_equal(torch.rand(3, generator=state.restore()).numpy(), first.numpy())
    rng = util.get_random_generator(7)
    np_state = util.RandomGeneratorState.from_generator(rng)
    assert np_state.restore().integers(100) == rng.integers(100)
    assert isinstance(util.random_generator_to_key(np.random.default_rng(0), device="cpu"),
                      torch.Generator)
    idata = pmt.sample(model=mt, chains=2, tune=10, draws=5, device="cpu", progressbar=False,
                       compute_convergence_checks=False, nuts={"max_treedepth": 2})
    assert util.chains_and_samples(idata) == (2, 5)
