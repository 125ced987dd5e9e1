"""The shaped one-thread form of the general and registered vector filter
kernels (``csrc/vector_filter_general_shaped.cuh``): one thread a
trajectory, up to 4 measurement outputs on states of 2-5 dimensions, both
rules at the UT or CKF point count, D, E, N, the models and both rules' kinds
template arguments, the rules, R and the measurement's constants by value, the
points' values and offsets on chip, no scratch buffer.
``ops.vector_filter.lanes_of`` names it ``_SHAPED``.

- Host builds: the general kernel's 24 instantiations
  (``vector_filter_general_shaped_host.cpp``, built with g++ once a module)
  and registered 2-D configurations (the generated header's ``VFR_SHAPED``
  entries through ``vector_filter_host.cpp``, one build a module) equal the
  plain version with the C library's transcendentals, to the bit, all five
  streams: every instantiated table pair under the UKF and the CKF, a
  registered driven pendulum with a registered two-output measurement under
  the UKF, the CKF and GPQ (BQ rules on both transforms), a registered
  pendulum with the table's radar and 3 bearings.
- Against the JAX package's float64 filter: CT + radar under the UKF, 4 x 20,
  all five streams at 1e-10, the tolerance of
  ``tests/test_torch_dd_pairs.py``.
- Routing: ``kernel_of`` / ``lanes_of`` on the shapes the form takes and on
  those it leaves to the other forms; the header's instantiation list
  (``VGS_PAIRS``) is what ``lanes_of`` asks (``vgs_takes_on``); the
  parameter struct's mirror; no scratch buffer.

Measurements come from a numpy seed: 4 trajectories of 20 steps simulated
through the port's model functions with numpy noise.
"""
import ctypes
import math
import re
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ssmtoybox_tpu as st
from ssmtoybox_tpu import ssmod as jssmod
from ssmtoybox_tpu.utils import GaussRV as JGaussRV
import ssmtoybox_torch as stt
from ssmtoybox_torch import set_device, ssmod
from ssmtoybox_torch.ops import KernelForm, forms, register_dyn_dd_vec, register_obs_dd_vec
from ssmtoybox_torch.ops import vector_filter as vf
from ssmtoybox_torch.utils import GaussRV


class Driven2D(ssmod.TransitionModel):
    """A driven pendulum, ``[x0 + dt x1, x1 - w dt sin(x0) + dt u_t]``, ``u_t
    = 0.5 sin(0.1 t)`` a per-step stream (``chip_smoke.py``'s registry
    lane)."""
    dim_state, dim_noise = 2, 2
    DT, W = 0.05, 4.0

    def dyn_fcn(self, x, q, time):
        x0, x1 = x.unbind(-1)
        u = 0.5 * math.sin(0.1 * time)
        return torch.stack([x0 + self.DT * x1,
                            x1 - (self.W * self.DT) * torch.sin(x0) + self.DT * u], -1) + q


class Mix2(ssmod.MeasurementModel):
    """``[a^2 + 0.5 b, sin(b) + 0.2 a]`` of the components (a, b) its
    ``state_index`` picks."""
    dim_substate, dim_out, dim_noise = 2, 2, 2

    def meas_fcn(self, x, r, time):
        a, b = x[..., 0], x[..., 1]
        return torch.stack([a * a + 0.5 * b, torch.sin(b) + 0.2 * a], -1) + r


class PendCopy(ssmod.Pendulum2DTransition):
    """The table's pendulum, registered with its own statements."""


def _driven_lower(model, n_steps):
    def plain(x, c, s, fns):
        x0, x1 = x.unbind(-1)
        return torch.stack([x0 + c[0] * x1, x1 - c[1] * fns.sin(x0) + c[0] * s[0]], -1)
    return [0.5 * np.sin(0.1 * np.arange(n_steps))], KernelForm(
        "f[0] = x[0] + c[0] * x[1];\nf[1] = x[1] - c[1] * sin(x[0]) + c[0] * s[0];",
        (model.DT, model.W * model.DT), plain)


def _mix_lower(model):
    i, j = model.state_index

    def plain(x, c, fns):
        a, b = x[..., i], x[..., j]
        return torch.stack([a * a + c[0] * b, fns.sin(b) + c[1] * a], -1)
    return KernelForm(f"h[0] = x[{i}] * x[{i}] + c[0] * x[{j}];\n"
                      f"h[1] = sin(x[{j}]) + c[1] * x[{i}];", (0.5, 0.2), plain)


def _pend_lower(model, n_steps):
    def plain(x, c, s, fns):
        x0, x1 = x.unbind(-1)
        return torch.stack([x0 + x1 * c[0], x1 - c[1] * fns.sin(x0)], -1)
    return [], KernelForm("f[0] = x[0] + x[1] * c[0];\nf[1] = x[1] - c[1] * sin(x[0]);",
                          (model.dt, model.g * model.dt), plain)


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port runs on the card unless told otherwise; these tests run it
    on the CPU, on one intra-op thread (the suite runs several workers at
    once), with the registered models registered (unregistered when the
    module ends: the registries are module globals)."""
    set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    register_dyn_dd_vec(Driven2D, _driven_lower)
    register_obs_dd_vec(Mix2, _mix_lower)
    register_dyn_dd_vec(PendCopy, _pend_lower)
    yield
    forms.DYN_DD_VEC.pop(Driven2D, None)
    forms.OBS_DD_VEC.pop(Mix2, None)
    forms.DYN_DD_VEC.pop(PendCopy, None)
    torch.set_num_threads(threads)
    set_device(None)


def _libm(fn):
    def apply(*ts):
        flat = [t.reshape(-1).tolist() for t in ts]
        out = torch.tensor([fn(*v) for v in zip(*flat)], dtype=torch.float64)
        return out.reshape(ts[0].shape)
    return apply


#: the C library's transcendentals, one value at a time: what a g++ build of
#: the step header calls (PyTorch's vectorised CPU versions may be an ulp off)
LIBM_FNS = SimpleNamespace(
    sqrt=_libm(lambda v: math.sqrt(v) if v >= 0.0 or v != v else math.nan),
    exp=_libm(lambda v: math.exp(v) if v < 709.0 or v != v else math.inf),
    sin=_libm(math.sin), cos=_libm(math.cos), atan2=_libm(math.atan2))

FIELDS = ("fi_mean", "fi_cov", "pr_mean", "pr_cov", "pr_xx_cov")
B, T = 4, 20

SENSORS = np.array([[0.0, 0.0], [200.0, 0.0], [0.0, 200.0], [200.0, 200.0]])
CT_M0, CT_P0 = np.array([100.0, 10.0, 100.0, 5.0, 0.06]), np.diag([10.0, 1.0, 10.0, 1.0, 1e-3])
PEND_Q = 0.1 * np.array([[0.01 ** 3 / 3, 0.01 ** 2 / 2], [0.01 ** 2 / 2, 0.01]])

#: transition -> (state dimension, maker(new, rv)); ``new(cls)`` is a class's
#: constructor in either package, ``rv(d, mean, cov)`` its Gaussian
DYNS = {
    "reentry": (5, lambda new, rv: new("ReentryVehicle2DTransition")(
        rv(5, np.array([6500.4, 349.14, -1.8093, -6.7967, 0.6932]),
           np.diag([1e-6, 1e-6, 1e-6, 1e-6, 1.0])),
        rv(3, None, np.diag([2.4064e-5, 2.4064e-5, 1e-6])), dt=0.05)),
    "cv": (4, lambda new, rv: new("ConstantVelocity")(
        rv(4, np.array([100.0, 10.0, 100.0, 5.0]), np.diag([10.0, 1.0, 10.0, 1.0])),
        rv(2, None, np.diag([0.5, 0.5])), dt=0.5)),
    "pendulum": (2, lambda new, rv: new("Pendulum2DTransition")(
        rv(2, np.array([1.5, 0.0]), 0.01 * np.eye(2)), rv(2, None, PEND_Q), dt=0.01)),
    "falling_body": (3, lambda new, rv: new("ReentryVehicle1DTransition")(
        rv(3, np.array([90.0, 6.0, 1.5]), 0.09 * np.eye(3)), rv(3, None, 1e-8 * np.eye(3)),
        dt=0.1)),
    "ct": (5, lambda new, rv: new("CoordinatedTurnTransition")(
        rv(5, CT_M0, CT_P0), rv(5, None, np.diag([0.1, 0.1, 0.1, 0.1, 1e-5])), dt=0.1)),
    "driven": (2, lambda new, rv: Driven2D(rv(2, np.array([1.0, 0.0]), 0.1 * np.eye(2)),
                                           rv(2, None, 1e-3 * np.eye(2)))),
    "pend_copy": (2, lambda new, rv: PendCopy(rv(2, np.array([1.5, 0.0]), 0.01 * np.eye(2)),
                                              rv(2, None, 1e-4 * np.eye(2)), dt=0.01)),
}


def _pos(D):
    """The state components a planar measurement reads."""
    return [0, 2] if D >= 4 else [0, 1]


def _bearings(S):
    scale = lambda D: SENSORS[:S] / 100.0 - 1.0 if D == 2 else SENSORS[:S]  # noqa: E731
    return lambda new, rv, D: new("BearingMeasurement")(
        rv(S, None, 1e-3 * np.eye(S)), dim_state=D, state_index=_pos(D), sensor_pos=scale(D))


#: measurement -> maker(new, rv, D)
OBS = {
    "sine": lambda new, rv, D: new("Pendulum2DMeasurement")(rv(1, None, 0.1 * np.eye(1)),
                                                            dim_state=D),
    "range": lambda new, rv, D: new("RangeMeasurement")(rv(1, None, 0.03 * np.eye(1)),
                                                        dim_state=D),
    "ungm": lambda new, rv, D: new("UNGMMeasurement")(rv(1, None, 1.0 * np.eye(1)), dim_state=D,
                                                      state_index=[0]),
    "radar": lambda new, rv, D: new("Radar2DMeasurement")(
        rv(2, None, np.diag([1.0, 1e-4])), dim_state=D, state_index=_pos(D),
        radar_loc=np.array([-5.0, -5.0])),
    "mix": lambda new, rv, D: Mix2(rv(2, None, 0.05 * np.eye(2)), dim_state=D,
                                   state_index=[1, 0]),
    **{f"b{S}": _bearings(S) for S in (1, 2, 3, 4)},
}


def _system(dyn, obs, jax_side=False):
    """(transition, measurement) in the port or the JAX package."""
    if jax_side:
        new, rv = (lambda cls: getattr(jssmod, cls).create), (
            lambda d, m, c: JGaussRV.create(d, mean=m, cov=c))
    else:
        new, rv = (lambda cls: getattr(ssmod, cls)), (lambda d, m, c: GaussRV(d, mean=m, cov=c))
    D, make = DYNS[dyn]
    return make(new, rv), OBS[obs](new, rv, D)


def _kpar(D):
    return np.array([[1.0] + [3.0] * D])


#: rule -> maker of the port's filter
RULES = {
    "ukf": lambda d, o: stt.UnscentedKalman(d, o),
    "ckf": lambda d, o: stt.CubatureKalman(d, o),
    "gh3": lambda d, o: stt.GaussHermiteKalman(d, o, deg=3),
    "gpq": lambda d, o: stt.GaussianProcessKalman(d, o, _kpar(d.dim_state), _kpar(d.dim_state)),
    "ukf/ckf": lambda d, o: stt.GaussianInference(d, o, stt.UnscentedKalman(d, o).tf_dyn,
                                                  stt.CubatureKalman(d, o).tf_obs),
}


def _params(dyn, obs, rule):
    alg = RULES[rule](*_system(dyn, obs))
    return vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)


def _simulate(dyn, obs, seed=0):
    """(B, E, T) measurements simulated with numpy noise through the port's
    model functions (truth from step 0, measurement k of the state at step
    k)."""
    d, o = _system(dyn, obs)
    rng = np.random.default_rng(seed)
    m0, P0 = (t.numpy() for t in d.init_rv.get_stats()[:2])
    Q, R = d.noise_rv.get_stats()[1].numpy(), o.noise_rv.get_stats()[1].numpy()
    D = d.dim_state
    x = torch.as_tensor(rng.multivariate_normal(np.ravel(m0), np.reshape(P0, (D, D)), size=B))
    ys = []
    for k in range(T):
        q = rng.multivariate_normal(np.zeros(len(Q)), np.atleast_2d(Q), size=B)
        x = d.dyn_fcn(x, torch.as_tensor(q), k)
        r = torch.as_tensor(rng.multivariate_normal(np.zeros(len(R)), np.atleast_2d(R), size=B))
        ys.append(o.meas_fcn(o._select(x), r, k + 1))
    return torch.stack(ys, dim=-1)


def _need_gxx():
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the step header cannot be built for the host")


#: the table's pairs of ``VGS_PAIRS`` (``csrc/vector_filter_general_shaped.cuh``)
TABLE_PAIRS = [("ct", "radar"), ("ct", "b2"), ("ct", "b3"), ("pendulum", "radar"),
               ("pendulum", "ungm"), ("pendulum", "b3"), ("falling_body", "sine"),
               ("falling_body", "b4"), ("cv", "b2"), ("cv", "b3"), ("reentry", "range"),
               ("reentry", "ungm")]
#: registered configurations of the shaped form: (transition, measurement, rule)
REGISTERED_CASES = [("driven", "mix", "ukf"), ("driven", "mix", "ckf"), ("driven", "mix", "gpq"),
                    ("pend_copy", "radar", "ukf"), ("pend_copy", "b3", "ckf")]


@pytest.fixture(scope="module")
def general_host():
    """One g++ build of the general kernel's shaped form (its 24
    instantiations)."""
    _need_gxx()
    return vf._general_shaped_host()


@pytest.fixture(scope="module")
def registered_host():
    """One g++ build of the registered kernel's source for the registered
    cases, each in the shaped form."""
    _need_gxx()
    configs = [_params(*case) for case in REGISTERED_CASES]
    assert all(vf.lanes_of(p) == vf._SHAPED for p in configs)
    return vf.build_registered(configs, host=True)


def _held_to_plain(params, ys):
    want = vf._vector_filter_plain(params, ys, LIBM_FNS)
    time_major = ys.permute(2, 1, 0).contiguous().permute(2, 1, 0)
    for y in (ys, time_major):
        for f, a, b in zip(FIELDS, vf._host_shim_run(params, y), want):
            assert bool(torch.isfinite(b).all()), f
            assert torch.equal(a, b), f"{f}: max |diff| {float((a - b).abs().max()):.3e}"


@pytest.mark.parametrize("rule", ["ukf", "ckf"])
@pytest.mark.parametrize("pair", TABLE_PAIRS, ids="-".join)
def test_shaped_form_on_host_matches_plain(general_host, pair, rule):
    """The general kernel's shaped form built with g++ == the plain version
    with the C library's transcendentals, to the bit, all five streams, at
    every instantiation (each pair of ``VGS_PAIRS`` at N = 2 D + 1 and 2 D);
    measurements read through their strides."""
    params = _params(*pair, rule)
    assert (vf.kernel_of(params), vf.lanes_of(params)) == ("vector_filter_general", vf._SHAPED)
    _held_to_plain(params, _simulate(*pair, seed=1))


@pytest.mark.parametrize("case", REGISTERED_CASES, ids="-".join)
def test_registered_shaped_form_on_host_matches_plain(registered_host, case):
    """The registered kernel's shaped form on the generated policy (the
    forms' statements, a table measurement by its id, the constants by
    value; GPQ on both transforms) built with g++ == the plain version, to
    the bit, all five streams; no library is built beyond the module's."""
    params = _params(*case)
    built = len(vf._build._bound)
    _held_to_plain(params, _simulate(*case[:2], seed=2))
    assert len(vf._build._bound) == built, "the module's build should have held the case"


def test_shaped_form_matches_jax_f64(general_host):
    """The shaped form's host build on a record of CT + radar (UKF) against
    the JAX package's float64 filter on the same measurements, all five
    streams at 1e-10 (``tests/test_torch_dd_pairs.py``'s tolerance)."""
    ys = _simulate("ct", "radar", seed=3)
    jd, jo = _system("ct", "radar", jax_side=True)
    jalg = st.UnscentedKalman(jd, jo)
    ref = jax.jit(lambda b: st.gaussian_filter_batch(jalg.mod_dyn, jalg.mod_obs, jalg.tf_dyn,
                                                     jalg.tf_obs, b))(jnp.asarray(ys.numpy()))
    params = _params("ct", "radar", "ukf")
    got = vf._host_shim_run(params, ys)
    for f, g in zip(FIELDS, got):
        g = g.permute(2, 1, 0) if g.ndim == 3 else g.permute(3, 1, 2, 0)     # (B, ..., T)
        assert bool(torch.isfinite(g).all()), f
        np.testing.assert_allclose(g.numpy(), np.asarray(getattr(ref, f)), atol=1e-10,
                                   rtol=1e-10, err_msg=f)


#: (transition, measurement, rule) -> (kernel, lanes) the wrapper picks
ROUTES = [
    (("ct", "radar", "ukf"), ("vector_filter_general", vf._SHAPED)),
    (("ct", "radar", "ckf"), ("vector_filter_general", vf._SHAPED)),
    (("ct", "b2", "ckf"), ("vector_filter_general", vf._SHAPED)),
    (("ct", "b3", "ckf"), ("vector_filter_general", vf._SHAPED)),
    (("falling_body", "b4", "ckf"), ("vector_filter_general", vf._SHAPED)),
    (("ct", "b1", "ukf"), ("vector_filter_general", 0)),              # a pair it does not hold
    (("ct", "radar", "gpq"), ("vector_filter_general", 0)),           # BQ on a table pair
    (("ct", "radar", "ukf/ckf"), ("vector_filter_general", vf._SHAPED)),  # mixed counts
    (("pendulum", "radar", "gh3"), ("vector_filter_general", vf._SHAPED)),  # 9 points
    (("ct", "radar", "gh3"), ("vector_filter_general", vf._WARP)),
    (("pendulum", "sine", "ukf"), ("vector_filter_shaped", 0)),       # the shaped kernel's pair
    (("driven", "mix", "ukf"), ("vector_filter_registered", vf._SHAPED)),
    (("driven", "mix", "gpq"), ("vector_filter_registered", vf._SHAPED)),
    (("pend_copy", "radar", "ukf"), ("vector_filter_registered", vf._SHAPED)),
    (("driven", "mix", "gh3"), ("vector_filter_registered", vf._SHAPED)),
    (("driven", "mix", "ukf/ckf"), ("vector_filter_registered", vf._SHAPED)),
]


@pytest.mark.parametrize("case,want", ROUTES, ids=["-".join(c) for c, _ in ROUTES])
def test_lanes_of_routes_the_shaped_shapes(case, want):
    """The shaped one-thread form takes a general-kernel shape of at most 4
    outputs whose pair and classical rules at the UT or CKF counts (one on
    both, or the two mixed) or at the Gauss-Hermite count of at most 11
    points (GH-3 on a 2-D state) it instantiates, and a registered
    configuration at those counts (of either kind at the UT and CKF counts,
    mixed too); every other shape keeps its form (the general one-thread
    form for other pairs and BQ or mixed kinds on a table pair; the warp
    form above 242 points)."""
    _need_gxx()
    assert (vf.kernel_of(_params(*case)), vf.lanes_of(_params(*case))) == want


def test_the_routing_asks_the_headers_instantiation_list():
    """``lanes_of`` asks the header (``vgs_takes_on``) which table pairs the
    shaped form holds: every (transition, measurement) of the table up to 4
    outputs under the UKF takes the form exactly where ``VGS_PAIRS`` lists
    it (or the pair is one of the shaped kernels')."""
    _need_gxx()
    src = open(f"{vf._build.CSRC}/vector_filter_general_shaped.cuh").read()
    body = src.split("#define VGS_PAIRS(X, F)")[1].split("\n\n")[0]
    ids = {**{f"VF_DYN_{k}": v for k, v in (("REENTRY", 0), ("CV", 1), ("PENDULUM", 2),
                                              ("REENTRY1D", 3), ("CT", 4))},
           **{f"VF_OBS_{k}": v for k, v in (("RADAR", 0), ("PENDULUM_SIN", 1), ("RANGE", 2),
                                              ("BEARING", 3), ("UNGM", 4))}}
    listed = {(int(D), int(E), ids[d], ids[o]) for D, E, d, o in
              re.findall(r"X\(F, (\d), (\d), (\w+), (\w+)\)", body)}
    assert len(listed) == 12
    taken = set()
    for dyn in ("reentry", "cv", "pendulum", "falling_body", "ct"):
        for obs in ("sine", "range", "ungm", "radar", "b1", "b2", "b3", "b4"):
            p = _params(dyn, obs, "ukf")
            if vf.kernel_of(p) == "vector_filter_general" and vf.lanes_of(p) == vf._SHAPED:
                taken.add((p.dim_state, p.dim_out, p.dyn_model, p.obs_model))
    assert taken == listed


def test_shaped_params_mirror_the_header():
    """The ctypes mirror of ``VgsParams`` has the header's fields and the
    size its ``static_assert`` states; the rules, R and a registered form's
    constants stand in it by value."""
    src = open(f"{vf._build.CSRC}/vector_filter_general_shaped.cuh").read()
    body = src.split("struct VgsParams {")[1].split("};")[0]
    for name, _ in vf._CGShapedParams._fields_:
        assert f" {name};" in body or f" {name}[" in body, name
    assert ctypes.sizeof(vf._CGShapedParams) == 6480 and "sizeof(VgsParams) == 6480" in src
    p = _params("driven", "mix", "ukf")
    c = vf._c_general_shaped(p, torch.device("cpu"))
    assert list(c.dyn_c[:2]) == list(p.dyn_form.consts) and list(c.obs_c[:2]) == [0.5, 0.2]
    assert [c.base.r[0], c.base.r[1], c.base.r[8], c.base.r[9]] == [0.05, 0.0, 0.0, 0.05]
    assert list(c.dyn.c.wm[:5]) == p.dyn.wm.tolist() and c.dyn.c.xi[1] == p.dyn.xi[0, 1]


def test_registered_shaped_policy_states_its_shape():
    """A registered configuration's shaped policy states both point counts
    (ND, NO), the kinds and the models' costs (calls of transcendentals and
    divisions: the driven pendulum's sine; the table radar's
    ``vgs_obs_cost``), reads its
    constants from the parameters by value and is listed in ``VFR_SHAPED``,
    not ``VFR_PAIRS``; a form with more constants than the parameters hold
    keeps the general one-thread form."""
    p = _params("pend_copy", "radar", "gpq")
    key = vf._key(p)
    assert key[:3] == (2, 2, vf._SHAPED)
    text = vf._registered_header([key])
    assert "static constexpr int ND = 5, NO = 5, KD = 1, KO = 1;" in text
    assert "dyn_cost = 1, obs_cost = vgs_obs_cost(0, 2);" in text
    assert "VgsObsFn<2, 0, 2> obs(const VgsParams& p)" in text and "{ return {p.dyn_c, s}; }" in text
    assert "#define VFR_PAIRS(F) \n" in text and "#define VFR_SHAPED(F) F(0, 2, 2, VfrPair0)" in text
    many = vf.VectorFilterParams(**{**{f: getattr(p, f) for f in (
        "dyn", "obs", "dyn_model", "obs_model", "dim_state", "dim_out", "dyn_c", "obs_c",
        "obs_idx", "m0", "P0", "gqg", "r", "obs_form", "obs_index", "n_s", "streams")},
        "dyn_form": KernelForm(p.dyn_form.source, tuple(range(vf._VGS_MAX_C + 1)),
                               p.dyn_form.plain)})
    assert vf.lanes_of(many) == 0
    with pytest.raises(ValueError, match="holds up to 32 constants"):
        vf._c_general_shaped(many, torch.device("cpu"))


def test_shaped_form_needs_no_scratch_buffer():
    """The shaped form keeps its values on chip: its launches take an empty
    scratch buffer, where the general one-thread form's holds every point's
    function values."""
    params = _params("ct", "b3", "ckf")
    assert vf._scratch(params, 3, "cpu", vf._SHAPED).numel() == 0
    assert vf._scratch(params, 3, "cpu").numel() == 3 * max(10 * 5, 10 * 3)
