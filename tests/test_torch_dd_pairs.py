"""``engine="dd"`` on every model pair and 1-D rule of the JAX package's dd
registry: the general vector filter kernel (``csrc/vector_filter_general.cu``)
and the general form of the scalar filter kernel
(``csrc/scalar_filter_step_general.cuh``).

- Admission parity: over the product of the registry's transitions (reentry,
  constant velocity, the pendulum, the falling body, the coordinated turn;
  UNGM on a 1-D state) and measurements (the sine, the range, UNGM on a state
  component, the radar, bearings from 1, 2, 3, 4, 6, 8 and 9 sensors) under
  the UKF, and CKF, GH-3 and GPQ rules on a few of them, and the 1-D GH-9,
  GH-15, GH-31 and GPQ/BSQ-GH9 rules, ``ops.dd_check`` admits what
  ``ssmtoybox_tpu.ops.ddvec.dd_supports`` admits (bearings from 9 sensors
  included: the general kernel's wide form); an admitted configuration runs
  through ``engine="dd"`` in the kernel :func:`vector_filter.kernel_of` /
  :func:`scalar_filter.form_of` names: the five pairs of the first version
  and the shaped kernels keep them, every other pair goes to the general
  kernel, and a 1-D configuration leaves the shaped scalar form only for the
  sine or range measurement or more than 8 points.
- Against the JAX package's float64 filter: CT + radar (UKF), CT + 3 bearings
  (CKF) and UNGM under GH-15, all five moment streams at 1e-10 (classical
  rules) and 1e-8 (BQ), the tolerances of ``tests/test_torch_vector_filter.py``.
- Against the port's eager float64 filter (itself held to the JAX package):
  the other representative pairs and rules at the same tolerances.
- Host builds: the general vector step (``vector_filter_general.cuh``,
  through ``vector_filter_host.cpp``) and the general scalar step (through
  ``scalar_filter_host.cpp``), compiled with g++, equal their plain versions
  to the bit when both take the C library's transcendentals.

Measurements come from a numpy seed: 4 trajectories of 20 steps simulated
through the port's model functions with numpy noise; the same arrays go to
the JAX package.
"""
import math
import shutil
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ssmtoybox_tpu as st
from ssmtoybox_tpu import ssmod as jssmod
from ssmtoybox_tpu.ops.ddvec import dd_supports
from ssmtoybox_tpu.utils import GaussRV as JGaussRV
import ssmtoybox_torch as stt
from ssmtoybox_torch import set_device, ssmod
from ssmtoybox_torch.ops import dd_check, scalar_filter as sf, vector_filter as vf
from ssmtoybox_torch.utils import GaussRV


@pytest.fixture(autouse=True, scope="module")
def _port_on_cpu():
    """The port runs on the card unless told otherwise; these tests run it
    on the CPU, on one intra-op thread (the suite runs several workers at
    once)."""
    set_device("cpu")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    set_device(None)


def _libm(fn):
    def apply(*ts):
        flat = [t.reshape(-1).tolist() for t in ts]
        out = torch.tensor([fn(*v) for v in zip(*flat)], dtype=torch.float64)
        return out.reshape(ts[0].shape)
    return apply


#: the C library's transcendentals, one value at a time: what a g++ build of
#: the step headers calls (PyTorch's vectorised CPU versions may be an ulp off)
LIBM_FNS = SimpleNamespace(
    sqrt=_libm(lambda v: math.sqrt(v) if v >= 0.0 or v != v else math.nan),
    exp=_libm(lambda v: math.exp(v) if v < 709.0 or v != v else math.inf),
    sin=_libm(math.sin), cos=_libm(math.cos), atan2=_libm(math.atan2))

FIELDS = ("fi_mean", "fi_cov", "pr_mean", "pr_cov", "pr_xx_cov")
B, T = 4, 20

#: nine sensors: the four of ``tests/test_ddvec.py:280-289`` and five more
SENSORS = np.array([[0.0, 0.0], [200.0, 0.0], [0.0, 200.0], [200.0, 200.0], [100.0, 0.0],
                    [0.0, 100.0], [200.0, 100.0], [100.0, 200.0], [300.0, 300.0]])
CT_M0, CT_P0 = np.array([100.0, 10.0, 100.0, 5.0, 0.06]), np.diag([10.0, 1.0, 10.0, 1.0, 1e-3])
PEND_DT = 0.01
PEND_Q = 0.1 * np.array([[PEND_DT ** 3 / 3, PEND_DT ** 2 / 2], [PEND_DT ** 2 / 2, PEND_DT]])

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
        rv(2, np.array([1.5, 0.0]), 0.01 * np.eye(2)), rv(2, None, PEND_Q), dt=PEND_DT)),
    "falling_body": (3, lambda new, rv: new("ReentryVehicle1DTransition")(
        rv(3, np.array([90.0, 6.0, 1.5]), 0.09 * np.eye(3)), rv(3, None, 1e-8 * np.eye(3)),
        dt=0.1)),
    "ct": (5, lambda new, rv: new("CoordinatedTurnTransition")(
        rv(5, CT_M0, CT_P0), rv(5, None, np.diag([0.1, 0.1, 0.1, 0.1, 1e-5])), dt=0.1)),
    "ungm": (1, lambda new, rv: new("UNGMTransition")(rv(1, None, 5.0 * np.eye(1)),
                                                      rv(1, None, 10.0 * np.eye(1)))),
}


def _pos(D):
    """The state components a planar measurement reads."""
    return [0, 2] if D >= 4 else [0, 1]


def _bearings(S):
    return lambda new, rv, D: new("BearingMeasurement")(
        rv(S, None, 1e-3 * np.eye(S)), dim_state=D, state_index=_pos(D), sensor_pos=SENSORS[:S])


#: measurement -> maker(new, rv, D)
OBS = {
    "sine": lambda new, rv, D: new("Pendulum2DMeasurement")(rv(1, None, 0.1 * np.eye(1)),
                                                            dim_state=D),
    "range": lambda new, rv, D: new("RangeMeasurement")(rv(1, None, 0.03 * np.eye(1)),
                                                        dim_state=D),
    "ungm": lambda new, rv, D: new("UNGMMeasurement")(rv(1, None, 1.0 * np.eye(1)), dim_state=D,
                                                      state_index=[0] if D > 1 else None),
    "radar": lambda new, rv, D: new("Radar2DMeasurement")(
        rv(2, None, np.diag([1.0, 1e-4])), dim_state=D, state_index=_pos(D),
        radar_loc=np.array([-5.0, -5.0])),
    **{f"b{S}": _bearings(S) for S in (1, 2, 3, 4, 6, 8, 9)},
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


def _mul(D, deg):
    """The multi-index of a BSQ rule: total degree up to 2 on D > 1 states,
    the monomials x^0 .. x^(deg-1) on one."""
    if D == 1:
        return np.atleast_2d(np.arange(deg))
    return np.hstack((np.zeros((D, 1), int), np.eye(D, dtype=int), 2 * np.eye(D, dtype=int)))


#: rule -> (maker in the port, maker in the JAX package), each of (dyn, obs, D)
RULES = {
    "ukf": (lambda d, o, D: stt.UnscentedKalman(d, o), lambda d, o, D: st.UnscentedKalman(d, o)),
    "ckf": (lambda d, o, D: stt.CubatureKalman(d, o), lambda d, o, D: st.CubatureKalman(d, o)),
    "gh3": (lambda d, o, D: stt.GaussHermiteKalman(d, o, deg=3),
            lambda d, o, D: st.GaussHermiteKalman(d, o, deg=3)),
    "gh9": (lambda d, o, D: stt.GaussHermiteKalman(d, o, deg=9),
            lambda d, o, D: st.GaussHermiteKalman(d, o, deg=9)),
    "gh15": (lambda d, o, D: stt.GaussHermiteKalman(d, o, deg=15),
             lambda d, o, D: st.GaussHermiteKalman(d, o, deg=15)),
    "gh31": (lambda d, o, D: stt.GaussHermiteKalman(d, o, deg=31),
             lambda d, o, D: st.GaussHermiteKalman(d, o, deg=31)),
    "gpq": (lambda d, o, D: stt.GaussianProcessKalman(d, o, _kpar(D), _kpar(D)),
            lambda d, o, D: st.GaussianProcessKalman(d, o, _kpar(D), _kpar(D), points="ut")),
    "gpq_gh9": (lambda d, o, D: stt.GaussianProcessKalman(d, o, _kpar(D), _kpar(D), points="gh",
                                                          point_hyp={"degree": 9}),
                lambda d, o, D: st.GaussianProcessKalman(d, o, _kpar(D), _kpar(D), points="gh",
                                                         point_hyp={"degree": 9})),
    "bsq_gh9": (lambda d, o, D: stt.BayesSardKalman(d, o, _kpar(D), _kpar(D),
                                                    mulind_dyn=_mul(D, 9), mulind_obs=_mul(D, 9),
                                                    points="gh", point_hyp={"degree": 9}),
                lambda d, o, D: st.BayesSardKalman(d, o, _kpar(D), _kpar(D),
                                                   mulind_dyn=_mul(D, 9), mulind_obs=_mul(D, 9),
                                                   points="gh", point_hyp={"degree": 9})),
    "bsq": (lambda d, o, D: stt.BayesSardKalman(d, o, _kpar(D), _kpar(D), _mul(D, 3),
                                                _mul(D, 3)),
            lambda d, o, D: st.BayesSardKalman(d, o, _kpar(D), _kpar(D), mulind_dyn=_mul(D, 3),
                                               mulind_obs=_mul(D, 3), points="ut")),
}

#: the product of the registry under the UKF: 5 transitions x 11 measurements,
#: and UNGM with its three 1-D measurements
PAIRS = ([(d, o, "ukf") for d in ("reentry", "cv", "pendulum", "falling_body", "ct")
          for o in OBS] + [("ungm", o, "ukf") for o in ("sine", "range", "ungm")])
#: other rules on a few pairs, and the 1-D rules the shaped scalar form does not take
OTHER_RULES = [("ct", "radar", "ckf"), ("ct", "radar", "gh3"), ("ct", "b3", "gpq"),
               ("pendulum", "ungm", "gh3"), ("pendulum", "b2", "gpq"),
               ("falling_body", "sine", "ckf"), ("cv", "b6", "gpq"), ("ungm", "ungm", "gh9"), ("ungm", "ungm", "gh15"),
               ("ungm", "ungm", "gh31"), ("ungm", "ungm", "gpq_gh9"), ("ungm", "ungm", "bsq_gh9"),
               ("ungm", "range", "gh15"), ("ungm", "sine", "gpq_gh9")]


def _case_id(case):
    return "-".join(case)


def _filter(case, jax_side=False):
    dyn, obs, rule = case
    d, o = _system(dyn, obs, jax_side)
    return RULES[rule][1 if jax_side else 0](d, o, DYNS[dyn][0])


#: the five pairs of the first version and the shaped kernels
INSTANTIATED = {("reentry", "radar"), ("cv", "radar"), ("pendulum", "sine"),
                ("falling_body", "range"), ("ct", "b4")}


@pytest.mark.parametrize("case", PAIRS + OTHER_RULES, ids=_case_id)
def test_admission_matches_jax_dd_supports(case):
    """``ops.dd_check`` admits what ``dd_supports`` admits (bearings from 9
    sensors included, in the general kernel); an admitted configuration runs
    through ``engine="dd"`` on the kernel that the routing names."""
    alg, jalg = _filter(case), _filter(case, jax_side=True)
    assert dd_supports(jalg.mod_dyn, jalg.mod_obs, jalg.tf_dyn, jalg.tf_obs)
    dyn, obs, rule = case
    E = alg.mod_obs.dim_out
    ys = torch.zeros((1, E, 2), dtype=torch.float64)
    dd_check(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    res = alg.forward_pass_batch(ys, engine="dd")
    D = DYNS[dyn][0]
    assert tuple(res.fi_cov.shape) == (1, D, D, 2)
    if D == 1:
        params = sf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
        shaped = obs == "ungm" and params.dyn.n <= sf.MAX_PTS
        assert sf.form_of(params) == ("shaped" if shaped else "general")
        return
    params = vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    kernel = vf.kernel_of(params)
    assert (kernel == "vector_filter_general") == ((dyn, obs) not in INSTANTIATED), kernel


def _simulate(dyn, obs, seed=0):
    """(B, E, T) measurements simulated with numpy noise through the port's
    model functions (truth from step 0, measurement k of the state at step
    k)."""
    d, o = _system(dyn, obs)
    rng = np.random.default_rng(seed)
    m0, P0 = (t.numpy() for t in d.init_rv.get_stats()[:2])
    Q, R = d.noise_rv.get_stats()[1].numpy(), o.noise_rv.get_stats()[1].numpy()
    D = DYNS[dyn][0]
    x = torch.as_tensor(rng.multivariate_normal(np.ravel(m0), np.reshape(P0, (D, D)), size=B))
    ys = []
    for k in range(T):
        q = rng.multivariate_normal(np.zeros(len(Q)), np.atleast_2d(Q), size=B)
        x = d.dyn_fcn(x, torch.as_tensor(q), k)
        r = torch.as_tensor(rng.multivariate_normal(np.zeros(len(R)), np.atleast_2d(R), size=B))
        ys.append(o.meas_fcn(o._select(x), r, k + 1))
    return torch.stack(ys, dim=-1)


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol, err_msg=what)


def _tol(rule):
    return 1e-8 if rule.startswith(("gpq", "bsq")) else 1e-10


@pytest.mark.parametrize("case", [("ct", "radar", "ukf"), ("ct", "b3", "ckf"),
                                  ("ungm", "ungm", "gh15")], ids=_case_id)
def test_new_paths_match_jax_f64(case):
    """The plain versions of both general kernels (what ``engine="dd"`` runs
    on the CPU) against the JAX package's float64 filter on the same
    measurements, all five streams."""
    ys = _simulate(case[0], case[1])
    jalg = _filter(case, jax_side=True)
    ref = jax.jit(lambda b: st.gaussian_filter_batch(jalg.mod_dyn, jalg.mod_obs, jalg.tf_dyn,
                                                     jalg.tf_obs, b))(jnp.asarray(ys.numpy()))
    res = _filter(case).forward_pass_batch(ys, engine="dd")
    for f in FIELDS:
        assert bool(torch.isfinite(getattr(res, f)).all()), f
        _close(getattr(res, f).numpy(), np.asarray(getattr(ref, f)), _tol(case[2]), f)


#: representative new configurations of both general kernels
EAGER_CASES = [("ct", "b2", "ckf"), ("ct", "b8", "ckf"), ("ct", "b1", "ukf"),
               ("ct", "radar", "gpq"), ("cv", "b6", "ukf"), ("cv", "ungm", "ukf"),
               ("pendulum", "radar", "gh3"), ("pendulum", "ungm", "ukf"),
               ("falling_body", "sine", "bsq"), ("reentry", "range", "ckf"),
               ("ungm", "ungm", "gh9"), ("ungm", "ungm", "gpq_gh9"), ("ungm", "ungm", "bsq_gh9"),
               ("ungm", "range", "ukf"), ("ungm", "sine", "gh15")]


@pytest.mark.parametrize("case", EAGER_CASES, ids=_case_id)
def test_new_paths_match_eager_f64(case):
    """``engine="dd"`` against ``engine="f64"`` on the same measurements: all
    five streams and the RTS smoother of both, at 1e-10 (classical) and 1e-8
    (BQ).  The sine of a UNGM state is taken over the first 8 steps: the
    two summation orders differ by ~2e-15 at step 1 there and the UNGM map
    under that measurement grows it tenfold every one or two steps (3.6e-7
    at step 20 under GH-15, 7e-5 under the UKF, in both directions), while
    the range of the same state stays within 2e-14 over all 20."""
    alg, ys = _filter(case), _simulate(case[0], case[1])
    if case[:2] == ("ungm", "sine"):
        ys = ys[..., :8]
    fused, eager = alg.forward_pass_batch(ys, engine="dd"), alg.forward_pass_batch(ys)
    tol = _tol(case[2])
    for f in FIELDS:
        assert bool(torch.isfinite(getattr(eager, f)).all()), f
        _close(getattr(fused, f), getattr(eager, f), tol, f)
    for a, b, what in zip(stt.gaussian_smoother(fused), stt.gaussian_smoother(eager),
                          ("smoothed mean", "smoothed cov")):
        _close(a, b, tol, what)


#: configurations of the general vector step's host build: every bound on E
#: (2, 4, 8) and every state dimension, both kinds
HOST_VECTOR = [("ct", "radar", "ukf"), ("ct", "b3", "ckf"), ("ct", "b8", "gpq"),
               ("reentry", "b2", "ckf"), ("cv", "ungm", "gpq"), ("cv", "b6", "ukf"),
               ("pendulum", "b1", "gh3"), ("pendulum", "range", "bsq"),
               ("falling_body", "radar", "ukf"), ("falling_body", "b4", "ckf")]


@pytest.mark.parametrize("case", HOST_VECTOR, ids=_case_id)
def test_general_vector_step_on_host_matches_plain(case):
    """``csrc/vector_filter_general.cuh``'s one-thread step built with g++ ==
    the plain version with the C library's transcendentals, to the bit, all
    five streams; measurements read through their strides.  (Above 4 outputs
    the kernel runs the lane-group form, ``tests/test_torch_dd_lanes.py``;
    the one-thread form keeps the shapes whose arrays do not fit in shared
    memory.)"""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the step header cannot be built for the host")
    alg, ys = _filter(case), _simulate(case[0], case[1], seed=1)
    params = vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    assert vf.kernel_of(params) == "vector_filter_general"
    want = vf._vector_filter_plain(params, ys, LIBM_FNS)
    time_major = ys.permute(2, 1, 0).contiguous().permute(2, 1, 0)
    for y in (ys, time_major):
        for a, b in zip(vf._host_shim_run(params, y, lanes=0), want):
            assert bool(torch.isfinite(b).all())
            assert torch.equal(a, b), f"max |diff| {float((a - b).abs().max()):.3e}"


#: configurations of the general scalar form's host build
HOST_SCALAR = [("ungm", "ungm", "gh9"), ("ungm", "ungm", "gh31"), ("ungm", "ungm", "gpq_gh9"),
               ("ungm", "ungm", "bsq_gh9"), ("ungm", "range", "ukf"), ("ungm", "sine", "gh15"),
               ("ungm", "sine", "gpq")]


@pytest.mark.parametrize("case", HOST_SCALAR, ids=_case_id)
def test_general_scalar_step_on_host_matches_plain(case):
    """``csrc/scalar_filter_step_general.cuh`` built with g++ == the plain
    version with the C library's square root and sine, to the bit, all five
    streams; measurements read through their strides."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the step header cannot be built for the host")
    alg, ys = _filter(case), _simulate(case[0], case[1], seed=2)
    params = sf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    assert sf.form_of(params) == "general"
    y, c = ys[:, 0, :].T.contiguous(), torch.as_tensor(sf.ungm_consts(T))
    want = sf._scalar_filter_plain(params, y, c, sqrt=LIBM_FNS.sqrt, sin=LIBM_FNS.sin)
    for yy in (y, ys[:, 0, :].contiguous().T):
        for a, b in zip(sf._host_shim_run(params, yy, c), want):
            assert bool(torch.isfinite(b).all())
            assert torch.equal(a, b), f"max |diff| {float((a - b).abs().max()):.3e}"


def test_wrappers_on_cpu_run_the_plain_versions_and_count_no_launch():
    """On CPU tensors both wrappers run their plain versions for the new
    forms, and no launch is counted."""
    before = (sf.LAUNCHES, sf.GENERAL_LAUNCHES, vf.LAUNCHES, vf.GENERAL_LAUNCHES)
    alg, ys = _filter(("ct", "b3", "ckf")), _simulate("ct", "b3")
    params = vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    for a, b in zip(vf.vector_filter(params, ys), vf._vector_filter_plain(params, ys)):
        assert torch.equal(a, b)
    alg = _filter(("ungm", "ungm", "gh15"))
    params = sf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    y, c = torch.ones((T, B), dtype=torch.float64), torch.as_tensor(sf.ungm_consts(T))
    for a, b in zip(sf.scalar_filter(params, y, c), sf._scalar_filter_plain(params, y, c)):
        assert torch.equal(a, b)
    assert (sf.LAUNCHES, sf.GENERAL_LAUNCHES, vf.LAUNCHES, vf.GENERAL_LAUNCHES) == before


def test_general_parameter_structs_match_the_headers():
    """The ctypes mirrors of ``SfgRule`` / ``SfgParams`` and of ``VfParams``
    have the headers' fields and the sizes their ``static_assert`` states;
    the measurement ids agree."""
    import ctypes
    src = open(sf._build.CSRC + "/scalar_filter_step_general.cuh").read()
    for struct, mirror in (("SfgRule", sf._CGRule), ("SfgParams", sf._CGParams)):
        body = src.split(f"struct {struct} {{")[1].split("};")[0]
        for name, _ in mirror._fields_:
            assert f" {name};" in body or f" {name}[" in body, (struct, name)
    assert ctypes.sizeof(sf._CGRule) == 56 and ctypes.sizeof(sf._CGParams) == 168
    assert "sizeof(SfgRule) == 56 && sizeof(SfgParams) == 168" in src
    tokens = {"UNGMMeasurement": "UNGM", "Pendulum2DMeasurement": "SIN",
              "RangeMeasurement": "RANGE"}
    for cls, (model_id, _) in sf._OBS_MODELS.items():
        assert f"#define SF_OBS_{tokens[cls.__name__]} {model_id}" in src
    step = open(vf._build.CSRC + "/vector_filter_step.cuh").read()
    assert ctypes.sizeof(vf._CParams) == 1904
    assert "sizeof(VfRule) == 56 && sizeof(VfParams) == 1904" in step
    assert f"#define VF_OBS_UNGM {vf._OBS_MODELS[ssmod.UNGMMeasurement][0]}" in step
    assert "vector_filter_general.cu" in vf.SOURCES
