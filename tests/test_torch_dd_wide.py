"""Bearings from more than 8 sensors through ``engine="dd"``: the wide form of
the general vector filter kernel (``vfg_step_wide`` in
``csrc/vector_filter_general.cuh``), which keeps every E-sized array of a
trajectory in the scratch buffer and reads the sensors' positions and R from
device memory, so the measurement dimension E has no cap.  The JAX package's
dd engine takes any number of bearing sensors (``ops/ddvec.py``,
``_bearing_lower``); so does the port now.

- Admission: CT with 9, 12, 16 and 32 bearing sensors is admitted by
  ``ops.dd_check`` as by ``ddvec.dd_supports`` and runs in the general
  kernel.
- Against the JAX package's float64 filter: CT + 9, 12 and 16 bearings under
  the CKF and the UKF, and CT + 12 bearings under GPQ, all five moment
  streams at 1e-10 (classical) and 1e-8 (BQ), the tolerances of
  ``tests/test_torch_dd_pairs.py``.
- Host build: the wide step compiled with g++ (``vector_filter_host.cpp``)
  equals the plain version to the bit with the C library's transcendentals,
  at every state dimension of the table (the pendulum, the falling body,
  constant velocity, the coordinated turn), both rule kinds.

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
from ssmtoybox_torch.ops import dd_check, vector_filter as vf
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
#: the step header calls (PyTorch's vectorised CPU versions may be an ulp off)
LIBM_FNS = SimpleNamespace(
    sqrt=_libm(lambda v: math.sqrt(v) if v >= 0.0 or v != v else math.nan),
    exp=_libm(lambda v: math.exp(v) if v < 709.0 or v != v else math.inf),
    sin=_libm(math.sin), cos=_libm(math.cos), atan2=_libm(math.atan2))

FIELDS = ("fi_mean", "fi_cov", "pr_mean", "pr_cov", "pr_xx_cov")
B, T = 4, 20

#: 32 sensors on a circle of radius 150 about (100, 100), where the turning
#: target of ``CT_M0`` starts
SENSORS = np.array([[100.0 + 150.0 * math.cos(0.2 + 2 * math.pi * i / 32),
                     100.0 + 150.0 * math.sin(0.2 + 2 * math.pi * i / 32)] for i in range(32)])
CT_M0, CT_P0 = np.array([100.0, 10.0, 100.0, 5.0, 0.06]), np.diag([10.0, 1.0, 10.0, 1.0, 1e-3])
PEND_DT = 0.01
PEND_Q = 0.1 * np.array([[PEND_DT ** 3 / 3, PEND_DT ** 2 / 2], [PEND_DT ** 2 / 2, PEND_DT]])

#: transition -> maker(new, rv): the systems of ``tests/test_torch_dd_pairs.py``
DYNS = {
    "ct": lambda new, rv: new("CoordinatedTurnTransition")(
        rv(5, CT_M0, CT_P0), rv(5, None, np.diag([0.1, 0.1, 0.1, 0.1, 1e-5])), dt=0.1),
    "cv": lambda new, rv: new("ConstantVelocity")(
        rv(4, np.array([100.0, 10.0, 100.0, 5.0]), np.diag([10.0, 1.0, 10.0, 1.0])),
        rv(2, None, np.diag([0.5, 0.5])), dt=0.5),
    "pendulum": lambda new, rv: new("Pendulum2DTransition")(
        rv(2, np.array([1.5, 0.0]), 0.01 * np.eye(2)), rv(2, None, PEND_Q), dt=PEND_DT),
    "falling_body": lambda new, rv: new("ReentryVehicle1DTransition")(
        rv(3, np.array([90.0, 6.0, 1.5]), 0.09 * np.eye(3)), rv(3, None, 1e-8 * np.eye(3)),
        dt=0.1),
}


def _system(dyn, S, jax_side=False):
    """(transition, S bearings of its planar position) in the port or the JAX
    package."""
    if jax_side:
        new, rv = (lambda cls: getattr(jssmod, cls).create), (
            lambda d, m, c: JGaussRV.create(d, mean=m, cov=c))
    else:
        new, rv = (lambda cls: getattr(ssmod, cls)), (lambda d, m, c: GaussRV(d, mean=m, cov=c))
    d = DYNS[dyn](new, rv)
    D = d.dim_state
    o = new("BearingMeasurement")(rv(S, None, 1e-3 * np.eye(S)), dim_state=D,
                                  state_index=[0, 2] if D >= 4 else [0, 1],
                                  sensor_pos=SENSORS[:S])
    return d, o


def _kpar(D):
    return np.array([[1.0] + [3.0] * D])


#: rule -> (maker in the port, maker in the JAX package)
RULES = {
    "ukf": (lambda d, o: stt.UnscentedKalman(d, o), lambda d, o: st.UnscentedKalman(d, o)),
    "ckf": (lambda d, o: stt.CubatureKalman(d, o), lambda d, o: st.CubatureKalman(d, o)),
    "gh3": (lambda d, o: stt.GaussHermiteKalman(d, o, deg=3),
            lambda d, o: st.GaussHermiteKalman(d, o, deg=3)),
    "gpq": (lambda d, o: stt.GaussianProcessKalman(d, o, _kpar(d.dim_state), _kpar(d.dim_state)),
            lambda d, o: st.GaussianProcessKalman(d, o, _kpar(d.dim_state), _kpar(d.dim_state),
                                                  points="ut")),
}


def _filter(dyn, S, rule, jax_side=False):
    return RULES[rule][int(jax_side)](*_system(dyn, S, jax_side))


def _simulate(dyn, S, seed=0):
    """(B, S, T) measurements simulated with numpy noise through the port's
    model functions (truth from step 0, measurement k of the state at step
    k)."""
    d, o = _system(dyn, S)
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


@pytest.mark.parametrize("S", [9, 12, 16, 32])
def test_admission_of_many_sensors_matches_jax_dd_supports(S):
    """``ops.dd_check`` admits CT with S bearings as ``dd_supports`` does;
    the configuration runs in the general kernel, whose scratch holds the
    wide form's E-sized arrays."""
    alg, jalg = _filter("ct", S, "ckf"), _filter("ct", S, "ckf", jax_side=True)
    assert dd_supports(jalg.mod_dyn, jalg.mod_obs, jalg.tf_dyn, jalg.tf_obs)
    dd_check(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    assert vf.supports(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    params = vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    assert vf.kernel_of(params) == "vector_filter_general" and params.dim_out == S
    assert len(params.obs_c) == 2 * S and len(params.r) == S * S
    n, D = 10, 5
    assert vf._scratch(params, 3, "cpu").numel() == 3 * (
        max(n * D, n * S) + 2 * S + 2 * S * S + 4 * D * S)


WIDE_JAX = [(9, "ckf"), (9, "ukf"), (12, "ckf"), (12, "ukf"), (16, "ckf"), (16, "ukf"),
            (12, "gpq")]


@pytest.mark.parametrize("case", WIDE_JAX, ids=lambda c: f"ct-b{c[0]}-{c[1]}")
def test_wide_bearings_match_jax_f64(case):
    """The plain version of the wide form (what ``engine="dd"`` runs on the
    CPU) against the JAX package's float64 filter on the same measurements,
    all five streams, and the RTS smoother of ``engine="dd"`` against the
    port's eager filter's."""
    S, rule = case
    ys = _simulate("ct", S)
    jalg = _filter("ct", S, rule, jax_side=True)
    ref = jax.jit(lambda b: st.gaussian_filter_batch(jalg.mod_dyn, jalg.mod_obs, jalg.tf_dyn,
                                                     jalg.tf_obs, b))(jnp.asarray(ys.numpy()))
    alg = _filter("ct", S, rule)
    res = alg.forward_pass_batch(ys, engine="dd")
    tol = 1e-8 if rule == "gpq" else 1e-10
    for f in FIELDS:
        got = getattr(res, f)
        assert bool(torch.isfinite(got).all()), f
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(ref, f)), atol=tol, rtol=tol,
                                   err_msg=f)
    for a, b in zip(stt.gaussian_smoother(res), stt.gaussian_smoother(alg.forward_pass_batch(ys))):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=tol, rtol=tol)


#: the wide step at every state dimension of the table, both rule kinds
HOST_WIDE = [("ct", 9, "ckf"), ("ct", 16, "ukf"), ("ct", 12, "gpq"), ("cv", 12, "ukf"),
             ("cv", 10, "gpq"), ("pendulum", 9, "gh3"), ("falling_body", 11, "ckf")]


@pytest.mark.parametrize("case", HOST_WIDE, ids=lambda c: f"{c[0]}-b{c[1]}-{c[2]}")
def test_wide_step_on_host_matches_plain(case):
    """``vfg_step_wide`` built with g++ == the plain version with the C
    library's transcendentals, to the bit, all five streams; measurements
    read through their strides.  (The kernel runs these shapes in the
    lane-group form, ``tests/test_torch_dd_lanes.py``; the wide form keeps
    the shapes whose arrays do not fit in shared memory.)"""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the step header cannot be built for the host")
    alg, ys = _filter(*case), _simulate(case[0], case[1], seed=1)
    params = vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    assert vf.kernel_of(params) == "vector_filter_general" and params.dim_out > 8
    want = vf._vector_filter_plain(params, ys, LIBM_FNS)
    time_major = ys.permute(2, 1, 0).contiguous().permute(2, 1, 0)
    for y in (ys, time_major):
        for a, b in zip(vf._host_shim_run(params, y, lanes=0), want):
            assert bool(torch.isfinite(b).all())
            assert torch.equal(a, b), f"max |diff| {float((a - b).abs().max()):.3e}"
