"""The fused vector filter (``ssmtoybox_torch/ops/vector_filter.py``): the
port's ``engine="dd"`` for states of dimension 2-8.

On the CPU its wrapper runs the plain PyTorch version, which is held against:

- the JAX package's float64 ``gaussian_filter_batch`` on reentry + radar
  under the UKF and BSQ-UT rules, all five moment streams, at the
  tolerances of ``tests/test_parity.py`` (atol = rtol = 1e-8);
- the port's eager float64 filter under UKF, CKF, Gauss-Hermite of degree 3
  (243 points), GPQ-UT and BSQ-UT on reentry + radar and the UKF on
  constant velocity + radar, all five streams and the RTS smoother on both:
  classical rules at 1e-10, BQ rules at 1e-8 (the BQ covariance is the
  reference's uncentred quadratic form, sum f_i Wc_ij f_j - mu mu^T, over
  function values of ~6.4e3: any two summation orders differ by ~3e-9 in
  covariances of magnitude ~1);
- ``goldens/reentry.npz`` (``ukf``, ``bsqkf``) at ``test_parity.py``'s 1e-7 /
  1e-6;
- on the pendulum, the falling body with its range and the coordinated turn
  with four bearings (``tests/test_ddvec.py:262-289``): the JAX package's
  float64 filter at ``1e-9 x scale`` as ``test_ddvec.py:308-329`` holds its dd
  engine, and the port's eager filter as above.

Both CUDA step headers (the first version's and the shaped kernels'),
compiled for the host with g++, equal the plain version to the bit when
both take the C library's ``sqrt``, ``exp``, ``sin``, ``cos`` and
``atan2`` (``LIBM_FNS`` below): PyTorch's vectorised CPU versions
are an ulp off some of their values, which the BQ quadratic form grows to
~1e-7 of the covariance.  :func:`vector_filter.supports` gives the answers
of the JAX package's ``ddvec.dd_supports`` on a table of configurations
(``JAX_ONLY``, the configurations only the JAX package's dd engine runs, is
empty), and
:func:`vector_filter.kernel_of` sends the UT and CKF shapes to the shaped
kernels (classical rules to ``vector_filter_shaped``, the UKF beside the
CKF too, whose mixed counts ``tests/test_torch_dd_mixed_counts.py`` holds;
a BQ rule on either transform to ``vector_filter_shaped_bq``, whose host
build ``tests/test_torch_vector_filter_bq.py`` holds), Gauss-Hermite
rules of fewer points to the first version, and the model pairs those three do not
instantiate (CT + radar, CT + 3 bearings) to the general kernel, whose host
build ``tests/test_torch_dd_pairs.py`` holds on more pairs.

Measurements come from a numpy seed: 8 trajectories of 20 steps simulated
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
from ssmtoybox_tpu.ops.ddvec import dd_supports
from ssmtoybox_tpu.utils import GaussRV as JGaussRV
import ssmtoybox_torch as stt
from ssmtoybox_torch import set_device, ssmod
from ssmtoybox_torch.mtran import SigmaPointTransform
from ssmtoybox_torch.ops import vector_filter as vf
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


#: the C library's transcendentals through ``math``, one value at a time, for
#: the plain version's ``fns``: what a g++ build of the step header calls
LIBM_FNS = SimpleNamespace(
    sqrt=_libm(lambda v: math.sqrt(v) if v >= 0.0 or v != v else math.nan),
    exp=_libm(lambda v: math.exp(v) if v < 709.0 or v != v else math.inf),
    sin=_libm(math.sin), cos=_libm(math.cos), atan2=_libm(math.atan2))

FIELDS = ("fi_mean", "fi_cov", "pr_mean", "pr_cov", "pr_xx_cov")
STREAMS = ("m_fi", "P_fi", "m_pr", "P_pr", "xx")
B, T = 8, 20

#: reentry + radar (bench.py:109-115) and the CV radar system (goldens/cv_radar)
RE_M0 = np.array([6500.4, 349.14, -1.8093, -6.7967, 0.6932])
RE_P0 = np.diag([1e-6, 1e-6, 1e-6, 1e-6, 1.0])
RE_Q = np.diag([2.4064e-5, 2.4064e-5, 1e-6])
RE_R = np.diag([1e-3, 1e-5])
RADAR = np.array([6374.0, 0.0])
CV_M0 = np.array([10000.0, 300.0, 1000.0, -40.0])
CV_P0 = np.diag([100.0, 25.0, 100.0, 25.0])
CV_Q, CV_R = np.diag([50.0, 5.0]), np.diag([50.0, 0.4e-6])
#: kernel parameters: BSQ of the tracking study (bsq_tracking.py:62-63);
#: GPQ lengthscales long enough that the reentry filter stays positive definite
BSQ_DYN, BSQ_OBS = np.array([[1.0, 1, 1, 1, 1, 1]]), np.array([[1.0, 0.9, 0.9, 1e4, 1e4, 1e4]])
GPQ_DYN, GPQ_OBS = np.array([[1.0, 10, 10, 10, 10, 10]]), np.array([[1.0, 10, 10, 1e4, 1e4, 1e4]])
MUL_UT = np.hstack((np.zeros((5, 1), int), np.eye(5, dtype=int), 2 * np.eye(5, dtype=int)))


def _reentry():
    return (ssmod.ReentryVehicle2DTransition(GaussRV(5, mean=RE_M0, cov=RE_P0), GaussRV(3, cov=RE_Q),
                                             dt=0.05),
            ssmod.Radar2DMeasurement(GaussRV(2, cov=RE_R), dim_state=5, state_index=[0, 1],
                                     radar_loc=RADAR))


def _reentry_jax():
    return (jssmod.ReentryVehicle2DTransition.create(
                JGaussRV.create(5, mean=RE_M0, cov=RE_P0), JGaussRV.create(3, cov=RE_Q), dt=0.05),
            jssmod.Radar2DMeasurement.create(JGaussRV.create(2, cov=RE_R), dim_state=5,
                                             state_index=[0, 1], radar_loc=RADAR))


def _cv():
    return (ssmod.ConstantVelocity(GaussRV(4, mean=CV_M0, cov=CV_P0), GaussRV(2, cov=CV_Q), dt=0.5),
            ssmod.Radar2DMeasurement(GaussRV(2, cov=CV_R), dim_state=4, state_index=[0, 2]))


def _cv_jax():
    return (jssmod.ConstantVelocity.create(JGaussRV.create(4, mean=CV_M0, cov=CV_P0),
                                           JGaussRV.create(2, cov=CV_Q), dt=0.5),
            jssmod.Radar2DMeasurement.create(JGaussRV.create(2, cov=CV_R), dim_state=4,
                                             state_index=[0, 2]))


PEND_DT = 0.01
PEND_Q = 0.1 * np.array([[PEND_DT ** 3 / 3, PEND_DT ** 2 / 2], [PEND_DT ** 2 / 2, PEND_DT]])
CT_M0, CT_P0 = np.array([100.0, 10.0, 100.0, 5.0, 0.06]), np.diag([10.0, 1.0, 10.0, 1.0, 1e-3])
CT_Q = np.diag([0.1, 0.1, 0.1, 0.1, 1e-5])
SENSORS = np.array([[0.0, 0.0], [200.0, 0.0], [0.0, 200.0], [200.0, 200.0]])
GPQ_PEND = np.array([[1.0, 2.0, 2.0]])
GPQ_CT = np.array([[1.0, 3.0, 3.0, 3.0, 3.0, 3.0]])


class _Drift(ssmod.TransitionModel):
    """A transition of the user's own that no registry has a form of."""
    dim_state, dim_noise = 5, 5

    def dyn_fcn(self, x, q, time):
        return x + q


class _JDrift(jssmod.TransitionModel):
    """:class:`_Drift` in the JAX package."""
    dim_state, dim_noise = 5, 5

    def dyn_fcn(self, x, q, time):
        return x + q


def _zoo(pkg, rv):
    """The systems of ``tests/test_ddvec.py:262-289`` and three the fused
    engines refuse, in the port (``pkg`` its ``ssmod``, ``rv`` its
    ``GaussRV``) or the JAX package (``jssmod``, ``JGaussRV.create``)."""
    def new(cls):
        return getattr(pkg, cls) if pkg is ssmod else getattr(pkg, cls).create

    def ct():
        return new("CoordinatedTurnTransition")(rv(5, CT_M0, CT_P0), rv(5, None, CT_Q), dt=0.1)

    def bearings(n):
        return new("BearingMeasurement")(rv(n, None, 1e-3 * np.eye(n)), dim_state=5,
                                         state_index=[0, 2], sensor_pos=SENSORS[:n])

    return {
        "pendulum": lambda: (new("Pendulum2DTransition")(rv(2, np.array([1.5, 0.0]),
                                                            0.01 * np.eye(2)),
                                                         rv(2, None, PEND_Q), dt=PEND_DT),
                             new("Pendulum2DMeasurement")(rv(1, None, 0.1 * np.eye(1)),
                                                          dim_state=2)),
        "falling_body": lambda: (new("ReentryVehicle1DTransition")(
                                     rv(3, np.array([90.0, 6.0, 1.5]), 0.09 * np.eye(3)),
                                     rv(3, None, 1e-8 * np.eye(3)), dt=0.1),
                                 new("RangeMeasurement")(rv(1, None, 0.03 * np.eye(1)),
                                                         dim_state=3)),
        "ct_bearing": lambda: (ct(), bearings(4)),
        "ct_bearing3": lambda: (ct(), bearings(3)),
        "ct_bearing9": lambda: (ct(), new("BearingMeasurement")(
            rv(9, None, 1e-3 * np.eye(9)), dim_state=5, state_index=[0, 2],
            sensor_pos=np.vstack((SENSORS, SENSORS + 50.0, [[300.0, 300.0]])))),
        "ct_radar": lambda: (ct(), new("Radar2DMeasurement")(rv(2, None, np.diag([1.0, 1e-4])),
                                                             dim_state=5, state_index=[0, 2])),
        "ungm_na": lambda: (new("UNGMNATransition")(rv(1, np.ones(1), np.eye(1)),
                                                    rv(1, None, 10.0 * np.eye(1))),
                            new("UNGMNAMeasurement")(rv(1, None, 0.01 * np.eye(1)), dim_state=1)),
        "drift": lambda: ((_Drift if pkg is ssmod else _JDrift.create)(rv(5, CT_M0, CT_P0),
                                                                       rv(5, None, CT_Q)),
                          new("Radar2DMeasurement")(rv(2, None, np.diag([1.0, 1e-4])),
                                                    dim_state=5, state_index=[0, 2])),
        "ctrs": lambda: (new("ConstantTurnRateSpeed")(rv(5, np.array([10.0, 0.0, 5.0, 0.5, 0.1]),
                                                         0.1 * np.eye(5)),
                                                      rv(2, None, np.diag([0.1, 0.1 * np.pi])),
                                                      dt=0.05, compat_heading=True),
                         new("Radar2DMeasurement")(rv(2, None, np.diag([0.3, 0.03])), dim_state=5,
                                                   state_index=[0, 1])),
    }


ZOO = _zoo(ssmod, lambda d, m, c: GaussRV(d, mean=m, cov=c))
ZOO_JAX = _zoo(jssmod, lambda d, m, c: JGaussRV.create(d, mean=m, cov=c))


def _bsq_override(alg):
    """The EMV override of ``experiments/bsq_tracking.py:76-84``: a matrix."""
    alg.tf_dyn = alg.tf_dyn.replace(model_var=np.diag([2e-4] * 5))
    alg.tf_obs = alg.tf_obs.replace(model_var=np.zeros((2, 2)))
    return alg


def _bsq_override_jax(alg):
    alg.tf_dyn = alg.tf_dyn.replace(model_var=jnp.asarray(np.diag([2e-4] * 5)))
    alg.tf_obs = alg.tf_obs.replace(model_var=jnp.asarray(np.zeros((2, 2))))
    return alg


#: name -> (system, port filter, JAX filter, admitted by the fused engine)
CONFIGS = {
    "ukf": ("reentry", lambda d, o: stt.UnscentedKalman(d, o),
            lambda d, o: st.UnscentedKalman(d, o), True),
    "ckf": ("reentry", lambda d, o: stt.CubatureKalman(d, o),
            lambda d, o: st.CubatureKalman(d, o), True),
    "gh3": ("reentry", lambda d, o: stt.GaussHermiteKalman(d, o, deg=3),
            lambda d, o: st.GaussHermiteKalman(d, o, deg=3), True),
    "gpq_ut": ("reentry", lambda d, o: stt.GaussianProcessKalman(d, o, GPQ_DYN, GPQ_OBS),
               lambda d, o: st.GaussianProcessKalman(d, o, GPQ_DYN, GPQ_OBS, points="ut"), True),
    "bsq_ut": ("reentry", lambda d, o: stt.BayesSardKalman(d, o, BSQ_DYN, BSQ_OBS, MUL_UT, MUL_UT),
               lambda d, o: st.BayesSardKalman(d, o, BSQ_DYN, BSQ_OBS, mulind_dyn=MUL_UT,
                                               mulind_obs=MUL_UT, points="ut"), True),
    "cv_ukf": ("cv", lambda d, o: stt.UnscentedKalman(d, o),
               lambda d, o: st.UnscentedKalman(d, o), True),
    "cv_ckf": ("cv", lambda d, o: stt.CubatureKalman(d, o),
               lambda d, o: st.CubatureKalman(d, o), True),
    "tpq": ("reentry", lambda d, o: stt.StudentProcessKalman(d, o, GPQ_DYN, GPQ_OBS),
            lambda d, o: st.StudentProcessKalman(d, o, GPQ_DYN, GPQ_OBS, points="ut"), False),
    "bsq_matrix_emv": ("reentry", lambda d, o: _bsq_override(CONFIGS["bsq_ut"][1](d, o)),
                       lambda d, o: _bsq_override_jax(CONFIGS["bsq_ut"][2](d, o)), False),
    "pend_ukf": ("pendulum", lambda d, o: stt.UnscentedKalman(d, o),
                 lambda d, o: st.UnscentedKalman(d, o), True),
    "pend_gpq": ("pendulum", lambda d, o: stt.GaussianProcessKalman(d, o, GPQ_PEND, GPQ_PEND,
                                                                    points="sr"),
                 lambda d, o: st.GaussianProcessKalman(d, o, GPQ_PEND, GPQ_PEND, points="sr"),
                 True),
    "fall_ukf": ("falling_body", lambda d, o: stt.UnscentedKalman(d, o),
                 lambda d, o: st.UnscentedKalman(d, o), True),
    "ct_ckf": ("ct_bearing", lambda d, o: stt.CubatureKalman(d, o),
               lambda d, o: st.CubatureKalman(d, o), True),
    "ct_ukf": ("ct_bearing", lambda d, o: stt.UnscentedKalman(d, o),
               lambda d, o: st.UnscentedKalman(d, o), True),
    "ct_bearing3": ("ct_bearing3", lambda d, o: stt.CubatureKalman(d, o),
                    lambda d, o: st.CubatureKalman(d, o), True),
    "ct_radar": ("ct_radar", lambda d, o: stt.UnscentedKalman(d, o),
                 lambda d, o: st.UnscentedKalman(d, o), True),
    "ct_bearing9": ("ct_bearing9", lambda d, o: stt.CubatureKalman(d, o),
                    lambda d, o: st.CubatureKalman(d, o), True),
    "drift_ukf": ("drift", lambda d, o: stt.UnscentedKalman(d, o),
                  lambda d, o: st.UnscentedKalman(d, o), False),
    "ct_tpq": ("ct_radar", lambda d, o: stt.StudentProcessKalman(d, o, GPQ_CT, GPQ_CT),
               lambda d, o: st.StudentProcessKalman(d, o, GPQ_CT, GPQ_CT, points="ut"), False),
    "ungm_na": ("ungm_na", lambda d, o: stt.UnscentedKalman(d, o),
                lambda d, o: st.UnscentedKalman(d, o), False),
    "ctrs": ("ctrs", lambda d, o: stt.UnscentedKalman(d, o),
             lambda d, o: st.UnscentedKalman(d, o), False),
}
ADMITTED = sorted(k for k, v in CONFIGS.items() if v[3])
#: refused by the port's fused engine, run by the JAX package's dd engine: none
JAX_ONLY = set()
SYSTEMS = {"reentry": (_reentry, _reentry_jax), "cv": (_cv, _cv_jax),
           **{name: (ZOO[name], ZOO_JAX[name]) for name in ZOO}}


def _port(name):
    dyn, obs = SYSTEMS[CONFIGS[name][0]][0]()
    return CONFIGS[name][1](dyn, obs)


def _simulate(system, seed=0, batch=B):
    """(batch, E, T) measurements of ``batch`` trajectories simulated with
    numpy noise through the port's model functions (truth from step 0,
    measurement k of the state at step k)."""
    dyn, obs = SYSTEMS[system][0]()
    rng = np.random.default_rng(seed)
    m0, P0 = (t.numpy() for t in dyn.init_rv.get_stats()[:2])
    Q, R = dyn.noise_rv.get_stats()[1].numpy(), obs.noise_rv.get_stats()[1].numpy()
    x = torch.as_tensor(rng.multivariate_normal(m0, P0, size=batch))
    ys = []
    for k in range(T):
        x = dyn.dyn_fcn(x, torch.as_tensor(rng.multivariate_normal(np.zeros(len(Q)), Q,
                                                                   size=batch)), k)
        r = torch.as_tensor(rng.multivariate_normal(np.zeros(len(R)), R, size=batch))
        ys.append(obs.meas_fcn(obs._select(x), r, k + 1))
    return torch.stack(ys, dim=-1)


@pytest.fixture(scope="module")
def data():
    return {s: _simulate(s) for s in SYSTEMS}


@pytest.fixture(scope="module")
def jax_results(data):
    """The JAX package's float64 filter, one call a configuration."""
    out = {}
    for name in ("ukf", "bsq_ut"):
        dyn, obs = _reentry_jax()
        alg = CONFIGS[name][2](dyn, obs)
        out[name] = st.gaussian_filter_batch(dyn, obs, alg.tf_dyn, alg.tf_obs,
                                             jnp.asarray(data["reentry"].numpy()))
    return out


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=tol, err_msg=what)


@pytest.mark.parametrize("name", ["ukf", "bsq_ut"])
def test_plain_matches_jax_f64(data, jax_results, name):
    res = _port(name).forward_pass_batch(data["reentry"], engine="dd")
    for f in FIELDS:
        _close(getattr(res, f).numpy(), getattr(jax_results[name], f), 1e-8, f)


@pytest.mark.parametrize("name", ["pend_ukf", "fall_ukf", "ct_ckf"])
def test_new_pairs_plain_matches_jax_f64(data, name):
    """The plain version on the three new model pairs against the JAX
    package's float64 filter, means and covariances at ``1e-9 x scale``
    (``test_ddvec.py:308-329``'s tolerance for its dd engine)."""
    system, _, make_jax, _ = CONFIGS[name]
    jdyn, jobs = SYSTEMS[system][1]()
    jalg = make_jax(jdyn, jobs)
    ref = jax.jit(lambda b: st.gaussian_filter_batch(jdyn, jobs, jalg.tf_dyn, jalg.tf_obs, b))(
        jnp.asarray(data[system].numpy()))
    res = _port(name).forward_pass_batch(data[system], engine="dd")
    scale = float(np.max(np.abs(np.asarray(ref.fi_mean)))) + 1.0
    for f in ("fi_mean", "fi_cov"):
        np.testing.assert_allclose(getattr(res, f).numpy(), np.asarray(getattr(ref, f)), rtol=0,
                                   atol=1e-9 * scale, err_msg=f)


@pytest.mark.parametrize("name", ADMITTED)
def test_plain_matches_eager_f64(data, name):
    """Every stream and the RTS smoother of both at 1e-10 (classical) and 1e-8
    (BQ; module docstring)."""
    alg = _port(name)
    ys = data[CONFIGS[name][0]]
    fused, eager = alg.forward_pass_batch(ys, engine="dd"), alg.forward_pass_batch(ys)
    tol = 1e-8 if name.startswith(("gpq", "bsq")) else 1e-10
    for f in FIELDS:
        assert bool(torch.isfinite(getattr(eager, f)).all()), f
        _close(getattr(fused, f), getattr(eager, f), tol, f)
    for a, b, what in zip(stt.gaussian_smoother(fused), stt.gaussian_smoother(eager),
                          ("smoothed mean", "smoothed cov")):
        _close(a, b, tol, what)


@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("name", ADMITTED)
def test_step_header_on_host_matches_plain(data, name, batch):
    """``csrc/vector_filter_step.cuh`` built with g++ == the plain version with
    the C library's transcendentals, to the bit, at the instantiation of the
    configuration; measurements read through their strides."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the step header cannot be built for the host")
    alg = _port(name)
    params = vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    ys = data[CONFIGS[name][0]][:batch]
    time_major = ys.permute(2, 1, 0).contiguous().permute(2, 1, 0)    # strides (1, B, 2 B)
    want = vf._vector_filter_plain(params, ys, LIBM_FNS)
    for y in (ys, time_major):
        for s, a, b in zip(STREAMS, vf._host_shim_run(params, y), want):
            assert bool(torch.isfinite(b).all()), s
            assert torch.equal(a, b), f"{s}: {float((a - b).abs().max()):.3e}"


@pytest.fixture(scope="module")
def data33():
    return {s: _simulate(s, seed=1, batch=33) for s in SYSTEMS}


@pytest.mark.parametrize("batch", [1, 7, 33])
@pytest.mark.parametrize("name", ["ukf", "ckf", "cv_ukf", "cv_ckf", "pend_ukf", "fall_ukf",
                                  "ct_ckf", "ct_ukf"])
def test_shaped_header_on_host_matches_plain(data33, name, batch):
    """``csrc/vector_filter_shaped.cuh`` built with g++ == the plain version
    with the C library's transcendentals, to the bit, all five streams, at
    the UT and CKF shapes of every model pair; measurements read through
    their strides."""
    if shutil.which("g++") is None:
        pytest.skip("g++ is not installed: the step header cannot be built for the host")
    alg = _port(name)
    params = vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    assert vf.kernel_of(params) == "vector_filter_shaped"
    ys = data33[CONFIGS[name][0]][:batch]
    time_major = ys.permute(2, 1, 0).contiguous().permute(2, 1, 0)
    want = vf._vector_filter_plain(params, ys, LIBM_FNS)
    for y in (ys, time_major):
        for s, a, b in zip(STREAMS, vf._host_shim_run(params, y, kernel="vector_filter_shaped"),
                           want):
            assert bool(torch.isfinite(b).all()), s
            assert torch.equal(a, b), f"{s}: {float((a - b).abs().max()):.3e}"


def _mixed(dyn_of, obs_of):
    """A filter with the dynamics rule of config ``dyn_of`` and the
    measurement rule of ``obs_of`` (same system)."""
    alg, other = _port(dyn_of), _port(obs_of)
    alg.tf_obs = other.tf_obs
    return alg


#: configuration -> the kernel that runs it: the UT and CKF shapes of every model
#: pair take the shaped kernels, classical rules the classical one (the UKF
#: beside the CKF too), GPQ, BSQ and mixed kinds at one count the kernel of the
#: BQ shapes; Gauss-Hermite on the reentry state (243 points) the general
#: kernel's warp form
ROUTES = {"ukf": "vector_filter_shaped", "ckf": "vector_filter_shaped",
          "cv_ukf": "vector_filter_shaped", "cv_ckf": "vector_filter_shaped",
          "pend_ukf": "vector_filter_shaped", "fall_ukf": "vector_filter_shaped",
          "ct_ckf": "vector_filter_shaped", "ct_ukf": "vector_filter_shaped",
          "pend_gpq": "vector_filter_shaped_bq",
          "gh3": "vector_filter_general", "gpq_ut": "vector_filter_shaped_bq",
          "bsq_ut": "vector_filter_shaped_bq",
          "ukf/bsq_ut": "vector_filter_shaped_bq", "bsq_ut/ukf": "vector_filter_shaped_bq",
          "ukf/ckf": "vector_filter_shaped", "cv_ckf/cv_ukf": "vector_filter_shaped"}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_kernel_of_routes_by_shape(name):
    alg = _mixed(*name.split("/")) if "/" in name else _port(name)
    params = vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    assert vf.kernel_of(params) == ROUTES[name]


def test_shaped_host_build_refuses_other_shapes(data):
    """The shaped header's host entries run no instantiation for a shape
    they do not hold (the classical one for CT with the radar, a model pair
    without its form; the BQ one at mixed counts for the UKF beside the CKF,
    two classical rules, which the classical kernel takes), and a rule that
    does not fit the parameter struct (GH-3's 243 points; a BQ rule in the
    classical struct) is refused before any call."""
    for alg, system, kernel in ((_port("ct_radar"), "ct_radar", "vector_filter_shaped"),
                                (_mixed("ukf", "ckf"), "reentry", "vector_filter_shaped_bq")):
        params = vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
        with pytest.raises(RuntimeError, match="ran the D=0 step"):
            vf._host_shim_run(params, data[system][:1], kernel=kernel)
    for name, kernel, what in (("gh3", "vector_filter_shaped", "shaped kernel takes classical"),
                               ("gh3", "vector_filter_shaped_bq", "BQ shapes takes classical "
                                                                  "and BQ rules of up to 11"),
                               ("bsq_ut", "vector_filter_shaped", "shaped kernel takes classical")):
        alg = _port(name)
        params = vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
        with pytest.raises(ValueError, match=what):
            vf._host_shim_run(params, data["reentry"][:1], kernel=kernel)


@pytest.mark.parametrize("name", ["ukf", "bsqkf"])
def test_reentry_golden_through_the_fused_engine(goldens, name):
    g = goldens["reentry"]
    dyn, obs = _reentry()
    alg = (stt.UnscentedKalman(dyn, obs) if name == "ukf"
           else stt.BayesSardKalman(dyn, obs, BSQ_DYN, BSQ_OBS, MUL_UT, MUL_UT))
    res = alg.forward_pass_batch(np.moveaxis(g["y"], -1, 0), engine="dd")
    np.testing.assert_allclose(res.fi_mean[0].numpy(), g[f"{name}_fm"], atol=1e-7, rtol=1e-6)
    np.testing.assert_allclose(res.fi_cov[0].numpy(), g[f"{name}_fP"], atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_supports_matches_jax_dd_supports(name):
    system, make, make_jax, admitted = CONFIGS[name]
    dyn, obs = SYSTEMS[system][0]()
    jdyn, jobs = SYSTEMS[system][1]()
    alg, jalg = make(dyn, obs), make_jax(jdyn, jobs)
    assert dd_supports(jdyn, jobs, jalg.tf_dyn, jalg.tf_obs) == (admitted or name in JAX_ONLY)
    assert vf.supports(dyn, obs, alg.tf_dyn, alg.tf_obs) == admitted


@pytest.mark.parametrize("name,reason", [
    ("tpq", "TPQ"), ("bsq_matrix_emv", "scalar model variance"),
    ("ungm_na", "additive noise"), ("ctrs", "additive process and measurement noise"),
    ("ct_tpq", "TPQ"), ("drift_ukf", "has no kernel form of _Drift")])
def test_refused_configurations_route_to_f64(data, name, reason):
    """``engine="auto"`` sends what the kernels refuse to the eager path (the
    same moments to the bit); ``engine="dd"`` raises naming the reason."""
    alg = _port(name)
    ys = data[CONFIGS[name][0]][:2, :, :4]
    auto, eager = alg.forward_pass_batch(ys, engine="auto"), alg.forward_pass_batch(ys)
    for f in FIELDS:
        assert torch.equal(getattr(auto, f), getattr(eager, f)), f
    with pytest.raises(ValueError, match="engine='dd' cannot run this configuration: .*" + reason):
        alg.forward_pass_batch(ys, engine="dd")


def test_dense_classical_rules_and_other_models_are_refused():
    dyn, obs = _reentry()
    ukf = stt.UnscentedKalman(dyn, obs)
    dense = SigmaPointTransform(ukf.tf_dyn.unit_sp, ukf.tf_dyn.wm, Wc_dense=ukf.tf_dyn.Wc)
    with pytest.raises(ValueError, match="diagonal classical weights"):
        vf.check(dyn, obs, dense, ukf.tf_obs)
    with pytest.raises(ValueError, match="transform dimension 4 != expected 5"):
        vf.check(dyn, obs, stt.UnscentedKalman(*_cv()).tf_dyn, ukf.tf_obs)
    class Drift5D(ssmod.TransitionModel):
        """A model of the user's own, which no kernel has a form of."""
        dim_state, dim_noise = 5, 5

        def dyn_fcn(self, x, q, time):
            return x + q

    drift = Drift5D(GaussRV(5), GaussRV(5))
    with pytest.raises(ValueError, match="no kernel form of Drift5D"):
        vf.check(drift, obs, ukf.tf_dyn, ukf.tf_obs)


def test_wrapper_on_cpu_runs_the_plain_version_and_counts_no_launch(data):
    alg = _port("ukf")
    params = vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    before = vf.LAUNCHES
    for a, b in zip(vf.vector_filter(params, data["reentry"]),
                    vf._vector_filter_plain(params, data["reentry"])):
        assert torch.equal(a, b)
    assert vf.LAUNCHES == before


def test_wrapper_checks_its_inputs(data):
    alg = _port("ukf")
    params = vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
    ys = data["reentry"]
    with pytest.raises(TypeError, match="float64"):
        vf.vector_filter(params, ys.float())
    with pytest.raises(ValueError, match=r"\(B, 2, T\)"):
        vf.vector_filter(params, ys[:, :1])
    with pytest.raises(ValueError, match=r"\(B, 2, T\)"):
        vf.vector_filter(params, ys[0])
    with pytest.raises(ValueError, match="CPU or CUDA"):
        vf.vector_filter(params, ys.to("meta"))


def test_layouts_and_the_initial_state(data):
    """Views in the JAX layout (B, D, T) and (B, D, D, T) of time-major
    streams; ``init_mean`` / ``init_cov`` replace the model's initial
    moments."""
    alg = _port("ukf")
    ys = data["reentry"]
    res = alg.forward_pass_batch(ys, engine="dd")
    assert res.fi_mean.shape == (B, 5, T) and res.pr_xx_cov.shape == (B, 5, 5, T)
    assert res.fi_cov.stride()[0] == 1                          # trajectories adjacent
    m0 = torch.as_tensor(RE_M0 + np.array([0.01, 0.0, 0.0, 0.0, 0.0]))
    moved = stt.gaussian_filter_batch(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs, ys,
                                      init_mean=m0, init_cov=2.0 * RE_P0, engine="dd")
    eager = stt.gaussian_filter_batch(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs, ys,
                                      init_mean=m0, init_cov=2.0 * RE_P0)
    assert float((moved.pr_mean[..., 0] - res.pr_mean[..., 0]).abs().max()) > 1e-3
    for f in FIELDS:
        _close(getattr(moved, f), getattr(eager, f), 1e-10, f)


def test_a_failed_cholesky_fills_the_trajectory_with_nan(data):
    """A covariance that is not positive definite gives NaN from that step
    on, as ``chol_small`` does, without raising; the other trajectories are
    untouched."""
    alg = _port("ukf")
    params = vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs,
                        init_cov=-np.eye(5))
    m_fi = vf.vector_filter(params, data["reentry"][:2])[0]
    assert bool(torch.isnan(m_fi).all())
    good = vf.vector_filter(vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs),
                            data["reentry"][:2])[0]
    assert bool(torch.isfinite(good).all())


@pytest.mark.parametrize("name", ["ukf", "bsq_ut"])
def test_an_edited_transform_is_lowered_anew(data, name):
    """A transform's rule is kept on it until its weights are edited in
    place; then the fused engine lowers it again and agrees with the eager
    path."""
    alg = _port(name)
    ys = data["reentry"]
    rule = vf.lower_transform(alg.tf_dyn, 5)
    before = alg.forward_pass_batch(ys, engine="dd")
    assert vf.lower_transform(alg.tf_dyn, 5) is rule
    (alg.tf_dyn.wm if name == "ukf" else alg.tf_dyn.Wcc).mul_(1.001)
    assert vf.lower_transform(alg.tf_dyn, 5) is not rule
    fused, eager = alg.forward_pass_batch(ys, engine="dd"), alg.forward_pass_batch(ys)
    assert float((fused.pr_xx_cov - before.pr_xx_cov).abs().max()) > 1e-9
    for f in FIELDS:
        _close(getattr(fused, f), getattr(eager, f), 1e-8, f)


def test_parameter_struct_matches_the_header():
    """The ctypes mirror of ``VfRule``/``VfParams`` has the header's fields
    and model ids."""
    src = open(vf._build.CSRC + "/vector_filter_step.cuh").read()
    for struct, mirror in (("VfRule", vf._CRule), ("VfParams", vf._CParams)):
        body = src.split(f"struct {struct} {{")[1].split("};")[0]
        for name, _ in mirror._fields_:
            assert f" {name};" in body or f" {name}[" in body, (struct, name)
    assert f"#define VF_MAX_DIM {vf._MAX_DIM}" in src
    assert f"#define VF_MAX_OBS_C {vf._MAX_OBS_C}" in src
    tokens = {"ReentryVehicle2DTransition": "DYN_REENTRY", "ConstantVelocity": "DYN_CV",
              "Pendulum2DTransition": "DYN_PENDULUM", "ReentryVehicle1DTransition": "DYN_REENTRY1D",
              "CoordinatedTurnTransition": "DYN_CT", "Radar2DMeasurement": "OBS_RADAR",
              "Pendulum2DMeasurement": "OBS_PENDULUM_SIN", "RangeMeasurement": "OBS_RANGE",
              "BearingMeasurement": "OBS_BEARING", "UNGMMeasurement": "OBS_UNGM"}
    for cls, (model_id, _) in {**vf._DYN_MODELS, **vf._OBS_MODELS}.items():
        assert f"#define VF_{tokens[cls.__name__]} {model_id}" in src
    # the pairs of VF_MODELS are the instantiated pairs of model ids
    ids = {f"VF_{tokens[cls.__name__]}": model_id
           for table in (vf._DYN_MODELS, vf._OBS_MODELS) for cls, (model_id, _) in table.items()}
    models = src.split("#define VF_MODELS(F)")[1]
    pairs = {(ids[d], ids[o]) for d, o in re.findall(r"F\(\d+, \d+, (VF_\w+), (VF_\w+)\)", models)}
    assert pairs == vf._PAIRS


def test_shaped_parameter_struct_matches_the_header():
    """The ctypes mirror of ``VfsRule``/``VfsParams`` has the shaped header's
    fields and sizes."""
    src = open(vf._build.CSRC + "/vector_filter_shaped.cuh").read()
    for struct, mirror in (("VfsRule", vf._CShapedRule), ("VfsParams", vf._CShapedParams)):
        body = src.split(f"struct {struct} {{")[1].split("};")[0]
        for name, _ in mirror._fields_:
            assert f" {name};" in body or f" {name}[" in body, (struct, name)
    assert f"#define VFS_MAX_DIM {vf._SHAPED_MAX_DIM}" in src
    assert f"#define VFS_MAX_PTS {vf._SHAPED_MAX_PTS}" in src
    assert ctypes.sizeof(vf._CShapedParams) == 3136 and "3,136 bytes" in src
    assert "1,904 bytes" in open(vf._build.CSRC + "/vector_filter_step.cuh").read()
    assert ctypes.sizeof(vf._CParams) == 1904
