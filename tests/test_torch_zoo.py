"""The rest of the model zoo in the PyTorch port: non-additive noise, the
models the main path does not run, their Jacobians and the two-component
Gaussian mixture, against the JAX package and the goldens.

- Model functions (``dyn_fcn``, ``dyn_eval``, ``dyn_fcn_cont``,
  ``dyn_fcn_dx``; ``meas_fcn``, ``meas_eval``, ``meas_fcn_dx``) on states and
  noise from a numpy seed, against the JAX package's per-state functions
  under ``vmap``, at 1e-12 (float64 on both sides; PyTorch's and XLA's
  ``sin``, ``exp`` and ``atan2`` may differ by an ulp).  The coordinated turn
  at a turn rate of 0, 1e-31 (both below the 1e-30 select) and 0.06; the
  constant turn-rate model with both ``compat_heading``; four bearings; the
  noise columns of the non-additive models' Jacobians.
- The goldens ``ungm_na``, ``pendulum``, ``cv_radar``, ``ct_bearing`` and
  ``ctrs_radar`` at ``tests/test_parity.py``'s tolerances.
- Non-additive filters against the JAX package on one batch (4 records of
  20 steps): the UKF on UNGM-NA and on the constant turn-rate model with the
  radar, filter and RTS smoother (the smoother reads the cross-covariance
  trimmed to the state); the fully-symmetric Student filter with Student
  noise, non-additive in the dynamics or in the measurement, filter and
  scale-matrix smoother.  1e-9 (float64, sums in another order).
- ``bigauss_mixture``: component weight and moments within five standard
  errors of 20,000 draws.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import scipy.linalg as sla

import ssmtoybox_tpu as st
from ssmtoybox_tpu import ssmod as jssmod
from ssmtoybox_tpu.utils import GaussRV as JGaussRV
from ssmtoybox_tpu.utils import StudentRV as JStudentRV
import ssmtoybox_torch as stt
from ssmtoybox_torch import set_device, ssmod
from ssmtoybox_torch.utils import GaussRV, StudentRV
from ssmtoybox_torch.utils.rand import bigauss_mixture


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


MODEL_TOL = 1e-12
JAX_TOL = 1e-9
FIELDS = ("fi_mean", "fi_cov", "pr_mean", "pr_cov", "pr_xx_cov")


def _both(cls_name, init, noise, **kw):
    """A transition model of both packages from (mean, cov) pairs."""
    port = getattr(ssmod, cls_name)(GaussRV(len(init[0]), *init),
                                    GaussRV(len(noise[1]), cov=noise[1]), **kw)
    jax_ = getattr(jssmod, cls_name).create(JGaussRV.create(len(init[0]), *init),
                                            JGaussRV.create(len(noise[1]), cov=noise[1]), **kw)
    return port, jax_


CT_INIT = (np.array([100.0, 10.0, 100.0, 5.0, 0.06]), np.diag([10.0, 1.0, 10.0, 1.0, 1e-3]))
CT_Q = (None, np.diag([0.1, 0.1, 0.1, 0.1, 1e-5]))
CTRS_INIT = (np.array([10.0, 0.0, 5.0, 0.5, 0.1]), 0.1 * np.eye(5))
CTRS_Q = (None, np.diag([0.1, 0.1 * np.pi]))

#: name -> (class, init, noise, keywords, state scale, turn rate to set or None)
TRANSITIONS = {
    "ungm_na": ("UNGMNATransition", (np.array([1.0]), np.eye(1)), (None, 10.0 * np.eye(1)), {},
                5.0, None),
    "pendulum": ("Pendulum2DTransition", (np.array([1.5, 0.0]), 0.01 * np.eye(2)),
                 (None, 1e-3 * np.eye(2)), {"dt": 0.01}, 1.0, None),
    "reentry1d": ("ReentryVehicle1DTransition", (np.array([90.0, 6.0, 1.5]), 0.09 * np.eye(3)),
                  (None, 1e-8 * np.eye(3)), {"dt": 0.1}, 1.0, None),
    "ct_om0": ("CoordinatedTurnTransition", CT_INIT, CT_Q, {"dt": 0.1}, 3.0, 0.0),
    "ct_om1e-31": ("CoordinatedTurnTransition", CT_INIT, CT_Q, {"dt": 0.1}, 3.0, 1e-31),
    "ct_om0.06": ("CoordinatedTurnTransition", CT_INIT, CT_Q, {"dt": 0.1}, 3.0, 0.06),
    "ctrs": ("ConstantTurnRateSpeed", CTRS_INIT, CTRS_Q, {}, 0.5, None),
    "ctrs_compat": ("ConstantTurnRateSpeed", CTRS_INIT, CTRS_Q, {"compat_heading": True}, 0.5,
                    None),
    "ctrs_straight": ("ConstantTurnRateSpeed", CTRS_INIT, CTRS_Q, {}, 0.5, 0.0),
}


def _states(rng, dyn, scale, n=12):
    m0 = np.asarray(dyn.init_rv.mean)
    return m0 + scale * rng.normal(size=(n, len(m0))) * np.maximum(np.abs(m0), 1.0) * 0.1


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol, err_msg=what)


@pytest.mark.parametrize("name", sorted(TRANSITIONS))
def test_transition_matches_jax(name):
    cls, init, noise, kw, scale, om = TRANSITIONS[name]
    tm, jm = _both(cls, init, noise, **kw)
    assert (tm.dim_in, tm.noise_additive) == (jm.dim_in, jm.noise_additive)
    rng = np.random.default_rng(3)
    x = _states(rng, jm, scale)
    if om is not None:
        x[:, 4] = om
    q = rng.normal(size=(len(x), jm.dim_noise)) * np.sqrt(np.diag(np.asarray(jm.noise_rv.cov)))
    xt, qt, xj, qj = torch.as_tensor(x), torch.as_tensor(q), jnp.asarray(x), jnp.asarray(q)
    per_state = lambda f: jax.vmap(f, in_axes=(0, 0, None))(xj, qj, 4)  # noqa: E731
    _close(tm.dyn_fcn(xt, qt, 4), per_state(jm.dyn_fcn), MODEL_TOL, "dyn_fcn")
    _close(tm.dyn_fcn_dx(xt, qt, 4), per_state(jm.dyn_fcn_dx), MODEL_TOL, "dyn_fcn_dx")
    xq = x if jm.noise_additive else np.hstack([x, q])
    _close(tm.dyn_eval(torch.as_tensor(xq), 4),
           jax.vmap(jm.dyn_eval, in_axes=(0, None))(jnp.asarray(xq), 4), MODEL_TOL, "dyn_eval")
    try:
        want = per_state(jm.dyn_fcn_cont)
    except NotImplementedError:
        with pytest.raises(NotImplementedError):
            tm.dyn_fcn_cont(xt, qt, 4)
    else:
        _close(tm.dyn_fcn_cont(xt, qt, 4), want, MODEL_TOL, "dyn_fcn_cont")


def test_jacobian_noise_columns():
    """A non-additive model's Jacobian has the noise columns, and they are
    the derivative in the noise (UNGM-NA: 8 cos(1.2 t))."""
    tm, _ = _both(*TRANSITIONS["ungm_na"][:3])
    jac = tm.dyn_fcn_dx(torch.tensor([[2.0]], dtype=torch.float64),
                        torch.tensor([[0.5]], dtype=torch.float64), 3)
    assert jac.shape == (1, 1, 2)
    assert float(jac[0, 0, 1]) == pytest.approx(8.0 * np.cos(3.6), rel=1e-14)
    ctrs, _ = _both(*TRANSITIONS["ctrs"][:3])
    assert ctrs.dyn_fcn_dx(torch.zeros(5, dtype=torch.float64),
                           torch.zeros(2, dtype=torch.float64), 0).shape == (5, 7)


def test_ungm_has_no_continuous_dynamics_in_either_package():
    tm, jm = (ssmod.UNGMTransition(GaussRV(1), GaussRV(1)),
              jssmod.UNGMTransition.create(JGaussRV.create(1), JGaussRV.create(1)))
    for f, x in ((tm.dyn_fcn_cont, torch.zeros(1)), (jm.dyn_fcn_cont, jnp.zeros(1))):
        with pytest.raises(NotImplementedError):
            f(x, x, 0)


SENSORS = np.array([[0.0, 0.0], [200.0, 0.0], [0.0, 200.0], [200.0, 200.0]])

#: name -> (class, noise cov, keywords, dim_state, state_index, state mean, scale)
MEASUREMENTS = {
    "ungm_na": ("UNGMNAMeasurement", 0.01 * np.eye(1), {}, 1, None, [1.0], 5.0),
    "ungm_na_indexed": ("UNGMNAMeasurement", 0.01 * np.eye(1), {}, 2, [1, 2], [1.0, -2.0], 5.0),
    "pendulum": ("Pendulum2DMeasurement", 0.1 * np.eye(1), {}, 2, None, [1.5, 0.0], 1.0),
    "range": ("RangeMeasurement", 0.03 * np.eye(1), {}, 3, None, [90.0, 6.0, 1.5], 10.0),
    "bearing4": ("BearingMeasurement", 1e-3 * np.eye(4), {"sensor_pos": SENSORS}, 5, [0, 2],
                 [100.0, 10.0, 100.0, 5.0, 0.06], 30.0),
    "bearing_default": ("BearingMeasurement", 1e-3 * np.eye(4), {}, 4, [0, 2],
                        [3.0, 1.0, -2.0, 0.5], 2.0),
    "bearing3": ("BearingMeasurement", 1e-3 * np.eye(3), {"sensor_pos": SENSORS[:3]}, 4,
                 [0, 2], [3.0, 1.0, -2.0, 0.5], 2.0),
}


@pytest.mark.parametrize("name", sorted(MEASUREMENTS))
def test_measurement_matches_jax(name):
    cls, cov, kw, dim, idx, mean, scale = MEASUREMENTS[name]
    tm = getattr(ssmod, cls)(GaussRV(len(cov), cov=cov), dim_state=dim, state_index=idx, **kw)
    jm = getattr(jssmod, cls).create(JGaussRV.create(len(cov), cov=cov), dim_state=dim,
                                     state_index=idx, **kw)
    assert (tm.dim_in, tm.dim_out, tm.dim_noise, tm.dim_substate) == (
        jm.dim_in, jm.dim_out, jm.dim_noise, jm.dim_substate)
    assert type(tm).__name__ == type(jm).__name__
    rng = np.random.default_rng(5)
    x = np.asarray(mean) + scale * rng.normal(size=(12, dim))
    r = 0.1 * rng.normal(size=(12, jm.dim_noise))
    # meas_fcn and its Jacobian take the sub-state the model reads
    sub = x[:, :jm.dim_substate] if idx is None else x[:, list(idx)[:jm.dim_substate]]
    st_, rt, sj, rj = torch.as_tensor(sub), torch.as_tensor(r), jnp.asarray(sub), jnp.asarray(r)
    per_state = lambda f: jax.vmap(f, in_axes=(0, 0, None))(sj, rj, 2)  # noqa: E731
    _close(tm.meas_fcn(st_, rt, 2), per_state(jm.meas_fcn), MODEL_TOL, "meas_fcn")
    _close(tm.meas_fcn_dx(st_, rt, 2), per_state(jm.meas_fcn_dx), MODEL_TOL, "meas_fcn_dx")
    xr = x if jm.noise_additive else np.hstack([x, r])
    _close(tm.meas_eval(torch.as_tensor(xr), 2),
           jax.vmap(jm.meas_eval, in_axes=(0, None))(jnp.asarray(xr), 2), MODEL_TOL, "meas_eval")


def test_bearing_subclass_is_one_per_sensor_count():
    a = ssmod.BearingMeasurement(GaussRV(4), dim_state=4)
    b = ssmod.BearingMeasurement(GaussRV(4), dim_state=5, sensor_pos=SENSORS)
    c = ssmod.BearingMeasurement(GaussRV(3), dim_state=4, sensor_pos=SENSORS[:3])
    assert type(a) is type(b) and type(a) is not type(c)
    assert isinstance(c, ssmod.BearingMeasurement) and (c.dim_out, c.dim_noise) == (3, 3)


@pytest.mark.parametrize("index,ok", [([1], False), ([0, 1, 2], False), ([0, 1], True)])
def test_nonadditive_state_index_length_is_checked(index, ok):
    """A non-additive measurement gathers [state; noise]: its state_index
    must pick dim_substate + dim_noise entries, in both packages."""
    make = (lambda: ssmod.UNGMNAMeasurement(GaussRV(1), dim_state=2, state_index=index),
            lambda: jssmod.UNGMNAMeasurement.create(JGaussRV.create(1), dim_state=2,
                                                    state_index=index))
    for f in make:
        if ok:
            assert f().state_index == tuple(index)
        else:
            with pytest.raises(ValueError, match="AUGMENTED"):
                f()


def test_bigauss_mixture_weight_and_moments():
    n, alpha = 20_000, 0.3
    m0, c0 = np.array([1.0, -1.0]), np.array([[1.0, 0.3], [0.3, 0.5]])
    m1, c1 = np.array([-20.0, 2.0]), np.array([[4.0, -1.0], [-1.0, 2.0]])
    s = bigauss_mixture(torch.Generator().manual_seed(0), m0, c0, m1, c1, alpha, (n,)).numpy()
    assert s.shape == (n, 2)
    # the components lie 21 and 5 standard deviations from x_0 = -10
    near0 = s[:, 0] > -10.0
    assert abs(near0.mean() - alpha) < 5 * np.sqrt(alpha * (1 - alpha) / n)
    mean = alpha * m0 + (1 - alpha) * m1
    cov = (alpha * (c0 + np.outer(m0 - mean, m0 - mean))
           + (1 - alpha) * (c1 + np.outer(m1 - mean, m1 - mean)))
    se = np.sqrt(np.diag(cov) / n)
    assert np.all(np.abs(s.mean(0) - mean) < 5 * se)
    np.testing.assert_allclose(np.cov(s.T), cov, atol=5 * np.sqrt(2.0 / n) * np.max(np.diag(cov)))


# ---------------------------------------------------------------------------
# goldens
# ---------------------------------------------------------------------------

def _pendulum():
    dt = 0.01
    Q = 0.1 * np.array([[dt ** 3 / 3, dt ** 2 / 2], [dt ** 2 / 2, dt]])
    return (ssmod.Pendulum2DTransition(GaussRV(2, mean=[1.5, 0.0], cov=0.01 * np.eye(2)),
                                       GaussRV(2, cov=Q), dt=dt),
            ssmod.Pendulum2DMeasurement(GaussRV(1, cov=0.1), dim_state=2))


def _ct_bearing():
    dt = 0.1
    A = np.array([[dt ** 3 / 3, dt ** 2 / 2], [dt ** 2 / 2, dt]])
    Q = sla.block_diag(0.1 * A, 0.1 * A, 1.75e-4 * dt)
    return (ssmod.CoordinatedTurnTransition(
                GaussRV(5, mean=[1000.0, 300.0, 1000.0, 0.0, -3.0 * np.pi / 180],
                        cov=np.diag([100.0, 10.0, 100.0, 10.0, 0.1])), GaussRV(5, cov=Q), dt=dt),
            ssmod.BearingMeasurement(GaussRV(4, cov=1e-3 * np.eye(4)), dim_state=5,
                                     state_index=[0, 2],
                                     sensor_pos=100.0 * np.vstack((np.eye(2), -np.eye(2)))))


def _ctrs_radar():
    return (ssmod.ConstantTurnRateSpeed(GaussRV(5, mean=[10.0, 0.0, 5.0, 0.5, 0.1],
                                                cov=0.1 * np.eye(5)),
                                        GaussRV(2, cov=np.diag([0.1, 0.1 * np.pi])), dt=0.05,
                                        compat_heading=True),
            ssmod.Radar2DMeasurement(GaussRV(2, cov=np.diag([0.3, 0.03])), dim_state=5,
                                     state_index=[0, 1]))


def _cv_radar():
    return (ssmod.ConstantVelocity(GaussRV(4, mean=[10000.0, 300.0, 1000.0, -40.0],
                                           cov=np.diag([100.0, 25.0, 100.0, 25.0])),
                                   GaussRV(2, cov=np.diag([50.0, 5.0])), dt=0.5),
            ssmod.Radar2DMeasurement(GaussRV(2, cov=np.diag([50.0, 0.4e-6])), dim_state=4,
                                     state_index=[0, 2]))


def _ungm_na():
    return (ssmod.UNGMNATransition(GaussRV(1, mean=1.0, cov=1.0), GaussRV(1, cov=10.0)),
            ssmod.UNGMNAMeasurement(GaussRV(1, cov=0.01), dim_state=1))


GPQ_PEND = np.array([[1.0, 2.0, 2.0]])
#: case -> (golden file, key, system, filter, smoothed too, tolerance)
GOLDENS = {
    "ungm_na/ukf": ("ungm_na", "ukf", _ungm_na, stt.UnscentedKalman, False, 1e-8),
    "pendulum/ukf": ("pendulum", "ukf", _pendulum, stt.UnscentedKalman, True, 1e-8),
    "pendulum/gpqkf": ("pendulum", "gpqkf", _pendulum,
                       lambda d, o: stt.GaussianProcessKalman(d, o, GPQ_PEND, GPQ_PEND,
                                                              points="sr"), True, 1e-8),
    "cv_radar/ukf": ("cv_radar", "ukf", _cv_radar, stt.UnscentedKalman, True, 1e-8),
    "ct_bearing/ckf": ("ct_bearing", "ckf", _ct_bearing, stt.CubatureKalman, False, 1e-7),
    "ctrs_radar/ukf": ("ctrs_radar", "ukf", _ctrs_radar, stt.UnscentedKalman, False, 1e-7),
}


@pytest.mark.parametrize("case", sorted(GOLDENS))
def test_golden(goldens, case):
    file, key, system, make, smoothed, tol = GOLDENS[case]
    g = goldens[file]
    alg = make(*system())
    fm, fP = alg.forward_pass(g["y"][..., 0])
    _close(fm, g[f"{key}_fm"], tol, f"{case} filtered mean")
    _close(fP, g[f"{key}_fP"], tol, f"{case} filtered cov")
    if smoothed:
        sm, sP = alg.backward_pass()
        _close(sm, g[f"{key}_sm"], tol, f"{case} smoothed mean")
        _close(sP, g[f"{key}_sP"], tol, f"{case} smoothed cov")


# ---------------------------------------------------------------------------
# non-additive filters and smoothers against the JAX package
# ---------------------------------------------------------------------------

def _jax_twin(model):
    """The JAX package's copy of a port model built from Gaussian RVs."""
    cls = getattr(jssmod, type(model).__name__.rstrip("0123456789"))
    if hasattr(model, "init_rv"):
        kw = {k: getattr(model, k) for k in ("dt", "compat_heading") if hasattr(model, k)}
        return cls.create(JGaussRV.create(model.dim_state, model.init_rv.mean.numpy(),
                                          model.init_rv.cov.numpy()),
                          JGaussRV.create(model.dim_noise, cov=model.noise_rv.cov.numpy()), **kw)
    kw = {"radar_loc": model.radar_loc.numpy()} if hasattr(model, "radar_loc") else {}
    return cls.create(JGaussRV.create(model.dim_noise, cov=model.noise_rv.cov.numpy()),
                      dim_state=model.dim_state, state_index=model.state_index, **kw)


def _records(dyn, obs, seed, batch=4, steps=20):
    gen = torch.Generator().manual_seed(seed)
    return obs.simulate_measurements(gen, dyn.simulate_discrete(gen, steps, batch)).permute(2, 0, 1)


@pytest.mark.parametrize("system", ["ungm_na", "ctrs_radar"])
def test_nonadditive_filter_and_smoother_match_jax(system):
    dyn, obs = {"ungm_na": _ungm_na, "ctrs_radar": _ctrs_radar}[system]()
    jdyn, jobs = _jax_twin(dyn), _jax_twin(obs)
    ys = _records(dyn, obs, seed=1)
    res = stt.UnscentedKalman(dyn, obs).forward_pass_batch(ys)
    jalg = st.UnscentedKalman(jdyn, jobs)
    ref = jax.jit(lambda b: st.gaussian_filter_batch(jdyn, jobs, jalg.tf_dyn, jalg.tf_obs, b))(
        jnp.asarray(ys.numpy()))
    assert res.pr_xx_cov.shape[-3:-1] == (dyn.dim_state, dyn.dim_state)
    for f in FIELDS:
        _close(getattr(res, f), getattr(ref, f), JAX_TOL, f)
    sm = jax.jit(jax.vmap(st.gaussian_smoother))(ref)
    for got, want, what in zip(stt.gaussian_smoother(res), sm, ("smoothed mean", "smoothed cov")):
        _close(got, want, JAX_TOL, what)


def _student_ungm(na_dyn: bool):
    dyn_cls = "UNGMNATransition" if na_dyn else "UNGMTransition"
    obs_cls = "UNGMMeasurement" if na_dyn else "UNGMNAMeasurement"
    scale = 1.0 if na_dyn else 0.01
    port = (getattr(ssmod, dyn_cls)(StudentRV(1, mean=[1.0], scale=1.0, dof=4.0),
                                    StudentRV(1, scale=1.0, dof=4.0)),
            getattr(ssmod, obs_cls)(StudentRV(1, scale=scale, dof=4.0), dim_state=1))
    jax_ = (getattr(jssmod, dyn_cls).create(JStudentRV.create(1, mean=jnp.array([1.0]), scale=1.0,
                                                              dof=4.0),
                                            JStudentRV.create(1, scale=1.0, dof=4.0)),
            getattr(jssmod, obs_cls).create(JStudentRV.create(1, scale=scale, dof=4.0),
                                            dim_state=1))
    return port, jax_


@pytest.mark.parametrize("na", ["dynamics", "measurement"])
def test_nonadditive_student_filter_matches_jax(na):
    """The fully-symmetric Student filter (degree 5: the degree-3 rule gives
    the bilinear UNGM-NA measurement a zero gain) on UNGM with Student noise,
    non-additive in one model, 20 steps: every stream and the scale-matrix
    smoother at 1e-9."""
    (dyn, obs), (jdyn, jobs) = _student_ungm(na == "dynamics")
    ys = _records(dyn, obs, seed=2, batch=1)[0]
    res = stt.FullySymmetricStudent(dyn, obs, degree=5).forward_pass_batch(ys[None])
    jalg = st.FullySymmetricStudent(jdyn, jobs, degree=5)
    ref = st.ssinf.studentian_filter(jdyn, jobs, jalg.tf_dyn, jalg.tf_obs, jnp.asarray(ys.numpy()))
    for f in ("fi_mean", "fi_cov", "fi_smat", "dof_fi", "pr_mean", "pr_smat", "pr_xx_smat"):
        _close(getattr(res, f)[0], getattr(ref, f), JAX_TOL, f)
    for got, want, what in zip(stt.studentian_smoother(res), st.ssinf.studentian_smoother(ref),
                               ("smoothed mean", "smoothed scale")):
        _close(got[0], want, JAX_TOL, what)


def test_student_filter_refuses_nonadditive_noise_on_both_models():
    """The JAX package's cross-covariance trim leaves noise rows in the gain
    there (its scan fails on the carry's shape); the port says why."""
    dyn = ssmod.UNGMNATransition(StudentRV(1, scale=1.0, dof=4.0), StudentRV(1, scale=1.0, dof=4.0))
    obs = ssmod.UNGMNAMeasurement(StudentRV(1, scale=0.01, dof=4.0), dim_state=1)
    with pytest.raises(ValueError, match="one of the two models must have additive noise"):
        stt.FullySymmetricStudent(dyn, obs).forward_pass_batch(torch.ones(1, 1, 3))
