"""Student-t filters and smoothers of the PyTorch port, and the Gaussian
filters on Student-t systems, against the JAX package and the goldens.

- The ``get_stats()[:2]`` repair: a UKF on a UNGM system whose RVs are
  ``StudentRV`` (``get_stats`` returns three values) through both engines,
  20 steps, against the JAX UKF at 1e-9.
- Goldens at the parity tolerance 1e-8: FSQ on ``ungm_student.npz``, the
  TPQ Kalman filter on ``ungm.npz``, the UKF on the CV radar ``cv_radar.npz``.
- The CV radar glint system (M=8, N=30): TPQSF and GPQSF with the JAX
  transforms' Monte-Carlo weights carried across (``convert.py``), and FSQ
  with its own closed-form rule; filtered mean, covariance, scale matrix,
  dof, predictive moments and both smoother layouts at 1e-9 (float64 on both
  sides, sums in another order).  The kernels' lengthscales are 3, not the
  study's 100: at 100 the Gram's ``lambda_min ~ 1e-7`` needs ~1e6 samples
  for weights that do not diverge, too slow for the JAX package here, while
  at 3 both packages filter the study's system stably from 2e4 samples.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ssmtoybox_tpu as st
from ssmtoybox_tpu import ssmod as jssmod
from ssmtoybox_tpu.utils import GaussianMixtureRV as JGaussianMixtureRV
from ssmtoybox_tpu.utils import GaussRV as JGaussRV
from ssmtoybox_tpu.utils import StudentRV as JStudentRV
from ssmtoybox_tpu.utils import metrics as jmetrics
import ssmtoybox_torch as stt
from ssmtoybox_torch import convert, ssmod
from ssmtoybox_torch.utils import GaussianMixtureRV, GaussRV, StudentRV
from ssmtoybox_torch.utils import metrics
from ssmtoybox_torch import set_device


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


PARITY = 1e-8
JAX_TOL = 1e-9

# the FUSION-2017 CV radar glint study (experiments/tpq_constant_velocity.py)
DT = 0.5
P0 = np.diag([100.0 ** 2, 10.0 ** 2, 100.0 ** 2, 10.0 ** 2])
Q = np.diag([50.0, 5.0])
R0 = np.diag([50.0, 0.4e-6])
R1 = np.diag([5000.0, 1.6e-5])
SIDX = [0, 2, 1, 3]
M0_TRUE = np.array([10000.0, 300.0, 1000.0, -40.0])
M0_MIS = np.array([10175.0, 295.0, 980.0, -35.0])
X0_DOF, R_DOF = 1000.0, 4.0
PAR_DYN = np.array([[0.05, 3.0, 3.0, 3.0, 3.0]])
PAR_OBS = np.array([[0.005, 3.0, 3.0, 3.0, 3.0]])
STUDENT_FIELDS = ("fi_mean", "fi_cov", "fi_smat", "dof_fi", "pr_mean", "pr_smat", "pr_xx_smat")


def _close(a, b, label, tol=JAX_TOL):
    """``|a - b| <= tol (|b| + max |b|)``: relative, with an absolute floor at
    the scale of the whole array (the scale matrices reach 1e5-1e6)."""
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    floor = np.nanmax(np.abs(b)) if b.size else 0.0
    np.testing.assert_allclose(a, b, atol=tol * max(floor, 1.0), rtol=tol, err_msg=label)


# ---------------------------------------------------------------------------
# the get_stats()[:2] repair
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["f64", "dd"])
def test_gaussian_filters_take_student_rvs(engine):
    """``StudentRV.get_stats()`` returns (mean, scale, dof); the Gaussian
    filters take its first two, as the JAX package does."""
    dyn = ssmod.UNGMTransition(StudentRV(1, scale=5.0, dof=4.0), StudentRV(1, scale=10.0, dof=4.0))
    obs = ssmod.UNGMMeasurement(StudentRV(1, scale=1.0, dof=4.0), dim_state=1)
    jdyn = jssmod.UNGMTransition.create(JStudentRV.create(1, scale=5.0, dof=4.0),
                                        JStudentRV.create(1, scale=10.0, dof=4.0))
    jobs = jssmod.UNGMMeasurement.create(JStudentRV.create(1, scale=1.0, dof=4.0), dim_state=1)
    ys = np.random.default_rng(1).normal(3.0, 5.0, size=(4, 1, 20))
    res = stt.UnscentedKalman(dyn, obs).forward_pass_batch(ys, engine=engine)
    ref = st.UnscentedKalman(jdyn, jobs).forward_pass_batch(jnp.asarray(ys))
    for f in ("fi_mean", "fi_cov", "pr_mean", "pr_cov", "pr_xx_cov"):
        _close(getattr(res, f), getattr(ref, f), f)


# ---------------------------------------------------------------------------
# goldens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,fixed", [("fsq3", True), ("fsq3_inc", False)])
def test_fsq_matches_golden(goldens, name, fixed):
    g = goldens["ungm_student"]
    dyn = ssmod.UNGMTransition(StudentRV(1, scale=1.0, dof=4.0), StudentRV(1, scale=10.0, dof=4.0))
    obs = ssmod.UNGMMeasurement(StudentRV(1, scale=0.01, dof=4.0), dim_state=1)
    alg = stt.FullySymmetricStudent(dyn, obs, degree=3, dof=4.0, fixed_dof=fixed)
    fm, fP = alg.forward_pass(g["y"][..., 0])
    _close(fm, g[f"{name}_fm"], f"{name} mean", PARITY)
    _close(fP, g[f"{name}_fP"], f"{name} cov", PARITY)
    sm, sS = alg.backward_pass()
    assert tuple(sS.shape) == (1, 1, g["y"].shape[1]) and alg.get_flag("smoothed")


def test_tpq_kalman_matches_golden(goldens):
    g = goldens["ungm"]
    dyn = ssmod.UNGMTransition(GaussRV(1, cov=1.0), GaussRV(1, cov=10.0))
    obs = ssmod.UNGMMeasurement(GaussRV(1, cov=1.0), dim_state=1)
    alg = stt.StudentProcessKalman(dyn, obs, np.array([[1.0, 3.0]]), np.array([[1.0, 3.0]]),
                                   points="ut", nu=3.0)
    fm, fP = alg.forward_pass(g["y"][..., 0])
    _close(fm, g["tpqkf_fm"], "TPQKF mean", PARITY)
    _close(fP, g["tpqkf_fP"], "TPQKF cov", PARITY)
    with pytest.raises(ValueError, match="TPQ"):
        alg.forward_pass_batch(np.moveaxis(g["y"], -1, 0), engine="dd")


def test_cv_radar_ukf_matches_golden(goldens):
    g = goldens["cv_radar"]
    dyn = ssmod.ConstantVelocity(GaussRV(4, mean=M0_TRUE, cov=np.diag([100.0, 25.0, 100.0, 25.0])),
                                 GaussRV(2, cov=Q), dt=DT)
    obs = ssmod.Radar2DMeasurement(GaussRV(2, cov=R0), dim_state=4, state_index=[0, 2])
    alg = stt.UnscentedKalman(dyn, obs)
    fm, fP = alg.forward_pass(g["y"][..., 0])
    _close(fm, g["ukf_fm"], "CV radar UKF mean", PARITY)
    _close(fP, g["ukf_fP"], "CV radar UKF cov", PARITY)
    sm, sP = alg.backward_pass()
    _close(sm, g["ukf_sm"], "CV radar UKF smoothed mean", PARITY)
    _close(sP, g["ukf_sP"], "CV radar UKF smoothed cov", PARITY)


# ---------------------------------------------------------------------------
# the CV radar glint study against the JAX package
# ---------------------------------------------------------------------------

def _cv_glint_data(rng, steps, mc):
    """True states (M, 4, N) and glint measurements (M, 2, N) from NumPy noise
    pushed through the port's model functions."""
    dyn = ssmod.ConstantVelocity(GaussRV(4, mean=M0_TRUE, cov=P0), GaussRV(2, cov=Q), dt=DT)
    obs = ssmod.Radar2DMeasurement(GaussRV(2, cov=R0), dim_state=4, state_index=SIDX)
    x = torch.as_tensor(M0_TRUE + rng.normal(size=(mc, 4)) @ np.sqrt(P0))
    xs, ys = [], []
    for k in range(steps):
        xs.append(x)
        glint = rng.uniform(size=(mc, 1)) < 0.15
        r = rng.normal(size=(mc, 2)) * np.sqrt(np.where(glint, np.diag(R1), np.diag(R0)))
        ys.append(obs.meas_fcn(obs._select(x), torch.as_tensor(r), k + 1))
        x = dyn.dyn_fcn(x, torch.as_tensor(rng.normal(size=(mc, 2)) @ np.sqrt(Q)), k)
    return torch.stack(xs, -1).numpy(), torch.stack(ys, -1).numpy()


def _student_systems():
    scale = (X0_DOF - 2.0) / X0_DOF
    dyn = ssmod.ConstantVelocity(StudentRV(4, mean=M0_MIS, scale=scale * P0, dof=X0_DOF),
                                 StudentRV(2, scale=scale * Q, dof=X0_DOF), dt=DT)
    obs = ssmod.Radar2DMeasurement(StudentRV(2, scale=(R_DOF - 2.0) / R_DOF * R0, dof=R_DOF),
                                   dim_state=4, state_index=SIDX)
    jdyn = jssmod.ConstantVelocity.create(
        JStudentRV.create(4, mean=M0_MIS, scale=scale * P0, dof=X0_DOF),
        JStudentRV.create(2, scale=scale * Q, dof=X0_DOF), dt=DT)
    jobs = jssmod.Radar2DMeasurement.create(
        JStudentRV.create(2, scale=(R_DOF - 2.0) / R_DOF * R0, dof=R_DOF),
        dim_state=4, state_index=SIDX)
    return dyn, obs, jdyn, jobs


def _carry(jt):
    d = {"points": np.asarray(jt.model.points), "wm": np.asarray(jt.wm),
         "Wc": np.asarray(jt.Wc), "Wcc": np.asarray(jt.Wcc),
         "model_var": np.asarray(jt.model_var), "integral_var": np.asarray(jt.integral_var),
         "iK": np.asarray(jt.iK)}
    if hasattr(jt.model, "nu"):
        d["nu"] = jt.model.nu
    return convert.transform_from_numpy(d)


@pytest.fixture(scope="module")
def glint_study():
    """The three Student lanes of both packages on one batch (8 x 30)."""
    _, ys = _cv_glint_data(np.random.default_rng(5), steps=30, mc=8)
    dyn, obs, jdyn, jobs = _student_systems()
    mc_opts = {"num_samples": 20_000}
    kappa = {"kappa": 0.0}
    jalgs = {
        "tpqsf": st.StudentProcessStudent(jdyn, jobs, PAR_DYN, PAR_OBS, point_par=kappa,
                                          dof=4.0, dof_tp=4.0, mc_opts=mc_opts),
        "gpqsf": st.GPQStudent(jdyn, jobs, PAR_DYN, PAR_OBS, point_hyp=kappa, dof=4.0,
                               mc_opts=mc_opts),
        "fsq": st.FullySymmetricStudent(jdyn, jobs, degree=3, kappa=0.0, dof=4.0),
    }
    algs = {name: stt.StudentianInference(dyn, obs, _carry(ja.tf_dyn), _carry(ja.tf_obs), dof=4.0)
            for name, ja in jalgs.items() if name != "fsq"}
    algs["fsq"] = stt.FullySymmetricStudent(dyn, obs, degree=3, kappa=0.0, dof=4.0)
    out = {}
    for name, ja in jalgs.items():
        ref = ja.forward_pass_batch(jnp.asarray(ys))
        smooth = {full: jax.jit(jax.vmap(lambda r: st.studentian_smoother(r, rts_full=full)))(ref)
                  for full in (False, True)}
        out[name] = (algs[name].forward_pass_batch(ys), ref, smooth)
    return out


@pytest.mark.parametrize("lane", ["tpqsf", "gpqsf", "fsq"])
def test_student_filter_matches_jax(glint_study, lane):
    res, ref, _ = glint_study[lane]
    assert bool(torch.isfinite(res.fi_mean).all())
    for f in STUDENT_FIELDS:
        _close(getattr(res, f), getattr(ref, f), f"{lane} {f}")


@pytest.mark.parametrize("lane", ["tpqsf", "gpqsf", "fsq"])
@pytest.mark.parametrize("rts_full", [False, True])
def test_student_smoother_matches_jax(glint_study, lane, rts_full):
    res, _, smooth = glint_study[lane]
    sm, sS = stt.studentian_smoother(res, rts_full=rts_full)
    _close(sm, smooth[rts_full][0], f"{lane} smoothed mean")
    _close(sS, smooth[rts_full][1], f"{lane} smoothed scale")


def test_single_trajectory_equals_batch_member(glint_study):
    res, _, _ = glint_study["fsq"]
    dyn, obs, _, _ = _student_systems()
    alg = stt.FullySymmetricStudent(dyn, obs, degree=3, kappa=0.0, dof=4.0)
    _, ys = _cv_glint_data(np.random.default_rng(5), steps=30, mc=8)
    fm, fP = alg.forward_pass(ys[2])
    _close(fm, res.fi_mean[2], "mean", 1e-12)
    _close(fP, res.fi_cov[2], "covariance", 1e-12)


def test_inclination_matches_jax():
    rng = np.random.default_rng(6)
    x, m = rng.normal(size=(2, 12)), rng.normal(size=(2, 12))
    A = rng.normal(size=(12, 2, 2))
    P = np.moveaxis(A @ np.swapaxes(A, 1, 2) + np.eye(2), 0, -1)
    MSE = np.moveaxis(np.eye(2) * rng.uniform(0.5, 2.0, size=(12, 1, 1)), 0, -1)
    _close(metrics.inclination(*(torch.as_tensor(a) for a in (x, m, P, MSE))),
           jmetrics.inclination(*(jnp.asarray(a) for a in (x, m, P, MSE))), "INC", 1e-12)


# ---------------------------------------------------------------------------
# models with Student-t and mixture noise
# ---------------------------------------------------------------------------

def test_cv_glint_models_simulate_and_convert():
    gen = torch.Generator().manual_seed(0)
    glint = GaussianMixtureRV(2, means=(np.zeros(2), np.zeros(2)), covs=(R0, R1),
                              alphas=(0.85, 0.15))
    dyn = ssmod.ConstantVelocity(GaussRV(4, mean=M0_TRUE, cov=P0), GaussRV(2, cov=Q), dt=DT)
    obs = ssmod.Radar2DMeasurement(glint, dim_state=4, state_index=SIDX)
    x = dyn.simulate_discrete(gen, steps=6, mc_sims=5)
    y = obs.simulate_measurements(gen, x)
    assert tuple(x.shape) == (4, 6, 5) and tuple(y.shape) == (2, 6, 5)
    assert bool(torch.isfinite(y).all())
    np.testing.assert_allclose(dyn.noise_gain.numpy(), np.asarray(
        jssmod.ConstantVelocity.create(JGaussRV.create(4), JGaussRV.create(2), dt=DT).noise_gain))
    jglint = JGaussianMixtureRV.create(2, means=(np.zeros(2), np.zeros(2)), covs=(R0, R1),
                                       alphas=(0.85, 0.15))
    for a, b in zip(glint.get_stats(), jglint.get_stats()):
        _close(a, b, "mixture moments", 1e-12)
    m = convert.model_from_numpy("Radar2DMeasurement", {
        "noise_rv": {"means": np.asarray(jglint.means), "covs": np.asarray(jglint.covs),
                     "alphas": np.asarray(jglint.alphas)},
        "dim_state": 4, "state_index": SIDX})
    assert isinstance(m.noise_rv, GaussianMixtureRV) and m.state_index == tuple(SIDX)
    d = convert.model_from_numpy("ConstantVelocity", {
        "init_rv": {"mean": M0_MIS, "scale": P0, "dof": X0_DOF},
        "noise_rv": {"mean": np.zeros(2), "scale": Q, "dof": X0_DOF}, "dt": DT})
    assert isinstance(d.init_rv, StudentRV) and d.dt == DT and d.init_rv.dof == X0_DOF
