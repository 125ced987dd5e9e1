"""Filters and smoothers of the PyTorch port against the reference goldens and
the JAX package.

- Goldens (``tests/goldens``): UNGM UKF and GPQKF filtered and smoothed
  moments at 1e-8, reentry UKF at atol 1e-7 / rtol 1e-6 (the tolerances of
  ``test_parity.py``).
- The JAX package on one shared batch (M=8, N=50) for the three study lanes:
  filter moments and both smoother layouts at 1e-9, relative and absolute
  (both sides float64; they differ only in summation order, which the UNGM
  map amplifies to ~1e-11 over 50 steps).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ssmtoybox_tpu as st
from ssmtoybox_tpu import ssmod as jssmod
from ssmtoybox_tpu.utils import GaussRV as JGaussRV
import ssmtoybox_torch as stt
from ssmtoybox_torch import ssmod
from ssmtoybox_torch.utils import GaussRV
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
KERN_PAR = np.array([[1.0, 3.0]])
REENTRY_MEAN = np.array([6500.4, 349.14, -1.8093, -6.7967, 0.6932])
REENTRY_COV = np.diag([1e-6, 1e-6, 1e-6, 1e-6, 1.0])
REENTRY_Q = np.diag([2.4064e-5, 2.4064e-5, 1e-6])
RADAR_R = np.diag([1e-3, 1e-5])
RADAR_LOC = np.array([6374.0, 0.0])
FIELDS = ("fi_mean", "fi_cov", "pr_mean", "pr_cov", "pr_xx_cov")


def _ungm(init_cov=5.0):
    return (ssmod.UNGMTransition(GaussRV(1, cov=init_cov), GaussRV(1, cov=10.0)),
            ssmod.UNGMMeasurement(GaussRV(1, cov=1.0), dim_state=1))


def _ungm_jax(init_cov=5.0):
    return (jssmod.UNGMTransition.create(JGaussRV.create(1, cov=init_cov),
                                         JGaussRV.create(1, cov=10.0)),
            jssmod.UNGMMeasurement.create(JGaussRV.create(1, cov=1.0), dim_state=1))


def _reentry(dt=0.05):
    return (ssmod.ReentryVehicle2DTransition(GaussRV(5, mean=REENTRY_MEAN, cov=REENTRY_COV),
                                             GaussRV(3, cov=REENTRY_Q), dt=dt),
            ssmod.Radar2DMeasurement(GaussRV(2, cov=RADAR_R), dim_state=5, state_index=[0, 1],
                                     radar_loc=RADAR_LOC))


def _reentry_jax(dt=0.05):
    return (jssmod.ReentryVehicle2DTransition.create(
                JGaussRV.create(5, mean=REENTRY_MEAN, cov=REENTRY_COV),
                JGaussRV.create(3, cov=REENTRY_Q), dt=dt),
            jssmod.Radar2DMeasurement.create(JGaussRV.create(2, cov=RADAR_R), dim_state=5,
                                             state_index=[0, 1], radar_loc=RADAR_LOC))


def _close(a, b, label, atol=PARITY, rtol=PARITY):
    a = a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), atol=atol, rtol=rtol, err_msg=label)


# ---------------------------------------------------------------------------
# goldens
# ---------------------------------------------------------------------------

UNGM_FILTERS = {
    "ukf": lambda d, o: stt.UnscentedKalman(d, o),
    "gpqkf": lambda d, o: stt.GaussianProcessKalman(d, o, KERN_PAR, KERN_PAR, points="ut"),
}


@pytest.mark.parametrize("name", sorted(UNGM_FILTERS))
def test_ungm_filter_and_smoother_match_goldens(goldens, name):
    g = goldens["ungm"]
    alg = UNGM_FILTERS[name](*_ungm(init_cov=1.0))
    fm, fP = alg.forward_pass(g["y"][..., 0])
    _close(fm, g[f"{name}_fm"], f"{name} filtered mean")
    _close(fP, g[f"{name}_fP"], f"{name} filtered cov")
    sm, sP = alg.backward_pass()
    _close(sm, g[f"{name}_sm"], f"{name} smoothed mean")
    _close(sP, g[f"{name}_sP"], f"{name} smoothed cov")


@pytest.mark.parametrize("name", sorted(UNGM_FILTERS))
@pytest.mark.parametrize("engine", ["dd", "auto"])
def test_ungm_fused_engine_matches_goldens(goldens, name, engine):
    """The fused engine (its plain twin on the CPU) on all three golden records."""
    g = goldens["ungm"]
    alg = UNGM_FILTERS[name](*_ungm(init_cov=1.0))
    res = alg.forward_pass_batch(np.moveaxis(g["y"], -1, 0), engine=engine)
    sm, sP = stt.gaussian_smoother(res)
    _close(res.fi_mean[0], g[f"{name}_fm"], f"{name} filtered mean")
    _close(res.fi_cov[0], g[f"{name}_fP"], f"{name} filtered cov")
    _close(sm[0], g[f"{name}_sm"], f"{name} smoothed mean")
    _close(sP[0], g[f"{name}_sP"], f"{name} smoothed cov")


def test_reentry_ukf_matches_golden(goldens):
    g = goldens["reentry"]
    fm, fP = stt.UnscentedKalman(*_reentry()).forward_pass(g["y"][..., 0])
    _close(fm, g["ukf_fm"], "reentry UKF mean", atol=1e-7, rtol=1e-6)
    _close(fP, g["ukf_fP"], "reentry UKF cov", atol=1e-7, rtol=1e-6)


# ---------------------------------------------------------------------------
# the JAX package on one shared batch
# ---------------------------------------------------------------------------

def _simulate(dyn, obs, rng, steps, mc):
    """States (M, D, N) and measurements (M, E, N) from NumPy noise pushed
    through the port's model functions, with the simulators' time stamps."""
    m0, P0 = (a.numpy() for a in dyn.init_rv.get_stats())
    x = torch.as_tensor(m0 + rng.normal(size=(mc, dyn.dim_state)) @ np.linalg.cholesky(P0).T)
    Lq = np.linalg.cholesky(dyn.noise_rv.cov.numpy())
    Lr = np.linalg.cholesky(obs.noise_rv.cov.numpy())
    xs, ys = [], []
    for k in range(steps):
        xs.append(x)
        r = torch.as_tensor(rng.normal(size=(mc, obs.dim_noise)) @ Lr.T)
        ys.append(obs.meas_fcn(obs._select(x), r, k + 1))
        x = dyn.dyn_fcn(x, torch.as_tensor(rng.normal(size=(mc, dyn.dim_noise)) @ Lq.T), k)
    return torch.stack(xs, -1).numpy(), torch.stack(ys, -1).numpy()


LANES = {
    "ungm_ukf": (_ungm, _ungm_jax, lambda d, o: stt.UnscentedKalman(d, o),
                 lambda d, o: st.UnscentedKalman(d, o)),
    "ungm_gpqkf": (_ungm, _ungm_jax,
                   lambda d, o: stt.GaussianProcessKalman(d, o, KERN_PAR, KERN_PAR),
                   lambda d, o: st.GaussianProcessKalman(d, o, KERN_PAR, KERN_PAR)),
    "reentry_ukf": (_reentry, _reentry_jax, lambda d, o: stt.UnscentedKalman(d, o),
                    lambda d, o: st.UnscentedKalman(d, o)),
}


@pytest.fixture(scope="module")
def shared_batch():
    """Per lane: data (8, E, 50) and the JAX package's filter result and
    both smoother layouts on it."""
    out = {}
    for i, (lane, (mk, mk_j, alg_t, alg_j)) in enumerate(sorted(LANES.items())):
        dyn, obs = mk()
        _, ys = _simulate(dyn, obs, np.random.default_rng(100 + i), steps=50, mc=8)
        jd, jo = mk_j()
        ja = alg_j(jd, jo)
        run = jax.jit(lambda b: st.gaussian_filter_batch(jd, jo, ja.tf_dyn, ja.tf_obs, b))
        res = run(jnp.asarray(ys))
        smooth = {full: jax.jit(jax.vmap(lambda r: st.gaussian_smoother(r, rts_full=full)))(res)
                  for full in (False, True)}
        out[lane] = (ys, res, smooth, alg_t(dyn, obs))
    return out


@pytest.mark.parametrize("lane", sorted(LANES))
def test_batch_filter_matches_jax(shared_batch, lane):
    ys, ref, _, alg = shared_batch[lane]
    res = alg.forward_pass_batch(ys)
    for f in FIELDS:
        _close(getattr(res, f), getattr(ref, f), f"{lane} {f}", atol=JAX_TOL, rtol=JAX_TOL)


@pytest.mark.parametrize("lane", sorted(LANES))
@pytest.mark.parametrize("rts_full", [False, True])
def test_batch_smoother_matches_jax(shared_batch, lane, rts_full):
    ys, _, smooth, alg = shared_batch[lane]
    sm, sP = stt.gaussian_smoother(alg.forward_pass_batch(ys), rts_full=rts_full)
    _close(sm, smooth[rts_full][0], f"{lane} smoothed mean", atol=JAX_TOL, rtol=JAX_TOL)
    _close(sP, smooth[rts_full][1], f"{lane} smoothed cov", atol=JAX_TOL, rtol=JAX_TOL)


@pytest.mark.parametrize("lane", ["ungm_ukf", "ungm_gpqkf"])
def test_fused_engine_matches_jax(shared_batch, lane):
    """``engine="dd"`` (the kernel's twin on the CPU) gives the JAX f64 moments."""
    ys, ref, _, alg = shared_batch[lane]
    res = alg.forward_pass_batch(ys, engine="dd")
    for f in FIELDS:
        _close(getattr(res, f), getattr(ref, f), f"{lane} {f}", atol=JAX_TOL, rtol=JAX_TOL)


def test_single_trajectory_equals_batch_member(shared_batch):
    ys, _, _, alg = shared_batch["reentry_ukf"]
    res = alg.forward_pass_batch(ys)
    fm, fP = alg.forward_pass(ys[3])
    torch.testing.assert_close(fm, res.fi_mean[3], atol=1e-12, rtol=1e-12)
    torch.testing.assert_close(fP, res.fi_cov[3], atol=1e-12, rtol=1e-12)


# ---------------------------------------------------------------------------
# engine selection and API contract
# ---------------------------------------------------------------------------

def test_auto_engine_falls_back_to_f64_for_vector_states(shared_batch):
    """``engine="auto"`` runs a vector-state configuration that the fused
    kernel refuses (a classical rule with dense covariance weights) through
    the eager f64 path, to the bit; the UKF it takes runs through the
    kernel's plain version, within 1e-10 of the eager path."""
    from ssmtoybox_torch.mtran import SigmaPointTransform
    ys, _, _, alg = shared_batch["reentry_ukf"]
    dense = SigmaPointTransform(alg.tf_dyn.unit_sp, alg.tf_dyn.wm, Wc_dense=alg.tf_dyn.Wc)
    refused = stt.GaussianInference(alg.mod_dyn, alg.mod_obs, dense, alg.tf_obs)
    auto, f64 = refused.forward_pass_batch(ys, engine="auto"), refused.forward_pass_batch(ys)
    for f in FIELDS:
        torch.testing.assert_close(getattr(auto, f), getattr(f64, f), atol=0, rtol=0)
    fused, f64 = alg.forward_pass_batch(ys, engine="auto"), alg.forward_pass_batch(ys)
    for f in FIELDS:
        torch.testing.assert_close(getattr(fused, f), getattr(f64, f), atol=1e-10, rtol=1e-10)


def test_dd_engine_on_vector_state_names_the_roadmap_item(shared_batch):
    """Bearings from more than 8 sensors, the one vector-state measurement
    that the fused kernels refused while ROADMAP queue 3 listed the
    difference, run through ``engine="dd"`` (the general kernel's wide form,
    its plain version here) and give the eager float64 filter's moments
    within 1e-10."""
    _, _, _, alg = shared_batch["reentry_ukf"]
    sensors = np.stack([np.linspace(6000.0, 6800.0, 9), np.linspace(-400.0, 400.0, 9)], axis=1)
    obs = ssmod.BearingMeasurement(GaussRV(9, cov=1e-3 * np.eye(9)), dim_state=5,
                                   state_index=[0, 1], sensor_pos=sensors)
    _, nine = _simulate(alg.mod_dyn, obs, np.random.default_rng(9), steps=20, mc=4)
    ukf = stt.UnscentedKalman(alg.mod_dyn, obs)
    fused, f64 = ukf.forward_pass_batch(nine, engine="dd"), ukf.forward_pass_batch(nine)
    for f in FIELDS:
        assert bool(torch.isfinite(getattr(fused, f)).all()), f
        torch.testing.assert_close(getattr(fused, f), getattr(f64, f), atol=1e-10, rtol=1e-10)


def test_dd_engine_rejects_an_unsupported_scalar_rule():
    """A 1-D rule that no fused kernel takes, dense classical covariance
    weights (GH-9, which the scalar kernel's general form runs since it took
    rules of any point count, was this case before), is refused by
    ``engine="dd"``; ``engine="auto"`` runs it in float64."""
    dyn, obs = _ungm()
    from ssmtoybox_torch.mtran import GaussHermiteTransform, SigmaPointTransform
    gh9 = GaussHermiteTransform(1, degree=9)
    dense = SigmaPointTransform(gh9.unit_sp, gh9.wm, Wc_dense=gh9.Wc)
    alg = stt.GaussianInference(dyn, obs, dense, dense)
    ys = np.zeros((2, 1, 4))
    with pytest.raises(ValueError, match="diagonal classical weights"):
        alg.forward_pass_batch(ys, engine="dd")
    auto = alg.forward_pass_batch(ys, engine="auto")
    torch.testing.assert_close(auto.fi_mean, alg.forward_pass_batch(ys).fi_mean)


def test_unknown_engine_raises():
    dyn, obs = _ungm()
    with pytest.raises(ValueError, match="engine must be"):
        stt.UnscentedKalman(dyn, obs).forward_pass_batch(np.zeros((1, 1, 3)), engine="pallas")


def test_api_shape_checks_and_flags():
    dyn, obs = _ungm()
    ukf = stt.UnscentedKalman(dyn, obs)
    with pytest.raises(RuntimeError, match="forward_pass"):
        ukf.backward_pass()
    with pytest.raises(ValueError, match="dim_y"):
        ukf.forward_pass(np.zeros((2, 5)))
    with pytest.raises(ValueError, match="num_traj"):
        ukf.forward_pass_batch(np.zeros((1, 5)))
    fm, fP = ukf.forward_pass(np.ones((1, 5)))
    assert tuple(fm.shape) == (1, 5) and tuple(fP.shape) == (1, 1, 5)
    assert ukf.get_flag("filtered") and not ukf.get_flag("smoothed")
    ukf.backward_pass()
    assert ukf.get_flag("smoothed")
    ukf.reset()
    assert ukf.fi_mean is None and not ukf.get_flag("filtered")


def test_lost_positive_definiteness_warns_and_gives_nan():
    dyn, obs = _ungm()
    ukf = stt.UnscentedKalman(dyn, obs)
    with pytest.warns(RuntimeWarning, match="positive definiteness"):
        res = stt.gaussian_filter_batch(dyn, obs, ukf.tf_dyn, ukf.tf_obs, np.ones((2, 1, 3)),
                                        init_cov=-np.ones((1, 1)))
    assert bool(torch.isnan(res.fi_cov).all())
