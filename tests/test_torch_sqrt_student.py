"""The square-root Student-t filters and smoothers of the PyTorch port
(``ssmtoybox_torch/sqrt.py``) against the JAX package's and the port's own
full Student filter, on the Student UNGM system of ``tests/test_sqrt.py``.

The same NumPy measurements go through both packages in float64: the FS
rule, GPQ on Student points and TPQ (both with the RBF-Student kernel, whose
Monte-Carlo weights the JAX package draws and the port takes over through
``BQTransform.replace``), each under both ``fixed_dof`` settings, filter and
smoother, at 1e-8 of each stream's largest entry; the FS streams at 1e-10.
Float32 against the JAX package's float32 at 1e-4 and against float64 at
rtol / atol 1e-3 (the JAX tests' bounds).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ssmtoybox_tpu as st
from ssmtoybox_tpu import sqrt as jsq
from ssmtoybox_tpu import ssmod as jssmod
from ssmtoybox_tpu.bq import transforms as jbqt
from ssmtoybox_tpu.utils import StudentRV as JStudentRV
import ssmtoybox_torch as stt
from ssmtoybox_torch import mtran, ssmod
from ssmtoybox_torch import sqrt as tsq
from ssmtoybox_torch.bq import transforms as bqt
from ssmtoybox_torch.utils import StudentRV
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


TOL = 1e-10
BQ_TOL = 1e-8
F32_JAX_TOL = 1e-4
KP = np.array([[1.0, 1.0]])
MC = dict(num_samples=20_000, num_batches=10)


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(a, b, tol, label=""):
    a, b = _np(a), _np(b)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * max(np.abs(b).max(), 1e-300),
                               err_msg=label)


def _outer(S):
    return np.einsum("...ijn,...kjn->...ikn", _np(S), _np(S))


def _vmap(fn, y):
    return jax.vmap(fn)(jnp.asarray(y))


@pytest.fixture(scope="module")
def system():
    dyn = ssmod.UNGMTransition(StudentRV(1, dof=4.0), StudentRV(1, scale=10.0, dof=4.0))
    obs = ssmod.UNGMMeasurement(StudentRV(1, scale=0.01, dof=4.0), dim_state=1)
    jdyn = jssmod.UNGMTransition.create(JStudentRV.create(1, dof=4.0),
                                        JStudentRV.create(1, scale=10.0, dof=4.0))
    jobs = jssmod.UNGMMeasurement.create(JStudentRV.create(1, scale=0.01, dof=4.0), dim_state=1)
    gen = torch.Generator().manual_seed(2)
    x = dyn.simulate_discrete(gen, steps=30, mc_sims=3)
    y = obs.simulate_measurements(gen, x).permute(2, 0, 1).numpy()
    return dyn, obs, jdyn, jobs, y


def _carried(tf, jtf):
    """The port's transform with the JAX transform's weights."""
    return tf.replace(points=np.asarray(jtf.model.points), wm=np.asarray(jtf.wm),
                      Wc=np.asarray(jtf.Wc), Wcc=np.asarray(jtf.Wcc),
                      model_var=np.asarray(jtf.model_var), iK=np.asarray(jtf.iK))


@pytest.fixture(scope="module")
def transforms():
    """kind -> (port transform, JAX transform), one pair serving both models."""
    fs = (mtran.FullySymmetricStudentTransform(1, 3, None, 4.0),
          st.FullySymmetricStudentTransform(1, 3, None, 4.0))
    args = (1, 1, KP, "rbf-student", "fs", dict(dof=4.0))
    jgp = jbqt.GaussianProcessTransform.create(*args, **MC)
    gp = _carried(bqt.GaussianProcessTransform(*args, num_samples=2000, num_batches=2), jgp)
    jtp = jbqt.StudentTProcessTransform.create(*args, nu=4.0, mc_opts=MC)
    tp = _carried(bqt.StudentTProcessTransform(*args, nu=4.0, mc_opts=dict(num_samples=2000,
                                                                           num_batches=2)), jtp)
    return {"fs": fs, "gpq": (gp, jgp), "tpq": (tp, jtp)}


@pytest.mark.parametrize("fixed_dof", [True, False])
@pytest.mark.parametrize("kind", ["fs", "gpq", "tpq"])
def test_filter_and_smoother_match_jax(system, transforms, kind, fixed_dof):
    dyn, obs, jdyn, jobs, y = system
    tf, jtf = transforms[kind]
    tol = TOL if kind == "fs" else BQ_TOL
    res, sm_m, sm_S = tsq.make_sqrt_studentian_smoother(dyn, obs, tf, tf,
                                                        fixed_dof=fixed_dof)(y)
    ref, jm, jS = _vmap(jsq.make_sqrt_studentian_smoother(jdyn, jobs, jtf, jtf,
                                                          fixed_dof=fixed_dof), y)
    assert bool(torch.isfinite(sm_m).all())
    for f in res.__dataclass_fields__:
        _close(getattr(res, f), getattr(ref, f), tol, f)
    _close(sm_m, jm, tol, "smoothed mean")
    _close(sm_S, jS, tol, "smoothed factor")
    filt = tsq.make_sqrt_studentian_filter(dyn, obs, tf, tf, fixed_dof=fixed_dof)(y)
    for f in res.__dataclass_fields__:
        _close(getattr(filt, f), getattr(res, f), tol, f"filter {f}")
    # the full Student filter: the same scale matrices, the same "covariance"
    full = stt.studentian_filter_batch(dyn, obs, tf, tf, y, fixed_dof=fixed_dof)
    _close(filt.fi_mean, full.fi_mean, tol, "mean vs full")
    _close(_outer(filt.fi_smat_sqrt), full.fi_smat, tol, "scale vs full")
    _close(_outer(filt.fi_cov_sqrt), full.fi_cov, tol, "covariance vs full")
    _close(_outer(filt.pr_smat_sqrt), full.pr_smat, tol, "predicted scale vs full")
    assert torch.equal(filt.dof_fi, full.dof_fi)
    sm_full, sS_full = stt.studentian_smoother(full, rts_full=True)
    _close(sm_m, sm_full, tol, "smoothed mean vs full")
    _close(_outer(sm_S), sS_full, tol, "smoothed scale vs full")


def test_nonadditive_measurement_matches_jax():
    """Non-additive measurement noise, FS degree 5 (the degree-3 rule gives
    the bilinear UNGM-NA measurement a zero gain)."""
    dyn = ssmod.UNGMTransition(StudentRV(1, mean=2.0, scale=1.0, dof=4.0),
                               StudentRV(1, scale=1.0, dof=4.0))
    obs = ssmod.UNGMNAMeasurement(StudentRV(1, scale=1.0, dof=4.0), dim_state=1)
    jdyn = jssmod.UNGMTransition.create(
        JStudentRV.create(1, mean=jnp.array([2.0]), scale=1.0, dof=4.0),
        JStudentRV.create(1, scale=1.0, dof=4.0))
    jobs = jssmod.UNGMNAMeasurement.create(JStudentRV.create(1, scale=1.0, dof=4.0),
                                           dim_state=1)
    gen = torch.Generator().manual_seed(3)
    x = dyn.simulate_discrete(gen, steps=25, mc_sims=2)
    y = obs.simulate_measurements(gen, x).permute(2, 0, 1).numpy()
    td, to = (mtran.FullySymmetricStudentTransform(d, 5, None, 4.0) for d in (1, 2))
    jtd, jto = (st.FullySymmetricStudentTransform(d, 5, None, 4.0) for d in (1, 2))
    res = tsq.make_sqrt_studentian_filter(dyn, obs, td, to)(y)
    ref = _vmap(jsq.make_sqrt_studentian_filter(jdyn, jobs, jtd, jto), y)
    for f in res.__dataclass_fields__:
        _close(getattr(res, f), getattr(ref, f), TOL, f)


def test_float32_matches_jax_float32_and_float64(system, transforms):
    dyn, obs, jdyn, jobs, y = system
    for kind in ("fs", "tpq"):
        tf, jtf = transforms[kind]
        _, m32, S32 = tsq.make_sqrt_studentian_smoother(dyn, obs, tf, tf,
                                                        dtype=torch.float32)(y)
        _, m64, _ = tsq.make_sqrt_studentian_smoother(dyn, obs, tf, tf)(y)
        assert m32.dtype == S32.dtype == torch.float32
        assert bool(torch.isfinite(S32).all()) and bool((torch.diagonal(S32, 0, -3, -2) > 0).all())
        np.testing.assert_allclose(_np(m32), _np(m64), rtol=1e-3, atol=1e-3, err_msg=kind)
        res = tsq.make_sqrt_studentian_filter(dyn, obs, tf, tf, dtype=torch.float32)(y)
        ref = _vmap(jsq.make_sqrt_studentian_filter(jdyn, jobs, jtf, jtf, dtype=jnp.float32), y)
        _close(res.fi_mean, ref.fi_mean, F32_JAX_TOL, kind)
        _close(res.fi_smat_sqrt, ref.fi_smat_sqrt, F32_JAX_TOL, kind)


def test_streaming_matches_jax_and_the_offline_filter(system, transforms):
    dyn, obs, jdyn, jobs, y = system
    tf, jtf = transforms["fs"]
    off = tsq.make_sqrt_studentian_filter(dyn, obs, tf, tf)(y)
    init, step = tsq.make_online_sqrt_student_filter(dyn, obs, tf, tf, batch=True)
    jinit, jstep = jsq.make_online_sqrt_student_filter(jdyn, jobs, jtf, jtf, batch=True)
    s, js = init(batch_size=3), jinit(batch_size=3)
    for k in range(y.shape[-1]):
        observed = np.array([True, k % 4 != 3, True])
        s, info = step(s, y[..., k], observed=torch.as_tensor(observed))
        js, jinfo = jstep(js, jnp.asarray(y[..., k]), observed=jnp.asarray(observed))
    for f in ("mean", "sqrt", "dof"):
        _close(getattr(s, f), getattr(js, f), TOL, f)
    _close(info.innov_sqrt, jinfo.innov_sqrt, TOL)
    _close(s.mean[0], off.fi_mean[0, :, -1], TOL, "observed stream vs offline")
    _close(s.sqrt[0], off.fi_smat_sqrt[0, ..., -1], TOL)
    assert float(s.dof[0]) == float(off.dof_fi[0, -1]) > float(s.dof[1])


@pytest.mark.parametrize("kind", ["fs", "tpq"])
def test_fixed_lag_smoother_matches_jax_and_the_offline_smoother(system, transforms, kind):
    dyn, obs, jdyn, jobs, y = system
    tf, jtf = transforms[kind]
    tol = TOL if kind == "fs" else BQ_TOL
    lag, steps = 4, 10
    smooth = tsq.make_sqrt_studentian_smoother(dyn, obs, tf, tf)
    init, step = tsq.make_fixed_lag_sqrt_student_smoother(dyn, obs, tf, tf, lag=lag,
                                                          batch=True, donate=False)
    jinit, jstep = jsq.make_fixed_lag_sqrt_student_smoother(jdyn, jobs, jtf, jtf, lag=lag,
                                                            batch=True)
    s, js = init(batch_size=3), jinit(batch_size=3)
    for n in range(1, steps + 1):
        s, _, (sm_m, sm_S) = step(s, y[..., n - 1])
        js, _, (jm, jS) = jstep(js, jnp.asarray(y[..., n - 1]))
        _close(sm_m, jm, tol, f"n={n}")
        _close(sm_S, jS, tol, f"n={n}")
        if n >= lag:
            _, m_all, S_all = smooth(y[..., :n])
            _close(sm_m, m_all[..., n - lag], TOL, f"n={n} vs offline")
            _close(_outer(sm_S[..., None]), _outer(S_all[..., n - lag, None]), TOL)


def test_class_api_matches_jax(system):
    dyn, obs, jdyn, jobs, y = system
    alg = stt.SquareRootStudent(dyn, obs, degree=3, dof=4.0)
    jalg = jsq.SquareRootStudent(jdyn, jobs, degree=3, dof=4.0)
    fm, fc = alg.forward_pass(y[0])
    jfm, jfc = jalg.forward_pass(jnp.asarray(y[0]))
    _close(fm, jfm, TOL)
    _close(fc, jfc, TOL)
    bm, bc = alg.forward_pass_batch(y)
    _close(bm[0], fm, 1e-12)
    _close(bc[0], fc, 1e-12)
    sm, sS = alg.smooth(y[1])
    jsm, jsS = jalg.smooth(jnp.asarray(y[1]))
    _close(sm, jsm, TOL)
    _close(sS, jsS, TOL)
    alg.reset()
    assert alg._result is None
