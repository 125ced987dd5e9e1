"""The square-root Gaussian filters and smoothers of the PyTorch port
(``ssmtoybox_torch/sqrt.py``) and their linalg helpers, against the JAX
package's ``ssmtoybox_tpu/sqrt.py`` and the port's own full-covariance
filters.

The same NumPy inputs (measurements simulated by the port on the CPU from a
seed) go through both packages, float64 on both sides.  Tolerances, relative
to each stream's largest entry: ``tria`` and ``cholupdate_small`` 1e-13 (a
zero weight returns the factor's bits); the classical filters, smoothers and
streams 1e-10; the BQ ones 1e-8 (the port builds its own weights); float32
against float64 at the JAX package's bounds (1e-2 relative on reentry, 1e-3
on UNGM BQ) and against the JAX package's float32 path at 1e-4 (sums in
another order, and the port evaluates the models in float64, each rounding
of float32 amplified by the recursion).
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
from ssmtoybox_tpu.utils import GaussRV as JGaussRV
from ssmtoybox_tpu.utils import StudentRV as JStudentRV
from ssmtoybox_tpu.utils.linalg import cholupdate_small as jcholupdate
from ssmtoybox_tpu.utils.linalg import tria as jtria
import ssmtoybox_torch as stt
from ssmtoybox_torch import mtran, ssmod
from ssmtoybox_torch import sqrt as tsq
from ssmtoybox_torch.bq import transforms as bqt
from ssmtoybox_torch.utils import GaussRV, StudentRV
from ssmtoybox_torch.utils.linalg import cholupdate_small, tria
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
KP = np.array([[1.0, 3.0]])
RE_M0 = np.array([6500.4, 349.14, -1.8093, -6.7967, 0.6932])
RE_P0 = np.diag([1e-6, 1e-6, 1e-6, 1e-6, 1.0])
RE_Q = np.diag([2.4064e-5, 2.4064e-5, 1e-6])
RE_R = np.diag([1e-6, 0.17e-6])


def _np(t):
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(a, b, tol, label=""):
    """``|a - b| <= tol (|b| + max |b|)``."""
    a, b = _np(a), _np(b)
    np.testing.assert_allclose(a, b, rtol=tol, atol=tol * max(np.abs(b).max(), 1e-300),
                               err_msg=label)


def _outer(S):
    return np.einsum("...ijn,...kjn->...ikn", _np(S), _np(S))


def _vmap(fn, y):
    """A JAX single-record function over a batch (M, dim_y, N)."""
    return jax.vmap(fn)(jnp.asarray(y))


def _simulate(dyn, obs, steps, mc, seed):
    gen = torch.Generator().manual_seed(seed)
    x = dyn.simulate_discrete(gen, steps=steps, mc_sims=mc)
    return obs.simulate_measurements(gen, x).permute(2, 0, 1).numpy()      # (M, dim_y, N)


@pytest.fixture(scope="module")
def ungm():
    dyn = ssmod.UNGMTransition(GaussRV(1, cov=1.0), GaussRV(1, cov=10.0))
    obs = ssmod.UNGMMeasurement(GaussRV(1, cov=1.0), dim_state=1)
    jdyn = jssmod.UNGMTransition.create(JGaussRV.create(1, cov=1.0), JGaussRV.create(1, cov=10.0))
    jobs = jssmod.UNGMMeasurement.create(JGaussRV.create(1, cov=1.0), dim_state=1)
    return dyn, obs, jdyn, jobs, _simulate(dyn, obs, 30, 3, 0)


@pytest.fixture(scope="module")
def reentry():
    dyn = ssmod.ReentryVehicle2DTransition(GaussRV(5, mean=RE_M0, cov=RE_P0),
                                           GaussRV(3, cov=RE_Q), dt=0.1)
    obs = ssmod.Radar2DMeasurement(GaussRV(2, cov=RE_R), dim_state=5)
    jdyn = jssmod.ReentryVehicle2DTransition.create(
        JGaussRV.create(5, mean=jnp.asarray(RE_M0), cov=jnp.asarray(RE_P0)),
        JGaussRV.create(3, cov=jnp.asarray(RE_Q)), dt=0.1)
    jobs = jssmod.Radar2DMeasurement.create(JGaussRV.create(2, cov=jnp.asarray(RE_R)),
                                            dim_state=5)
    return dyn, obs, jdyn, jobs, _simulate(dyn, obs, 30, 2, 1)


# ---------------------------------------------------------------------------
# linalg helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("d", range(1, 7))
def test_tria_matches_jax(d):
    cols = np.random.default_rng(d).normal(size=(4, d, 2 * d + 1))
    got = tria(torch.as_tensor(cols))
    _close(got, jtria(jnp.asarray(cols)), 1e-13, f"D={d}")
    assert bool((torch.diagonal(got, dim1=-2, dim2=-1) > 0).all())
    _close(got @ got.mT, cols @ cols.swapaxes(-1, -2), 1e-13, "L L^T")


@pytest.mark.parametrize("w", [0.7, -0.5, 0.0])
@pytest.mark.parametrize("d", range(1, 7))
def test_cholupdate_matches_jax(d, w):
    rng = np.random.default_rng(10 + d)
    A = rng.normal(size=(4, d, d + 3))
    L = np.linalg.cholesky(A @ A.swapaxes(-1, -2) + np.eye(d))
    v = 0.3 * rng.normal(size=(4, d))
    got = cholupdate_small(torch.as_tensor(L), torch.as_tensor(v), w)
    want = jcholupdate(jnp.asarray(L), jnp.asarray(v), w)
    _close(got, want, 1e-13, f"D={d} w={w}")
    _close(got @ got.mT, L @ L.swapaxes(-1, -2) + w * v[..., :, None] * v[..., None, :], 1e-13)
    if w == 0.0:
        assert torch.equal(got, torch.as_tensor(L)) and np.array_equal(_np(got), _np(want))


def test_cholupdate_takes_a_weight_for_each_batch_member():
    rng = np.random.default_rng(3)
    A = rng.normal(size=(5, 4, 7))
    L = np.linalg.cholesky(A @ A.swapaxes(-1, -2) + np.eye(4))
    v, w = 0.3 * rng.normal(size=(5, 4)), np.array([0.5, -0.4, 0.0, 1.2, -0.1])
    got = cholupdate_small(torch.as_tensor(L), torch.as_tensor(v), torch.as_tensor(w))
    _close(got, jax.vmap(jcholupdate)(jnp.asarray(L), jnp.asarray(v), jnp.asarray(w)), 1e-13)
    assert torch.equal(got[2], torch.as_tensor(L[2]))


# ---------------------------------------------------------------------------
# filters and smoothers
# ---------------------------------------------------------------------------

#: (system, rule, point_hyp): the FS rule at a large dof (at dof 4 it
#: reconstructs twice the covariance and the Gaussian recursion of both
#: packages loses definiteness at step 2); the UT with kappa = -2, beta = 0
#: has a negative covariance weight (a downdate in every factorization; its
#: joint smoothing factor, and a negative weight on UNGM, lose definiteness
#: in both packages and in the full-covariance recursion)
CLASSICAL = [("ungm", "sr", None), ("ungm", "ut", None), ("ungm", "gh", {"degree": 5}),
             ("ungm", "fs", {"dof": 1000.0}), ("reentry", "sr", None),
             ("reentry", "ut", {"kappa": -2.0, "beta": 0.0})]


def _system(request, name):
    return request.getfixturevalue(name)


@pytest.mark.parametrize("system,points,hyp", CLASSICAL)
def test_filter_matches_jax_and_the_full_covariance_filter(request, system, points, hyp):
    dyn, obs, jdyn, jobs, y = _system(request, system)
    alg = stt.SquareRootKalman(dyn, obs, points=points, point_hyp=hyp)
    jalg = jsq.SquareRootKalman(jdyn, jobs, points=points, point_hyp=hyp)
    res, ref = alg._filter(y), _vmap(jalg._filter, y)
    assert tuple(res.fi_sqrt.shape) == (y.shape[0],) + ref.fi_sqrt.shape[1:]
    for f in res.__dataclass_fields__:
        _close(getattr(res, f), getattr(ref, f), TOL, f)
    full = stt.gaussian_filter(dyn, obs, alg.tf_dyn, alg.tf_obs, y)
    _close(res.fi_mean, full.fi_mean, TOL, "mean vs full")
    _close(_outer(res.fi_sqrt), full.fi_cov, TOL, "cov vs full")
    _close(_outer(res.pr_sqrt), full.pr_cov, TOL, "predicted cov vs full")
    fm, fP = alg.forward_pass(y[1])
    _close(fm, res.fi_mean[1], 1e-12, "record vs batch member")
    _close(fP, _outer(res.fi_sqrt)[1], 1e-12)


@pytest.mark.parametrize("system,points,hyp", [("ungm", "ut", None), ("ungm", "gh", None),
                                               ("reentry", "ut", None)])
def test_smoother_matches_jax_and_the_textbook_rts(request, system, points, hyp):
    dyn, obs, jdyn, jobs, y = _system(request, system)
    alg = stt.SquareRootKalman(dyn, obs, points=points, point_hyp=hyp)
    jalg = jsq.SquareRootKalman(jdyn, jobs, points=points, point_hyp=hyp)
    res, sm_m, sm_S = tsq.make_sqrt_smoother(dyn, obs, alg.tf_dyn, alg.tf_obs)(y)
    ref, jm, jS = _vmap(jsq.make_sqrt_smoother(jdyn, jobs, jalg.tf_dyn, jalg.tf_obs), y)
    for f in res.__dataclass_fields__:
        _close(getattr(res, f), getattr(ref, f), TOL, f)
    _close(sm_m, jm, TOL, "smoothed mean")
    _close(sm_S, jS, TOL, "smoothed factor")
    filt = alg._filter(y)
    for f in res.__dataclass_fields__:          # the embedded forward pass is the filter
        assert torch.equal(getattr(res, f), getattr(filt, f)), f
    full = stt.gaussian_filter(dyn, obs, alg.tf_dyn, alg.tf_obs, y)
    sm_full, sP_full = stt.gaussian_smoother(full, rts_full=True)
    _close(sm_m, sm_full, TOL, "mean vs full RTS")
    _close(_outer(sm_S), sP_full, TOL, "cov vs full RTS")
    m1, P1 = alg.smooth(y[0])
    _close(m1, sm_m[0], 1e-12, "class smooth")
    _close(P1, _outer(sm_S)[0], 1e-12)


def _bq_pair(kind, dim_in, dim_out, kp):
    """The port's and the JAX package's transform of one kind, each built
    from its own closed-form weights."""
    if kind == "gpq":
        return (bqt.GaussianProcessTransform(dim_in, dim_out, kp, point_str="ut"),
                jbqt.GaussianProcessTransform.create(dim_in, dim_out, kp, point_str="ut"))
    if kind == "bsq":
        return (bqt.BayesSardTransform(dim_in, dim_out, kp, multi_ind=2, point_str="ut"),
                jbqt.BayesSardTransform.create(dim_in, dim_out, kp, multi_ind=2,
                                               point_str="ut"))
    return (bqt.StudentTProcessTransform(dim_in, dim_out, kp, point_str="ut"),
            jbqt.StudentTProcessTransform.create(dim_in, dim_out, kp, point_str="ut"))


@pytest.mark.parametrize("kind", ["gpq", "bsq", "tpq"])
def test_bq_filter_and_smoother_match_jax(ungm, kind):
    dyn, obs, jdyn, jobs, y = ungm
    tf, jtf = _bq_pair(kind, 1, 1, KP)
    res, sm_m, sm_S = tsq.make_sqrt_smoother(dyn, obs, tf, tf)(y)
    ref, jm, jS = _vmap(jsq.make_sqrt_smoother(jdyn, jobs, jtf, jtf), y)
    for f in res.__dataclass_fields__:
        _close(getattr(res, f), getattr(ref, f), BQ_TOL, f)
    _close(sm_m, jm, BQ_TOL, "smoothed mean")
    _close(sm_S, jS, BQ_TOL, "smoothed factor")
    filt = tsq.make_sqrt_filter(dyn, obs, tf, tf)(y)     # S_pr from its own QR here
    for f in res.__dataclass_fields__:
        _close(getattr(filt, f), getattr(res, f), BQ_TOL, f"filter {f}")
    full = stt.gaussian_filter(dyn, obs, tf, tf, y)
    sm_full, sP_full = stt.gaussian_smoother(full, rts_full=True)
    _close(res.fi_mean, full.fi_mean, BQ_TOL, "mean vs full")
    _close(_outer(res.fi_sqrt), full.fi_cov, BQ_TOL, "cov vs full")
    _close(sm_m, sm_full, BQ_TOL, "smoothed mean vs full")
    _close(_outer(sm_S), sP_full, BQ_TOL, "smoothed cov vs full")


@pytest.mark.parametrize("rule", ["ut", "gpq"])
def test_ungm_na_matches_jax(rule):
    """Non-additive noise on both models: the augmented factor, the jitter
    columns and (GPQ) the cross weights trimmed to the state."""
    dyn = ssmod.UNGMNATransition(GaussRV(1, mean=2.0, cov=1.0), GaussRV(1, cov=1.0))
    obs = ssmod.UNGMNAMeasurement(GaussRV(1, cov=1.0), dim_state=1)
    jdyn = jssmod.UNGMNATransition.create(JGaussRV.create(1, mean=jnp.array([2.0]), cov=1.0),
                                          JGaussRV.create(1, cov=1.0))
    jobs = jssmod.UNGMNAMeasurement.create(JGaussRV.create(1, cov=1.0), dim_state=1)
    y = _simulate(dyn, obs, 25, 2, 4)
    if rule == "ut":
        tf, jtf = mtran.UnscentedTransform(2), st.UnscentedTransform(2)
    else:
        tf, jtf = _bq_pair("gpq", 2, 1, np.array([[1.0, 3.0, 3.0]]))
    res, sm_m, sm_S = tsq.make_sqrt_smoother(dyn, obs, tf, tf)(y)
    ref, jm, jS = _vmap(jsq.make_sqrt_smoother(jdyn, jobs, jtf, jtf), y)
    tol = TOL if rule == "ut" else BQ_TOL
    for f in res.__dataclass_fields__:
        _close(getattr(res, f), getattr(ref, f), tol, f)
    _close(sm_m, jm, tol, "smoothed mean")
    _close(sm_S, jS, tol, "smoothed factor")


def test_float32_matches_jax_float32_and_float64(ungm):
    """Float32 SR-UKF on the reentry system of ``chip_smoke.py`` (dt 0.05,
    the radar at (6374, 0); 100 runs x 100 steps): means within the JAX
    tests' 1e-2 of the float64 lane's largest entry and within 1e-4 of the
    JAX package's float32 means.  Float32 moves this lane's RMSE by a few
    percent in both packages (the ballistic coefficient is read from
    accelerations near float32's resolution of the 6,500 km position): the
    port's gap is no larger than 1.25 times the JAX package's."""
    m0 = np.array([6500.4, 349.14, -1.8093, -6.7967, 0.6932])
    R, loc = np.diag([1e-3, 1e-5]), np.array([6374.0, 0.0])
    dyn = ssmod.ReentryVehicle2DTransition(GaussRV(5, mean=m0, cov=RE_P0), GaussRV(3, cov=RE_Q),
                                           dt=0.05)
    obs = ssmod.Radar2DMeasurement(GaussRV(2, cov=R), dim_state=5, state_index=[0, 1],
                                   radar_loc=loc)
    jdyn = jssmod.ReentryVehicle2DTransition.create(
        JGaussRV.create(5, mean=jnp.asarray(m0), cov=jnp.asarray(RE_P0)),
        JGaussRV.create(3, cov=jnp.asarray(RE_Q)), dt=0.05)
    jobs = jssmod.Radar2DMeasurement.create(JGaussRV.create(2, cov=jnp.asarray(R)), dim_state=5,
                                            state_index=[0, 1], radar_loc=jnp.asarray(loc))
    gen = torch.Generator().manual_seed(0)
    x = dyn.simulate_discrete(gen, steps=100, mc_sims=100)
    xs, y = x.permute(2, 0, 1), obs.simulate_measurements(gen, x).permute(2, 0, 1).numpy()
    alg = stt.SquareRootKalman(dyn, obs)
    jalg = jsq.SquareRootKalman(jdyn, jobs)
    m64 = alg._filter(y).fi_mean
    res = tsq.make_sqrt_filter(dyn, obs, alg.tf_dyn, alg.tf_obs, dtype=torch.float32)(y)
    assert res.fi_mean.dtype == torch.float32 and bool(torch.isfinite(res.fi_mean).all())
    assert bool((torch.diagonal(res.fi_sqrt, dim1=-3, dim2=-2) > 0).all())
    _close(res.fi_mean, m64, 1e-2, "float32 vs float64")
    jm = {dt: _vmap(jsq.make_sqrt_filter(jdyn, jobs, jalg.tf_dyn, jalg.tf_obs, dtype=dt), y).fi_mean
          for dt in (None, jnp.float32)}
    _close(res.fi_mean, jm[jnp.float32], F32_JAX_TOL, "float32 vs the JAX package's float32")
    rmse = lambda m: float(np.sqrt(((_np(m).astype(np.float64) - _np(xs)) ** 2).sum(1).mean()))
    gap = abs(rmse(res.fi_mean) - rmse(m64)) / rmse(m64)
    jgap = abs(rmse(jm[jnp.float32]) - rmse(jm[None])) / rmse(jm[None])
    assert jgap > 0.01 and gap <= 1.25 * jgap, (gap, jgap)
    # the BQ smoother in float32 against float64 (UNGM GPQ)
    dyn, obs, _, _, y = ungm
    tf, _ = _bq_pair("gpq", 1, 1, KP)
    _, m64, S64 = tsq.make_sqrt_smoother(dyn, obs, tf, tf)(y)
    _, m32, S32 = tsq.make_sqrt_smoother(dyn, obs, tf, tf, dtype=torch.float32)(y)
    assert m32.dtype == torch.float32 and bool((torch.diagonal(S32, 0, -3, -2) > 0).all())
    np.testing.assert_allclose(_np(m32), _np(m64), rtol=1e-3, atol=1e-3)


def test_float32_products_do_not_take_tf32(ungm):
    """The library runs float32 products without TF32 whatever the process's
    switch, and leaves the switch as it found it."""
    dyn, obs, _, _, y = ungm
    seen = []
    f = dyn.dyn_eval

    def spy(x, time):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return f(x, time)

    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        dyn.dyn_eval = spy
        stt.SquareRootKalman(dyn, obs, dtype=torch.float32).forward_pass(y[0, :, :3])
        assert seen and not any(seen)
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        del dyn.dyn_eval
        torch.backends.cuda.matmul.allow_tf32 = before


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------

def test_online_filter_matches_jax_and_the_offline_filter(ungm):
    dyn, obs, jdyn, jobs, y = ungm
    alg = stt.SquareRootKalman(dyn, obs)
    jalg = jsq.SquareRootKalman(jdyn, jobs)
    off = alg._filter(y)
    init, step = tsq.make_online_sqrt_filter(dyn, obs, alg.tf_dyn, alg.tf_obs, batch=True)
    jinit, jstep = jsq.make_online_sqrt_filter(jdyn, jobs, jalg.tf_dyn, jalg.tf_obs, batch=True)
    s, js = init(batch_size=y.shape[0]), jinit(batch_size=y.shape[0])
    observed = np.ones(y.shape[0], bool)
    for k in range(y.shape[-1]):
        observed[:] = True
        observed[k % y.shape[0]] = k % 5 != 4          # one target drops every fifth step
        s, info = step(s, y[..., k], observed=torch.as_tensor(observed))
        js, jinfo = jstep(js, jnp.asarray(y[..., k]), observed=jnp.asarray(observed))
        if k < 4:
            _close(s.mean, off.fi_mean[..., k], TOL, f"online vs offline, step {k + 1}")
            _close(s.sqrt, off.fi_sqrt[..., k], TOL)
    _close(s.mean, js.mean, TOL, "mean vs JAX")
    _close(s.sqrt, js.sqrt, TOL, "factor vs JAX")
    _close(info.innov_sqrt, jinfo.innov_sqrt, TOL, "innovation factor vs JAX")
    assert int(s.step[0]) == y.shape[-1] + 1
    # unbatched, without donation: the state passed in is left as it was
    init, step = tsq.make_online_sqrt_filter(dyn, obs, alg.tf_dyn, alg.tf_obs, donate=False)
    s0 = init()
    s1, _ = step(s0, y[0, :, 0])
    assert torch.equal(s0.sqrt, off.fi_sqrt.new_tensor([[1.0]])) and int(s0.step) == 1
    _close(s1.mean, off.fi_mean[0, :, 0], TOL)


def test_fixed_lag_smoother_matches_jax_and_the_offline_smoother(ungm):
    dyn, obs, jdyn, jobs, y = ungm
    tf, jtf = _bq_pair("gpq", 1, 1, KP)
    alg = stt.SquareRootKalman(dyn, obs)
    jalg = jsq.SquareRootKalman(jdyn, jobs)
    lag, steps = 4, 12
    smooth = tsq.make_sqrt_smoother(dyn, obs, alg.tf_dyn, alg.tf_obs)
    init, step = tsq.make_fixed_lag_sqrt_smoother(dyn, obs, alg.tf_dyn, alg.tf_obs, lag=lag,
                                                  batch=True)
    jinit, jstep = jsq.make_fixed_lag_sqrt_smoother(jdyn, jobs, jalg.tf_dyn, jalg.tf_obs,
                                                    lag=lag, batch=True)
    s, js = init(batch_size=y.shape[0]), jinit(batch_size=y.shape[0])
    for n in range(1, steps + 1):
        s, _, (sm_m, sm_S) = step(s, y[..., n - 1])
        js, _, (jm, jS) = jstep(js, jnp.asarray(y[..., n - 1]))
        _close(sm_m, jm, TOL, f"n={n} mean vs JAX")
        _close(sm_S, jS, TOL, f"n={n} factor vs JAX")
        if n >= lag:
            _, m_all, S_all = smooth(y[..., :n])
            _close(sm_m, m_all[..., n - lag], TOL, f"n={n} vs offline")
            _close(sm_S, S_all[..., n - lag], TOL, f"n={n} vs offline")
    # BQ dynamics, one stream, against the offline BQ smoother
    _, m_all, S_all = tsq.make_sqrt_smoother(dyn, obs, tf, tf)(y[0, :, :6])
    init, step = tsq.make_fixed_lag_sqrt_smoother(dyn, obs, tf, tf, lag=3)
    s = init()
    for n in range(1, 7):
        s, _, (sm_m, sm_S) = step(s, y[0, :, n - 1])
    _, m_cut, S_cut = tsq.make_sqrt_smoother(dyn, obs, tf, tf)(y[0, :, :6])
    _close(sm_m, m_cut[..., 3], TOL)
    _close(sm_S, S_cut[..., 3], TOL)


# ---------------------------------------------------------------------------
# refusals, exports
# ---------------------------------------------------------------------------

def _ungm_pair():
    dyn = ssmod.UNGMTransition(GaussRV(1, cov=1.0), GaussRV(1, cov=10.0))
    obs = ssmod.UNGMMeasurement(GaussRV(1, cov=1.0), dim_state=1)
    jdyn = jssmod.UNGMTransition.create(JGaussRV.create(1, cov=1.0), JGaussRV.create(1, cov=10.0))
    jobs = jssmod.UNGMMeasurement.create(JGaussRV.create(1, cov=1.0), dim_state=1)
    return (dyn, obs), (jdyn, jobs)


def _student_pair():
    dyn = ssmod.UNGMTransition(StudentRV(1, dof=4.0), StudentRV(1, scale=10.0, dof=4.0))
    obs = ssmod.UNGMMeasurement(StudentRV(1, scale=0.01, dof=4.0), dim_state=1)
    jdyn = jssmod.UNGMTransition.create(JStudentRV.create(1, dof=4.0),
                                        JStudentRV.create(1, scale=10.0, dof=4.0))
    jobs = jssmod.UNGMMeasurement.create(JStudentRV.create(1, scale=0.01, dof=4.0), dim_state=1)
    return (dyn, obs), (jdyn, jobs)


def _dense_wc(pkg, dyn, obs):
    ut = mtran.UnscentedTransform(1) if pkg is tsq else st.UnscentedTransform(1)
    W = np.diag(_np(ut.wc_diag))
    W[0, 1] = W[1, 0] = 1e-3
    tf = (mtran.SigmaPointTransform(_np(ut.unit_sp), _np(ut.wm), Wc_dense=W) if pkg is tsq
          else st.SigmaPointTransform(unit_sp=ut.unit_sp, wm=ut.wm, Wc_dense=jnp.asarray(W)))
    return pkg.make_sqrt_filter(dyn, obs, tf, tf)


def _mo(pkg, dyn, obs):
    tf = (bqt.MultiOutputGaussianProcessTransform(1, 1, KP) if pkg is tsq
          else jbqt.MultiOutputGaussianProcessTransform.create(1, 1, KP))
    return pkg.make_sqrt_filter(dyn, obs, tf, tf)


def _rq(pkg, dyn, obs):
    par = np.array([[1.0, 2.0, 1.0]])
    tf = (bqt.GaussianProcessTransform(1, 1, par, "rq") if pkg is tsq
          else jbqt.GaussianProcessTransform.create(1, 1, par, "rq"))
    pkg.make_sqrt_filter(dyn, obs, tf, tf)                  # an RQ kernel filters
    return pkg.make_sqrt_smoother(dyn, obs, tf, tf)


def _fs_smooth(pkg, dyn, obs):
    fs = (mtran.FullySymmetricStudentTransform(1) if pkg is tsq
          else st.FullySymmetricStudentTransform(1))
    return pkg.make_sqrt_smoother(dyn, obs, fs, fs)


def _student_kernel(pkg, dyn, obs):
    args = (1, 1, np.array([[1.0, 1.0]]), "rbf-student", "fs", dict(dof=4.0))
    tf = (bqt.GaussianProcessTransform(*args, num_samples=2000, num_batches=2) if pkg is tsq
          else jbqt.GaussianProcessTransform.create(*args, num_samples=2000, num_batches=2))
    return pkg.make_sqrt_smoother(dyn, obs, tf, tf)


def _ut(pkg):
    return mtran.UnscentedTransform(1) if pkg is tsq else st.UnscentedTransform(1)


def _fs4(pkg):
    return (mtran.FullySymmetricStudentTransform(1, 3, None, 4.0) if pkg is tsq
            else st.FullySymmetricStudentTransform(1, 3, None, 4.0))


def _shape(method, data):
    return lambda pkg, dyn, obs: getattr(pkg.SquareRootKalman(dyn, obs), method)(data)


#: label -> (system, call(pkg, dyn, obs)): each must raise in both packages,
#: the same exception type
REFUSALS = {
    "non-diagonal Wc": ("gauss", _dense_wc),
    "multi-output transform": ("gauss", _mo),
    "RQ kernel smoothing": ("gauss", _rq),
    "FS rule, Gaussian smoothing": ("gauss", _fs_smooth),
    "kappa > 1, Gaussian smoothing": ("gauss", _student_kernel),
    "scale*c > 1": ("student", lambda pkg, dyn, obs: pkg.make_sqrt_studentian_smoother(
        dyn, obs, _fs4(pkg), _fs4(pkg), dof=6.0, fixed_dof=False)),
    "lag < 2": ("gauss", lambda pkg, dyn, obs: pkg.make_fixed_lag_sqrt_smoother(
        dyn, obs, _ut(pkg), _ut(pkg), lag=1)),
    "Student lag < 2": ("student", lambda pkg, dyn, obs: pkg.make_fixed_lag_sqrt_student_smoother(
        dyn, obs, _fs4(pkg), _fs4(pkg), lag=1)),
    "tf_dyn without tf_obs": ("gauss", lambda pkg, dyn, obs: pkg.SquareRootKalman(
        dyn, obs, tf_dyn=_ut(pkg))),
    "Student tf_dyn without tf_obs": ("student", lambda pkg, dyn, obs: pkg.SquareRootStudent(
        dyn, obs, tf_dyn=_fs4(pkg))),
    "unknown points": ("gauss", lambda pkg, dyn, obs: pkg.SquareRootKalman(dyn, obs, "xx")),
    "batch into forward_pass": ("gauss", _shape("forward_pass", np.zeros((3, 1, 10)))),
    "record into forward_pass_batch": ("gauss", _shape("forward_pass_batch", np.zeros((1, 10)))),
    "batch into smooth": ("gauss", _shape("smooth", np.zeros((3, 1, 10)))),
    "batch into the Student smooth": ("student", lambda pkg, dyn, obs: pkg.SquareRootStudent(
        dyn, obs).smooth(np.zeros((2, 1, 5)))),
}


@pytest.mark.parametrize("label", list(REFUSALS))
def test_refusals_raise_what_the_jax_package_raises(label):
    system, call = REFUSALS[label]
    port, ref = (_ungm_pair if system == "gauss" else _student_pair)()
    with pytest.raises(Exception) as want:
        call(jsq, *ref)
    with pytest.raises(want.type):
        call(tsq, *port)


def test_the_jax_package_top_level_names_resolve_in_the_port():
    not_ported = {"parallel"}
    missing = [n for n in st.__all__ if n not in not_ported and not hasattr(stt, n)]
    assert not missing, missing
    for name in jsq.__all__:
        assert hasattr(tsq, name) and hasattr(stt, name), name
    assert stt.GaussRV is GaussRV and stt.sqrt is tsq
