"""Per-call kernel parameters through the Gaussian filter, statistical linear
regression and the iterated posterior-linearization filter (IPLF), and the
multi-output BQ filters of the PyTorch port, against the JAX package.

The JAX references run in one compiled program (module fixture).

Tolerances:

- ``gaussian_filter`` with ``theta``, and its gradient by autograd against
  ``jax.grad``: 1e-8 relative to each array's largest entry (UNGM, 2 records
  of 15 steps, GPQ rules whose Grams the JAX package inverts by its own
  Cholesky);
- the IPLF against the JAX package: 1e-9 of each stream's largest entry
  (constant velocity + precise radar, 4 records of 30 steps, 5 iterations;
  non-additive UNGM, 2 records of 20 steps, 4 iterations);
- the multi-output filters against the JAX package: 1e-10 of each stream's
  largest entry; the MO-TP Student filter on one set of Monte-Carlo weights
  (each package draws its own sample stream): the port's, carried across as
  arrays, through ``convert`` into the port's filter and into the JAX
  package's transform;
- SLR of an affine map: 1e-12; ``iterations=1`` against the UKF, per-call
  ``theta`` equal to the construction parameters, ``"auto"`` against
  ``"f64"``: to the bit.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ssmtoybox_tpu as st
from ssmtoybox_tpu import ssmod as jssmod
from ssmtoybox_tpu.bq import models as jmodels
from ssmtoybox_tpu.bq.transforms import GaussianProcessTransform as JGPQ
from ssmtoybox_tpu.bq.transforms import MultiOutputGaussianProcessTransform as JMOGP
from ssmtoybox_tpu.bq.transforms import MultiOutputStudentTProcessTransform as JMOTP
from ssmtoybox_tpu.utils import GaussRV as JGaussRV, StudentRV as JStudentRV
import ssmtoybox_torch as stt
from ssmtoybox_torch import convert, set_device, ssmod
from ssmtoybox_torch.mtran import UnscentedTransform
from ssmtoybox_torch.utils import GaussRV, StudentRV


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


THETA = 1e-8
IPLF = 1e-9
MO = 1e-10
KPAR = np.array([[1.0, 3.0]])
THETA_DYN, THETA_OBS = np.array([[1.3, 2.5]]), np.array([[0.8, 3.4]])
FIELDS = ("fi_mean", "fi_cov", "pr_mean", "pr_cov", "pr_xx_cov")
STUDENT_FIELDS = ("fi_mean", "fi_cov", "fi_smat", "pr_mean", "pr_smat", "pr_xx_smat")


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t)


def _close(got, want, tol, label=""):
    want = np.atleast_1d(_np(want))
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(np.atleast_1d(_np(got)), want, rtol=tol, atol=tol * scale,
                               err_msg=label)


def _records(dyn, obs, seed, batch, steps):
    gen = torch.Generator().manual_seed(seed)
    x = dyn.simulate_discrete(gen, steps, batch)
    return x.permute(2, 0, 1), obs.simulate_measurements(gen, x).permute(2, 0, 1)


def _ungm():
    return (ssmod.UNGMTransition(GaussRV(1, cov=5.0), GaussRV(1, cov=10.0)),
            ssmod.UNGMMeasurement(GaussRV(1, cov=1.0), dim_state=1))


def _jungm():
    return (jssmod.UNGMTransition.create(JGaussRV.create(1, cov=5.0),
                                         JGaussRV.create(1, cov=10.0)),
            jssmod.UNGMMeasurement.create(JGaussRV.create(1, cov=1.0), dim_state=1))


def _cv_radar(pkg, rv):
    """The IPLF setting of ``tests/test_ssmod_ssinf.py``: constant velocity
    with a poor prior, a precise radar."""
    mk = (lambda cls, *a, **k: cls.create(*a, **k)) if pkg is jssmod else (
        lambda cls, *a, **k: cls(*a, **k))
    x0 = mk(rv, 4, mean=np.array([100., 2., 100., -1.]), cov=np.diag([400.0, 25.0, 400.0, 25.0]))
    dyn = mk(pkg.ConstantVelocity, x0, mk(rv, 2, cov=0.1 * np.eye(2)), dt=0.5)
    obs = mk(pkg.Radar2DMeasurement, mk(rv, 2, cov=np.diag([1.0, 1e-4])), dim_state=4,
             state_index=[0, 2])
    return dyn, obs


def _ungm_na(pkg, rv):
    mk = (lambda cls, *a, **k: cls.create(*a, **k)) if pkg is jssmod else (
        lambda cls, *a, **k: cls(*a, **k))
    return (mk(pkg.UNGMNATransition, mk(rv, 1, mean=1.0, cov=1.0), mk(rv, 1, cov=10.0)),
            mk(pkg.UNGMNAMeasurement, mk(rv, 1, cov=0.01), dim_state=1))


def _student_ungm(pkg, rv):
    mk = (lambda cls, *a, **k: cls.create(*a, **k)) if pkg is jssmod else (
        lambda cls, *a, **k: cls(*a, **k))
    return (mk(pkg.UNGMTransition, mk(rv, 1, dof=4.0), mk(rv, 1, scale=10.0, dof=4.0)),
            mk(pkg.UNGMMeasurement, mk(rv, 1, scale=0.01, dof=4.0), dim_state=1))


def _loss(fi_mean, fi_cov, xt, log):
    """A Gaussian NLL of the scalar truth ``xt`` (M, 1, N) under the filtered
    moments, summed."""
    var = fi_cov[:, 0]
    return 0.5 * (((fi_mean - xt) ** 2 / var).sum() + log(var).sum())


MO_TP_KEYS = ("points", "wm", "Wc", "Wcc", "Q", "iK", "scale", "nu", "num_pts")


def _mo_tp_arrays():
    """The arrays of the MO-TP Student filter's two transforms on the
    Student UNGM system (each noise's dof 4 shapes its FS points), 20,000
    Monte-Carlo samples."""
    dyn, obs = _student_ungm(ssmod, StudentRV)
    alg = stt.MultiOutputStudentProcessStudent(dyn, obs, [[1.0, 1.0]], [[1.0, 1.0]],
                                               mc_opts={"num_samples": 20_000})
    return [{k: _np(getattr(tf, k)) for k in MO_TP_KEYS} for tf in (alg.tf_dyn, alg.tf_obs)]


def _jax_mo_tp(d):
    """The JAX package's MO-TP transform holding the arrays ``d``."""
    model = jmodels.StudentTProcessMO.create(1, 1, d["scale"][:, None] * [1.0, 1.0],
                                             "rbf-student", "fs", {"dof": 4.0}, nu=float(d["nu"]))
    return JMOTP(model=model, wm=d["wm"], Wc=d["Wc"], Wcc=d["Wcc"], Q=d["Q"], iK=d["iK"],
                 dim_out=1)


@pytest.fixture(scope="module")
def ref():
    """Records, port systems and the JAX package's results, one program."""
    out = {"ungm": _records(*_ungm(), seed=1, batch=2, steps=15),
           "cv": _records(*_cv_radar(ssmod, GaussRV), seed=2, batch=4, steps=30),
           "na": _records(*_ungm_na(ssmod, GaussRV), seed=3, batch=2, steps=20),
           "st": _records(*_student_ungm(ssmod, StudentRV), seed=4, batch=2, steps=10)}
    jdyn, jobs = _jungm()
    # the JAX transforms hold the port's weights (theta replaces the GPQ's)
    dyn, obs = _ungm()
    gpq = stt.GaussianProcessKalman(dyn, obs, KPAR, KPAR).tf_dyn
    gpq = JGPQ(model=jmodels.GaussianProcessModel.create(1, KPAR), dim_out=1,
               **{k: _np(getattr(gpq, k)) for k in ("wm", "Wc", "Wcc", "model_var",
                                                    "integral_var", "iK")})
    mo = stt.MultiOutputGaussianProcessKalman(dyn, obs, KPAR, KPAR).tf_dyn
    mo = JMOGP(model=jmodels.GaussianProcessMO.create(1, 1, KPAR), dim_out=1,
               **{k: _np(getattr(mo, k)) for k in ("wm", "Wc", "Wcc", "Q", "iK")})
    cvd, cvo = _cv_radar(jssmod, JGaussRV)
    iplf = st.IteratedPosteriorLinearizationKalman(cvd, cvo, iterations=5)
    nad, nao = _ungm_na(jssmod, JGaussRV)
    ut2 = st.UnscentedTransform(2)
    sd, so = _student_ungm(jssmod, JStudentRV)
    out["mo_tp"] = _mo_tp_arrays()
    mo_tp = [_jax_mo_tp(d) for d in out["mo_tp"]]

    def run(y, x, cv, na, sy):
        def theta_loss(th_d, th_o):
            res = jax.vmap(lambda d: st.gaussian_filter(
                jdyn, jobs, gpq, gpq, d, theta_dyn=th_d, theta_obs=th_o))(y)
            return _loss(res.fi_mean, res.fi_cov, x, jnp.log), res
        (_, res), grads = jax.value_and_grad(theta_loss, argnums=(0, 1), has_aux=True)(
            THETA_DYN, THETA_OBS)
        return {
            "theta": (res, grads),
            "iplf": jax.vmap(lambda d: st.iterated_gaussian_filter(
                cvd, cvo, iplf.tf_dyn, iplf.tf_obs, d, iterations=5))(cv),
            "na_res": jax.vmap(lambda d: st.iterated_gaussian_filter(
                nad, nao, ut2, ut2, d, iterations=4))(na),
            "mo": jax.vmap(lambda d: st.gaussian_filter(
                jdyn, jobs, mo, mo, d))(y),
            "mo_tp_res": jax.vmap(lambda d: st.ssinf.studentian_filter(
                sd, so, mo_tp[0], mo_tp[1], d, 4.0, True))(sy),
        }

    np_ = lambda t: jnp.asarray(_np(t))  # noqa: E731
    out.update(jax.jit(run)(np_(out["ungm"][1]), np_(out["ungm"][0]), np_(out["cv"][1]),
                            np_(out["na"][1]), np_(out["st"][1])))
    return out


# ---------------------------------------------------------------------------
# per-call kernel parameters
# ---------------------------------------------------------------------------

def test_theta_filter_and_gradient_against_jax(ref):
    """GPQKF with per-call kernel parameters: the filter's streams and the
    gradient of an NLL of the truth with respect to both thetas."""
    xs, ys = ref["ungm"]
    dyn, obs = _ungm()
    gpq = stt.GaussianProcessKalman(dyn, obs, KPAR, KPAR)
    th_d = torch.tensor(THETA_DYN, requires_grad=True)
    th_o = torch.tensor(THETA_OBS, requires_grad=True)
    res = stt.gaussian_filter(dyn, obs, gpq.tf_dyn, gpq.tf_obs, ys, theta_dyn=th_d,
                              theta_obs=th_o)
    assert res.fi_mean.grad_fn is not None
    want, want_g = ref["theta"]
    for f in FIELDS:
        _close(getattr(res, f), getattr(want, f), THETA, f)
    loss = _loss(res.fi_mean, res.fi_cov, xs, torch.log)
    for g, w, name in zip(torch.autograd.grad(loss, (th_d, th_o)), want_g, ("dyn", "obs")):
        _close(g, w, THETA, f"d loss / d theta_{name}")


@pytest.mark.parametrize("kind", ["gpq", "bsq"])
def test_theta_bits(ref, kind):
    """``theta`` equal to the construction parameters gives the
    construction-time bits; another ``theta`` gives the bits of a filter
    built at it; a theta for a classical rule raises."""
    _, ys = ref["ungm"]
    dyn, obs = _ungm()
    make = ((lambda p, q: stt.GaussianProcessKalman(dyn, obs, p, q)) if kind == "gpq" else
            (lambda p, q: stt.BayesSardKalman(dyn, obs, p, q)))
    alg = make(KPAR, KPAR)
    base = stt.gaussian_filter(dyn, obs, alg.tf_dyn, alg.tf_obs, ys)
    same = stt.gaussian_filter(dyn, obs, alg.tf_dyn, alg.tf_obs, ys, theta_dyn=KPAR,
                               theta_obs=KPAR.copy())
    other = stt.gaussian_filter(dyn, obs, alg.tf_dyn, alg.tf_obs, ys,
                                theta_dyn=torch.tensor(THETA_DYN), theta_obs=THETA_OBS)
    built = make(THETA_DYN, THETA_OBS).forward_pass_batch(ys)
    for f in FIELDS:
        assert torch.equal(getattr(same, f), getattr(base, f)), f
        assert torch.equal(getattr(other, f), getattr(built, f)), f
    ukf = stt.UnscentedKalman(dyn, obs)
    with pytest.raises(ValueError, match="only the BQ transforms"):
        stt.gaussian_filter(dyn, obs, ukf.tf_dyn, ukf.tf_obs, ys, theta_dyn=KPAR)


def test_slr_recovers_affine_map():
    """SLR of an affine map through any rule returns the map and zero
    residual covariance."""
    rng = np.random.default_rng(5)
    A, b = torch.as_tensor(rng.normal(size=(3, 2))), torch.as_tensor(rng.normal(size=3))
    mean = torch.as_tensor(rng.normal(size=(4, 2)))
    L = torch.as_tensor(rng.normal(size=(4, 2, 2)))
    cov = L @ L.mT + 0.5 * torch.eye(2, dtype=torch.float64)
    A_, b_, Om = stt.slr_affine(UnscentedTransform(2), lambda x, t: x @ A.T + b, mean, cov, 0)
    _close(A_, A.expand(4, 3, 2), 1e-12, "A")
    _close(b_, b.expand(4, 3), 1e-12, "b")
    assert float(Om.abs().max()) < 1e-12


# ---------------------------------------------------------------------------
# the IPLF
# ---------------------------------------------------------------------------

def test_iplf_one_iteration_is_the_ukf(ref):
    _, ys = ref["cv"]
    dyn, obs = _cv_radar(ssmod, GaussRV)
    got = stt.IteratedPosteriorLinearizationKalman(dyn, obs, iterations=1).forward_pass_batch(ys)
    want = stt.UnscentedKalman(dyn, obs).forward_pass_batch(ys)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f


def test_iplf_against_jax(ref):
    """Five iterations on the CV + precise radar records: the JAX package's
    streams, and a lower RMSE than one iteration."""
    xs, ys = ref["cv"]
    dyn, obs = _cv_radar(ssmod, GaussRV)
    alg = stt.IteratedPosteriorLinearizationKalman(dyn, obs, iterations=5)
    res = alg.forward_pass_batch(ys)
    for f in FIELDS:
        _close(getattr(res, f), getattr(ref["iplf"], f), IPLF, f)
    one = stt.IteratedPosteriorLinearizationKalman(dyn, obs, iterations=1).forward_pass_batch(ys)
    rmse = lambda r: float(((r.fi_mean - xs) ** 2).mean().sqrt())  # noqa: E731
    assert rmse(res) < rmse(one)
    fm, _ = alg.forward_pass(ys[0])
    _close(fm, res.fi_mean[0], 1e-12, "single record")
    sm, sP = alg.backward_pass(rts_full=True)
    assert bool(torch.isfinite(sm).all()) and bool(torch.isfinite(sP).all())


def test_iplf_nonadditive_against_jax(ref):
    _, ys = ref["na"]
    dyn, obs = _ungm_na(ssmod, GaussRV)
    tf = UnscentedTransform(2)
    res = stt.iterated_gaussian_filter(dyn, obs, tf, tf, ys, iterations=4)
    for f in FIELDS:
        _close(getattr(res, f), getattr(ref["na_res"], f), IPLF, f)


def test_iplf_guards():
    dyn, obs = _ungm()
    for kw in ({"points": "bogus"}, {"iterations": 0}, {"points": "sr",
                                                        "point_hyp": {"kappa": 1.0}}):
        with pytest.raises(ValueError):
            stt.IteratedPosteriorLinearizationKalman(dyn, obs, **kw)
    ut = UnscentedTransform(1)
    with pytest.raises(ValueError, match="iterations"):
        stt.iterated_gaussian_filter(dyn, obs, ut, ut, torch.zeros(1, 3), iterations=0)
    gh = stt.IteratedPosteriorLinearizationKalman(dyn, obs, "gh", {"degree": 5}, iterations=2)
    assert gh.tf_obs.unit_sp.shape == (1, 5)


# ---------------------------------------------------------------------------
# multi-output filters
# ---------------------------------------------------------------------------

def test_mo_gpq_kalman_against_jax_and_gpqkf(ref):
    """The MO-GPQKF against the JAX package; with one output it is the
    GPQKF to rounding.  The fused engines refuse its transforms by name,
    ``"auto"`` runs ``"f64"``."""
    _, ys = ref["ungm"]
    dyn, obs = _ungm()
    alg = stt.MultiOutputGaussianProcessKalman(dyn, obs, KPAR, KPAR)
    res = alg.forward_pass_batch(ys, engine="auto")
    f64 = alg.forward_pass_batch(ys, engine="f64")
    gpq = stt.GaussianProcessKalman(dyn, obs, KPAR, KPAR).forward_pass_batch(ys, engine="f64")
    for f in FIELDS:
        assert torch.equal(getattr(res, f), getattr(f64, f)), f
        _close(getattr(res, f), getattr(ref["mo"], f), MO, f)
        _close(getattr(res, f), getattr(gpq, f), MO, f"{f} vs GPQKF")
    with pytest.raises(ValueError, match="MultiOutputGaussianProcessTransform"):
        alg.forward_pass_batch(ys, engine="dd")
    cvd, cvo = _cv_radar(ssmod, GaussRV)
    mo_cv = stt.MultiOutputGaussianProcessKalman(cvd, cvo, np.tile([[1.0, 3, 3, 3, 3]], (4, 1)),
                                                 np.tile([[1.0, 3, 3, 3, 3]], (2, 1)))
    with pytest.raises(ValueError, match="multi-output BQ transforms"):
        mo_cv.forward_pass_batch(ref["cv"][1][:, :, :3], engine="dd")


def test_mo_tp_student_against_jax(ref):
    """The MO-TP Student filter on Monte-Carlo weights carried across as
    arrays: the port's filter on the transforms ``convert`` loads, the JAX
    package's on the same arrays.  The filter class put each noise's dof
    into its points, as the JAX package's does."""
    _, ys = ref["st"]
    dyn, obs = _student_ungm(ssmod, StudentRV)
    tfs = [convert.transform_from_numpy(d) for d in ref["mo_tp"]]
    res = stt.StudentianInference(dyn, obs, *tfs, dof=4.0).forward_pass_batch(ys)
    for f in STUDENT_FIELDS:
        _close(getattr(res, f), getattr(ref["mo_tp_res"], f), MO, f)
    for tf in tfs:
        _close(tf.points, jmodels.StudentTProcessMO.create(1, 1, KPAR, "rbf", "fs",
                                                           {"dof": 4.0}).points, 0.0, "points")
