"""The Bayes-Sard quadrature path of the PyTorch port: the device default,
``BayesSardModel`` / ``BayesSardTransform`` / ``BayesSardKalman``, the
classical GH and CKF filters, the continuous-time reentry simulator and the
expected-model-variance override, against the JAX package and the goldens.

Tolerances: goldens at ``tests/test_parity.py``'s (1e-8; reentry atol 1e-7 /
rtol 1e-6); the JAX package's weights at 1e-9 relative to each array's
largest entry (same float64 formulas; the port solves ``V W = I`` by LU
where the JAX package runs Gauss-Jordan, and raises to integer powers by
repeated products); the polynomial moments exactly (the same NumPy code);
the Monte-Carlo verifiers at atol 5e-3 with 10 x 100,000 samples, as
``tests/test_bq.py`` holds the JAX package's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ssmtoybox_tpu as st
from ssmtoybox_tpu.bq import models as jmodels
from ssmtoybox_tpu.bq.transforms import BayesSardTransform as JBSTransform
from ssmtoybox_tpu.ssmod import ReentryVehicle2DTransition as JReentry
from ssmtoybox_tpu.utils import GaussRV as JGaussRV
import ssmtoybox_torch as stt
from ssmtoybox_torch import convert, set_device
from ssmtoybox_torch.bq import models
from ssmtoybox_torch.bq.models import BayesSardModel
from ssmtoybox_torch.bq.transforms import BayesSardTransform
from ssmtoybox_torch.ssmod import (Radar2DMeasurement, ReentryVehicle2DTransition,
                                   UNGMMeasurement, UNGMTransition)
from ssmtoybox_torch.bq.kernels import RBFGauss, RBFStudent
from ssmtoybox_torch.bq.transforms import BQTransform
from ssmtoybox_torch.mtran import SigmaPointTransform
from ssmtoybox_torch.utils import GaussianMixtureRV, GaussRV, StudentRV
from ssmtoybox_torch.utils.arrays import default_device, f64


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


MUL_UT5 = np.hstack((np.zeros((5, 1), int), np.eye(5, dtype=int), 2 * np.eye(5, dtype=int)))
PAR_DYN5 = np.array([[1.0, 1, 1, 1, 1, 1]])
PAR_OBS5 = np.array([[1.0, 0.9, 0.9, 1e4, 1e4, 1e4]])
GH = lambda deg: {"degree": deg}  # noqa: E731

# name: (dim, kernel parameters, multi-index, points, point parameters, compat)
CONFIGS = {
    "ut1": (1, [[3.0, 0.3]], np.array([[0, 1, 2]]), "ut", None, True),
    "gh5": (1, [[5.0, 0.6]], np.atleast_2d(np.arange(5)), "gh", GH(5), True),
    "gh7": (1, [[3.0, 0.4]], np.atleast_2d(np.arange(7)), "gh", GH(7), True),
    "gh5_general": (1, [[5.0, 0.6]], np.atleast_2d(np.arange(3)), "gh", GH(5), True),
    "gh3_2d_exact": (2, [[1.0, 0.7, 1.2]], 2, "gh", GH(3), False),
    "ut5_dyn": (5, PAR_DYN5, MUL_UT5, "ut", None, True),
    "ut5_obs": (5, PAR_OBS5, MUL_UT5, "ut", None, True),
}


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t)


def _rel_close(got, want, tol, label):
    want = np.atleast_1d(_np(want))
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(np.atleast_1d(_np(got)), want, rtol=tol, atol=tol * scale,
                               err_msg=label)


def _models(name):
    dim, par, mi, pts, pp, compat = CONFIGS[name]
    par = np.asarray(par, dtype=float)
    port = BayesSardModel(dim, par, mi, pts, pp, compat_kxpx_ell_squared=compat)
    jax_ = jmodels.BayesSardModel.create(dim, par, mi, pts, pp, compat_kxpx_ell_squared=compat)
    return port, jax_


# ---------------------------------------------------------------------------
# the device default
# ---------------------------------------------------------------------------

def test_without_a_card_the_port_asks_for_set_device(monkeypatch):
    """With no card and no ``set_device``, building anything raises and
    names ``set_device("cpu")``; after it, the port builds on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    try:
        set_device(None)
        with pytest.raises(RuntimeError, match=r"set_device\('cpu'\)"):
            GaussRV(1, cov=5.0)
        with pytest.raises(RuntimeError, match="set_device"):
            BayesSardTransform(1, 1, [[3.0, 0.3]], [[0, 1, 2]])
        set_device("cpu")
        rv = GaussRV(1, cov=5.0)
        assert rv.mean.device.type == "cpu" and rv.cov.device.type == "cpu"
    finally:
        set_device("cpu")


def test_the_card_is_the_default_and_tensors_keep_their_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    try:
        set_device(None)
        assert default_device() == torch.device("cuda")
        t = torch.ones(2, dtype=torch.float32)
        assert f64(t).device.type == "cpu" and f64(t).dtype == torch.float64
        set_device("cpu")
        assert default_device() == torch.device("cpu")
    finally:
        set_device("cpu")


def _cpu(*shape):
    return torch.ones(shape, dtype=torch.float64)


#: constructors handed CPU tensors with ``device=None``, and a member each
#: that must land on the default device
BUILT_FROM_CPU_TENSORS = {
    "GaussianMixtureRV": (lambda: GaussianMixtureRV(1, [_cpu(1), _cpu(1)], [_cpu(1, 1)] * 2,
                                                    torch.tensor([0.5, 0.5])), "means"),
    "SigmaPointTransform": (lambda: SigmaPointTransform(_cpu(1, 3), _cpu(3), wc_diag=_cpu(3)),
                            "wm"),
    "BQTransform": (lambda: BQTransform(_cpu(1, 3), _cpu(3), torch.eye(3, dtype=torch.float64),
                                        _cpu(1, 3), 1.0), "Wcc"),
    "RBFGauss": (lambda: RBFGauss(1, _cpu(1, 2)), "par"),
    "RBFStudent": (lambda: RBFStudent(1, _cpu(1, 2)), "par"),
    "GaussRV": (lambda: GaussRV(1, _cpu(1), _cpu(1, 1)), "cov"),
    "StudentRV": (lambda: StudentRV(1, _cpu(1), _cpu(1, 1)), "scale"),
}


@pytest.mark.parametrize("name", sorted(BUILT_FROM_CPU_TENSORS))
def test_device_none_moves_cpu_tensors_to_the_default_device(name):
    """``device=None`` names the default device for tensor arguments too: CPU
    tensors handed to a constructor land where ``set_device`` points (here
    ``meta``), beside the members made from nothing."""
    make, member = BUILT_FROM_CPU_TENSORS[name]
    try:
        set_device("meta")
        obj = make()
    finally:
        set_device("cpu")
    assert getattr(obj, member).device.type == "meta"
    if name == "BQTransform":
        assert obj._emv.device.type == "meta"
        assert obj.replace(model_var=2.0).Wc.device.type == "meta"   # the copy stays there


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

MOMENT_INDICES = [np.array([[0, 1, 2]]), np.atleast_2d(np.arange(7)), MUL_UT5,
                  np.array([[1, 3, 5, 7], [0, 2, 0, 0]]), stt.utils.combin.n_sum_k(3, 4)]


@pytest.mark.parametrize("i", range(len(MOMENT_INDICES)))
def test_polynomial_moments_equal_the_jax_package(i):
    mi = MOMENT_INDICES[i]
    for name in ("_exp_x_px", "_exp_x_xpx", "_exp_x_pxpx"):
        np.testing.assert_array_equal(getattr(models, name)(mi), getattr(jmodels, name)(mi),
                                      err_msg=name)
    rng = np.random.default_rng(i)
    ell, x = rng.uniform(0.3, 2.0, mi.shape[0]), rng.normal(0.0, 1.5, (mi.shape[0], 6))
    got = models._exp_x_kxpx(torch.as_tensor(ell), mi, torch.as_tensor(x))
    want = np.asarray(jmodels._exp_x_kxpx(jnp.asarray(ell), mi, jnp.asarray(x)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-13, atol=1e-300)
    assert [models._dfact(n) for n in range(-1, 8)] == [jmodels._dfact(n)
                                                        for n in range(-1, 8)]


@pytest.mark.parametrize("branch", ["gh", "uni"])
def test_weights_match_goldens(goldens, branch):
    """The general branch on 2-D GH points (degree-2 total basis) and the
    unisolvent branch on 2-D UT points, ``transforms.npz``, 1e-8."""
    g = goldens["transforms"]
    par = g["kern_par"]
    if branch == "gh":
        bs = BayesSardModel(2, par, multi_ind=2, point_str="gh", point_par={"degree": 3})
        np.testing.assert_array_equal(bs.mulind, g["bs_gh_mulind"])
    else:
        bs = BayesSardModel(2, par, multi_ind=g["bs_uni_mulind"], point_str="ut")
    w = bs.bq_weights()
    for key, got in (("wm", w.wm), ("wc", w.Wc), ("wcc", w.Wcc), ("emv", w.model_var),
                     ("ivar", w.integral_var)):
        if f"bs_{branch}_{key}" in g:
            np.testing.assert_allclose(np.atleast_1d(_np(got)), g[f"bs_{branch}_{key}"],
                                       atol=1e-8, rtol=1e-8, err_msg=key)
    if branch == "uni":     # unisolvent BSQ on UT points gives the UT mean weights
        np.testing.assert_allclose(_np(w.wm), stt.points.ut_weights(2)[0], atol=1e-8)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_weights_match_jax(name):
    """The weights at 1e-9.  ``K^-1`` and the variances built on it carry
    the Gram's condition number: 7e8 for the radar rule's length-scales of
    1e4 (``ut5_obs``), where two Cholesky solves differ by ~1e-8; they are
    held at ``max(1e-9, 1e-15 cond(K))``."""
    port, jax_ = _models(name)
    w, wj = port.bq_weights(), jax_.bq_weights()
    K = _np(port.kernel.eval(port.kernel.par, port.points, scaling=False))
    tol_iK = max(1e-9, 1e-15 * np.linalg.cond(K + port.kernel.jitter * np.eye(K.shape[0])))
    for key in ("wm", "Wc", "Wcc", "q", "Q"):
        _rel_close(getattr(w, key), getattr(wj, key), 1e-9, key)
    for key in ("model_var", "integral_var", "iK"):
        _rel_close(getattr(w, key), getattr(wj, key), tol_iK, key)
    _rel_close(port.exp_model_variance(), jax_.exp_model_variance(), tol_iK, "emv")
    _rel_close(port.integral_variance(), jax_.integral_variance(), tol_iK, "ivar")


@pytest.mark.parametrize("name", ["ut1", "gh5_general", "gh3_2d_exact"])
def test_predict_matches_jax(name):
    port, jax_ = _models(name)
    rng = np.random.default_rng(3)
    dim, n = port.dim_in, port.num_pts
    test = rng.normal(size=(dim, 9))
    fobs = np.sin(np.asarray(port.points)).sum(0) + 0.1 * rng.normal(size=n)
    mean, var = port.predict(test, fobs)
    mean_j, var_j = jax_.predict(jnp.asarray(test), jnp.asarray(fobs))
    _rel_close(mean, mean_j, 1e-9, "mean")
    _rel_close(var, var_j, 1e-9, "var")


def test_model_refuses_bad_bases():
    port, _ = _models("ut1")
    with pytest.raises(ValueError, match="Dimension mismatch"):
        port.bq_weights(multi_ind=np.zeros((2, 3), int))
    with pytest.raises(ValueError, match="basis functions"):
        port.bq_weights(multi_ind=np.atleast_2d(np.arange(4)))
    with pytest.raises(NotImplementedError):
        port.neg_log_marginal_likelihood(None, None, None, None)


def test_mc_exp_x_kxpx_matches_the_closed_form():
    """The Monte-Carlo verifier against the corrected closed form, as
    ``tests/test_bq.py`` checks the JAX package's."""
    port = BayesSardModel(2, [[1.0, 0.7, 1.2]], 2, "ut", compat_kxpx_ell_squared=False)
    closed = models._exp_x_kxpx(torch.as_tensor([0.7, 1.2]), port.mulind, port.points)
    mc = port.mc_exp_x_kxpx(torch.Generator().manual_seed(0), num_iter=10)
    torch.testing.assert_close(mc, closed, atol=5e-3, rtol=0)


def test_mc_exp_x_cov_matches_the_closed_form():
    """``E[b b^T]`` with ``b = V^T K^-1 k(x) - p(x)`` is the matrix ``B`` of
    the expected model variance (its kernel scale cancels).  Degree-2 terms
    carry fourth moments, whose 1e6-sample error is ~1e-2: atol 5e-2."""
    port = BayesSardModel(2, [[1.3, 0.7, 1.2]], 2, "ut", compat_kxpx_ell_squared=False)
    par, x, mi = port.kernel.par, port.points, port.mulind
    iK = port.kernel.eval_inv_dot(par, x, scaling=False)
    Z = stt.utils.combin.vandermonde(mi, x).T @ iK
    kxpx = models._exp_x_kxpx(port._ell(par), mi, x)
    B = (Z @ port.kernel.exp_x_kxkx(par, par, x) @ Z.T + torch.as_tensor(models._exp_x_pxpx(mi))
         - Z @ kxpx - kxpx.T @ Z.T)
    mc = port.mc_exp_x_cov(torch.Generator().manual_seed(1), num_iter=10)
    torch.testing.assert_close(mc, B, atol=5e-2, rtol=0)


# ---------------------------------------------------------------------------
# transforms and filters
# ---------------------------------------------------------------------------

def _jax_arrays(tf):
    return {"points": np.asarray(tf.model.points), "wm": np.asarray(tf.wm),
            "Wc": np.asarray(tf.Wc), "Wcc": np.asarray(tf.Wcc),
            "model_var": np.asarray(tf.model_var), "integral_var": np.asarray(tf.integral_var),
            "iK": np.asarray(tf.iK), "mulind": tf.model.mulind_np, "dim_out": tf.dim_out,
            "compat_kxpx_ell_squared": tf.model.compat_kxpx_ell_squared}


def _reentry(dt=0.1, x0_var=1.0):
    """The tracking study's reentry model (``experiments/bsq_tracking.py``)."""
    mean, q = np.array([6500., 350., -1.1, -6.1, 0.7]), np.diag([2.4e-5, 2.4e-5, 1e-6])
    cov = np.diag([1e-6, 1e-6, 1e-6, 1e-6, x0_var])
    return (ReentryVehicle2DTransition(GaussRV(5, mean, cov), GaussRV(3, cov=q), dt=dt),
            JReentry.create(JGaussRV.create(5, mean=mean, cov=cov), JGaussRV.create(3, cov=q),
                            dt=dt))


@pytest.mark.parametrize("dim_out,override", [(5, np.diag([2e-4] * 5)), (5, 2e-6),
                                              (2, np.zeros((2, 2)))])
def test_emv_override_matches_jax(dim_out, override):
    """A matrix (or scalar) expected model variance set through ``replace``
    on a transform carried over from the JAX one (the tracking study's 5-D
    rules), applied to a smooth test function, against the JAX transform,
    1e-12.  The JAX package adds ``model_var * I`` elementwise."""
    par = PAR_DYN5 if dim_out == 5 else PAR_OBS5
    jtf = JBSTransform.create(5, dim_out, par, MUL_UT5, "ut")
    tf = convert.transform_from_numpy(_jax_arrays(jtf))
    assert isinstance(tf, BayesSardTransform) and tf.dim_out == dim_out
    jtf2, tf2 = jtf.replace(model_var=jnp.asarray(override)), tf.replace(model_var=override)
    assert tf2 is not tf and float(tf._emv[0, 0]) == float(np.asarray(jtf.model_var))
    torch.testing.assert_close(tf2._emv, torch.as_tensor(override * np.eye(dim_out)))

    def f(x, t):
        return torch.sin(x[..., :dim_out]) + 0.1 * x[..., :dim_out] ** 2

    def jf(x, t):
        return jnp.sin(x[:dim_out]) + 0.1 * x[:dim_out] ** 2

    mean, cov = 0.3 * np.arange(5.0), 0.5 * np.eye(5) + 0.1
    got = tf2.apply(f, torch.as_tensor(mean)[None], torch.as_tensor(cov)[None], 0)
    want = jtf2.apply(jf, jnp.asarray(mean), jnp.asarray(cov), 0)
    for a, b, label in zip(got, want, ("mean", "cov", "cross")):
        _rel_close(a[0], b, 1e-12, label)
    with pytest.raises(ValueError, match="cannot replace"):
        tf.replace(kernel=None)


def test_bsqkf_matches_ungm_golden(goldens):
    g = goldens["ungm"]
    dyn = UNGMTransition(GaussRV(1, cov=1.0), GaussRV(1, cov=10.0))
    obs = UNGMMeasurement(GaussRV(1, cov=1.0), dim_state=1)
    par, mi = np.array([[3.0, 0.3]]), np.array([[0, 1, 2]])
    alg = stt.BayesSardKalman(dyn, obs, par, par, mulind_dyn=mi, mulind_obs=mi, points="ut")
    fm, fP = alg.forward_pass(g["y"][..., 0])
    sm, sP = alg.backward_pass()
    for got, key in ((fm, "fm"), (fP, "fP"), (sm, "sm"), (sP, "sP")):
        np.testing.assert_allclose(got.numpy(), g[f"bsqkf_{key}"], atol=1e-8, rtol=1e-8,
                                   err_msg=key)


def test_bsqkf_matches_reentry_golden(goldens):
    g = goldens["reentry"]
    dyn = ReentryVehicle2DTransition(
        GaussRV(5, mean=np.array([6500.4, 349.14, -1.8093, -6.7967, 0.6932]),
                cov=np.diag([1e-6, 1e-6, 1e-6, 1e-6, 1.0])),
        GaussRV(3, cov=np.diag([2.4064e-5, 2.4064e-5, 1e-6])), dt=0.05)
    obs = Radar2DMeasurement(GaussRV(2, cov=np.diag([1e-3, 1e-5])), dim_state=5,
                             state_index=[0, 1], radar_loc=np.array([6374.0, 0.0]))
    alg = stt.BayesSardKalman(dyn, obs, PAR_DYN5, PAR_OBS5, mulind_dyn=MUL_UT5,
                              mulind_obs=MUL_UT5, points="ut")
    fm, fP = alg.forward_pass(g["y"][..., 0])
    np.testing.assert_allclose(fm.numpy(), g["bsqkf_fm"], atol=1e-7, rtol=1e-6)
    np.testing.assert_allclose(fP.numpy(), g["bsqkf_fP"], atol=1e-7, rtol=1e-6)


@pytest.mark.parametrize("name", ["ghkf5", "ckf"])
def test_classical_filters_match_ungm_golden(goldens, name):
    g = goldens["ungm"]
    dyn = UNGMTransition(GaussRV(1, cov=1.0), GaussRV(1, cov=10.0))
    obs = UNGMMeasurement(GaussRV(1, cov=1.0), dim_state=1)
    alg = (stt.GaussHermiteKalman(dyn, obs, deg=5) if name == "ghkf5"
           else stt.CubatureKalman(dyn, obs))
    fm, fP = alg.forward_pass(g["y"][..., 0])
    np.testing.assert_allclose(fm.numpy(), g[f"{name}_fm"], atol=1e-8, rtol=1e-8)
    np.testing.assert_allclose(fP.numpy(), g[f"{name}_fP"], atol=1e-8, rtol=1e-8)


# ---------------------------------------------------------------------------
# the continuous-time simulator
# ---------------------------------------------------------------------------

def test_simulate_continuous_matches_jax_on_the_same_noise():
    """Euler-Maruyama on the reentry dynamics, dt 0.05 over 2 s, fed the JAX
    package's own initial states and scaled noise, 1e-12."""
    dyn, jdyn = _reentry(dt=0.05, x0_var=1e-6)
    key, duration, dt, mc = jax.random.PRNGKey(4), 2.0, 0.05, 3
    want = np.asarray(jdyn.simulate_continuous(key, duration=duration, dt=dt, mc_sims=mc))
    steps = int(np.floor(duration / dt))
    k0, kq = jax.random.split(key)
    x0 = np.asarray(jdyn.init_rv.sample(k0, (mc,)))                    # (D, M)
    q = np.asarray((jnp.sqrt(dt) / dt) * jdyn.noise_rv.sample(kq, (steps + 1, mc)))
    got = dyn.euler_maruyama(torch.tensor(x0.T), torch.tensor(q[:, :steps]), dt)
    assert tuple(got.shape) == want.shape == (5, steps, mc)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    sim = dyn.simulate_continuous(torch.Generator().manual_seed(0), duration, dt, mc_sims=mc)
    assert tuple(sim.shape) == (5, steps, mc) and bool(torch.isfinite(sim).all())
    with pytest.raises(NotImplementedError):
        UNGMTransition(GaussRV(1), GaussRV(1)).simulate_continuous(
            torch.Generator().manual_seed(0), 1.0, 0.1)
