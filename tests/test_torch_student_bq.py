"""The RBF-Student kernel, GP/TP models and TPQ transform of the PyTorch port
against the JAX package and the reference golden ``tpq_cv_weights.npz``.

The JAX package's scan path draws its float64 batches from
``split(PRNGKey(seed), num_batches)``; the port's own generator gives other
numbers, so these tests build the JAX batches and inject them into the port
(its ``RBFStudent._batches``).  On the same samples both packages compute
the same float64 sums in another order: 1e-10 relative.  The port's own
weights (its own samples) are held to the golden at the tolerances and the
eigenvalue check of ``tests/test_parity.py::test_tpq_cv_weight_parity``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssmtoybox_tpu.bq.kernels import RBFStudent as JRBFStudent
from ssmtoybox_tpu.bq.models import GaussianProcessModel as JGPModel
from ssmtoybox_tpu.bq.models import StudentTProcessModel as JTPModel
from ssmtoybox_tpu.bq.transforms import StudentTProcessTransform as JTPTransform
from ssmtoybox_tpu.utils.rand import multivariate_t as jmultivariate_t
from ssmtoybox_torch import convert
from ssmtoybox_torch.bq import (GaussianProcessModel, RBFStudent, StudentTProcessModel,
                                StudentTProcessTransform)
from ssmtoybox_torch.bq.kernels import get_kernel
from ssmtoybox_torch.ops import student_mc as smc
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


JAX_TOL = 1e-10
MC = dict(dof=4.0, num_samples=3000, num_batches=6, seed=3)
PAR = np.array([[1.2, 0.9, 1.7]])


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t)


def _close(a, b, tol=JAX_TOL, label=""):
    np.testing.assert_allclose(_np(a), _np(b), rtol=tol, atol=tol * np.abs(_np(b)).max(),
                               err_msg=label)


def _inject_jax_batches(kernel: RBFStudent):
    """Make ``kernel`` draw the JAX package's scan batches for its seed."""
    def batches(num_batches, batch_size, per_sample):
        keys = jax.random.split(jax.random.PRNGKey(kernel.seed), num_batches)
        mean = jnp.zeros(kernel.dim, jnp.float64)
        eye = jnp.eye(kernel.dim, dtype=jnp.float64)
        xs = jax.vmap(lambda k: jmultivariate_t(k, mean, eye, kernel.dof, (batch_size,)).T)(keys)
        return [torch.as_tensor(np.array(xs))]
    kernel._batches = batches
    return kernel


@pytest.fixture(scope="module")
def points():
    return np.random.default_rng(7).normal(size=(2, 5))


def test_scan_expectations_match_jax(points):
    k = _inject_jax_batches(RBFStudent(2, PAR, **MC))
    kj = JRBFStudent.create(2, PAR, use_pallas=False, **MC)
    p, x = torch.as_tensor(PAR), torch.as_tensor(points)
    pj, xj = jnp.asarray(PAR), jnp.asarray(points)
    p1 = torch.tensor([[0.7, 1.4, 0.8]], dtype=torch.float64)
    p1j = jnp.asarray(_np(p1))
    _close(k.exp_x_kx(p, x), kj.exp_x_kx(pj, xj), label="q")
    _close(k.exp_x_kx(p, x, scaling=True), kj.exp_x_kx(pj, xj, scaling=True), label="q scaled")
    _close(k.exp_x_xkx(p, x), kj.exp_x_xkx(pj, xj), label="R")
    # distinct parameter rows: the transpose the JAX package fixed shows here
    Q01 = k.exp_x_kxkx(p, p1, x)
    _close(Q01, kj.exp_x_kxkx(pj, p1j, xj), label="Q(p0, p1)")
    _close(k.exp_x_kxkx(p1, p, x), Q01.T, label="Q(p1, p0) = Q(p0, p1)^T")
    for a, b in zip(k.exp_x_qRQ(p, x), kj.exp_x_qRQ(pj, xj)):
        _close(a, b, label="qRQ scan composition")
    _close(k.exp_x_kxx(p), kj.exp_x_kxx(pj))
    # the pair count: off-diagonal pairs of 1500 batches of 2 samples
    _close(k.exp_xy_kxy(p), kj.exp_xy_kxy(pj), label="kxy")
    iK = k.eval_inv_dot(p, x, scaling=False)
    for i, (a, b) in enumerate(zip(k.projected_weight_stats(p, x, iK),
                                   kj.projected_weight_stats(pj, xj, jnp.asarray(_np(iK))))):
        _close(a, b, label=f"projected stat {i}")


def test_models_match_jax_on_the_same_samples():
    kw = dict(point_par={"dof": 4.0, "kappa": 0.0})
    gp = GaussianProcessModel(2, PAR, "rbf-student", "fs", **kw, **MC)
    tp = StudentTProcessModel(2, PAR, "rbf-student", "fs", nu=5.0, **kw, **MC)
    gpj = JGPModel.create(2, PAR, "rbf-student", "fs", kw["point_par"], use_pallas=False, **MC)
    tpj = JTPModel.create(2, PAR, "rbf-student", "fs", kw["point_par"], nu=5.0,
                          use_pallas=False, **MC)
    for m in (gp, tp):
        _inject_jax_batches(m.kernel)
    w, wj = gp.bq_weights(), gpj.bq_weights(jnp.asarray(PAR))
    for f in ("wm", "Wc", "Wcc", "model_var", "integral_var", "q", "Q", "iK"):
        _close(getattr(w, f), getattr(wj, f), label=f)
    _close(gp.exp_model_variance(), gpj.exp_model_variance(jnp.asarray(PAR)), label="emv")
    _close(gp.integral_variance(), gpj.integral_variance(jnp.asarray(PAR)), label="ivar")
    fo = np.random.default_rng(8).normal(size=(1, gp.num_pts))
    _close(tp.exp_model_variance(fcn_obs=fo), tpj.exp_model_variance(fcn_obs=jnp.asarray(fo)),
           label="TP emv")
    _close(tp.integral_variance(fcn_obs=fo), tpj.integral_variance(fcn_obs=jnp.asarray(fo)),
           label="TP ivar")
    assert tp.nu == 5.0 and StudentTProcessModel(2, PAR, nu=1.0).nu == 3.0


def test_tp_weights_match_golden(goldens):
    """The port's own weights (1e6 samples of its own stream) on the
    FUSION-2017 CV-glint parameters, where ``lambda_min(K) ~ 1e-7``: the
    golden's tolerances and its eigenvalue check catch a composed
    ``iK Q iK`` (eigmax ~580 instead of 2-6).

    The seed is pinned: under dof = 4 the integrand of ``Wc`` has no finite
    variance, and at 1e6 samples the largest ``Wc`` error spreads from seed
    to seed past the golden's 0.5 in both packages (dyn row, CPU: the port
    0.13-1.15 over seeds 0-5, the JAX package 0.18-1.39 over seeds 0-3).
    The dynamics row, as in the JAX package's default profile (the
    measurement row runs the same code)."""
    g, tag = goldens["tpq_cv_weights"], "dyn"
    t = StudentTProcessTransform(4, 1, g[f"{tag}_par"], "rbf-student", "fs",
                                 point_par={"dof": 4.0}, nu=4.0,
                                 mc_opts={"num_samples": 1_000_000, "seed": 1})
    np.testing.assert_allclose(_np(t.wm), g[f"{tag}_wm"], atol=5e-3)
    np.testing.assert_allclose(_np(t.Wc), g[f"{tag}_Wc"], atol=0.5)
    np.testing.assert_allclose(_np(t.Wcc), g[f"{tag}_Wcc"], atol=0.25)
    np.testing.assert_allclose(float(t.model_var), float(g[f"{tag}_emv"][0]), rtol=0.3)
    lam = np.linalg.eigvalsh(_np(t.Wc))
    lam_ref = np.linalg.eigvalsh(g[f"{tag}_Wc"])
    assert lam[0] > -1e-10 and lam[-1] < 2.0 * lam_ref[-1], (lam, lam_ref)


def test_kernel_dispatch():
    x = torch.as_tensor(np.random.default_rng(9).normal(size=(2, 4)))
    forced = RBFStudent(2, PAR, use_kernel="force", **MC)
    samples, chunk = forced._fused_samples(forced.par, smc.QRQ_CHUNK)
    assert chunk == 3000 and tuple(samples.shape) == (3000, 2)
    assert samples.dtype == torch.float32
    for a, b in zip(forced.exp_x_qRQ(forced.par, x),
                    smc.student_qrq_plain(forced.par, x, samples, chunk)):
        torch.testing.assert_close(a, b, atol=0, rtol=0)
    s_kxy, c_kxy = forced._fused_samples(forced.par, smc.KXY_CHUNK)
    torch.testing.assert_close(forced.exp_xy_kxy(forced.par),
                               1.2 ** 2 * smc.student_kxy_plain(forced.par, s_kxy, c_kxy))
    # True on CPU tensors takes the scan path, like False
    on, off = RBFStudent(2, PAR, use_kernel=True, **MC), RBFStudent(2, PAR, use_kernel=False, **MC)
    assert not on._kernel_on() and forced._kernel_on()
    torch.testing.assert_close(on.exp_x_qRQ(on.par, x)[2], off.exp_x_qRQ(off.par, x)[2])
    with pytest.raises(ValueError, match="use_kernel"):
        RBFStudent(2, PAR, use_kernel="pallas")
    with pytest.raises(ValueError, match="empty batch"):
        RBFStudent(2, PAR, num_samples=3, num_batches=6).exp_x_kx(torch.as_tensor(PAR), x)
    with pytest.raises(ValueError, match="rbf-student"):
        get_kernel(2, "matern", PAR)


def test_fused_qrq_grad_flows_through_the_kernel_class():
    k = RBFStudent(1, [[1.0, 1.2]], use_kernel="force", num_samples=8192)
    par = k.par.clone().requires_grad_(True)
    x = torch.tensor([[-0.5, 0.3, 1.1]], dtype=torch.float64, requires_grad=True)
    q, R, Q = k.exp_x_qRQ(par, x)
    g_par, g_x = torch.autograd.grad(q.sum() + R.sum() + Q.sum(), (par, x))
    assert float(g_par[0, 0]) == 0.0 and bool(torch.isfinite(g_x).all())
    (g_kxy,) = torch.autograd.grad(k.exp_xy_kxy(par), par)
    assert float(g_kxy[0, 0]) > 0.0                 # d(s^2 E[k]) / ds = 2 s E[k]


def test_tpq_transform_carried_from_jax_applies_the_same():
    """The TP transform's arrays pulled from the JAX transform give the JAX
    moments, TP model variance included (1e-10)."""
    par = np.array([[1.0, 2.0, 3.0]])
    jt = JTPTransform.create(2, 1, par, "rbf", "ut", nu=5.0, compat_drop_nu=False)
    t = convert.transform_from_numpy(
        {"points": np.asarray(jt.model.points), "wm": np.asarray(jt.wm),
         "Wc": np.asarray(jt.Wc), "Wcc": np.asarray(jt.Wcc),
         "model_var": np.asarray(jt.model_var), "integral_var": np.asarray(jt.integral_var),
         "iK": np.asarray(jt.iK), "nu": jt.model.nu, "num_pts": jt.model.num_pts})
    own = StudentTProcessTransform(2, 1, par, "rbf", "ut", nu=5.0, compat_drop_nu=False)
    for f in ("wm", "Wc", "Wcc", "model_var", "integral_var", "iK"):
        _close(getattr(own, f), getattr(t, f), label=f)
    rng = np.random.default_rng(10)
    mean = rng.normal(size=(4, 2))
    A = rng.normal(size=(4, 2, 2))
    cov = A @ np.swapaxes(A, 1, 2) + np.eye(2)
    fj = lambda x, _: jnp.stack([jnp.sin(x[0]) * x[1], x[0] ** 2 - x[1]])
    ft = lambda x, _: torch.stack([torch.sin(x[..., 0]) * x[..., 1], x[..., 0] ** 2 - x[..., 1]],
                                  -1)
    ref = jax.vmap(lambda m, c: jt.apply(fj, m, c, None))(jnp.asarray(mean), jnp.asarray(cov))
    for tf in (t, own):
        for a, b in zip(tf.apply(ft, torch.as_tensor(mean), torch.as_tensor(cov), None), ref):
            _close(a, b)
    with pytest.raises(ValueError, match="num_pts"):
        convert.transform_from_numpy({"points": np.zeros((2, 5)), "wm": 0, "Wc": 0, "Wcc": 0,
                                      "model_var": 0, "iK": 0, "nu": 4.0, "num_pts": 4})


def test_kernel_settings_carried_from_jax():
    kj = JRBFStudent.create(2, PAR, dof=5.0, num_samples=1234, num_batches=7, seed=9,
                            use_pallas="force")
    k = convert.kernel_from_numpy({"par": np.asarray(kj.par), "dof": kj.dof,
                                   "num_samples": kj.num_samples,
                                   "num_batches": kj.num_batches, "seed": kj.seed,
                                   "use_pallas": kj.use_pallas})
    assert (k.dim, k.dof, k.num_samples, k.num_batches, k.seed, k.use_kernel) == \
        (2, 5.0, 1234, 7, 9, "force")
    _close(k.par, PAR)
