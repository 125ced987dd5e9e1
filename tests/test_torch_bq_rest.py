"""The rest of Bayesian quadrature in the PyTorch port: the kernel helpers and
the RQ kernel, GP and TP prediction, NLML and optimization, the multi-output
models and transforms, and per-call kernel parameters of the BQ transforms,
against the JAX package and the goldens.

Tolerances:

- goldens (``transforms.npz``, ``transforms2.npz``) at
  ``tests/test_parity.py``'s 1e-8;
- the JAX package at 1e-12 relative to each array's largest entry where the
  same closed forms meet (the RQ ``Q``, ``der_par``, the multi-output
  weights, ``apply(kern_par=...)``), at 1e-10 where a Cholesky solve of a
  Gram enters a prediction or an NLML and its gradient;
- :meth:`Model.optimize` at 1e-6 of the JAX package's optimum (both run
  SciPy's BFGS on their own value and gradient);
- the RQ kernel's ``alpha -> inf`` limit: its ``Q`` at ``alpha = 1e7``
  within 1e-5 relative of the RBF kernel's.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssmtoybox_tpu.bq import kernels as jkernels, models as jmodels, transforms as jtransforms
from ssmtoybox_tpu.bq.gpqd import GaussianProcessDerModel as JGPQDModel
from ssmtoybox_tpu.bq.gpqd import GaussianProcessDerTransform as JGPQD
from ssmtoybox_torch import convert, set_device
from ssmtoybox_torch.bq import kernels, models, transforms
from ssmtoybox_torch.bq.gpqd import GaussianProcessDerTransform


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
EXACT = 1e-12
SOLVE = 1e-10
RQ_PAR = np.array([[1.2, 1.7, 0.9, 1.4]])
MO_PAR = np.array([[1.0, 0.7, 1.1], [1.3, 0.9, 1.4]])


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t)


def _close(got, want, tol, label=""):
    want = np.atleast_1d(_np(want))
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(np.atleast_1d(_np(got)), want, rtol=tol, atol=tol * scale,
                               err_msg=label)


@pytest.fixture(scope="module")
def goldens():
    from pathlib import Path
    root = Path(__file__).parent / "goldens"
    return {name: np.load(root / f"{name}.npz") for name in ("transforms", "transforms2")}


def _x(seed, d, n):
    return np.random.default_rng(seed).normal(size=(d, n))


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------

def test_rq_against_goldens_and_jax(goldens):
    """K, q, R and E[k(x, y)] against the goldens; Q against the JAX
    package's sign-fixed formula (the golden ``rq_Q`` holds the reference's
    sign bug)."""
    g = goldens["transforms"]
    x, par = g["kern_x"], g["rq_par"]
    rq = kernels.get_kernel(2, "rq", par)
    assert isinstance(rq, kernels.RQ)
    xt, pt = torch.as_tensor(x), torch.as_tensor(par)
    _close(rq.eval(pt, xt), g["rq_K"], PARITY, "K")
    _close(rq.exp_x_kx(pt, xt), g["rq_q"], PARITY, "q")
    _close(rq.exp_x_xkx(pt, xt), g["rq_R"], PARITY, "R")
    _close(rq.exp_xy_kxy(pt), g["rq_kxy"], PARITY, "kxy")
    want = jax.jit(lambda k: (k.exp_x_kxkx(par, par, x), k.exp_x_kxkx(par, par, x, scaling=True),
                              k.eval(par, x, x, diag=True)))(jkernels.RQ.create(2, par))
    _close(rq.exp_x_kxkx(pt, pt, xt), want[0], EXACT, "Q")
    _close(rq.exp_x_kxkx(pt, pt, xt, scaling=True), want[1], EXACT, "Q scaled")
    _close(rq.eval(pt, xt, xt, diag=True), want[2], EXACT, "diag")
    with pytest.raises(NotImplementedError):
        rq.der_par(pt, xt)
    with pytest.raises(ValueError):
        kernels.RQ(2, [[1.0, 1.0, 1.0]])


def test_rq_rbf_limit():
    """As alpha -> inf the RQ kernel and its Gaussian expectations become the
    RBF's; the sign-fixed Q meets that limit."""
    x = torch.as_tensor(_x(0, 2, 5))
    rq_par = torch.tensor([[1.0, 1e7, 0.8, 1.3]], dtype=torch.float64)
    rbf_par = torch.tensor([[1.0, 0.8, 1.3]], dtype=torch.float64)
    rq, rbf = kernels.RQ(2, rq_par), kernels.RBFGauss(2, rbf_par)
    for name in ("exp_x_kx", "exp_x_xkx"):
        _close(getattr(rq, name)(rq_par, x), getattr(rbf, name)(rbf_par, x), 1e-5, name)
    _close(rq.exp_x_kxkx(rq_par, rq_par, x), rbf.exp_x_kxkx(rbf_par, rbf_par, x), 1e-5, "Q")


def test_kernel_helpers_against_jax():
    """``scale``, ``eval_chol`` and the RBF ``der_par`` (d/d log l for the
    length-scales) as in the JAX package."""
    par = np.array([[1.3, 0.8, 1.6], [0.7, 1.1, 0.9]])
    x = _x(1, 2, 6)
    k = kernels.RBFGauss(2, par)
    want = jax.jit(lambda k: (k.scale, [(k.eval_chol(p, x), k.der_par(p, x)) for p in par]))(
        jkernels.RBFGauss.create(2, par))
    _close(k.scale, want[0], 0.0, "scale")
    for row in range(2):
        pt = torch.as_tensor(par[row])
        _close(k.eval_chol(pt, torch.as_tensor(x)), want[1][row][0], EXACT, "chol")
        _close(k.der_par(pt, torch.as_tensor(x)), want[1][row][1], EXACT, "der_par")
    rq = kernels.RQ(2, RQ_PAR)
    _close(rq.scale, RQ_PAR[:, 0], 0.0, "RQ scale")


# ---------------------------------------------------------------------------
# GP and TP models: predict, NLML, optimize, plot
# ---------------------------------------------------------------------------

def _ungm_fit_data(n=8, seed=2):
    """The UNGM dynamics at ``n`` points, (1, n) and (n, 1)."""
    x = np.random.default_rng(seed).uniform(-6.0, 6.0, size=(1, n))
    y = 0.5 * x + 25.0 * x / (1.0 + x ** 2)
    return x, y.T


@pytest.mark.parametrize("kind", ["gp-rbf", "gp-rq", "tp-rbf"])
def test_predict_and_nlml_against_jax(kind):
    """Prediction at test points from observations at the points, and the
    NLML's value and autograd gradient against ``jax.grad``."""
    model_kind, kern = kind.split("-")
    par = RQ_PAR[:, [0, 1, 2]] if kern == "rq" else np.array([[2.0, 1.3]])
    if model_kind == "gp":
        port = models.GaussianProcessModel(1, par, kern, "gh", {"degree": 7})
        jax_m = jmodels.GaussianProcessModel.create(1, par, kern, "gh", {"degree": 7})
    else:
        port = models.StudentTProcessModel(1, par, kern, "gh", {"degree": 7}, nu=5.0)
        jax_m = jmodels.StudentTProcessModel.create(1, par, kern, "gh", {"degree": 7}, nu=5.0)
    test = np.linspace(-3.0, 3.0, 9)[None]
    fo = np.sin(np.asarray(jax_m.points)).reshape(-1)
    x, y = _ungm_fit_data()
    jitter = 1e-8 * np.eye(x.shape[1])
    lp = np.log(par.reshape(-1)) + 0.1

    @jax.jit
    def reference(m, lp):
        nlml = jax.value_and_grad(lambda p: m.neg_log_marginal_likelihood(p, y, x, jitter))
        return m.predict(test, fo), nlml(lp)

    want_pred, (want_v, want_g) = reference(jax_m, lp)
    for got, want in zip(port.predict(test, fo), want_pred):
        _close(got, want, SOLVE, f"{kind} predict")
    lp_t = torch.tensor(lp, requires_grad=True)
    v = port.neg_log_marginal_likelihood(lp_t, torch.as_tensor(y), torch.as_tensor(x),
                                         torch.as_tensor(jitter))
    (g,) = torch.autograd.grad(v, lp_t)
    _close(v, want_v, SOLVE, f"{kind} NLML")
    _close(g, want_g, SOLVE, f"{kind} NLML gradient")


def test_optimize_against_jax():
    """BFGS on the NLML from the same start reaches the JAX package's
    optimum; the fitted model predicts the data."""
    x, y = _ungm_fit_data()
    par = np.array([[1.0, 1.0]])
    port = models.GaussianProcessModel(1, par, "rbf", "ut")
    jax_m = jmodels.GaussianProcessModel.create(1, par, "rbf", "ut")
    lp0 = np.log([3.0, 1.5])
    got, want = port.optimize(lp0, y, x), jax_m.optimize(lp0, y, x)
    assert got.success and want.success
    _close(got.x, want.x, 1e-6, "optimum")
    _close(got.fun, want.fun, 1e-6, "NLML at the optimum")
    mean, _ = port.predict(x, y.T, x_obs=x, par=np.exp(got.x))
    _close(mean, y[:, 0], 1e-3, "fit")


def test_weights_shortcut_and_plot():
    """``weights=`` short-cuts the variances; ``plot_model`` returns a
    figure without showing it."""
    gp = models.GaussianProcessModel(1, [[1.0, 1.0]], "rbf", "ut")
    w = gp.bq_weights()
    assert gp.exp_model_variance(weights=w) is w.model_var
    assert gp.integral_variance(weights=w) is w.integral_var
    _close(gp.integral_variance(), w.integral_var, EXACT, "integral variance")
    assert gp.bq_weights(with_integral_var=False).integral_var is None
    pytest.importorskip("matplotlib")
    fig = gp.plot_model(np.linspace(-3, 3, 30)[None], torch.sin(gp.points).reshape(-1),
                        fcn_true=np.sin(np.linspace(-3, 3, 30)))
    assert fig is not None


# ---------------------------------------------------------------------------
# multi-output models and transforms
# ---------------------------------------------------------------------------

def _p2c_torch(x, time):
    return x[..., :1] * torch.stack([torch.cos(x[..., 1]), torch.sin(x[..., 1])], dim=-1)


def _p2c_jax(x, pars):
    return x[0] * jnp.stack([jnp.cos(x[1]), jnp.sin(x[1])])


def test_mo_transforms_against_goldens(goldens):
    g = goldens["transforms2"]
    mean, cov = torch.as_tensor(g["mean2"])[None], torch.as_tensor(g["cov2"])[None]
    for tag, tf in (("gp", transforms.MultiOutputGaussianProcessTransform(2, 2, g["mo_par"])),
                    ("tp", transforms.MultiOutputStudentTProcessTransform(2, 2, g["mo_par"],
                                                                          nu=4.0))):
        assert not isinstance(tf, transforms.BQTransform)
        for attr, key in (("wm", "wm"), ("Wc", "wc"), ("Wcc", "wcc")):
            _close(getattr(tf, attr), g[f"mo_{tag}_{key}"], PARITY, f"{tag} {attr}")
        for got, key in zip(tf.apply(_p2c_torch, mean, cov, 0), ("mf", "cf", "ccf")):
            _close(got[0], g[f"mo_{tag}_{key}"], PARITY, f"{tag} {key}")


MO3_PAR = np.array([[1.0, 0.7, 1.1], [1.3, 0.9, 1.4], [0.8, 1.2, 0.6]])


@pytest.mark.parametrize("mirror", [True, False])
def test_mo_weights_against_jax(mirror):
    """Every MOWeights field under both ``compat_mirror_wc`` settings."""
    port = models.GaussianProcessMO(2, 3, MO3_PAR, compat_mirror_wc=mirror)
    jw = jax.jit(lambda m: m.bq_weights())(
        jmodels.GaussianProcessMO.create(2, 3, MO3_PAR, compat_mirror_wc=mirror))
    w = port.bq_weights()
    for f in ("wm", "Wc", "Wcc", "q", "Q", "R", "iK"):
        _close(getattr(w, f), getattr(jw, f), EXACT, f)


def test_mo_variances_and_nlml_against_jax():
    """The per-output EMVs (GP and TP), integral variances and NLML terms;
    the TP model's refusals."""
    port, tp = models.GaussianProcessMO(2, 3, MO3_PAR), models.StudentTProcessMO(2, 3, MO3_PAR,
                                                                                  nu=5.0)
    fx = _x(3, 3, port.num_pts)
    x, y = _ungm_fit_data()
    jitter = 1e-8 * np.eye(x.shape[1])
    lp = np.log(MO3_PAR[0])

    @jax.jit
    def reference(gp, tp):
        nlml = [m.neg_log_marginal_likelihood(lp, y[:, 0], x, jitter) for m in (gp, tp)]
        return (gp.exp_model_variance(gp.bq_weights()), gp.integral_variance(),
                tp.exp_model_variance(tp.bq_weights(), fx), nlml)

    want = reference(jmodels.GaussianProcessMO.create(2, 3, MO3_PAR),
                     jmodels.StudentTProcessMO.create(2, 3, MO3_PAR, nu=5.0))
    _close(port.exp_model_variance(port.bq_weights()), want[0], EXACT, "GP EMV")
    _close(port.integral_variance(), want[1], EXACT, "integral variance")
    _close(tp.exp_model_variance(tp.bq_weights(), fx), want[2], EXACT, "TP EMV")
    for m, w in zip((port, tp), want[3]):
        got = m.neg_log_marginal_likelihood(torch.as_tensor(lp), torch.as_tensor(y[:, 0]),
                                            torch.as_tensor(x), torch.as_tensor(jitter))
        _close(got, w, SOLVE, f"{type(m).__name__} NLML")
    assert tp.integral_variance() is None
    with pytest.raises(NotImplementedError):
        tp.predict(fx, fx)


def test_mo_optimize_per_output():
    """``optimize`` of a multi-output model fits each output's row on its
    own, as the single-output model does on that output."""
    x, y = _ungm_fit_data()
    fo = np.vstack([y[:, 0], np.cos(x[0])])
    mo = models.GaussianProcessMO(1, 2, [[1.0, 1.0]] * 2)
    par, results = mo.optimize(np.log([[3.0, 1.5], [1.0, 1.0]]), fo, x)
    assert par.shape == (2, 2) and len(results) == 2
    single = models.GaussianProcessModel(1, [[1.0, 1.0]]).optimize(np.log([3.0, 1.5]),
                                                                 y, x)
    _close(par[0], single.x, 1e-8, "output 0")


def test_mo_apply_against_jax_and_single_output():
    """The MO transforms against the JAX package on a batch of inputs (a
    correlated covariance tells the cross-covariance's orientation); with
    equal rows the MO-GPQ means and cross-covariances are the single-output
    GPQ's."""
    par = np.array([[1.0, 1.5, 1.5]] * 2)
    rng = np.random.default_rng(4)
    means = np.array([1.0, 0.5]) + 0.1 * rng.normal(size=(3, 2))
    cov = np.array([[0.4, 0.15], [0.15, 0.3]])
    covs = np.broadcast_to(cov, (3, 2, 2)).copy()
    f_t = lambda x, t: torch.stack([x[..., 0] * x[..., 1], torch.sin(x[..., 0])], -1)  # noqa: E731
    f_j = lambda x, p: jnp.stack([x[0] * x[1], jnp.sin(x[0])])  # noqa: E731
    ports = (transforms.MultiOutputGaussianProcessTransform(2, 2, par),
             transforms.MultiOutputStudentTProcessTransform(2, 2, par, nu=5.0))
    # the JAX transforms hold the port's weights; their formulas are held
    # to the JAX package's weights in test_mo_weights_against_jax
    jax_tfs = [cls(model=m, dim_out=2, **{k: _np(getattr(p, k))
                                          for k in ("wm", "Wc", "Wcc", "Q", "iK")})
               for p, cls, m in zip(ports, (jtransforms.MultiOutputGaussianProcessTransform,
                                            jtransforms.MultiOutputStudentTProcessTransform),
                                    (jmodels.GaussianProcessMO.create(2, 2, par),
                                     jmodels.StudentTProcessMO.create(2, 2, par, nu=5.0)))]
    wants = jax.jit(lambda tfs: [jax.vmap(lambda m: tf.apply(f_j, m, cov, None))(means)
                                 for tf in tfs])(jax_tfs)
    for port, want in zip(ports, wants):
        got = port.apply(f_t, torch.as_tensor(means), torch.as_tensor(covs), 0)
        for a, b, name in zip(got, want, ("mean", "cov", "cross-cov")):
            _close(a, b, EXACT, f"{type(port).__name__} {name}")
    so = transforms.GaussianProcessTransform(2, 2, par[:1])
    mo = transforms.MultiOutputGaussianProcessTransform(2, 2, par)
    got = mo.apply(f_t, torch.as_tensor(means), torch.as_tensor(covs), 0)
    want = so.apply(f_t, torch.as_tensor(means), torch.as_tensor(covs), 0)
    _close(got[0], want[0], 1e-8, "mean")
    _close(got[2], want[2], 1e-8, "cross-cov")


def test_mo_convert_and_kern_par():
    """An MO transform carried across by its arrays applies like the one it
    came from; one built from weights refuses ``kern_par``; ``kern_par``
    equal to the construction rows gives the construction-time bits."""
    rng = np.random.default_rng(5)
    mean = torch.as_tensor(rng.normal(size=(2, 2)))
    cov = torch.eye(2, dtype=torch.float64).expand(2, 2, 2) * 0.3
    f = _p2c_torch
    for tf in (transforms.MultiOutputGaussianProcessTransform(2, 2, MO_PAR),
               transforms.MultiOutputStudentTProcessTransform(2, 2, MO_PAR, nu=4.0)):
        d = {k: _np(getattr(tf, k)) for k in ("points", "wm", "Wc", "Wcc", "Q", "iK", "scale")}
        if hasattr(tf, "nu"):
            d.update(nu=tf.nu, num_pts=tf.num_pts)
        loaded = convert.transform_from_numpy(d)
        assert type(loaded) is type(tf)
        for a, b in zip(loaded.apply(f, mean, cov, 0), tf.apply(f, mean, cov, 0)):
            assert torch.equal(a, b)
        with pytest.raises(ValueError, match="precomputed weights"):
            loaded.apply(f, mean, cov, 0, kern_par=MO_PAR)
        for a, b in zip(tf.apply(f, mean, cov, 0, kern_par=MO_PAR), tf.apply(f, mean, cov, 0)):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# per-call kernel parameters of the single-output transforms
# ---------------------------------------------------------------------------

def _so_pairs():
    """Port transforms and the JAX package's on the same models; the JAX
    transforms hold the port's weights, which ``kern_par`` replaces."""
    par = np.array([[1.2, 1.1, 0.9]])
    mulind = np.hstack([np.zeros((2, 1), int), np.eye(2, dtype=int), 2 * np.eye(2, dtype=int)])
    pairs = [
        ("GPQ", transforms.GaussianProcessTransform(2, 2, par),
         jtransforms.GaussianProcessTransform, jmodels.GaussianProcessModel.create(2, par)),
        ("BSQ", transforms.BayesSardTransform(2, 2, par, mulind), jtransforms.BayesSardTransform,
         jmodels.BayesSardModel.create(2, par, mulind)),
        ("TPQ", transforms.StudentTProcessTransform(2, 2, par, nu=5.0),
         jtransforms.StudentTProcessTransform, jmodels.StudentTProcessModel.create(2, par, nu=4.0)),
        ("GPQ+D", GaussianProcessDerTransform(2, 2, par), JGPQD,
         JGPQDModel.create(2, par)),
    ]
    return [(name, port, cls(model=m, **{k: _np(getattr(port, k)) for k in (
        "wm", "Wc", "Wcc", "model_var", "integral_var", "iK")}, dim_out=2))
        for name, port, cls, m in pairs]


def test_apply_kern_par_against_jax():
    """``apply(..., kern_par=theta)`` against the JAX package's
    ``apply(..., kern_par)`` at another theta; the construction parameters
    give the construction-time bits; a gradient reaches theta."""
    rng = np.random.default_rng(6)
    means = np.array([1.0, 0.5]) + 0.2 * rng.normal(size=(2, 2))
    cov = np.array([[0.4, 0.1], [0.1, 0.3]])
    covs = torch.as_tensor(np.broadcast_to(cov, (2, 2, 2)).copy())
    pairs = _so_pairs()
    theta = pairs[0][1].model.kernel.par * torch.tensor([[1.1, 0.9, 0.9]], dtype=torch.float64)
    wants = jax.jit(lambda tfs, th: [jax.vmap(lambda m: tf.apply(
        _p2c_jax, m, cov, None, kern_par=th))(means) for tf in tfs])(
        [p[2] for p in pairs], _np(theta))
    for (name, port, _), want in zip(pairs, wants):
        base = port.model.kernel.par
        got = port.apply(_p2c_torch, torch.as_tensor(means), covs, 0, kern_par=theta)
        for i, part in enumerate(("mean", "cov", "cross-cov")):
            _close(got[i], want[i], EXACT, f"{name} {part}")
        same = port.apply(_p2c_torch, torch.as_tensor(means), covs, 0, kern_par=base.clone())
        for a, b in zip(same, port.apply(_p2c_torch, torch.as_tensor(means), covs, 0)):
            assert torch.equal(a, b), name
        th = theta.clone().requires_grad_(True)
        out = port.apply(_p2c_torch, torch.as_tensor(means), covs, 0, kern_par=th)
        (g,) = torch.autograd.grad(out[1].sum(), th)
        assert bool(torch.isfinite(g).all()) and bool(g.abs().sum() > 0), name


def test_from_weights_refuses_kern_par():
    port = transforms.StudentTProcessTransform(1, 1, [[1.0, 2.0]])
    d = {k: _np(getattr(port, k)) for k in ("points", "wm", "Wc", "Wcc", "model_var", "iK")}
    for loaded in (convert.transform_from_numpy(dict(d, nu=port.nu)),
                   convert.transform_from_numpy(d)):
        with pytest.raises(ValueError, match="precomputed weights"):
            loaded.apply(lambda x, t: torch.sin(x), torch.zeros(1, 1), torch.eye(1)[None], 0,
                         kern_par=[[1.0, 2.0]])
