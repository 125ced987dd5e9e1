"""GPQ with derivative observations (GPQ+D) in the PyTorch port: the RBF
derivative kernel and its expectations, the joint model's weights, variances
and prediction, the transform, the GPQ+D Kalman filter, and its refusal by
both fused engines.

Tolerances:

- goldens (``gpqd.npz``) at ``tests/test_parity.py``'s 1e-8;
- the JAX package: the kernel blocks and expectations, which need no
  inverse, at 1e-12 (2-D, derivatives at 3 of 5 points); the transform of
  the UNGM filter below (RBF ``[[1, 2]]``, UT points, derivatives at the
  outer two: a joint Gram of condition number 1.1e3) on a batch of 3 inputs
  from a numpy seed, its weights and prediction, at the goldens' 1e-8
  relative to each array's largest entry;
- the GPQ+D Kalman filter and RTS smoother on UNGM against the JAX package,
  2 records of 20 steps, at 1e-10 relative to each stream's largest entry,
  run on the JAX transform's weights (carried across with ``convert``): the
  UNGM recursion grows the weights' 1e-12 difference to 5e-9 in 20 steps.
  (The hybrid demo's configuration, ``[[1, 3]]`` with derivatives at every
  point, has a Gram of condition number 3.5e5: there ``Wc = K^-1 Q K^-1``,
  entries of K^-1 up to 8.8e4 and of Wc below 0.9, differs between the
  packages by up to 1e-7 of its largest entry, from the same K^-1 and Q as
  much as from the port's own.)
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import ssmtoybox_tpu as st
from ssmtoybox_tpu.bq.gpqd import GaussianProcessDerTransform as JGPQD
from ssmtoybox_tpu.bq.gpqd import RBFGaussDer as JRBFGaussDer
from ssmtoybox_tpu.ssmod import UNGMMeasurement as JUNGMMeasurement
from ssmtoybox_tpu.ssmod import UNGMTransition as JUNGMTransition
from ssmtoybox_tpu.utils import GaussRV as JGaussRV
import ssmtoybox_torch as stt
from ssmtoybox_torch import convert, set_device
from ssmtoybox_torch.bq import GaussianProcessTransform
from ssmtoybox_torch.bq.gpqd import GaussianProcessDerTransform, RBFGaussDer
from ssmtoybox_torch.mtran import apply_f_columns
from ssmtoybox_torch.ops import scalar_filter as sf, vector_filter as vf
from ssmtoybox_torch.ssmod import UNGMMeasurement, UNGMTransition
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


PARITY = 1e-8
EXACT = 1e-12
GRAM = 1e-8
FILTER = 1e-10
#: a 2-D kernel and a derivative subset
PAR = np.array([[1.0, 1.5, 2.0]])
WHICH = [0, 2, 4]
#: the configuration held to the JAX package, that of the UNGM filter
KPAR = np.array([[1.0, 2.0]])
KWHICH = [0, 2]


def _np(t):
    return t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(got, want, tol, what, relative=False):
    want = np.asarray(want)
    atol = tol * max(float(np.abs(want).max()), 1e-300) if relative else tol
    np.testing.assert_allclose(_np(got), want, rtol=tol, atol=atol, err_msg=what)


def p2c(x, time):
    return x[..., :1] * torch.stack([torch.cos(x[..., 1]), torch.sin(x[..., 1])], dim=-1)


def sin_quad(x, time):
    """The GPQ+D demo's integrand, ``sin(x) + x^2 / 2``."""
    return torch.sin(x) + 0.5 * x ** 2


def jsin_quad(x, pars):
    return jnp.sin(x) + 0.5 * x ** 2


@pytest.fixture(scope="module")
def jax_tf():
    """The JAX package's transform of the configuration held here."""
    return JGPQD.create(1, 1, KPAR, point_str="ut", which_der=KWHICH)


@pytest.fixture(scope="module")
def port_tf():
    return GaussianProcessDerTransform(1, 1, KPAR, "ut", which_der=KWHICH)


def _inputs(seed=0, batch=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(batch, 1)), rng.uniform(0.2, 2.0, (batch, 1, 1))


@pytest.fixture(scope="module")
def jax_applied(jax_tf):
    """The JAX transform on the batch of ``_inputs()``."""
    mean, cov = _inputs()
    return jax.jit(jax.vmap(lambda m, c: jax_tf.apply(jsin_quad, m, c, None)))(
        jnp.asarray(mean), jnp.asarray(cov))


# ---------------------------------------------------------------------------
# goldens
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("prefix,dim", [("d1", 1), ("d2", 2)])
def test_kernel_matches_golden(goldens, prefix, dim):
    g = goldens["gpqd"]
    x, par = torch.as_tensor(g[f"{prefix}_x"]), torch.as_tensor(g[f"{prefix}_par"])
    kern = RBFGaussDer(dim, par)
    _close(kern.eval(par, x), g[f"{prefix}_K"], PARITY, "joint K")
    _close(kern.exp_x_dkx(par, x), g[f"{prefix}_qd"], PARITY, "qd")
    _close(kern.exp_x_xdkx(par, x), g[f"{prefix}_Rd"], PARITY, "Rd")
    _close(kern.exp_x_kxdkx(par, x), g[f"{prefix}_Qfd"], PARITY, "Qfd")
    _close(kern.exp_x_dkxdkx(par, x), g[f"{prefix}_Qdd"], PARITY, "Qdd")


def test_transform_matches_golden(goldens):
    g = goldens["gpqd"]
    tf = GaussianProcessDerTransform(2, 2, g["d2_par"], point_str="ut")
    w = tf.model.bq_weights()
    _close(w.wm, g["gpqd_wm"], PARITY, "wm")
    _close(w.Wc, g["gpqd_wc"], PARITY, "Wc")
    _close(w.Wcc, g["gpqd_wcc"], PARITY, "Wcc")
    _close(w.model_var.reshape(1), g["gpqd_emv"], PARITY, "emv")
    _close(w.integral_var.reshape(1), g["gpqd_ivar"], PARITY, "ivar")
    assert torch.equal(tf.model.exp_model_variance(weights=w), w.model_var)
    _close(tf.model.integral_variance(), g["gpqd_ivar"][0], PARITY, "integral_variance()")
    mf, cf, ccf = tf.apply(p2c, torch.as_tensor(g["gpqd_mean_in"])[None],
                           torch.as_tensor(g["gpqd_cov_in"])[None], 0)
    _close(mf[0], g["gpqd_mf"], PARITY, "mean")
    _close(cf[0], g["gpqd_cf"], PARITY, "cov")
    _close(ccf[0], g["gpqd_ccf"], PARITY, "cross-covariance")


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

def test_kernel_blocks_match_jax_at_a_derivative_subset():
    rng = np.random.default_rng(1)
    x, y, par = rng.normal(size=(2, 5)), rng.normal(size=(2, 4)), PAR
    kern, jkern, wd = RBFGaussDer(2, par), JRBFGaussDer.create(2, par), np.array(WHICH)
    names = ("exp_x_dkx", "exp_x_xdkx", "exp_x_kxdkx", "exp_x_dkxdkx")

    @jax.jit
    def jax_blocks(xj, yj):
        return ((jkern.eval(par, xj, which_der=wd), jkern.eval(par, yj, xj, which_der=wd))
                + tuple(getattr(jkern, n)(par, xj, which_der=wd) for n in names))

    xt, yt, pt = torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(par)
    got = ((kern.eval(pt, xt, which_der=WHICH), kern.eval(pt, yt, xt, which_der=WHICH))
           + tuple(getattr(kern, n)(pt, xt, which_der=WHICH) for n in names))
    for g_, w_, what in zip(got, jax_blocks(jnp.asarray(x), jnp.asarray(y)),
                            ("joint K", "cross K") + names):
        _close(g_, w_, EXACT, what)
    L = kern.eval_chol(pt, xt, which_der=WHICH)
    _close(L @ L.T, got[0] + kern.jitter * torch.eye(L.shape[0], dtype=torch.float64), EXACT,
           "eval_chol")


def test_weights_match_jax(jax_tf, port_tf):
    assert port_tf.which_der == tuple(KWHICH) == tuple(jax_tf.model.which_der)
    for name in ("wm", "Wc", "Wcc", "iK", "model_var", "integral_var"):
        _close(getattr(port_tf, name), getattr(jax_tf, name), GRAM, name, relative=True)


def test_transform_matches_jax_on_a_batch(jax_applied, port_tf):
    mean, cov = _inputs()
    got = port_tf.apply(sin_quad, torch.as_tensor(mean), torch.as_tensor(cov), 0)
    for g_, w_, what in zip(got, jax_applied, ("mean", "cov", "cross-cov")):
        _close(g_, w_, GRAM, what, relative=True)


def test_predict_matches_jax(jax_tf, port_tf):
    """The predictive moments from joint observations: the function values
    at the points, then the derivatives at ``which_der``."""
    rng = np.random.default_rng(2)
    test = rng.normal(size=(1, 6))
    obs = rng.normal(size=3 + len(KWHICH))
    got = port_tf.model.predict(test, obs)
    want = jax.jit(jax_tf.model.predict)(jnp.asarray(test), jnp.asarray(obs))
    for g_, w_, what in zip(got, want, ("mean", "variance")):
        _close(g_, w_, GRAM, what, relative=True)
    with pytest.raises(ValueError, match="must stack 3 function values and 2 Jacobian"):
        port_tf.model.predict(test, obs[:-1])


def _carried(jtf):
    keys = ("wm", "Wc", "Wcc", "model_var", "iK", "integral_var")
    return convert.transform_from_numpy(
        {**{k: np.asarray(getattr(jtf, k)) for k in keys}, "dim_out": jtf.dim_out,
         "points": np.asarray(jtf.model.points), "which_der": np.asarray(jtf.model.which_der)})


def test_loaded_from_jax_weights(jax_tf, jax_applied):
    """``convert`` carries the JAX transform's weights and ``which_der``
    across: the result transforms as the JAX transform does."""
    tf = _carried(jax_tf)
    assert type(tf) is GaussianProcessDerTransform and tf.which_der == tuple(KWHICH)
    mean, cov = _inputs()
    got = tf.apply(sin_quad, torch.as_tensor(mean), torch.as_tensor(cov), 0)
    for g_, w_, what in zip(got, jax_applied, ("mean", "cov", "cross-cov")):
        _close(g_, w_, EXACT, what, relative=True)


# ---------------------------------------------------------------------------
# the integrand hook
# ---------------------------------------------------------------------------

def test_integrand_columns_are_values_then_jacobians():
    """``_fcn_eval`` appends each derivative point's Jacobian, a block of D
    columns for each output row, after the N values."""
    tf = GaussianProcessDerTransform(2, 2, PAR, "ut", which_der=WHICH)
    rng = np.random.default_rng(4)
    x = torch.as_tensor(np.array([1.0, 0.3])[:, None] + 0.1 * rng.normal(size=(3, 2, 5)))
    fx = tf._fcn_eval(p2c, x, 0)
    assert fx.shape == (3, 2, 5 + 2 * len(WHICH))
    assert torch.equal(fx[..., :5], apply_f_columns(p2c, x, 0))
    r, th = x[:, 0, 2], x[:, 1, 2]                      # the second derivative point
    want = torch.stack([torch.stack([torch.cos(th), -r * torch.sin(th)], -1),
                        torch.stack([torch.sin(th), r * torch.cos(th)], -1)], 1)
    torch.testing.assert_close(fx[..., 7:9], want, rtol=1e-15, atol=1e-15)


def test_other_bq_transforms_keep_their_bits():
    """The integrand hook defaults to the values alone: a GPQ transform gives
    the bits of the formula written out."""
    tf = GaussianProcessTransform(2, 2, PAR)
    rng = np.random.default_rng(5)
    mean = torch.as_tensor(np.array([1.0, 0.3]) + 0.1 * rng.normal(size=(3, 2)))
    cov = torch.as_tensor(np.diag([0.01, 0.1])).expand(3, 2, 2)
    L = torch.linalg.cholesky_ex(cov)[0]
    fx = apply_f_columns(p2c, mean[..., None] + L @ tf.points, 0)
    mf = fx @ tf.wm
    want = (mf, fx @ tf.Wc @ fx.mT - mf[..., :, None] * mf[..., None, :] + tf._emv,
            fx @ tf.Wcc.mT @ L.mT)
    for got, w_ in zip(tf.apply(p2c, mean, cov, 0), want):
        assert torch.equal(got, w_)


# ---------------------------------------------------------------------------
# the filter
# ---------------------------------------------------------------------------

def test_filter_and_smoother_match_jax(jax_tf):
    """The GPQ+D Kalman filter on the hybrid demo's system (UNGM, Q 10, R 1),
    2 records of 20 steps: every stream and the RTS smoother.  The filter
    builds its own transforms; they are then swapped for the JAX one's
    weights, so that the comparison sees the filter and not the weights'
    rounding (held above)."""
    dyn = UNGMTransition(GaussRV(1, cov=5.0), GaussRV(1, cov=10.0))
    obs = UNGMMeasurement(GaussRV(1, cov=1.0), dim_state=1)
    jdyn = JUNGMTransition.create(JGaussRV.create(1, cov=5.0), JGaussRV.create(1, cov=10.0))
    jobs = JUNGMMeasurement.create(JGaussRV.create(1, cov=1.0), dim_state=1)
    gen = torch.Generator().manual_seed(0)
    ys = obs.simulate_measurements(gen, dyn.simulate_discrete(gen, 20, 2)).permute(2, 0, 1)
    alg = stt.GaussianProcessDerKalman(dyn, obs, KPAR, KPAR, which_der=KWHICH)
    for tf in (alg.tf_dyn, alg.tf_obs):
        assert (tf.which_der, tf.dim_out, tuple(tf.points.shape)) == (tuple(KWHICH), 1, (1, 3))
    # both transforms of the filter are this one (UNGM: 1-D in and out)
    alg.tf_dyn = alg.tf_obs = _carried(jax_tf)
    res = alg.forward_pass_batch(ys)
    ref = jax.jit(lambda b: st.gaussian_filter_batch(jdyn, jobs, jax_tf, jax_tf, b))(
        jnp.asarray(ys.numpy()))
    for f in ("fi_mean", "fi_cov", "pr_mean", "pr_cov", "pr_xx_cov"):
        _close(getattr(res, f), getattr(ref, f), FILTER, f, relative=True)
    sm = jax.jit(jax.vmap(st.gaussian_smoother))(ref)
    for got, want, what in zip(stt.gaussian_smoother(res), sm, ("smoothed mean", "cov")):
        _close(got, want, FILTER, what, relative=True)


@pytest.mark.parametrize("lowering", ["scalar", "vector"])
def test_fused_engines_refuse_gpqd(lowering):
    """A GPQ+D transform is a BQTransform whose weights run past the points;
    both lowerings refuse it by name before their BQ branch (the JAX dd
    engine reads the first N weights and filters on silently)."""
    dim = 1 if lowering == "scalar" else 2
    tf = GaussianProcessDerTransform(dim, 1, np.ones((1, dim + 1)))
    with pytest.raises(ValueError, match="GPQ\\+D derivative observations have no kernel form"):
        if lowering == "scalar":
            sf.lower_transform(tf)
        else:
            vf.lower_transform(tf, dim)


@pytest.mark.parametrize("par", [[[1.0, 1.5]], [[1.0, 3.0]]], ids=["demo", "hybrid"])
def test_gpqd_rules_keep_the_variance_of_a_constant(par):
    """The GPQ+D rules of ``experiments/gpqd_demo.py`` (RBF ``[[1, 1.5]]``,
    UT points, the transform study) and of its hybrid filter and
    ``chip_smoke.py`` phase 20's GPQ+D lane (RBF ``[[1, 3]]``: a joint Gram
    of condition number 3.5e5) form ``Wc = K^-1 Q K^-1`` directly.  Their
    ``1^T Wc 1 - (1^T wm)^2``, the variance a filter gives a constant
    integrand, stays positive and within 1e-7 relative of its value in
    long-double arithmetic from the same joint Gram matrix and kernel
    expectations (measured 5.4e-13 and 4.7e-9 off), unlike the reentry GPQ
    rule of ``tests/test_torch_experiments_tracking.py``, which lost its sign
    before its ``Wc`` was centred."""
    tf = GaussianProcessDerTransform(1, 1, np.array(par), "ut", device="cpu")
    k, x, wd = tf.model.kernel, tf.model.points, tf.model.which_der
    p = k.get_parameters(None)
    q, _, Q = k.exp_x_qRQ(p, x)
    Qfd = k.exp_x_kxdkx(p, x, which_der=wd)
    q_t = torch.cat([q, k.exp_x_dkx(p, x, which_der=wd)]).numpy().astype(np.longdouble)
    Q_t = torch.cat([torch.cat([Q, Qfd], 1),
                     torch.cat([Qfd.T, k.exp_x_dkxdkx(p, x, which_der=wd)], 1)])
    Q_t = Q_t.numpy().astype(np.longdouble)
    # the jittered joint Gram matrix the weights use, inverted by Gauss-Jordan in long double
    A = k._jittered(p, x, False, wd).numpy().astype(np.longdouble)
    n = A.shape[0]
    G = np.hstack([A, np.eye(n, dtype=np.longdouble)])
    for i in range(n):
        G[i] /= G[i, i]
        for j in range(n):
            if j != i:
                G[j] -= G[j, i] * G[i]
    iK = G[:, n:]
    want = float((iK @ Q_t @ iK).sum() - (q_t @ iK).sum() ** 2)
    got = float(tf.Wc.sum() - tf.wm.sum() ** 2)
    assert want > 0 and got > 0
    assert abs(got - want) <= 1e-7 * want, (got, want)
