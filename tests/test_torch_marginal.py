"""Marginalized-parameter inference in the PyTorch port: the linear-algebra
helpers it brings, per-member BQ weights, the SciPy-BFGS, damped-Newton and
batch paths of ``MarginalInference`` and the float32 search, against the JAX
package and the golden UNGM record (``tests/goldens/marginal_ungm.npz``).

Tolerances:

- ``pd_inv``, ``mat_sqrt``, ``gen_inv``, ``ellipse_points`` and the
  per-member weights at 1e-12 (relative to each array's largest entry);
- the BFGS objective's value and gradient at 1e-10 relative, at five seeded
  log parameters of well-conditioned Grams (two outside the ``[-8, 8]`` box;
  long length-scales make the 3-point Gram near singular, and the two
  packages' weights then differ far beyond rounding);
- the first BFGS step (both packages' SciPy BFGS on their own value and
  gradient) at 1e-6;
- the damped-Newton path against the JAX package's: step 1 at 1e-8, steps
  2-4 at 2e-7 (measured 9e-8 on the covariance of step 4, the packages'
  Gram solves differing in rounding);
- the batch path's rows against single runs at 1e-10;
- ``inner_dtype="float32"``: step 1 at rtol 0.05 of float64 (as
  ``tests/test_ssmod_ssinf.py`` holds the JAX package), the search float32,
  the state moments float64;
- BFGS against Newton as ``tests/test_parity.py`` holds the JAX package:
  step 1 at rtol 0.05, RMSE within 1.5 and below 1.25x the golden's.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import ssmtoybox_tpu as st
from ssmtoybox_tpu.ssmod import UNGMMeasurement as JUNGMMeasurement
from ssmtoybox_tpu.ssmod import UNGMTransition as JUNGMTransition
from ssmtoybox_tpu.utils import GaussRV as JGaussRV
from ssmtoybox_tpu.utils import linalg as jlinalg
import ssmtoybox_torch as stt
from ssmtoybox_torch import set_device
from ssmtoybox_torch.ssinf import marginal_filter_batch
from ssmtoybox_torch.ssmod import UNGMMeasurement, UNGMTransition
from ssmtoybox_torch.utils import GaussRV
from ssmtoybox_torch.utils import linalg


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


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t)


def _close(got, want, tol, label=""):
    want = np.atleast_1d(_np(want))
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(np.atleast_1d(_np(got)), want, rtol=tol, atol=tol * scale,
                               err_msg=label)


def _rmse(fm, x):
    return float(np.sqrt(np.mean((_np(fm) - x) ** 2)))


@pytest.fixture(scope="module")
def golden():
    import os
    return np.load(os.path.join(os.path.dirname(__file__), "goldens", "marginal_ungm.npz"))


@pytest.fixture(scope="module")
def models():
    """The golden's UNGM system in both packages."""
    port = (UNGMTransition(GaussRV(1, cov=1.0), GaussRV(1, cov=10.0)),
            UNGMMeasurement(GaussRV(1, cov=1.0), dim_state=1))
    jax_ = (JUNGMTransition.create(JGaussRV.create(1, cov=1.0), JGaussRV.create(1, cov=10.0)),
            JUNGMMeasurement.create(JGaussRV.create(1, cov=1.0), dim_state=1))
    return port, jax_


@pytest.fixture(scope="module")
def jax_newton(models, golden):
    """The JAX package's damped-Newton filter on the golden's first 4 steps
    (one compile, shared)."""
    alg = st.ssinf.MarginalizedGaussianProcessKalman(*models[1])
    fm, fP = alg.forward_pass_compiled(jnp.asarray(golden["y"][:, :4]))
    return np.asarray(fm), np.asarray(fP)


@pytest.fixture(scope="module")
def port_bfgs(models, golden):
    alg = stt.MarginalizedGaussianProcessKalman(*models[0])
    fm, fP = alg.forward_pass(golden["y"])
    sm, sP = alg.backward_pass()
    return fm, fP, sm, sP


@pytest.fixture(scope="module")
def port_newton(models, golden):
    alg = stt.MarginalizedGaussianProcessKalman(*models[0])
    fm, fP = alg.forward_pass_compiled(golden["y"])
    sm, sP = alg.backward_pass()
    return fm, fP, sm, sP


# ---------------------------------------------------------------------------
# linear-algebra helpers
# ---------------------------------------------------------------------------

def test_linalg_helpers_match_jax():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(4, 4))
    spd = a @ a.T + 4 * np.eye(4)
    psd = np.diag([2.0, 1.0, 0.0, -1e-3])                    # not PD: the eigh fallback
    _close(linalg.pd_inv(torch.tensor(spd)), jlinalg.pd_inv(jnp.asarray(spd)), 1e-12)
    _close(linalg.pd_inv(torch.tensor(spd), jitter=0.1, do_symmetrize=False),
           jlinalg.pd_inv(jnp.asarray(spd), jitter=0.1, do_symmetrize=False), 1e-12)
    for m in (spd, psd):
        _close(linalg.mat_sqrt(torch.tensor(m)), jlinalg.mat_sqrt(jnp.asarray(m)), 1e-12)
    _close(linalg.gen_inv(torch.tensor(a)), jlinalg.gen_inv(jnp.asarray(a)), 1e-12)
    pos, cov = rng.normal(size=2), spd[:2, :2]
    _close(linalg.ellipse_points(torch.tensor(pos), torch.tensor(cov), num=37),
           jlinalg.ellipse_points(jnp.asarray(pos), jnp.asarray(cov), num=37), 1e-12)


def test_gen_solve_of_a_singular_matrix_does_not_raise():
    """As the JAX package's solve: a singular system gives inf or NaN, it
    does not stop the caller (which would read the LU's status back)."""
    out = linalg.gen_solve(torch.zeros(2, 2, dtype=torch.float64),
                           torch.ones(2, dtype=torch.float64))
    assert not bool(torch.isfinite(out).all())


def test_per_member_weights_match_single_rows():
    """``with_kern_par_batch`` derives each row's weights as
    ``with_kern_par`` does for that row alone."""
    tf = stt.GaussianProcessKalman(*_ungm(), np.ones((1, 2)), np.ones((1, 2))).tf_dyn
    pars = np.exp(np.random.default_rng(1).normal(scale=0.5, size=(5, 2)))
    batch = tf.with_kern_par_batch(torch.tensor(pars))
    for i, p in enumerate(pars):
        one = tf.with_kern_par(torch.tensor(p))
        for name in ("wm", "Wc", "Wcc", "_emv"):
            _close(getattr(batch, name)[i], getattr(one, name), 1e-12, f"row {i} {name}")


def _ungm():
    return (UNGMTransition(GaussRV(1, cov=1.0), GaussRV(1, cov=10.0)),
            UNGMMeasurement(GaussRV(1, cov=1.0), dim_state=1))


# ---------------------------------------------------------------------------
# the SciPy-BFGS path
# ---------------------------------------------------------------------------

def test_bfgs_objective_matches_jax(models, golden):
    rng = np.random.default_rng(2)
    thetas = [rng.normal(scale=0.5, size=4) for _ in range(3)]
    thetas += [np.array([9.5, 0.4, -0.3, 0.2]), np.array([0.1, -8.7, -9.2, -0.4])]
    port = stt.MarginalizedGaussianProcessKalman(*models[0])
    ref = st.ssinf.MarginalizedGaussianProcessKalman(*models[1])
    y, m, P = golden["y"][:, 0], np.array([0.3]), np.array([[2.0]])
    for th in thetas:
        t = torch.tensor(th, requires_grad=True)
        v = port._neg_log_post(t, torch.tensor(y), torch.tensor(m), torch.tensor(P), 1,
                               port.param_mean, port.param_cov)
        (g,) = torch.autograd.grad(v, t)
        jv, jg = ref._neg_log_post(jnp.asarray(th), jnp.asarray(y), jnp.asarray(m),
                                   jnp.asarray(P), 1, ref.param_mean, ref.param_cov)
        _close(v, jv, 1e-10, f"value at {th}")
        _close(g, jg, 1e-10, f"gradient at {th}")


def test_first_bfgs_step_matches_jax(models, golden):
    port = stt.MarginalizedGaussianProcessKalman(*models[0])
    ref = st.ssinf.MarginalizedGaussianProcessKalman(*models[1])
    fm, fP = port.forward_pass(golden["y"][:, :1])
    jfm, jfP = ref.forward_pass(jnp.asarray(golden["y"][:, :1]))
    for got, want, name in ((port.param_mean, ref.param_mean, "param_mean"),
                            (port.param_cov, ref.param_cov, "param_cov"),
                            (fm, jfm, "fi_mean"), (fP, jfP, "fi_cov")):
        _close(got, want, 1e-6, name)


def test_bfgs_forward_pass_on_the_golden(port_bfgs, golden):
    fm, fP, _, _ = port_bfgs
    assert bool(torch.isfinite(fm).all()) and bool(torch.isfinite(fP).all())
    assert bool((fP[0, 0] > 0).all())
    assert _rmse(fm, golden["x"]) < 1.25 * float(golden["rmse"][0])


def test_reset_restores_the_prior(models, golden):
    alg = stt.MarginalizedGaussianProcessKalman(*models[0])
    alg.forward_pass(golden["y"][:, :1])
    assert not torch.equal(alg.param_mean, alg.param_prior_mean)
    alg.reset()
    assert torch.equal(alg.param_mean, alg.param_prior_mean)
    assert torch.equal(alg.param_cov, alg.param_prior_cov)


# ---------------------------------------------------------------------------
# the damped-Newton and batch paths
# ---------------------------------------------------------------------------

def test_newton_matches_jax(port_newton, jax_newton):
    fm, fP = port_newton[0][:, :4], port_newton[1][..., :4]
    jfm, jfP = jax_newton
    _close(fm[:, :1], jfm[:, :1], 1e-8, "step 1 mean")
    _close(fP[..., :1], jfP[..., :1], 1e-8, "step 1 cov")
    _close(fm, jfm, 2e-7, "steps 1-4 mean")
    _close(fP, jfP, 2e-7, "steps 1-4 cov")


def test_forward_pass_batch_is_marginalized(models):
    """Each row of ``forward_pass_batch`` is the marginalized filter of that
    row (``forward_pass_compiled``), not the inherited fixed-parameter batch
    filter."""
    dyn, obs = models[0]
    gen = torch.Generator().manual_seed(8)
    x = dyn.simulate_discrete(gen, steps=5, mc_sims=3)
    y = obs.simulate_measurements(gen, x)                          # (1, 5, 3)
    alg = stt.MarginalizedGaussianProcessKalman(dyn, obs)
    res = alg.forward_pass_batch(y.permute(2, 0, 1))
    assert res.fi_mean.shape == (3, 1, 5) and res.fi_cov.shape == (3, 1, 1, 5)
    fixed = stt.gaussian_filter_batch(dyn, obs, alg.tf_dyn, alg.tf_obs, y.permute(2, 0, 1))
    assert not torch.allclose(res.fi_mean, fixed.fi_mean)
    for i in range(3):
        fm, fP = alg.forward_pass_compiled(y[..., i])
        _close(res.fi_mean[i], fm, 1e-10, f"row {i} mean")
        _close(res.fi_cov[i], fP, 1e-10, f"row {i} cov")


def test_inner_float32(models, golden, port_newton):
    """The float32 search: its iterate and objective float32, the state
    moments float64, step 1 within 5% of the float64 search."""
    alg = stt.MarginalizedGaussianProcessKalman(*models[0])
    y = torch.tensor(golden["y"][None, :, :1])
    res, (pm, pc, f) = marginal_filter_batch(
        alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs, y, alg.param_prior_mean,
        alg.param_prior_cov, alg.newton_iters, alg.damping, inner_dtype="float32")
    assert pm.dtype == pc.dtype == f.dtype == torch.float32
    assert res.fi_mean.dtype == res.fi_cov.dtype == res.pr_mean.dtype == torch.float64
    fm32, fP32 = alg.forward_pass_compiled(golden["y"][:, :1], inner_dtype="float32")
    assert fm32.dtype == torch.float64 and torch.equal(fm32, res.fi_mean[0])
    np.testing.assert_allclose(_np(fm32), _np(port_newton[0][:, :1]), rtol=0.05, atol=0.05)
    assert bool(torch.isfinite(fP32).all()) and bool((fP32 > 0).all())
    # the models and transforms the caller holds stay float64
    assert alg.tf_dyn.wm.dtype == alg.tf_obs.model.kernel.par.dtype == torch.float64


def test_smoother_runs_on_both_paths(port_bfgs, port_newton, golden):
    for fm, fP, sm, sP in (port_bfgs, port_newton):
        assert sm.shape == fm.shape and sP.shape == fP.shape
        assert bool(torch.isfinite(sm).all()) and bool(torch.isfinite(sP).all())


def test_bfgs_vs_newton_quantified(port_bfgs, port_newton, golden):
    """The two searches approximate the same Laplace posterior at step 1;
    later steps may settle in other modes of the multimodal parameter
    posterior, so the study's RMSE is held instead."""
    fm_b, fm_n = _np(port_bfgs[0]), _np(port_newton[0])
    assert np.isfinite(fm_n).all()
    np.testing.assert_allclose(fm_n[:, :1], fm_b[:, :1], rtol=0.05, atol=0.05)
    rmse_b, rmse_n = _rmse(fm_b, golden["x"]), _rmse(fm_n, golden["x"])
    assert abs(rmse_b - rmse_n) <= 1.5, (rmse_b, rmse_n)
    assert rmse_n < 1.25 * float(golden["rmse"][0]), rmse_n
