"""RBF kernel, GP model weights and GPQ transform of the PyTorch port against
the JAX package and the reference goldens (``tests/goldens/transforms.npz``).

Tolerances: goldens at the 1e-8 parity tolerance; the JAX package at 1e-10
(same float64 formulas; the Gram solve orders its sums differently).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssmtoybox_tpu.bq.kernels import RBFGauss as JRBFGauss
from ssmtoybox_tpu.bq.models import GaussianProcessModel as JGPModel
from ssmtoybox_tpu.bq.transforms import GaussianProcessTransform as JGPTransform
from ssmtoybox_torch import convert
from ssmtoybox_torch.bq import GaussianProcessModel, GaussianProcessTransform, RBFGauss
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
JAX_TOL = 1e-10


def _np(t):
    return np.asarray(t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t)


def _close(a, b, tol):
    np.testing.assert_allclose(_np(a), _np(b), atol=tol, rtol=tol)


def test_kernel_expectations_match_goldens(goldens):
    g = goldens["transforms"]
    x, par = torch.as_tensor(g["kern_x"]), torch.as_tensor(g["kern_par"])
    k = RBFGauss(2, par)
    _close(k.eval(par, x), g["kern_K"], PARITY)
    _close(k.exp_x_kx(par, x), g["kern_q"], PARITY)
    _close(k.exp_x_kxkx(par, par, x), g["kern_Q"], PARITY)
    _close(k.exp_x_xkx(par, x), g["kern_R"], PARITY)
    _close(torch.atleast_1d(k.exp_xy_kxy(par)), g["kern_kxy"], PARITY)


@pytest.mark.parametrize("dim", [1, 3])
def test_kernel_matches_jax(dim):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(dim, 6))
    par = np.hstack([[1.3], rng.uniform(0.5, 3.0, dim)])[None]
    par_1 = np.hstack([[0.7], rng.uniform(0.5, 3.0, dim)])[None]
    k, kj = RBFGauss(dim, par), JRBFGauss.create(dim, par)
    p, p1, xt = torch.as_tensor(par), torch.as_tensor(par_1), torch.as_tensor(x)
    pj, p1j, xj = jnp.asarray(par), jnp.asarray(par_1), jnp.asarray(x)
    _close(k.eval(p, xt), kj.eval(pj, xj), JAX_TOL)
    _close(k.eval(p, xt, torch.flip(xt, [1]), diag=True),
           kj.eval(pj, xj, jnp.flip(xj, 1), diag=True), JAX_TOL)
    _close(k.eval_inv_dot(p, xt, scaling=False), kj.eval_inv_dot(pj, xj, scaling=False), JAX_TOL)
    _close(k.exp_x_kx(p, xt), kj.exp_x_kx(pj, xj), JAX_TOL)
    _close(k.exp_x_kx(p, xt, scaling=True), kj.exp_x_kx(pj, xj, scaling=True), JAX_TOL)
    _close(k.exp_x_xkx(p, xt), kj.exp_x_xkx(pj, xj), JAX_TOL)
    _close(k.exp_x_kxkx(p, p1, xt, scaling=True), kj.exp_x_kxkx(pj, p1j, xj, scaling=True),
           JAX_TOL)
    _close(k.exp_x_kxx(p), kj.exp_x_kxx(pj), JAX_TOL)
    _close(k.exp_xy_kxy(p), kj.exp_xy_kxy(pj), JAX_TOL)
    for a, b in zip(k.exp_x_qRQ(p, xt), kj.exp_x_qRQ(pj, xj)):
        _close(a, b, JAX_TOL)


def test_kernel_rejects_wrong_parameter_width():
    with pytest.raises(ValueError, match="parameters"):
        RBFGauss(2, np.array([[1.0, 3.0]]))


@pytest.mark.parametrize("point_str", ["ut", "sr", "gh"])
def test_gp_weights_match_goldens(goldens, point_str):
    g = goldens["transforms"]
    gp = GaussianProcessModel(2, g["kern_par"], "rbf", point_str)
    w = gp.bq_weights()
    _close(w.wm, g[f"gp_{point_str}_wm"], PARITY)
    _close(w.Wc, g[f"gp_{point_str}_wc"], PARITY)
    _close(w.Wcc, g[f"gp_{point_str}_wcc"], PARITY)
    _close(torch.atleast_1d(w.model_var), g[f"gp_{point_str}_emv"], PARITY)
    _close(torch.atleast_1d(w.integral_var), g[f"gp_{point_str}_ivar"], PARITY)


@pytest.mark.parametrize("dim,par,point_str", [
    (1, [[1.0, 3.0]], "ut"),            # the study's GPQKF configuration
    (2, [[1.5, 0.8, 2.0]], "sr"),
    (2, [[0.9, 1.1, 1.7]], "gh"),
])
def test_gp_weights_match_jax(dim, par, point_str):
    par = np.asarray(par, np.float64)
    w = GaussianProcessModel(dim, par, "rbf", point_str).bq_weights()
    jgp = JGPModel.create(dim, par, "rbf", point_str)
    wj = jgp.bq_weights(jnp.asarray(par))
    for f in ("wm", "Wc", "Wcc", "model_var", "integral_var", "q", "Q", "iK"):
        _close(getattr(w, f), getattr(wj, f), JAX_TOL)
    emv = GaussianProcessModel(dim, par, "rbf", point_str).exp_model_variance()
    _close(emv, jgp.exp_model_variance(jnp.asarray(par)), JAX_TOL)


def _polar2cartesian_torch(x, time):
    return x[..., :1] * torch.stack([torch.cos(x[..., 1]), torch.sin(x[..., 1])], dim=-1)


def test_gpq_apply_matches_golden(goldens):
    g = goldens["transforms"]
    tf = GaussianProcessTransform(2, 2, g["kern_par"], point_str="ut")
    mf, cf, ccf = tf.apply(_polar2cartesian_torch, torch.as_tensor(g["p2c_mean_in"])[None],
                           torch.as_tensor(g["p2c_cov_in"])[None], None)
    _close(mf[0], g["p2c_gpq_mf"], PARITY)
    _close(cf[0], g["p2c_gpq_cf"], PARITY)
    _close(ccf[0], g["p2c_gpq_ccf"], PARITY)


def test_gpq_weights_carried_from_jax_compute_the_same():
    """Weights pulled from the JAX transform and loaded into the port give
    the port's own transform's moments, and the two weight sets agree."""
    par = np.array([[1.0, 3.0]])
    jt = JGPTransform.create(1, 1, par, point_str="ut")
    loaded = convert.transform_from_numpy(
        {"points": np.asarray(jt.model.points), "wm": np.asarray(jt.wm),
         "Wc": np.asarray(jt.Wc), "Wcc": np.asarray(jt.Wcc),
         "model_var": np.asarray(jt.model_var), "iK": np.asarray(jt.iK)})
    own = GaussianProcessTransform(1, 1, par, point_str="ut")
    for f in ("points", "wm", "Wc", "Wcc", "model_var", "iK"):
        _close(getattr(own, f), getattr(loaded, f), JAX_TOL)
    rng = np.random.default_rng(2)
    mean = torch.as_tensor(rng.normal(size=(5, 1)))
    cov = torch.as_tensor(rng.uniform(0.5, 4.0, size=(5, 1, 1)))
    f = lambda x, t: 0.5 * x + 25.0 * x / (1.0 + x ** 2) + 8.0 * np.cos(1.2 * t)
    for a, b in zip(own.apply(f, mean, cov, 3), loaded.apply(f, mean, cov, 3)):
        _close(a, b, JAX_TOL)
