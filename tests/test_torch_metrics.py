"""Study metrics of the PyTorch port against the reference goldens
(``tests/goldens/metrics.npz``, 1e-8 parity tolerance) and the JAX package
(1e-12: the same float64 formulas on the same arrays)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssmtoybox_tpu.utils import metrics as JM
from ssmtoybox_torch.utils import metrics as M
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
JAX_TOL = 1e-12


def _t(a):
    return torch.as_tensor(np.asarray(a, np.float64))


def test_metrics_match_goldens(goldens):
    g = goldens["metrics"]
    x, m, P, MSE, est = (_t(g[k]) for k in ("x", "m", "P", "MSE", "est"))
    for got, key in ((M.squared_error(x, m), "se"), (M.mse_matrix(x, est), "msem"),
                     (torch.atleast_1d(M.log_cred_ratio(x, m, P, MSE)), "lcr"),
                     (torch.atleast_1d(M.neg_log_likelihood(x, m, P)), "nll")):
        np.testing.assert_allclose(got.numpy(), g[key], atol=PARITY, rtol=PARITY, err_msg=key)


def _series(seed, D=3, N=7):
    rng = np.random.default_rng(seed)
    x, m = rng.normal(size=(D, N)), rng.normal(size=(D, N))
    A = rng.normal(size=(N, D, D))
    B = rng.normal(size=(N, D, D))
    P = np.moveaxis(A @ np.swapaxes(A, -1, -2) + np.eye(D), 0, -1)
    MSE = np.moveaxis(B @ np.swapaxes(B, -1, -2) + np.eye(D), 0, -1)
    return x, m, P, MSE


@pytest.mark.parametrize("axis", [None, 0, 1])
def test_rmse_matches_jax(axis):
    rng = np.random.default_rng(1)
    x, m = rng.normal(size=(2, 9, 5)), rng.normal(size=(2, 9, 5))
    np.testing.assert_allclose(M.rmse(_t(x), _t(m), axis=axis).numpy(),
                               np.asarray(JM.rmse(jnp.asarray(x), jnp.asarray(m), axis=axis)),
                               atol=JAX_TOL, rtol=JAX_TOL)


def test_time_series_metrics_match_jax():
    x, m, P, MSE = _series(2)
    jx, jm, jP, jMSE = (jnp.asarray(a) for a in (x, m, P, MSE))
    np.testing.assert_allclose(float(M.nci(_t(x), _t(m), _t(P), _t(MSE))),
                               float(JM.nci(jx, jm, jP, jMSE)), atol=JAX_TOL, rtol=JAX_TOL)
    np.testing.assert_allclose(float(M.nll_mean(_t(x), _t(m), _t(P))),
                               float(JM.nll_mean(jx, jm, jP)), atol=JAX_TOL, rtol=JAX_TOL)
    for k in range(x.shape[1]):
        np.testing.assert_allclose(
            float(M.log_cred_ratio(_t(x[:, k]), _t(m[:, k]), _t(P[..., k]), _t(MSE[..., k]))),
            float(JM.log_cred_ratio(jx[:, k], jm[:, k], jP[..., k], jMSE[..., k])),
            atol=JAX_TOL, rtol=JAX_TOL)


def test_mse_matrix_matches_jax():
    rng = np.random.default_rng(3)
    x, est = rng.normal(size=(3, 40)), rng.normal(size=(3, 40))
    np.testing.assert_allclose(M.mse_matrix(_t(x), _t(est)).numpy(),
                               np.asarray(JM.mse_matrix(jnp.asarray(x), jnp.asarray(est))),
                               atol=JAX_TOL, rtol=JAX_TOL)
