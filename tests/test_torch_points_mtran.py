"""Point sets and sigma-point transforms of the PyTorch port against the JAX
package and the reference goldens (``tests/goldens/transforms.npz``).

Inputs are NumPy arrays from a fixed seed, handed to both packages.
Tolerances: point sets are copied code, so equal to 1e-15; transforms agree
to 1e-12 with the JAX package (float64, different summation order) and to
the 1e-8 parity tolerance with the goldens.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssmtoybox_tpu import mtran as jmtran
from ssmtoybox_tpu import points as jpts
from ssmtoybox_torch import mtran, points as pts
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

RULES = {
    "ut": (lambda d: mtran.UnscentedTransform(d), lambda d: jmtran.UnscentedTransform(d)),
    "ut_k": (lambda d: mtran.UnscentedTransform(d, kappa=0.5, alpha=0.8, beta=1.5),
             lambda d: jmtran.UnscentedTransform(d, kappa=0.5, alpha=0.8, beta=1.5)),
    "sr": (lambda d: mtran.SphericalRadialTransform(d),
           lambda d: jmtran.SphericalRadialTransform(d)),
    "gh": (lambda d: mtran.GaussHermiteTransform(d, degree=4),
           lambda d: jmtran.GaussHermiteTransform(d, degree=4)),
}


def _np(t):
    return t.detach().cpu().numpy()


@pytest.mark.parametrize("dim", [1, 2, 5])
def test_point_sets_match_jax(dim):
    np.testing.assert_allclose(pts.ut_points(dim), jpts.ut_points(dim), atol=1e-15)
    for a, b in zip(pts.ut_weights(dim, 1.0, 0.5, 2.0), jpts.ut_weights(dim, 1.0, 0.5, 2.0)):
        np.testing.assert_allclose(a, b, atol=1e-15)
    np.testing.assert_allclose(pts.sr_points(dim), jpts.sr_points(dim), atol=1e-15)
    np.testing.assert_allclose(pts.sr_weights(dim), jpts.sr_weights(dim), atol=1e-15)
    np.testing.assert_allclose(pts.gh_points(dim, 3), jpts.gh_points(dim, 3), atol=1e-15)
    np.testing.assert_allclose(pts.gh_weights(dim, 3), jpts.gh_weights(dim, 3), atol=1e-15)
    for name in ("sr", "ut", "gh"):
        np.testing.assert_allclose(pts.get_points(dim, name), jpts.get_points(dim, name),
                                   atol=1e-15)


def test_point_sets_match_goldens(goldens):
    g = goldens["transforms"]
    np.testing.assert_allclose(pts.ut_points(3), g["ut3_pts"], atol=PARITY, rtol=PARITY)
    wm, wc = pts.ut_weights(3)
    np.testing.assert_allclose(wm, g["ut3_wm"], atol=PARITY, rtol=PARITY)
    np.testing.assert_allclose(wc, g["ut3_wc"], atol=PARITY, rtol=PARITY)
    np.testing.assert_allclose(pts.sr_points(4), g["sr4_pts"], atol=PARITY, rtol=PARITY)
    np.testing.assert_allclose(pts.sr_weights(4), g["sr4_w"], atol=PARITY, rtol=PARITY)
    np.testing.assert_allclose(pts.gh_points(2, 4), g["gh2_pts"], atol=PARITY, rtol=PARITY)
    np.testing.assert_allclose(pts.gh_weights(2, 4), g["gh2_w"], atol=PARITY, rtol=PARITY)


def test_unported_point_set_raises():
    with pytest.raises(ValueError, match="not supported"):
        pts.get_points(2, "mc")


def _polar2cartesian_torch(x, time):
    return x[..., :1] * torch.stack([torch.cos(x[..., 1]), torch.sin(x[..., 1])], dim=-1)


def _polar2cartesian_jax(x, pars):
    return x[0] * jnp.stack([jnp.cos(x[1]), jnp.sin(x[1])])


def test_unscented_apply_matches_golden(goldens):
    g = goldens["transforms"]
    mean = torch.as_tensor(g["p2c_mean_in"])[None]
    cov = torch.as_tensor(g["p2c_cov_in"])[None]
    mf, cf, ccf = mtran.UnscentedTransform(2).apply(_polar2cartesian_torch, mean, cov, None)
    np.testing.assert_allclose(_np(mf[0]), g["p2c_ut_mf"], atol=PARITY, rtol=PARITY)
    np.testing.assert_allclose(_np(cf[0]), g["p2c_ut_cf"], atol=PARITY, rtol=PARITY)
    np.testing.assert_allclose(_np(ccf[0]), g["p2c_ut_ccf"], atol=PARITY, rtol=PARITY)


def _random_moments(rng, batch, dim):
    mean = rng.normal(size=(batch, dim))
    A = rng.normal(size=(batch, dim, dim))
    cov = A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(dim)
    return mean, cov


@pytest.mark.parametrize("rule", sorted(RULES))
def test_transform_apply_matches_jax(rule):
    """Batched apply of the port == per-mean apply of the JAX package."""
    rng = np.random.default_rng(11)
    mean, cov = _random_moments(rng, 4, 2)
    make_t, make_j = RULES[rule]
    mf, cf, ccf = make_t(2).apply(_polar2cartesian_torch, torch.as_tensor(mean),
                                  torch.as_tensor(cov), None)
    tf_j = make_j(2)
    for b in range(mean.shape[0]):
        jm, jc, jcc = tf_j.apply(_polar2cartesian_jax, jnp.asarray(mean[b]),
                                 jnp.asarray(cov[b]), None)
        np.testing.assert_allclose(_np(mf[b]), np.asarray(jm), atol=JAX_TOL, rtol=JAX_TOL)
        np.testing.assert_allclose(_np(cf[b]), np.asarray(jc), atol=JAX_TOL, rtol=JAX_TOL)
        np.testing.assert_allclose(_np(ccf[b]), np.asarray(jcc), atol=JAX_TOL, rtol=JAX_TOL)


def test_dense_weights_equal_diagonal_weights():
    rng = np.random.default_rng(3)
    mean, cov = _random_moments(rng, 3, 2)
    ut = mtran.UnscentedTransform(2)
    dense = mtran.SigmaPointTransform(_np(ut.unit_sp), _np(ut.wm), Wc_dense=_np(ut.Wc))
    args = (_polar2cartesian_torch, torch.as_tensor(mean), torch.as_tensor(cov), None)
    for a, b in zip(ut.apply(*args), dense.apply(*args)):
        torch.testing.assert_close(a, b, atol=1e-14, rtol=1e-14)


def test_sigma_point_transform_needs_one_weight_set():
    with pytest.raises(ValueError, match="exactly one"):
        mtran.SigmaPointTransform(np.zeros((1, 3)), np.ones(3))


def test_apply_f_columns_shapes():
    x = torch.zeros(4, 2, 5, dtype=torch.float64)
    out = mtran.apply_f_columns(_polar2cartesian_torch, x, None)
    assert tuple(out.shape) == (4, 2, 5)
