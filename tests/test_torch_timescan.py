"""The associative scan and the time-parallel affine and linear Kalman
filters and smoothers of the PyTorch port (``ssmtoybox_torch/parallel/scan.py``
and ``parallel/timescan.py``) against the JAX package's
``jax.lax.associative_scan`` and ``ssmtoybox_tpu/parallel/timescan.py``.

The same NumPy inputs, made from a seed, go through both packages (the JAX
functions under ``jax.jit``: one compile each instead of one a scan level).
Tolerances, relative to each stream's largest entry: float64 1e-10, float32
1e-6 (the two packages' 2 x 2 products round in other orders).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssmtoybox_tpu.parallel import timescan as jts
from ssmtoybox_torch import set_device
from ssmtoybox_torch.parallel import associative_scan
from ssmtoybox_torch.parallel import timescan as tts

TOL = 1e-10
F32_TOL = 1e-6


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
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _close(a, b, tol, label=""):
    """``|a - b| <= tol max |b|``."""
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * max(np.abs(b).max(), 1e-300),
                               err_msg=label)


# ---------------------------------------------------------------------------
# the associative scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("n", [1, 2, 7, 16, 33])
def test_associative_scan_matches_jax(n, reverse, dtype):
    """2 x 2 matrix products (not commutative) with a vector sum beside them:
    the port follows JAX's recursion, so the products associate alike."""
    rng = np.random.default_rng(n)
    mats = (rng.standard_normal((n, 2, 2)) / np.sqrt(2.0)).astype(dtype)
    vecs = rng.standard_normal((n, 3)).astype(dtype)
    want = jax.jit(lambda e: jax.lax.associative_scan(
        lambda a, b: (jnp.matmul(a[0], b[0]), a[1] + b[1]), e, reverse=reverse))(
        (jnp.asarray(mats), jnp.asarray(vecs)))
    got = associative_scan(lambda a, b: (a[0] @ b[0], a[1] + b[1]),
                           (torch.from_numpy(mats), torch.from_numpy(vecs)), reverse=reverse)
    tol = TOL if dtype == np.float64 else F32_TOL
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(np.zeros(1, dtype)).dtype
        assert tuple(g.shape) == w.shape
        _close(g, w, tol)


def test_associative_scan_refuses_ragged_inputs():
    with pytest.raises(ValueError, match="first dimension"):
        associative_scan(lambda a, b: a, (torch.zeros(3, 2), torch.zeros(4)))


# ---------------------------------------------------------------------------
# the affine and linear filters and smoothers
# ---------------------------------------------------------------------------

def _random_affine_model(rng, n, d, e):
    def pd(k, dim):
        a = rng.standard_normal((k, dim, dim))
        return a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(dim)

    Fs = 0.9 * np.stack([np.linalg.qr(m)[0] for m in rng.standard_normal((n, d, d))])
    return dict(Fs=Fs, bs=0.1 * rng.standard_normal((n, d)), Qs=0.2 * pd(n, d),
                Hs=rng.standard_normal((n, e, d)), cs=0.1 * rng.standard_normal((n, e)),
                Rs=0.5 * pd(n, e), m0=rng.standard_normal(d), P0=pd(1, d)[0],
                data=rng.standard_normal((e, n)))


#: constant velocity, positions measured (tests/test_timescan.py's model)
DT = 0.5
CV_F = np.array([[1, DT, 0, 0], [0, 1, 0, 0], [0, 0, 1, DT], [0, 0, 0, 1.0]])
CV_G = np.kron(np.eye(2), np.array([[DT ** 2 / 2], [DT]]))
CV_Q = CV_G @ np.diag([5.0, 5.0]) @ CV_G.T
CV_H = np.array([[1.0, 0, 0, 0], [0, 0, 1.0, 0]])
CV_R = np.diag([20.0, 20.0])
CV_M0 = np.array([100.0, 10.0, -50.0, 4.0])
CV_P0 = np.diag([100.0, 25.0, 100.0, 25.0])


@pytest.fixture(scope="module")
def affine():
    """A 40-step time-varying affine model (D = 3, E = 2) and the JAX
    package's filter and smoother of it."""
    model = _random_affine_model(np.random.default_rng(0), 40, 3, 2)
    fi = jax.jit(jts.parallel_affine_filter)(**model)
    sm = jax.jit(jts.parallel_affine_smoother)(model["Fs"], model["bs"], model["Qs"], *fi)
    return model, fi, sm


@pytest.fixture(scope="module")
def linear():
    """A 33-step record of the CV model and the JAX package's filter and
    smoother (33 steps: an odd level in the scan's recursion)."""
    data = np.random.default_rng(1).standard_normal((2, 33)) * 10.0
    args = (CV_F, CV_Q, CV_H, CV_R, CV_M0, CV_P0, data)
    fi = jax.jit(jts.parallel_linear_filter)(*args)
    sm = jax.jit(jts.parallel_linear_smoother)(CV_F, CV_Q, *fi)
    return args, fi, sm


def test_affine_filter_matches_jax(affine):
    model, want, _ = affine
    got = tts.parallel_affine_filter(**{k: torch.from_numpy(v) for k, v in model.items()})
    for g, w, name in zip(got, want, ("fi_mean", "fi_cov")):
        assert tuple(g.shape) == w.shape
        _close(g, w, TOL, name)


def test_affine_smoother_matches_jax(affine):
    model, fi, want = affine
    got = tts.parallel_affine_smoother(model["Fs"], model["bs"], model["Qs"],
                                       *(np.asarray(a) for a in fi))
    for g, w, name in zip(got, want, ("sm_mean", "sm_cov")):
        _close(g, w, TOL, name)


def test_linear_filter_and_smoother_match_jax(linear):
    args, fi_want, sm_want = linear
    fi = tts.parallel_linear_filter(*args)
    sm = tts.parallel_linear_smoother(CV_F, CV_Q, *fi)
    for g, w in zip(fi + sm, tuple(fi_want) + tuple(sm_want)):
        _close(g, w, TOL)


def test_linear_filter_matches_a_sequential_kalman_filter(linear):
    """The scan against an independent NumPy loop: the associativity, not
    only the agreement of two ports of one code."""
    (F, Q, H, R, m, P, data), _, _ = linear
    fm, fP = tts.parallel_linear_filter(F, Q, H, R, m, P, data)
    for k in range(data.shape[1]):
        m, P = F @ m, F @ P @ F.T + Q
        S = H @ P @ H.T + R
        K = P @ H.T @ np.linalg.inv(S)
        m, P = m + K @ (data[:, k] - H @ m), P - K @ S @ K.T
        _close(fm[:, k], m, 1e-9, f"mean {k}")
        _close(fP[..., k], P, 1e-9, f"cov {k}")


def test_float32_inputs_stay_float32(linear):
    """Tensors keep their dtype: float32 in, float32 out, near the float64
    result."""
    args, want, _ = linear
    got = tts.parallel_linear_filter(*(torch.as_tensor(a, dtype=torch.float32) for a in args))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.float32
    _close(got[0], want[0], 1e-4)


def test_arrays_go_to_the_default_device(linear):
    args, _, _ = linear
    fm, fP = tts.parallel_linear_filter(*args)
    assert fm.device.type == "cpu" and fm.dtype == torch.float64
