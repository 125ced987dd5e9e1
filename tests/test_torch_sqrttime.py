"""The time-parallel square-root Kalman filters and smoothers of the PyTorch
port (``ssmtoybox_torch/parallel/sqrttime.py``) and ``chol_small_psd``
against the JAX package's ``ssmtoybox_tpu/parallel/sqrttime.py`` and
``utils/linalg.py``.

The same NumPy inputs, made from a seed, go through both packages (the JAX
scans under ``jax.jit``).  Tolerances, relative to each stream's largest
entry: float64 1e-10; float32 against the JAX package's float32 1e-4 (sums
in another order, each rounding carried through the scan).
"""
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ssmtoybox_tpu.parallel import sqrttime as jsq
from ssmtoybox_tpu.utils.linalg import chol_small_psd as jchol_psd
from ssmtoybox_torch import set_device
from ssmtoybox_torch.parallel import sqrttime as tsq
from ssmtoybox_torch.parallel import timescan as tts
from ssmtoybox_torch.utils.linalg import chol_small_psd

TOL = 1e-10
F32_JAX_TOL = 1e-4


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


def _outer(S):
    return np.einsum("ijn,kjn->ikn", _np(S), _np(S))


# ---------------------------------------------------------------------------
# chol_small_psd
# ---------------------------------------------------------------------------

def _psd_inputs(kind):
    rng = np.random.default_rng(3)
    if kind == "full rank":
        a = rng.standard_normal((6, 4, 4))
        return a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(4)
    if kind == "rank deficient":
        a = rng.standard_normal((6, 4, 2))           # rank 2 of 4, like G Q G^T
        return a @ np.swapaxes(a, -1, -2)
    if kind == "zero":
        return np.zeros((3, 4, 4))
    a = rng.standard_normal((2, 11, 11))             # above the unrolled limit
    return a @ np.swapaxes(a, -1, -2) + np.eye(11)


@pytest.mark.parametrize("kind", ["full rank", "rank deficient", "zero", "wide"])
def test_chol_small_psd_matches_jax(kind):
    a = _psd_inputs(kind)
    got = chol_small_psd(torch.from_numpy(a))
    want = np.asarray(jchol_psd(jnp.asarray(a)))
    assert np.all(np.isfinite(_np(got)))
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=TOL * max(np.abs(want).max(), 1.0))
    np.testing.assert_array_equal(np.triu(_np(got), 1), 0.0)


# ---------------------------------------------------------------------------
# the square-root scans
# ---------------------------------------------------------------------------

DT = 0.5
CV_F = np.array([[1, DT, 0, 0], [0, 1, 0, 0], [0, 0, 1, DT], [0, 0, 0, 1.0]])
#: thin process-noise columns (D = 4, two of them) through the CV gain
CV_SQ = np.kron(np.eye(2), np.array([[DT ** 2 / 2], [DT]])) * np.sqrt(5.0)
CV_H = np.array([[1.0, 0, 0, 0], [0, 0, 1.0, 0]])
CV_SR = np.sqrt(20.0) * np.eye(2)
CV_M0 = np.array([100.0, 10.0, -50.0, 4.0])
CV_S0 = np.diag(np.sqrt([100.0, 25.0, 100.0, 25.0]))


def _time_varying(rng, n, d, e):
    """A time-varying affine model with square-root noise factors."""
    def chol_pd(k, dim):
        a = rng.standard_normal((k, dim, dim))
        return np.linalg.cholesky(a @ np.swapaxes(a, -1, -2) + 0.5 * np.eye(dim))

    Fs = 0.9 * np.stack([np.linalg.qr(m)[0] for m in rng.standard_normal((n, d, d))])
    return dict(Fs=Fs, bs=0.1 * rng.standard_normal((n, d)), SQs=np.sqrt(0.2) * chol_pd(n, d),
                Hs=rng.standard_normal((n, e, d)), cs=0.1 * rng.standard_normal((n, e)),
                SRs=np.sqrt(0.5) * chol_pd(n, e), m0=rng.standard_normal(d),
                S0=chol_pd(1, d)[0], data=rng.standard_normal((e, n)))


def _jax_pair(filt, smooth, *args, smooth_lead=()):
    """A JAX filter and the smoother of its output, both under jit."""
    fi = jax.jit(filt)(*args)
    return fi, jax.jit(smooth)(*smooth_lead, *fi)


@functools.lru_cache(maxsize=None)
def _case(name):
    """``(kind, filter arguments, smoother arguments before the filtered
    moments)`` of a case, made from a seed."""
    rng = np.random.default_rng({"linear": 5, "time-varying": 6, "E > D": 7}[name])
    if name == "linear":
        args = (CV_F, CV_SQ, CV_H, CV_SR, CV_M0, CV_S0, rng.standard_normal((2, 40)) * 10.0)
        return "linear", args, args[:2]
    if name == "time-varying":
        args = tuple(_time_varying(rng, 37, 3, 2).values())
        return "affine", args, args[:3]
    # E > D: a 1-D state observed by 3 sensors (the information factor's QR)
    args = (np.array([[0.95]]), np.sqrt([[0.3]]), np.array([[1.0], [0.8], [-0.5]]),
            np.diag(np.sqrt([0.4, 0.6, 0.5])), np.array([1.0]), np.sqrt([[2.0]]),
            rng.standard_normal((3, 40)))
    return "linear", args, args[:2]


@functools.lru_cache(maxsize=None)
def _jax_case(name, **kw):
    """The JAX package's filtered and smoothed moments of a case, computed
    on first use (a worker computes only the cases its tests need)."""
    kind, args, lead = _case(name)
    filt, smooth = ((jsq.parallel_linear_sqrt_filter, jsq.parallel_linear_sqrt_smoother)
                    if kind == "linear" else
                    (jsq.parallel_affine_sqrt_filter, jsq.parallel_affine_sqrt_smoother))
    return _jax_pair(functools.partial(filt, **kw), functools.partial(smooth, **kw), *args,
                     smooth_lead=lead)


def _port_pair(kind, args, lead, **kw):
    filt = tsq.parallel_linear_sqrt_filter if kind == "linear" else tsq.parallel_affine_sqrt_filter
    smooth = (tsq.parallel_linear_sqrt_smoother if kind == "linear"
              else tsq.parallel_affine_sqrt_smoother)
    fi = filt(*args, **kw)
    return fi, smooth(*lead, *fi, **kw)


@pytest.mark.parametrize("case", ["linear", "time-varying", "E > D"])
def test_sqrt_filter_and_smoother_match_jax(case):
    kind, args, lead = _case(case)
    fi_want, sm_want = _jax_case(case)
    fi, sm = _port_pair(kind, args, lead)
    for got, want, name in zip(fi + sm, tuple(fi_want) + tuple(sm_want),
                               ("fi_mean", "fi_sqrt", "sm_mean", "sm_sqrt")):
        assert tuple(got.shape) == np.shape(want)
        _close(got, want, TOL, f"{case} {name}")
    S = _np(fi[1]).transpose(2, 0, 1)
    assert np.all(np.diagonal(S, axis1=-2, axis2=-1) >= 0)
    np.testing.assert_array_equal(np.triu(S, 1), 0.0)


def test_sqrt_matches_full_covariance_scans():
    """The factor form against the port's own full-covariance scans on the
    time-varying model."""
    _, (Fs, bs, SQs, Hs, cs, SRs, m0, S0, data), _ = _case("time-varying")
    Q, R, P0 = SQs @ np.swapaxes(SQs, -1, -2), SRs @ np.swapaxes(SRs, -1, -2), S0 @ S0.T
    fm, fP = tts.parallel_affine_filter(Fs, bs, Q, Hs, cs, R, m0, P0, data)
    sm, sP = tts.parallel_affine_smoother(Fs, bs, Q, fm, fP)
    qm, qS = tsq.parallel_affine_sqrt_filter(Fs, bs, SQs, Hs, cs, SRs, m0, S0, data)
    rm, rS = tsq.parallel_affine_sqrt_smoother(Fs, bs, SQs, qm, qS)
    for got, want in ((qm, fm), (_outer(qS), fP), (rm, sm), (_outer(rS), sP)):
        _close(got, want, 1e-9)


@pytest.mark.parametrize("case", ["linear", "time-varying"])
def test_blocked_scan_matches_unblocked(case):
    """Blocks of 16 over 37-40 steps leave a ragged last block, padded with
    the identity."""
    kind, args, lead = _case(case)
    fi, sm = _port_pair(kind, args, lead)
    fi_b, sm_b = _port_pair(kind, args, lead, scan_block_len=16)
    for got, want in zip(fi_b + sm_b, fi + sm):
        _close(got, want, TOL)


def test_blocked_scan_matches_jax_blocked_scan():
    kind, args, lead = _case("linear")
    fi, sm = _port_pair(kind, args, lead, scan_block_len=16)
    fj, sj = _jax_case("linear", scan_block_len=16)
    for got, want in zip(fi + sm, tuple(fj) + tuple(sj)):
        _close(got, want, TOL)


def test_float32_matches_jax_float32():
    kind, args, lead = _case("linear")
    args32 = tuple(np.asarray(a, np.float32) for a in args)
    lead32 = tuple(np.asarray(a, np.float32) for a in lead)
    fj, sj = _jax_pair(jsq.parallel_linear_sqrt_filter, jsq.parallel_linear_sqrt_smoother,
                       *(jnp.asarray(a) for a in args32), smooth_lead=lead32)
    fi, sm = _port_pair(kind, tuple(torch.from_numpy(a) for a in args32), lead32)
    assert fi[0].dtype == torch.float32 and sm[1].dtype == torch.float32
    for got, want in zip(fi + sm, tuple(fj) + tuple(sj)):
        assert np.asarray(want).dtype == np.float32
        _close(got, want, F32_JAX_TOL)
    assert np.all(np.diagonal(_np(fi[1]).transpose(2, 0, 1), axis1=-2, axis2=-1) > 0)


def test_thin_noise_columns_match_full_covariance_scan():
    """Two process-noise columns for a 4-D state (a rank-2 ``G Q G^T``): the
    factor form equals the full-covariance scan."""
    y = np.random.default_rng(9).standard_normal((2, 24)) * 10.0
    fm, fP = tts.parallel_linear_filter(CV_F, CV_SQ @ CV_SQ.T, CV_H, CV_SR @ CV_SR.T, CV_M0,
                                        CV_S0 @ CV_S0.T, y)
    qm, qS = tsq.parallel_linear_sqrt_filter(CV_F, CV_SQ, CV_H, CV_SR, CV_M0, CV_S0, y)
    _close(qm, fm, 1e-9)
    _close(_outer(qS), fP, 1e-9)
