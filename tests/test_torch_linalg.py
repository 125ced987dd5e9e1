"""Small batched linear algebra of the PyTorch port against the JAX package
on the same NumPy arrays, at 1e-12 (float64; LAPACK on both sides, different
blocking)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ssmtoybox_tpu.utils import linalg as JL
from ssmtoybox_torch.utils import linalg as L
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


TOL = 1e-12


def _spd(rng, batch, dim):
    A = rng.normal(size=(batch, dim, dim))
    return A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(dim)


def _close(a, b):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dim", [1, 3, 5])
def test_solves_and_products_match_jax(dim):
    rng = np.random.default_rng(dim)
    A, b, w = _spd(rng, 4, dim), rng.normal(size=(4, dim, 2)), rng.normal(size=(4, dim, dim))
    tA, tb, tw = (torch.as_tensor(a) for a in (A, b, w))
    _close(L.symmetrize(tw), JL.symmetrize(jnp.asarray(w)))
    _close(L.chol_small(tA), np.linalg.cholesky(A))
    _close(L.pd_solve_small(tA, tb), JL.pd_solve_small(jnp.asarray(A), jnp.asarray(b)))
    _close(L.pd_solve(tA, tb, jitter=1e-3), JL.pd_solve(jnp.asarray(A), jnp.asarray(b), 1e-3))
    _close(L.small_mm3(tw, tA, tw.mT), JL.small_mm3(jnp.asarray(w), jnp.asarray(A),
                                                     jnp.swapaxes(jnp.asarray(w), -1, -2)))
    _close(L.pd_logdet(tA), JL.pd_logdet(jnp.asarray(A)))
    x, y = rng.normal(size=(5, dim)), rng.normal(size=(3, dim))
    V = _spd(rng, 1, dim)[0]
    _close(L.maha(torch.as_tensor(x), torch.as_tensor(y), torch.as_tensor(V)),
           JL.maha(jnp.asarray(x), jnp.asarray(y), jnp.asarray(V)))


def test_safe_cholesky_matches_jax_on_pd_and_singular_matrices():
    rng = np.random.default_rng(0)
    v = rng.normal(size=(3, 1))
    A = np.stack([_spd(rng, 1, 3)[0], v @ v.T])          # PD, and rank one
    got = L.safe_cholesky(torch.as_tensor(A))
    ref = np.asarray(JL.safe_cholesky(jnp.asarray(A)))
    _close(got[0], ref[0])
    # the fallback factor is a square root (U sqrt(s)), not a unique
    # triangle: compare what it factors
    np.testing.assert_allclose((got[1] @ got[1].mT).numpy(), A[1], atol=1e-12)
    np.testing.assert_allclose((got[1] @ got[1].mT).numpy(), ref[1] @ ref[1].T, atol=1e-12)


def test_failed_cholesky_gives_nan_without_raising():
    A = torch.as_tensor(np.stack([np.eye(2), -np.eye(2)]))
    out = L.chol_small(A)
    assert bool(torch.isfinite(out[0]).all()) and bool(torch.isnan(out[1]).all())
