"""Small batched linear algebra on ``torch.linalg``.

Counterpart of :mod:`ssmtoybox_tpu.utils.linalg`, reduced to what the
filtering main path calls.  The JAX package unrolls tiny Cholesky factors
and products into scalar recurrences to dodge the TPU's emulated float64;
the card has native float64, so the port calls the batched library routines.

Every function takes a leading batch: matrices are ``(..., D, D)``.  None of
them synchronises with the host: a Cholesky that fails (a matrix that is not
positive definite) yields NaN in the factor, exactly as the JAX package's
LAPACK-backed ``cholesky`` does, instead of raising inside a time loop.
"""
from __future__ import annotations

import torch

__all__ = ["maha", "symmetrize", "chol_small", "safe_cholesky", "pd_solve",
           "pd_solve_small", "tri_solve_small", "pd_logdet", "small_mm3", "gen_solve",
           "block_diag"]


def maha(x: torch.Tensor, y: torch.Tensor, V: torch.Tensor | None = None) -> torch.Tensor:
    """Pairwise squared Mahalanobis distance of the rows of ``x`` (N, D) and
    ``y`` (M, D), weighted by ``V`` (identity if omitted)."""
    xV = x if V is None else x @ V
    yV = y if V is None else y @ V
    x2 = torch.sum(xV * x, dim=-1)
    y2 = torch.sum(yV * y, dim=-1)
    return x2[..., :, None] + y2[..., None, :] - 2.0 * xV @ y.mT


def symmetrize(a: torch.Tensor) -> torch.Tensor:
    """Force symmetry: ``0.5 * (A + A^T)``."""
    return 0.5 * (a + a.mT)


def chol_small(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor, NaN where the factorisation fails.

    ``cholesky_ex`` reports failure in ``info`` without a host round trip;
    the failed factors are replaced by NaN so that the failure propagates
    like it does in the JAX package.
    """
    L, info = torch.linalg.cholesky_ex(a)
    return torch.where((info == 0)[..., None, None], L, torch.nan)


def safe_cholesky(a: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Lower Cholesky factor with an eigh-based PSD fallback.

    Where the Cholesky succeeds it is returned as is; elsewhere the square
    root ``U sqrt(clip(s))`` of a clipped eigendecomposition is used.
    """
    if jitter:
        a = a + jitter * torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    L, info = torch.linalg.cholesky_ex(a)
    w, v = torch.linalg.eigh(symmetrize(a))
    fallback = v * torch.sqrt(torch.clamp(w, min=0.0))[..., None, :]
    return torch.where((info == 0)[..., None, None], L, fallback)


def pd_solve(A: torch.Tensor, b: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Solve ``A x = b`` for symmetric positive-definite ``A`` via Cholesky."""
    if jitter:
        A = A + jitter * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.cholesky_solve(b, chol_small(A))


#: the JAX package's name for its unrolled small-dim solve; here the same call
pd_solve_small = pd_solve


def tri_solve_small(L: torch.Tensor, b: torch.Tensor, lower: bool = True) -> torch.Tensor:
    """Triangular solve ``L x = b`` with ``b`` (..., D) or (..., D, K)."""
    vec = b.ndim == L.ndim - 1
    out = torch.linalg.solve_triangular(L, b[..., None] if vec else b, upper=not lower)
    return out[..., 0] if vec else out


def block_diag(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[[a, 0], [0, b]]`` of ``a`` (..., n, n) and ``b`` (..., k, k), the
    leading dimensions broadcast."""
    lead = torch.broadcast_shapes(a.shape[:-2], b.shape[:-2])
    n, k = a.shape[-1], b.shape[-1]
    out = a.new_zeros(lead + (n + k, n + k))
    out[..., :n, :n] = a
    out[..., n:, n:] = b
    return out


def pd_logdet(A: torch.Tensor) -> torch.Tensor:
    """``log det A`` of a positive-definite matrix from its Cholesky factor."""
    L = chol_small(A)
    return 2.0 * torch.sum(torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)


def small_mm3(a: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ w @ b``."""
    return a @ w @ b


def gen_solve(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """Solve ``A X = B`` for a general (non-symmetric) square ``A``, ``B``
    (..., D) or (..., D, K), with ``torch.linalg.solve`` (LU with partial
    pivoting).  The JAX package writes this solve as a Gauss-Jordan loop only
    because the TPU has no float64 LU; the card has one."""
    return torch.linalg.solve(A, B)
