"""Small batched linear algebra on ``torch.linalg``.

Counterpart of :mod:`ssmtoybox_tpu.utils.linalg`, without its unrolled
small-matrix kernels.  The JAX package unrolls tiny Cholesky factors
and products into scalar recurrences to dodge the TPU's emulated float64;
the card has native float64, so the port calls the batched library routines.

Every function takes a leading batch: matrices are ``(..., D, D)``.  None of
them synchronises with the host: a Cholesky that fails (a matrix that is not
positive definite) yields NaN in the factor, exactly as the JAX package's
LAPACK-backed ``cholesky`` does, instead of raising inside a time loop.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["maha", "symmetrize", "chol_small", "chol_small_psd", "safe_cholesky", "mat_sqrt",
           "pd_solve",
           "pd_solve_small", "pd_inv", "tri_solve_small", "pd_logdet", "small_mm3",
           "gen_solve", "gen_inv", "block_diag", "ellipse_points", "tria", "cholupdate_small"]


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


#: the JAX package's limit of its unrolled Cholesky recurrences; above it
#: :func:`chol_small_psd` takes the library factor instead
SMALL_DIM_MAX = 9


def chol_small_psd(a: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of a positive SEMI-definite ``a`` (..., D, D),
    clamped where a plain factorisation would fail.

    Rank-deficient inputs are routine in the square-root scans: the SLR
    residual of a linear model is exactly zero, and ``G Q G^T`` through a thin
    gain has rank below D.  Each pivot is clamped at zero, and the column of a
    pivot under ``sqrt(max_diag * eps) * D`` is zeroed (the resolution at
    which a pivot is told apart from elimination round-off), so ``L L^T`` may
    differ from ``a`` by ``~D sqrt(eps)`` of its scale.  The JAX package's
    recurrence, written over the batch: Python loops over the entries only.
    Above :data:`SMALL_DIM_MAX` it is :func:`tria` of :func:`safe_cholesky`,
    as there.
    """
    d = a.shape[-1]
    if d > SMALL_DIM_MAX:
        return tria(safe_cholesky(a))
    fi = torch.finfo(a.dtype)
    diag = torch.diagonal(a, dim1=-2, dim2=-1)
    scale = torch.clamp(diag.max(dim=-1).values, min=fi.tiny)
    tol = torch.sqrt(scale * fi.eps) * d
    col = [[None] * d for _ in range(d)]
    for i in range(d):
        for j in range(i + 1):
            s = a[..., i, j]
            for k in range(j):
                s = s - col[i][k] * col[j][k]
            if i == j:
                col[i][j] = torch.sqrt(torch.clamp(s, min=0.0))
            else:
                ok = col[j][j] > tol
                col[i][j] = torch.where(ok, s / torch.where(ok, col[j][j], 1.0), 0.0)
    zero = torch.zeros_like(a[..., 0, 0])
    return torch.stack([torch.stack([col[i][j] if j <= i else zero for j in range(d)], dim=-1)
                        for i in range(d)], dim=-2)


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


def mat_sqrt(a: torch.Tensor) -> torch.Tensor:
    """Matrix square root: the Cholesky factor where ``a`` is positive
    definite, the eigh fallback of :func:`safe_cholesky` elsewhere."""
    return safe_cholesky(a)


def pd_solve(A: torch.Tensor, b: torch.Tensor, jitter: float = 0.0) -> torch.Tensor:
    """Solve ``A x = b`` for symmetric positive-definite ``A`` via Cholesky."""
    if jitter:
        A = A + jitter * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return torch.cholesky_solve(b, chol_small(A))


#: the JAX package's name for its unrolled small-dim solve; here the same call
pd_solve_small = pd_solve


def pd_inv(A: torch.Tensor, jitter: float = 0.0, do_symmetrize: bool = True) -> torch.Tensor:
    """Inverse of a symmetric positive-definite ``A``: a Cholesky solve
    against the identity, then symmetrized (unless ``do_symmetrize=False``)."""
    iA = pd_solve(A, torch.eye(A.shape[-1], dtype=A.dtype, device=A.device), jitter=jitter)
    return symmetrize(iA) if do_symmetrize else iA


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
    (..., D) or (..., D, K), with ``torch.linalg.solve_ex`` (LU with partial
    pivoting): a singular ``A`` gives inf or NaN, as the JAX package's
    Gauss-Jordan loop does, instead of an error that would read the LU's
    status back to the host.  The JAX package writes this solve as a loop only
    because the TPU has no float64 LU; the card has one."""
    return torch.linalg.solve_ex(A, B)[0]


def gen_inv(A: torch.Tensor) -> torch.Tensor:
    """Inverse of a general square ``A`` by :func:`gen_solve`."""
    return gen_solve(A, torch.eye(A.shape[-1], dtype=A.dtype, device=A.device))


def ellipse_points(pos: torch.Tensor, mat: torch.Tensor, num: int = 50) -> torch.Tensor:
    """``num`` points (2, num) on the one-sigma ellipse of the 2-D Gaussian
    ``N(pos, mat)``."""
    w, v = torch.linalg.eigh(mat)
    theta = torch.linspace(0.0, 2.0 * torch.pi, num, dtype=mat.dtype, device=mat.device)
    t = torch.stack((torch.cos(theta), torch.sin(theta)))
    return pos[:, None] + v @ (torch.sqrt(torch.clamp(w, min=0.0))[:, None] * t)


def tria(cols: torch.Tensor) -> torch.Tensor:
    """Lower factor of ``cols @ cols^T`` with a non-negative diagonal, from a
    QR of ``cols^T``: ``cols`` (..., D, M) with M >= D gives (..., D, D).

    The square-root filters' factorization: it never forms the covariance,
    so it does not square the conditioning.  The rows of R are flipped to a
    positive diagonal as the JAX package does (a zero diagonal entry counts
    as positive).  On the card a batch of small matrices goes to cuBLAS's
    batched ``geqrf``.
    """
    r = torch.linalg.qr(cols.mT, mode="r")[1]
    sgn = torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))
    sgn = torch.where(sgn == 0, torch.ones_like(sgn), sgn)
    return (r * sgn[..., :, None]).mT


def cholupdate_small(L: torch.Tensor, v: torch.Tensor, w) -> torch.Tensor:
    """Rank-1 update or downdate: the lower factor of ``L L^T + w v v^T``.

    ``L`` (..., D, D), ``v`` (..., D); ``w`` a number or a tensor over the
    leading dimensions, of either sign.  The JAX package's hyperbolic
    rotation recurrence, one column of ``L`` at a time (D steps of batched
    elementwise operations, each element computed as there); ``w = 0``
    returns ``L``'s bits.  A number ``w`` is rounded to ``L``'s dtype on the
    host, so that no tensor is copied to the card.
    """
    d = L.shape[-1]
    if isinstance(w, torch.Tensor):
        w = w.to(L.dtype)
        sgn, root = torch.sign(w), torch.sqrt(torch.abs(w))
        u = root[..., None] * v
    else:
        w = np.asarray(w, dtype=np.float32 if L.dtype == torch.float32 else np.float64)
        sgn, root = float(np.sign(w)), float(np.sqrt(np.abs(w)))
        u = root * v
    cols = []
    for k in range(d):                  # u holds the entries k.. of the rotated vector
        Lkk, uk, u_rest = L[..., k, k], u[..., 0], u[..., 1:]
        r = torch.sqrt(Lkk * Lkk + sgn * uk * uk)
        c, s = r / Lkk, uk / Lkk
        below = (L[..., k + 1:, k] + (sgn * s)[..., None] * u_rest) / c[..., None]
        u = c[..., None] * u_rest - s[..., None] * below
        cols.append(torch.cat([L.new_zeros(L.shape[:-2] + (k,)), r[..., None], below], dim=-1))
    return torch.stack(cols, dim=-1)
