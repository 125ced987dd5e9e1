"""Multi-indices of multivariate monomials and their Vandermonde matrix
(counterpart of :mod:`ssmtoybox_tpu.utils.combin`).

The multi-index helpers are host-side NumPy, copied from the JAX package so
that the port never imports it.  :func:`vandermonde` is the compute-path
function: a CUDA tensor goes to the hand-written kernel
(:mod:`ssmtoybox_torch.ops.vandermonde`), a CPU tensor to its plain PyTorch
version.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["n_sum_k", "n_sum_k_complete", "total_degree_multi_index", "vandermonde",
           "vandermonde_np"]


def n_sum_k(n: int, k: int) -> np.ndarray:
    """n-tuples of non-negative ints summing to k, as a (n, count) matrix.

    The reference's recursion, column order and all: BSQ weights depend on
    the order through the Vandermonde matrix.  It is INCOMPLETE for
    ``n >= 3, k >= 3`` (it leaves out (0, 3, 0) for (3, 3), 3 of 15 tuples
    for (3, 4), 4 of 20 for (4, 3)), as in the JAX package; the full set is
    :func:`n_sum_k_complete`.
    """
    if k < 0:
        raise ValueError(f"k must be >= 0; got {k}")
    if k == 0:
        return np.zeros((n, 1), dtype=np.int64)
    if k == 1:
        return np.eye(n, dtype=np.int64)
    a = n_sum_k(n, k - 1)
    eye = np.eye(n, dtype=np.int64)
    cols = [a[:, i] + eye[:, j] for i in range(n - 1) for j in range(i, n)]
    temp = np.stack(cols, axis=1) if cols else np.zeros((n, 0), dtype=np.int64)
    return np.hstack((temp, a[:, n - 1:] + eye[:, -1, None]))


def n_sum_k_complete(n: int, k: int) -> np.ndarray:
    """ALL n-tuples of non-negative ints summing to k: ``C(k+n-1, n-1)``
    columns in lexicographic order."""
    if k < 0:
        raise ValueError(f"k must be >= 0; got {k}")
    if n == 1:
        return np.full((1, 1), k, dtype=np.int64)
    cols = []
    for first in range(k + 1):
        rest = n_sum_k_complete(n - 1, k - first)
        cols.append(np.vstack([np.full((1, rest.shape[1]), first, dtype=np.int64), rest]))
    return np.hstack(cols)


def total_degree_multi_index(dim: int, degree: int, complete: bool = False) -> np.ndarray:
    """Multi-index matrix of the monomials of total degree <= ``degree``,
    one block per degree from :func:`n_sum_k` (the reference's, default) or
    :func:`n_sum_k_complete`."""
    gen = n_sum_k_complete if complete else n_sum_k
    return np.hstack([gen(dim, td) for td in range(degree + 1)])


def vandermonde(mul_ind, x: torch.Tensor) -> torch.Tensor:
    """``vdm[n, b] = prod_d x[d, n] ** mul_ind[d, b]`` for points ``x``
    (D, N) float64 and a (D, Q) integer multi-index; returns (N, Q).

    The kernel on a CUDA tensor, the plain version on a CPU tensor; both
    multiply in the same order and agree to the bit.
    """
    from ..ops.vandermonde import vandermonde as _vandermonde
    return _vandermonde(mul_ind, x)


def vandermonde_np(mul_ind: np.ndarray, x: np.ndarray) -> np.ndarray:
    """NumPy twin of :func:`vandermonde` on the host: (N, Q) from ``x`` (D,
    N) and the (D, Q) multi-index."""
    return np.prod(x.T[:, None, :] ** mul_ind.T[None, :, :], axis=-1)
