"""Time-parallel Kalman filtering and smoothing by associative scans
(counterpart of :mod:`ssmtoybox_tpu.parallel.timescan`).

For linear-Gaussian (and time-varying affine) models the Kalman recursions
are associative, so one long record filters and smooths in O(log N) depth
(Särkkä & García-Fernández, "Temporal Parallelization of Bayesian
Smoothers", IEEE TAC 2021).

Model: ``x_k = F_k x_{k-1} + b_k + q_k, q_k ~ N(0, Q_k)``; ``y_k = H_k x_k +
c_k + r_k, r_k ~ N(0, R_k)`` with prior ``x_0 ~ N(m0, P0)`` and
measurements ``y_1..y_N``.  Filtering elements ``(A, b, C, eta, J)`` compose
as

    A = A2 (I + C1 J2)^-1 A1
    b = A2 (I + C1 J2)^-1 (b1 + C1 eta2) + b2
    C = A2 (I + C1 J2)^-1 C1 A2^T + C2
    eta = A1^T (I + J2 C1)^-1 (eta2 - J2 b1) + eta1
    J = A1^T (I + J2 C1)^-1 J2 A1 + J1

and smoothing elements ``(E, g, L)`` as ``E = E1 E2``, ``g = E1 g2 + g1``,
``L = E1 L2 E1^T + L1``, scanned in reverse.

Layouts are the JAX package's: data (E, N), moments (D, N) and (D, D, N);
per-step coefficients time first, ``Fs`` (N, D, D).  Inside, every tensor is
time first and each step of the recursion is one batched call over all the
elements of a scan level.  Tensors keep their device and dtype (the first
tensor argument's); arrays become float64 on the default device.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..utils.linalg import chol_small, gen_solve, symmetrize
from .common import as_tensors, ieee, mv, rep
from .scan import associative_scan

__all__ = ["parallel_linear_filter", "parallel_linear_smoother",
           "parallel_affine_filter", "parallel_affine_smoother"]


def _chol_solve(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(L L^T)^-1 b`` for ``b`` (..., E) or (..., E, K)."""
    if b.ndim == L.ndim - 1:
        return torch.cholesky_solve(b[..., None], L)[..., 0]
    return torch.cholesky_solve(b, L)


def _affine_filter_elements(Fs, bs, Qs, Hs, cs, Rs, m0, P0, ys):
    """Per-step filtering elements of the time-varying affine model: given
    ``x_{k-1}``, the posterior of ``x_k`` after ``y_k`` is ``N((I - K H) F x +
    b + K (y - c - H b), (I - K H) Q)``; the first element conditions on the
    prior pushed through step 1's model."""
    d = m0.shape[0]
    eye = torch.eye(d, dtype=m0.dtype, device=m0.device)
    yc = ys - cs - mv(Hs, bs)
    L = chol_small(Hs @ Qs @ Hs.mT + Rs)
    K = _chol_solve(L, Hs @ Qs).mT
    A = (eye - K @ Hs) @ Fs
    b = bs + mv(K, yc)
    C = symmetrize(Qs - K @ Hs @ Qs)
    HF = Hs @ Fs
    eta = mv(HF.mT, _chol_solve(L, yc))
    J = HF.mT @ _chol_solve(L, HF)

    F1, H1 = Fs[0], Hs[0]
    m1 = F1 @ m0 + bs[0]
    P1 = symmetrize(F1 @ P0 @ F1.T + Qs[0])
    K1 = _chol_solve(chol_small(H1 @ P1 @ H1.T + Rs[0]), H1 @ P1).T
    b0 = m1 + K1 @ (ys[0] - cs[0] - H1 @ m1)
    C0 = symmetrize(P1 - K1 @ H1 @ P1)
    first = lambda x0, x: torch.cat([x0[None], x[1:]])
    return (first(torch.zeros_like(A[0]), A), first(b0, b), first(C0, C),
            first(torch.zeros_like(eta[0]), eta), first(torch.zeros_like(J[0]), J))


def _combine_filter(elem1, elem2):
    """Associative composition of filtering elements."""
    A1, b1, C1, eta1, J1 = elem1
    A2, b2, C2, eta2, J2 = elem2
    eye = torch.eye(A1.shape[-1], dtype=A1.dtype, device=A1.device).expand(A1.shape)
    M = gen_solve(eye + C1 @ J2, eye)                      # (I + C1 J2)^-1
    A2M = A2 @ M
    A = A2M @ A1
    b = mv(A2M, b1 + mv(C1, eta2)) + b2
    C = A2M @ C1 @ A2.mT + C2
    Mt = gen_solve(eye + J2 @ C1, eye)                     # (I + J2 C1)^-1
    A1tMt = A1.mT @ Mt
    eta = mv(A1tMt, eta2 - mv(J2, b1)) + eta1
    J = A1tMt @ J2 @ A1 + J1
    return A, b, C, eta, J


@ieee
def parallel_affine_filter(Fs, bs, Qs, Hs, cs, Rs, m0, P0, data
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kalman-filter a time-varying affine model in O(log N) depth.

    ``Fs`` (N, D, D), ``bs`` (N, D), ``Qs`` (N, D, D) define ``x_k = F_k
    x_{k-1} + b_k + q_k`` (element ``k`` predicts step ``k`` from ``k - 1``);
    ``Hs`` (N, E, D), ``cs`` (N, E), ``Rs`` (N, E, E) define ``y_k = H_k x_k +
    c_k + r_k``; ``data`` is (E, N).  Returns ``(fi_mean (D, N), fi_cov (D,
    D, N))``, equal to the sequential filter's to rounding.
    """
    Fs, bs, Qs, Hs, cs, Rs, m0, P0, data = as_tensors(Fs, bs, Qs, Hs, cs, Rs, m0, P0, data)
    elems = _affine_filter_elements(Fs, bs, Qs, Hs, cs, Rs, m0, P0, data.T)
    _, b, C, _, _ = associative_scan(_combine_filter, elems)
    return b.T, symmetrize(C).permute(1, 2, 0)


def parallel_linear_filter(F, Q, H, R, m0, P0, data) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kalman-filter a linear-Gaussian model in O(log N) depth: the
    constant-coefficient, zero-offset case of :func:`parallel_affine_filter`.
    ``data`` is (dim_y, N); returns ``(fi_mean (D, N), fi_cov (D, D, N))``."""
    F, Q, H, R, m0, P0, data = as_tensors(F, Q, H, R, m0, P0, data)
    n = data.shape[-1]
    return parallel_affine_filter(rep(F, n), F.new_zeros(n, F.shape[0]), rep(Q, n),
                                  rep(H, n), F.new_zeros(n, H.shape[0]), rep(R, n),
                                  m0, P0, data)


def _combine_smoother(elem2, elem1):
    """Associative composition of smoothing elements; the scan runs in
    reverse, so the later element comes first."""
    E1, g1, L1 = elem1
    E2, g2, L2 = elem2
    return E1 @ E2, mv(E1, g2) + g1, E1 @ L2 @ E1.mT + L1


def _affine_smoother_elements(Fs, bs, Qs, m, P):
    """RTS smoothing elements ``(E, g, L)`` of the filtered moments ``m`` (N,
    D), ``P`` (N, D, D); the last step keeps its filtered moments."""
    F, bd, Q, mk, Pk = Fs[1:], bs[1:], Qs[1:], m[:-1], P[:-1]
    Pp = symmetrize(F @ Pk @ F.mT + Q)                      # predictive at k + 1
    G = _chol_solve(chol_small(Pp), F @ Pk).mT              # smoother gain
    g = mk - mv(G, mv(F, mk) + bd)
    L = symmetrize(Pk - G @ Pp @ G.mT)
    return (torch.cat([G, torch.zeros_like(Fs[:1])]), torch.cat([g, m[-1:]]),
            torch.cat([L, P[-1:]]))


@ieee
def parallel_affine_smoother(Fs, bs, Qs, fi_mean, fi_cov) -> Tuple[torch.Tensor, torch.Tensor]:
    """RTS-smooth the output of :func:`parallel_affine_filter` in O(log N)
    depth.  ``Fs``/``bs``/``Qs`` are indexed as there, so the element at step
    ``k`` uses the dynamics into ``k + 1``.  Returns ``(sm_mean (D, N),
    sm_cov (D, D, N))``."""
    Fs, bs, Qs, fi_mean, fi_cov = as_tensors(Fs, bs, Qs, fi_mean, fi_cov)
    elems = _affine_smoother_elements(Fs, bs, Qs, fi_mean.T, fi_cov.permute(2, 0, 1))
    _, g, L = associative_scan(_combine_smoother, elems, reverse=True)
    return g.T, symmetrize(L).permute(1, 2, 0)


def parallel_linear_smoother(F, Q, fi_mean, fi_cov) -> Tuple[torch.Tensor, torch.Tensor]:
    """RTS-smooth the output of :func:`parallel_linear_filter` in O(log N)
    depth: the constant-coefficient case of :func:`parallel_affine_smoother`."""
    F, Q, fi_mean, fi_cov = as_tensors(F, Q, fi_mean, fi_cov)
    n = fi_mean.shape[-1]
    return parallel_affine_smoother(rep(F, n), F.new_zeros(n, F.shape[0]), rep(Q, n),
                                    fi_mean, fi_cov)
