"""Time-parallel square-root Kalman filtering and smoothing by associative
scans (counterpart of :mod:`ssmtoybox_tpu.parallel.sqrttime`).

The elements of :mod:`~ssmtoybox_torch.parallel.timescan` with every
covariance carried as a lower Cholesky factor (Yaghoobi, Corenflos, Hassan &
Särkkä, "Parallel square-root solutions for Bayesian smoothers", IEEE TSP
2022): no covariance is formed, so float32 keeps its definiteness.

The filtering combine needs ``M C1`` and ``N J2`` with ``M = (I + C1
J2)^-1``, ``N = (I + J2 C1)^-1``.  With ``C = U U^T``, ``J = Z Z^T`` and ``V =
U1^T Z2``, the push-through identity gives ``M C1 = U1 (I + V V^T)^-1 U1^T``
and ``N J2 = Z2 (I + V^T V)^-1 Z2^T``, so with ``L_V L_V^T = I + V V^T`` and
``L_W L_W^T = I + V^T V`` (one QR each) the factors update as ``U =
tria([A2 U1 L_V^-T, U2])`` and ``Z = tria([A1^T Z2 L_W^-T, Z1])``; the mean
and information vectors use ``M = I - U1 V W^-1 Z2^T`` and ``N = I - Z2 W^-1
V^T U1^T`` (Woodbury), triangular solves against ``L_W``, whose diagonal is
at least 1.

Layouts and conventions are :mod:`~ssmtoybox_torch.parallel.timescan`'s.
``scan_block_len`` runs the scan block by block, each block's prefixes
combined with the running composition of the blocks before it: the
temporaries are bounded by the block, the results equal the unblocked
scan's to rounding.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..utils.linalg import tri_solve_small, tria
from .common import as_tensors, ieee, mv, rep
from .scan import associative_scan

__all__ = ["parallel_affine_sqrt_filter", "parallel_affine_sqrt_smoother",
           "parallel_linear_sqrt_filter", "parallel_linear_sqrt_smoother"]


def _blocked_associative_scan(fn, elems, identity, block_len: int, reverse: bool = False):
    """The prefix (or, reversed, suffix) compositions of ``elems`` by blocks
    of ``block_len``: an associative scan inside each block, then each
    in-block prefix combined with the composition of all finished blocks.
    ``identity`` is a two-sided identity of ``fn``, the first carry and the
    padding of the last block."""
    if reverse:
        flip = lambda t: tuple(torch.flip(e, (0,)) for e in t)
        return flip(_blocked_associative_scan(fn, flip(elems), identity, block_len))
    n = elems[0].shape[0]
    carry = tuple(i[None] for i in identity)
    outs = []
    for start in range(0, n, block_len):
        blk = tuple(e[start:start + block_len] for e in elems)
        pad = block_len - blk[0].shape[0]
        if pad:
            blk = tuple(torch.cat([e, i.expand((pad,) + i.shape)]) for e, i in zip(blk, identity))
        scanned = associative_scan(fn, blk)
        out = fn(tuple(c.expand(s.shape) for c, s in zip(carry, scanned)), scanned)
        carry = tuple(o[-1:] for o in out)
        outs.append(out)
    return tuple(torch.cat(parts)[:n] for parts in zip(*outs))


def _filter_identity(d: int, like: torch.Tensor):
    """Two-sided identity of :func:`_combine_sqrt_filter`: ``x -> I x + 0``
    with zero covariance and zero information."""
    z = like.new_zeros
    return (torch.eye(d, dtype=like.dtype, device=like.device), z(d), z(d, d), z(d), z(d, d))


def _smoother_identity(d: int, like: torch.Tensor):
    """Two-sided identity of :func:`_combine_sqrt_smoother`."""
    return (torch.eye(d, dtype=like.dtype, device=like.device), like.new_zeros(d),
            like.new_zeros(d, d))


def _tria_pad(cols: torch.Tensor) -> torch.Tensor:
    """:func:`tria` of fewer columns than rows: zero columns pad the block to
    a square (the Gram, hence the factor, is unchanged)."""
    rows, m = cols.shape[-2], cols.shape[-1]
    if m < rows:
        cols = torch.cat([cols, cols.new_zeros(cols.shape[:-1] + (rows - m,))], dim=-1)
    return tria(cols)


def _square_cols(Zm: torch.Tensor, d: int) -> torch.Tensor:
    """A (..., D, E) factor as (..., D, D) columns: zero-padded for E < D,
    triangularized for E > D."""
    e = Zm.shape[-1]
    if e == d:
        return Zm
    if e < d:
        return torch.cat([Zm, Zm.new_zeros(Zm.shape[:-1] + (d - e,))], dim=-1)
    return tria(Zm)


def _gain(Psi11: torch.Tensor, Psi21: torch.Tensor) -> torch.Tensor:
    """``Psi21 Psi11^-1`` by a triangular solve."""
    return tri_solve_small(Psi11.mT, Psi21.mT, lower=False).mT


def _joint(top_left, top_right, bottom_left):
    """``tria([[top_left, top_right], [bottom_left, 0]])``."""
    zeros = bottom_left.new_zeros(bottom_left.shape[:-1] + (top_right.shape[-1],))
    return _tria_pad(torch.cat([torch.cat([top_left, top_right], dim=-1),
                                torch.cat([bottom_left, zeros], dim=-1)], dim=-2))


def _sqrt_filter_elements(Fs, bs, SQs, Hs, cs, SRs, m0, S0, ys):
    """Per-step square-root filtering elements ``(A, b, U, eta, Z)`` with ``C
    = U U^T`` and ``J = Z Z^T``.  ``tria([[H SQ, SR], [SQ, 0]])`` gives
    ``Psi11 = sqrt(H Q H^T + R)``, ``Psi21 = Q H^T Psi11^-T`` and ``U =
    sqrt((I - K H) Q)``."""
    d, e = m0.shape[0], ys.shape[-1]
    eye = torch.eye(d, dtype=m0.dtype, device=m0.device)
    Psi = _joint(Hs @ SQs, SRs, SQs)
    Psi11, U = Psi[..., :e, :e], Psi[..., e:, e:]
    K = _gain(Psi11, Psi[..., e:, :e])
    A = (eye - K @ Hs) @ Fs
    z = ys - cs - mv(Hs, bs)
    b = bs + mv(K, z)
    # eta = (H F)^T S^-1 z and Z = (H F)^T Psi11^-T, so that J = Z Z^T
    Zm = tri_solve_small(Psi11, Hs @ Fs, lower=True).mT
    eta = mv(Zm, tri_solve_small(Psi11, z, lower=True))

    F1, H1 = Fs[0], Hs[0]
    m1 = F1 @ m0 + bs[0]
    SP1 = _tria_pad(torch.cat([F1 @ S0, SQs[0]], dim=-1))
    Psi0 = _joint(H1 @ SP1, SRs[0], SP1)
    K1 = _gain(Psi0[:e, :e], Psi0[e:, :e])
    b0 = m1 + K1 @ (ys[0] - cs[0] - H1 @ m1)
    first = lambda x0, x: torch.cat([x0[None], x[1:]])
    return (first(torch.zeros_like(A[0]), A), first(b0, b), first(Psi0[e:, e:], U),
            first(torch.zeros_like(eta[0]), eta), first(eye.new_zeros(d, d), _square_cols(Zm, d)))


def _combine_sqrt_filter(elem1, elem2):
    """Associative square-root filtering composition: every factor update a
    QR, every solve against a diagonal of at least 1."""
    A1, b1, U1, eta1, Z1 = elem1
    A2, b2, U2, eta2, Z2 = elem2
    eye = torch.eye(A1.shape[-1], dtype=A1.dtype, device=A1.device).expand(A1.shape)
    V = U1.mT @ Z2
    LV = tria(torch.cat([V, eye], dim=-1))                  # chol(I + V V^T)
    LW = tria(torch.cat([V.mT, eye], dim=-1))               # chol(I + V^T V)

    A2U1 = A2 @ U1
    X = tri_solve_small(LV, A2U1.mT, lower=True)            # LV^-1 (A2 U1)^T
    U = tria(torch.cat([X.mT, U2], dim=-1))
    A1tZ2 = A1.mT @ Z2
    Y = tri_solve_small(LW, A1tZ2.mT, lower=True)
    Z = tria(torch.cat([Y.mT, Z1], dim=-1))

    def w_solve(rhs):
        """``(I + V^T V)^-1 rhs`` by two triangular substitutions."""
        return tri_solve_small(LW.mT, tri_solve_small(LW, rhs, lower=True), lower=False)

    # A = A2 M A1, b = A2 M (b1 + C1 eta2) + b2, M = I - U1 V W^-1 Z2^T
    b1c = b1 + mv(U1, mv(U1.mT, eta2))
    TG = A2U1 @ w_solve(V.mT).mT
    Z2t = Z2.mT
    A = A2 @ A1 - TG @ (Z2t @ A1)
    b = mv(A2, b1c) - mv(TG, mv(Z2t, b1c)) + b2
    # eta = A1^T N (eta2 - J2 b1) + eta1, N = I - Z2 W^-1 V^T U1^T
    dvec = eta2 - mv(Z2, mv(Z2t, b1))
    corr = w_solve(mv(V.mT, mv(U1.mT, dvec)))
    eta = mv(A1.mT, dvec) - mv(A1tZ2, corr) + eta1
    return A, b, U, eta, Z


@ieee
def parallel_affine_sqrt_filter(Fs, bs, SQs, Hs, cs, SRs, m0, S0, data,
                                scan_block_len: int | None = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Square-root Kalman filter of a time-varying affine model in O(log N)
    depth.

    The model and indexing of
    :func:`~ssmtoybox_torch.parallel.timescan.parallel_affine_filter`, with
    the covariances as factor columns: ``SQs`` (N, D, Mq) and ``SRs`` (N, E,
    Mr), any column count (square factors, thin gain-scaled ones, stacked
    sources); ``S0`` the prior's factor.  Returns ``(fi_mean (D, N), fi_sqrt
    (D, D, N))`` with ``fi_sqrt fi_sqrt^T`` the filtered covariance.
    ``scan_block_len`` bounds the scan's temporaries (module docstring).
    """
    Fs, bs, SQs, Hs, cs, SRs, m0, S0, data = as_tensors(Fs, bs, SQs, Hs, cs, SRs, m0, S0, data)
    elems = _sqrt_filter_elements(Fs, bs, SQs, Hs, cs, SRs, m0, S0, data.T)
    if scan_block_len:
        _, b, U, _, _ = _blocked_associative_scan(
            _combine_sqrt_filter, elems, _filter_identity(m0.shape[0], m0), int(scan_block_len))
    else:
        _, b, U, _, _ = associative_scan(_combine_sqrt_filter, elems)
    return b.T, U.permute(1, 2, 0)


def parallel_linear_sqrt_filter(F, SQ, H, SR, m0, S0, data, scan_block_len: int | None = None
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Constant-coefficient case of :func:`parallel_affine_sqrt_filter`."""
    F, SQ, H, SR, m0, S0, data = as_tensors(F, SQ, H, SR, m0, S0, data)
    n = data.shape[-1]
    return parallel_affine_sqrt_filter(rep(F, n), F.new_zeros(n, F.shape[0]), rep(SQ, n),
                                       rep(H, n), F.new_zeros(n, H.shape[0]), rep(SR, n),
                                       m0, S0, data, scan_block_len=scan_block_len)


def _combine_sqrt_smoother(elem2, elem1):
    """Associative square-root smoothing composition (reverse scan): ``E =
    E1 E2``, ``g = E1 g2 + g1``, ``D = tria([E1 D2, D1])``."""
    E1, g1, D1 = elem1
    E2, g2, D2 = elem2
    return E1 @ E2, mv(E1, g2) + g1, tria(torch.cat([E1 @ D2, D1], dim=-1))


def _sqrt_smoother_elements(Fs, bs, SQs, m, S):
    """Square-root RTS elements ``(E, g, D)`` of the filtered moments ``m``
    (N, D) and factors ``S`` (N, D, D), from one joint QR a step:
    ``tria([[F S, S_Q], [S, 0]]) = [[S_pr, 0], [L21, L22]]`` gives the gain
    ``L21 S_pr^-1`` and ``L22``; the last step keeps its filtered moments."""
    d = S.shape[-1]
    F, Sk, mk = Fs[1:], S[:-1], m[:-1]
    L = _joint(F @ Sk, SQs[1:], Sk)
    G = _gain(L[..., :d, :d], L[..., d:, :d])
    g = mk - mv(G, mv(F, mk) + bs[1:])
    return (torch.cat([G, S.new_zeros(1, d, d)]), torch.cat([g, m[-1:]]),
            torch.cat([L[..., d:, d:], S[-1:]]))


@ieee
def parallel_affine_sqrt_smoother(Fs, bs, SQs, fi_mean, fi_sqrt,
                                  scan_block_len: int | None = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Square-root RTS smoothing of the output of
    :func:`parallel_affine_sqrt_filter` in O(log N) depth.  Returns
    ``(sm_mean (D, N), sm_sqrt (D, D, N))``."""
    Fs, bs, SQs, fi_mean, fi_sqrt = as_tensors(Fs, bs, SQs, fi_mean, fi_sqrt)
    S = fi_sqrt.permute(2, 0, 1)
    elems = _sqrt_smoother_elements(Fs, bs, SQs, fi_mean.T, S)
    if scan_block_len:
        _, g, D = _blocked_associative_scan(_combine_sqrt_smoother, elems,
                                            _smoother_identity(S.shape[-1], S),
                                            int(scan_block_len), reverse=True)
    else:
        _, g, D = associative_scan(_combine_sqrt_smoother, elems, reverse=True)
    return g.T, D.permute(1, 2, 0)


def parallel_linear_sqrt_smoother(F, SQ, fi_mean, fi_sqrt, scan_block_len: int | None = None
                                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Constant-coefficient case of :func:`parallel_affine_sqrt_smoother`."""
    F, SQ, fi_mean, fi_sqrt = as_tensors(F, SQ, fi_mean, fi_sqrt)
    n = fi_mean.shape[-1]
    return parallel_affine_sqrt_smoother(rep(F, n), F.new_zeros(n, F.shape[0]), rep(SQ, n),
                                         fi_mean, fi_sqrt, scan_block_len=scan_block_len)
