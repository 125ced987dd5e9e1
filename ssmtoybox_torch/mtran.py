"""Classical sigma-point moment transforms (counterpart of :mod:`ssmtoybox_tpu.mtran`).

A transform maps ``(f, mean, cov, time) -> (mean_f, cov_f, cov_fx)`` for a
nonlinear ``f``.  Where the JAX package transforms one mean and ``vmap``s the
call, here every transform takes the batch written out: ``mean`` (M, D) and
``cov`` (M, D, D) give ``mean_f`` (M, E), ``cov_f`` (M, E, E) and the
input-output cross-covariance ``cov_fx`` (M, E, D).

Callable convention: ``f(x, time)`` takes states ``x`` of shape (..., D) and
returns (..., E), broadcasting over the leading dimensions.
"""
from __future__ import annotations

from typing import Callable

import torch

from . import points as pts
from .utils.arrays import f64, resolve_device
from .utils.linalg import chol_small

__all__ = [
    "MomentTransform",
    "SigmaPointTransform",
    "SphericalRadialTransform",
    "UnscentedTransform",
    "GaussHermiteTransform",
    "FullySymmetricStudentTransform",
    "apply_f_columns",
]


def apply_f_columns(f: Callable, x: torch.Tensor, time) -> torch.Tensor:
    """Evaluate ``f`` on every column of ``x`` (..., D, N); returns (..., E, N)."""
    return f(x.mT, time).mT


class MomentTransform:
    """Interface marker: ``apply(f, mean, cov, time) -> (mean_f, cov_f, cov_fx)``."""

    def apply(self, f, mean, cov, time):  # pragma: no cover - interface
        raise NotImplementedError


class SigmaPointTransform(MomentTransform):
    """Weighted sigma-point transform.

    ``x = mean + chol(cov) @ xi``; push through ``f``; weighted mean,
    covariance and cross-covariance.  ``wm`` is the mean-weight vector (N,);
    classical rules pass their diagonal covariance weights as ``wc_diag``,
    general rules a dense (N, N) ``Wc_dense``.
    """

    def __init__(self, unit_sp, wm, wc_diag=None, Wc_dense=None, device=None):
        if (wc_diag is None) == (Wc_dense is None):
            raise ValueError("SigmaPointTransform needs exactly one of wc_diag "
                             "(classical diagonal rule) or Wc_dense (general rule)")
        device = resolve_device(device)
        self.unit_sp = f64(unit_sp, device)          # (D, N)
        self.wm = f64(wm, device)                    # (N,)
        self.wc_diag = None if wc_diag is None else f64(wc_diag, device)
        self.Wc_dense = None if Wc_dense is None else f64(Wc_dense, device)

    @property
    def Wc(self) -> torch.Tensor:
        """Dense covariance-weight matrix, materialized for diagonal rules."""
        return self.Wc_dense if self.Wc_dense is not None else torch.diag(self.wc_diag)

    @property
    def device(self) -> torch.device:
        return self.wm.device

    def apply(self, f, mean, cov, time):
        dx = chol_small(cov) @ self.unit_sp                    # (M, D, N)
        fx = apply_f_columns(f, mean[..., None] + dx, time)    # (M, E, N)
        mean_f = fx @ self.wm
        dfx = fx - mean_f[..., None]
        if self.wc_diag is not None:
            dfx_w = dfx * self.wc_diag
        else:
            dfx_w = dfx @ self.Wc_dense
        return mean_f, dfx_w @ dfx.mT, dfx_w @ dx.mT


class SphericalRadialTransform(SigmaPointTransform):
    """CKF spherical-radial rule, 2d points."""

    def __init__(self, dim: int, device=None):
        w = pts.sr_weights(dim)
        super().__init__(pts.sr_points(dim), w, wc_diag=w, device=device)


class UnscentedTransform(SigmaPointTransform):
    """Unscented transform, 2d+1 points; ``kappa = max(3 - d, 0)`` by default."""

    def __init__(self, dim: int, kappa=None, alpha: float = 1.0, beta: float = 2.0,
                 device=None):
        wm, wc = pts.ut_weights(dim, kappa, alpha, beta)
        super().__init__(pts.ut_points(dim, kappa, alpha), wm, wc_diag=wc, device=device)


class GaussHermiteTransform(SigmaPointTransform):
    """Gauss-Hermite rule, degree^d points."""

    def __init__(self, dim: int, degree: int = 3, device=None):
        w = pts.gh_weights(dim, degree)
        super().__init__(pts.gh_points(dim, degree), w, wc_diag=w, device=device)


class FullySymmetricStudentTransform(SigmaPointTransform):
    """McNamee-Stenger fully-symmetric rule for Student inputs, degree 3 or 5."""

    def __init__(self, dim: int, degree: int = 3, kappa=None, dof: float = 4.0, device=None):
        w = pts.fs_weights(dim, degree, kappa, dof)
        super().__init__(pts.fs_points(dim, degree, kappa, dof), w, wc_diag=w, device=device)
