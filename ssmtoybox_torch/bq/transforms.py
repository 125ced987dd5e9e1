"""Bayesian-quadrature moment transforms (counterpart of
:mod:`ssmtoybox_tpu.bq.transforms`, GP quadrature only).

A BQ transform is a sigma-point transform whose weights come from a GP model
of the integrand.  Its covariance is the UNCENTERED quadrature
``fx Wc fx^T - mu mu^T`` inflated by the expected model variance, and its
cross-covariance is ``fx Wcc^T L^T`` — not the centered classical formulas.
Weights depend only on the kernel parameters and the unit points, so they are
computed once, at construction, in float64.  Batch convention as in
:mod:`ssmtoybox_torch.mtran`.
"""
from __future__ import annotations

import torch

from ..mtran import MomentTransform, apply_f_columns
from ..utils.arrays import f64
from ..utils.linalg import chol_small
from .models import GaussianProcessModel

__all__ = ["BQTransform", "GaussianProcessTransform"]


class BQTransform(MomentTransform):
    """BQ transform from precomputed weights.

    ``points`` (D, N) unit points, ``wm`` (N,), ``Wc`` (N, N), ``Wcc`` (D, N),
    ``model_var`` the scalar expected model variance; ``dim_out`` sizes the
    variance inflation ``model_var * I``.
    """

    def __init__(self, points, wm, Wc, Wcc, model_var, dim_out: int = 1, iK=None,
                 device=None):
        self.points = f64(points, device)
        self.wm = f64(wm, device)
        self.Wc = f64(Wc, device)
        self.Wcc = f64(Wcc, device)
        self.model_var = f64(model_var, device).reshape(())
        self.iK = None if iK is None else f64(iK, device)
        self.dim_out = int(dim_out)
        self._emv = self.model_var * torch.eye(self.dim_out, dtype=torch.float64,
                                               device=self.points.device)

    @property
    def device(self) -> torch.device:
        return self.points.device

    def apply(self, f, mean, cov, time):
        L = chol_small(cov)
        fx = apply_f_columns(f, mean[..., None] + L @ self.points, time)   # (M, E, N)
        mean_f = fx @ self.wm
        cov_f = fx @ self.Wc @ fx.mT - mean_f[..., :, None] * mean_f[..., None, :] + self._emv
        return mean_f, cov_f, fx @ self.Wcc.mT @ L.mT


class GaussianProcessTransform(BQTransform):
    """GPQ moment transform: weights from a :class:`GaussianProcessModel`."""

    def __init__(self, dim_in: int, dim_out: int, kern_par, kern_str: str = "rbf",
                 point_str: str = "ut", point_par=None, device=None):
        self.model = GaussianProcessModel(dim_in, kern_par, kern_str, point_str,
                                          point_par, device=device)
        w = self.model.bq_weights()
        self.integral_var = w.integral_var
        super().__init__(self.model.points, w.wm, w.Wc, w.Wcc, w.model_var,
                         dim_out=dim_out, iK=w.iK, device=device)
