"""Bayesian-quadrature moment transforms (counterpart of
:mod:`ssmtoybox_tpu.bq.transforms`: GP and Student-t-process quadrature).

A BQ transform is a sigma-point transform whose weights come from a GP model
of the integrand.  Its covariance is the UNCENTERED quadrature
``fx Wc fx^T - mu mu^T`` inflated by the expected model variance, and its
cross-covariance is ``fx Wcc^T L^T`` — not the centered classical formulas.
Weights depend only on the kernel parameters and the unit points, so they are
computed once, at construction, in float64.  Batch convention as in
:mod:`ssmtoybox_torch.mtran`.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from ..mtran import MomentTransform, apply_f_columns
from ..utils.arrays import f64, resolve_device
from ..utils.linalg import chol_small
from .models import BayesSardModel, GaussianProcessModel, StudentTProcessModel, tp_scale

__all__ = ["BQTransform", "GaussianProcessTransform", "BayesSardTransform",
           "StudentTProcessTransform"]


class BQTransform(MomentTransform):
    """BQ transform from precomputed weights.

    ``points`` (D, N) unit points, ``wm`` (N,), ``Wc`` (N, N), ``Wcc`` (D, N),
    ``model_var`` the expected model variance: a scalar, or an (E, E) matrix
    (an override, as the BSQ tracking study sets).  The variance inflation is
    ``model_var * I_{dim_out}`` ELEMENTWISE, as in the JAX package: a matrix
    keeps its diagonal only.  :meth:`replace` returns a copy with fields
    replaced and the inflation recomputed.
    """

    def __init__(self, points, wm, Wc, Wcc, model_var, dim_out: int = 1, iK=None,
                 integral_var=None, device=None):
        device = resolve_device(device)
        self.points = f64(points, device)
        self.wm = f64(wm, device)
        self.Wc = f64(Wc, device)
        self.Wcc = f64(Wcc, device)
        mv = f64(model_var, device)
        self.model_var = mv.reshape(()) if mv.numel() == 1 and mv.ndim <= 1 else mv
        self.iK = None if iK is None else f64(iK, device)
        self.integral_var = None if integral_var is None else f64(integral_var, device)
        self.dim_out = int(dim_out)
        self._emv = self.model_var * torch.eye(self.dim_out, dtype=torch.float64,
                                               device=self.points.device)

    def replace(self, **fields) -> "BQTransform":
        """A copy with ``fields`` (``model_var``, ``wm``, ...) replaced, the
        inflation ``model_var * I`` recomputed: the JAX package's
        ``tf.replace(model_var=...)``.  The copy shares the other tensors."""
        kw = {k: getattr(self, k) for k in ("points", "wm", "Wc", "Wcc", "model_var", "iK",
                                            "integral_var", "dim_out")}
        unknown = set(fields) - set(kw)
        if unknown:
            raise ValueError(f"cannot replace {sorted(unknown)}")
        tf = copy.copy(self)
        BQTransform.__init__(tf, **{**kw, **fields}, device=self.device)
        return tf

    @property
    def device(self) -> torch.device:
        return self.points.device

    def apply(self, f, mean, cov, time):
        L = chol_small(cov)
        fx = self._fcn_eval(f, mean[..., None] + L @ self.points, time)     # (M, E, N)
        mean_f = fx @ self.wm
        cov_f = (fx @ self.Wc @ fx.mT - mean_f[..., :, None] * mean_f[..., None, :]
                 + self._model_variance(fx))
        return mean_f, cov_f, fx @ self.Wcc.mT @ L.mT

    def _fcn_eval(self, f, x, time):
        """The integrand's values at the points ``x`` (M, D, N), one column a
        weight: (M, E, N).  GPQ+D appends its Jacobian columns."""
        return apply_f_columns(f, x, time)

    def _model_variance(self, fx):
        """The GPQ inflation ``model_var * I``."""
        return self._emv


class GaussianProcessTransform(BQTransform):
    """GPQ moment transform: weights from a :class:`GaussianProcessModel`;
    ``kern_kwargs`` reach the kernel (e.g. an ``RBFStudent``'s Monte-Carlo
    settings ``num_samples``, ``num_batches``, ``seed``, ``dof``,
    ``use_kernel``)."""

    def __init__(self, dim_in: int, dim_out: int, kern_par, kern_str: str = "rbf",
                 point_str: str = "ut", point_par=None, device=None, **kern_kwargs):
        self.model = GaussianProcessModel(dim_in, kern_par, kern_str, point_str,
                                          point_par, device=device, **kern_kwargs)
        w = self.model.bq_weights()
        super().__init__(self.model.points, w.wm, w.Wc, w.Wcc, w.model_var,
                         dim_out=dim_out, iK=w.iK, integral_var=w.integral_var,
                         device=device)


class BayesSardTransform(BQTransform):
    """BSQ moment transform: weights from a :class:`BayesSardModel` (RBF
    kernel, polynomial prior mean of multi-index ``multi_ind``)."""

    def __init__(self, dim_in: int, dim_out: int, kern_par, multi_ind=2,
                 point_str: str = "ut", point_par=None, compat_kxpx_ell_squared: bool = True,
                 device=None):
        self.model = BayesSardModel(dim_in, kern_par, multi_ind, point_str, point_par,
                                    compat_kxpx_ell_squared, device=device)
        w = self.model.bq_weights()
        super().__init__(self.model.points, w.wm, w.Wc, w.Wcc, w.model_var,
                         dim_out=dim_out, iK=w.iK, integral_var=w.integral_var,
                         device=device)

    @classmethod
    def from_weights(cls, points, wm, Wc, Wcc, model_var, mulind, dim_out: int = 1, iK=None,
                     integral_var=None, compat_kxpx_ell_squared: bool = True,
                     device=None) -> "BayesSardTransform":
        """The transform from precomputed weights (e.g. the JAX transform's
        arrays), without a model: ``mulind`` and the compat flag are kept as
        attributes for reference."""
        tf = cls.__new__(cls)
        BQTransform.__init__(tf, points, wm, Wc, Wcc, model_var, dim_out=dim_out, iK=iK,
                             integral_var=integral_var, device=device)
        tf.model = None
        tf.mulind = np.atleast_2d(np.asarray(mulind, dtype=np.int64))
        tf.compat_kxpx_ell_squared = bool(compat_kxpx_ell_squared)
        return tf


class StudentTProcessTransform(BQTransform):
    """TPQ moment transform: GP weights from a :class:`StudentTProcessModel`
    and the data-dependent model variance
    ``tp_scale(nu, iK, f) * model_var * I_out`` (for ``dim_out=1`` the whole
    (E, E) scale matrix, as in the JAX package and the reference).

    ``compat_drop_nu=True`` (default) reproduces the reference, where the
    transform's ``nu`` never reaches the model, which keeps ``nu = 4``.
    ``mc_opts`` reach the kernel (``num_samples``, ``num_batches``, ``seed``,
    ``dof``, ``use_kernel``); the point-set ``dof`` shapes the points only.
    :meth:`from_weights` builds the transform from precomputed arrays.
    """

    def __init__(self, dim_in: int, dim_out: int, kern_par, kern_str: str = "rbf",
                 point_str: str = "ut", point_par=None, nu: float = 3.0,
                 compat_drop_nu: bool = True, mc_opts=None, device=None):
        self.model = StudentTProcessModel(dim_in, kern_par, kern_str, point_str, point_par,
                                          nu=4.0 if compat_drop_nu else nu, device=device,
                                          **dict(mc_opts or {}))
        w = self.model.bq_weights()
        super().__init__(self.model.points, w.wm, w.Wc, w.Wcc, w.model_var,
                         dim_out=dim_out, iK=w.iK, integral_var=w.integral_var,
                         device=device)
        self.nu = self.model.nu

    @classmethod
    def from_weights(cls, points, wm, Wc, Wcc, model_var, iK, nu: float, dim_out: int = 1,
                     integral_var=None, device=None) -> "StudentTProcessTransform":
        tf = cls.__new__(cls)
        BQTransform.__init__(tf, points, wm, Wc, Wcc, model_var, dim_out=dim_out, iK=iK,
                             integral_var=integral_var, device=device)
        tf.model = None
        tf.nu = float(nu)
        return tf

    def _model_variance(self, fx):
        scale = tp_scale(self.nu, self.iK, fx)                          # (M, E, E)
        return scale * self.model_var * torch.eye(self.dim_out, dtype=fx.dtype,
                                                  device=fx.device)
