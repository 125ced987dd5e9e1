"""Bayesian-quadrature moment transforms (counterpart of
:mod:`ssmtoybox_tpu.bq.transforms`: GP, Bayes-Sard and Student-t-process
quadrature, single- and multi-output).

A BQ transform is a sigma-point transform whose weights come from a GP model
of the integrand.  Its covariance is the UNCENTERED quadrature
``fx Wc fx^T - mu mu^T`` inflated by the expected model variance, and its
cross-covariance is ``fx Wcc^T L^T`` — not the centered classical formulas.
Weights depend only on the kernel parameters and the unit points, so they are
computed once, at construction, in float64.  ``apply(..., kern_par=...)``
derives them from other kernel parameters for that call instead, and
:meth:`BQTransform.with_kern_par` once for many calls (the filters' per-call
``theta``); both stay differentiable in ``kern_par``.
:meth:`BQTransform.with_kern_par_batch` derives a set of weights for each
member of a batch (the marginalized filter's parameter nodes).  Batch
convention as in :mod:`ssmtoybox_torch.mtran`.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from ..mtran import MomentTransform, apply_f_columns
from ..utils.arrays import f64, resolve_device
from ..utils.linalg import chol_small
from .models import (BayesSardModel, GaussianProcessModel, GaussianProcessMO,
                     StudentTProcessModel, StudentTProcessMO, mo_gp_emv, mo_tp_emv, tp_scale)

__all__ = ["BQTransform", "GaussianProcessTransform", "BayesSardTransform",
           "StudentTProcessTransform", "MultiOutputBQTransform",
           "MultiOutputGaussianProcessTransform", "MultiOutputStudentTProcessTransform"]


def _model_of(tf):
    """The transform's model, ``ValueError`` for one built from weights."""
    model = getattr(tf, "model", None)
    if model is None:
        raise ValueError(f"this {type(tf).__name__} was built from precomputed weights and "
                         "has no model to derive weights from kern_par; build it from its "
                         "kernel parameters instead")
    return model


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

    def weights(self, par, *args):
        """``(wm, Wc, Wcc)`` derived from kernel parameters ``par``."""
        w = _model_of(self).bq_weights(par, *args)
        return w.wm, w.Wc, w.Wcc

    def _weight_bundle(self, kern_par):
        """``(wm, Wc, Wcc, model_var, iK)``: the stored weights, or those of
        ``kern_par`` (no integral variance)."""
        if kern_par is None:
            return self.wm, self.Wc, self.Wcc, self.model_var, self.iK
        w = _model_of(self).bq_weights(kern_par, with_integral_var=False)
        return w.wm, w.Wc, w.Wcc, w.model_var, w.iK

    def with_kern_par(self, kern_par) -> "BQTransform":
        """A copy that applies with the weights of ``kern_par``, derived once
        (``self`` for None).  Differentiable in ``kern_par``; the copy shares
        the model and the points."""
        if kern_par is None:
            return self
        tf = copy.copy(self)
        tf.wm, tf.Wc, tf.Wcc, tf.model_var, tf.iK = self._weight_bundle(kern_par)
        tf.integral_var = None
        tf._emv = tf.model_var * torch.eye(self.dim_out, dtype=tf.model_var.dtype,
                                           device=self.points.device)
        return tf

    def with_kern_par_batch(self, kern_par) -> "BQTransform":
        """A copy that applies with other weights for each member of a batch:
        ``kern_par`` (B, num_par) holds one kernel parameter row a member,
        and ``apply`` then takes a batch of B moments.  The weights of all B
        rows are derived at once (``torch.func.vmap`` of the model's
        ``bq_weights``, differentiable in ``kern_par``): ``wm`` (B, N), ``Wc``
        (B, N, N), ``Wcc`` (B, D, N), ``model_var`` (B, 1, 1)."""
        model = _model_of(self)

        def one(par):
            w = model.bq_weights(par, with_integral_var=False)
            return w.wm, w.Wc, w.Wcc, w.model_var, w.iK

        tf = copy.copy(self)
        tf.wm, tf.Wc, tf.Wcc, mv, tf.iK = torch.func.vmap(one)(kern_par)
        tf.model_var = mv.reshape(-1, 1, 1)
        tf.integral_var = None
        tf._emv = tf.model_var * torch.eye(self.dim_out, dtype=mv.dtype, device=mv.device)
        return tf

    def apply(self, f, mean, cov, time, kern_par=None):
        if kern_par is not None:
            return self.with_kern_par(kern_par).apply(f, mean, cov, time)
        L = chol_small(cov)
        fx = self._fcn_eval(f, mean[..., None] + L @ self.points, time)     # (M, E, N)
        mean_f = fx @ self.wm if self.wm.ndim == 1 else (fx @ self.wm[..., None])[..., 0]
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
        arrays), without a model (so ``kern_par`` raises): ``mulind`` and the
        compat flag are kept as attributes for reference."""
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


# ---------------------------------------------------------------------------
# Multi-output transforms (EXPERIMENTAL in the reference)
# ---------------------------------------------------------------------------

class MultiOutputBQTransform(MomentTransform):
    """Multi-output BQ transform: one kernel-parameter row per output, weight
    tensors ``wm`` (N, E), ``Wc`` (N, N, E, E), ``Wcc`` (D, N, E), with ``Q``
    (N, N, E, E) and ``iK`` (N, N, E) for the per-output expected model
    variance, which is added to every row of the covariance (NumPy's
    broadcast of ``tcov - outer + emv``, as in the JAX package).  A
    :class:`~ssmtoybox_torch.mtran.MomentTransform`, not a
    :class:`BQTransform`.

    The model variance takes the construction-time kernel scales ``scale``
    (E,) also under ``kern_par``, as the JAX package does.
    """

    def _init(self, model, points, wm, Wc, Wcc, Q, iK, scale, dim_out, device):
        device = resolve_device(device)
        self.model = model
        self.points, self.wm, self.Wc, self.Wcc, self.Q, self.iK, self.scale = (
            f64(a, device) for a in (points, wm, Wc, Wcc, Q, iK, scale))
        self.dim_out = int(dim_out)

    def _from_model(self, model, dim_out, device):
        w = model.bq_weights()
        self._init(model, model.points, w.wm, w.Wc, w.Wcc, w.Q, w.iK, model.kernel.scale,
                   dim_out, device)

    @property
    def device(self) -> torch.device:
        return self.points.device

    def weights(self, par):
        """``(wm, Wc, Wcc)`` derived from kernel parameters ``par``."""
        w = _model_of(self).bq_weights(par)
        return w.wm, w.Wc, w.Wcc

    def with_kern_par(self, kern_par) -> "MultiOutputBQTransform":
        """A copy that applies with the weights of ``kern_par``, derived once
        (``self`` for None)."""
        if kern_par is None:
            return self
        w = _model_of(self).bq_weights(kern_par)
        tf = copy.copy(self)
        tf.wm, tf.Wc, tf.Wcc, tf.Q, tf.iK = w.wm, w.Wc, w.Wcc, w.Q, w.iK
        return tf

    def apply(self, f, mean, cov, time, kern_par=None):
        if kern_par is not None:
            return self.with_kern_par(kern_par).apply(f, mean, cov, time)
        L = chol_small(cov)
        fx = apply_f_columns(f, mean[..., None] + L @ self.points, time)     # (M, E, N)
        mean_f = torch.einsum("...en,ne->...e", fx, self.wm)
        cov_q = torch.einsum("...ei,ijed,...dj->...ed", fx, self.Wc, fx)
        cov_f = (cov_q - mean_f[..., :, None] * mean_f[..., None, :]
                 + self._emv(fx)[..., None, :])
        # "jd": against the factor's TRANSPOSE, like the single-output path
        cov_fx = torch.einsum("...en,dne,...jd->...ej", fx, self.Wcc, L)
        return mean_f, cov_f, cov_fx

    def _emv(self, fx):  # pragma: no cover - interface
        raise NotImplementedError


class MultiOutputGaussianProcessTransform(MultiOutputBQTransform):
    """MO-GPQ transform: weights from a :class:`GaussianProcessMO`."""

    def __init__(self, dim_in: int, dim_out: int, kern_par, kern_str: str = "rbf",
                 point_str: str = "ut", point_par=None, device=None):
        self._from_model(GaussianProcessMO(dim_in, dim_out, kern_par, kern_str, point_str,
                                           point_par, device=device), dim_out, device)

    @classmethod
    def from_weights(cls, points, wm, Wc, Wcc, Q, iK, scale, device=None):
        """The transform from precomputed weights, without a model."""
        tf = cls.__new__(cls)
        tf._init(None, points, wm, Wc, Wcc, Q, iK, scale, np.shape(wm)[-1], device)
        return tf

    def _emv(self, fx):
        return mo_gp_emv(self.scale, self.Q, self.iK)


class MultiOutputStudentTProcessTransform(MultiOutputBQTransform):
    """MO-TPQ transform: weights from a :class:`StudentTProcessMO`;
    ``mc_opts`` reach an ``rbf-student`` kernel as in
    :class:`StudentTProcessTransform` (the point-set ``dof`` shapes the
    points only)."""

    def __init__(self, dim_in: int, dim_out: int, kern_par, kern_str: str = "rbf",
                 point_str: str = "ut", point_par=None, nu: float = 3.0, mc_opts=None,
                 device=None):
        model = StudentTProcessMO(dim_in, dim_out, kern_par, kern_str, point_str, point_par,
                                  nu=nu, device=device, **dict(mc_opts or {}))
        self._from_model(model, dim_out, device)
        self.nu, self.num_pts = model.nu, model.num_pts

    @classmethod
    def from_weights(cls, points, wm, Wc, Wcc, Q, iK, scale, nu: float, device=None):
        """The transform from precomputed weights, without a model."""
        tf = cls.__new__(cls)
        tf._init(None, points, wm, Wc, Wcc, Q, iK, scale, np.shape(wm)[-1], device)
        tf.nu, tf.num_pts = float(nu), tf.points.shape[-1]
        return tf

    def _emv(self, fx):
        return mo_tp_emv(self.scale, self.nu, self.num_pts, self.Q, self.iK, fx)
