"""Classical moment transforms (counterpart of :mod:`ssmtoybox_tpu.mtran`):
linearization, Monte Carlo, sigma-point rules, their truncated forms and the
single-point GPQ+D ("Taylor") transform.

A transform maps ``(f, mean, cov, time) -> (mean_f, cov_f, cov_fx)`` for a
nonlinear ``f``.  Where the JAX package transforms one mean and ``vmap``s the
call, here every transform takes the batch written out: ``mean`` (M, D) and
``cov`` (M, D, D) give ``mean_f`` (M, E), ``cov_f`` (M, E, E) and the
input-output cross-covariance ``cov_fx`` (M, E, D).

Callable convention: ``f(x, time)`` takes states ``x`` of shape (..., D) and
returns (..., E), broadcasting over the leading dimensions.  The transforms
that linearize take the Jacobian of the ``f`` they are given
(:func:`~ssmtoybox_torch.utils.autodiff.jacobian`), not a model's
``*_fcn_dx``: the filters pass closures that split ``[x, q]``.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from . import points as pts
from .utils.arrays import f64, resolve_device
from .utils.autodiff import jacobian_in_time
from .utils.linalg import chol_small, pd_logdet, pd_solve

__all__ = [
    "MomentTransform",
    "LinearizationTransform",
    "MonteCarloTransform",
    "SigmaPointTransform",
    "SphericalRadialTransform",
    "UnscentedTransform",
    "GaussHermiteTransform",
    "FullySymmetricStudentTransform",
    "TruncatedSigmaPointTransform",
    "TruncatedSphericalRadialTransform",
    "TruncatedUnscentedTransform",
    "TruncatedGaussHermiteTransform",
    "TaylorGPQDTransform",
    "apply_f_columns",
]


def apply_f_columns(f: Callable, x: torch.Tensor, time) -> torch.Tensor:
    """Evaluate ``f`` on every column of ``x`` (..., D, N); returns (..., E, N)."""
    return f(x.mT, time).mT


class MomentTransform:
    """Interface marker: ``apply(f, mean, cov, time) -> (mean_f, cov_f, cov_fx)``."""

    def apply(self, f, mean, cov, time):  # pragma: no cover - interface
        raise NotImplementedError


def _value_and_jacobian(f, mean, time):
    """``f(mean)`` (M, E) and its Jacobian (M, E, D) at each row of ``mean``.
    A tensor ``time`` broadcasts against point sets (M, n, D): its point axis
    is dropped to meet the rows."""
    if isinstance(time, torch.Tensor) and time.ndim >= 2:
        time = time.squeeze(-2)
    return f(mean, time), jacobian_in_time(f, mean, time)


class LinearizationTransform(MomentTransform):
    """First-order Taylor (EKF) transform: ``J P``, ``J P J^T`` with the
    Jacobian ``J`` of ``f`` at the mean."""

    def __init__(self, dim: int, device=None):
        self.dim = int(dim)
        self._device = resolve_device(device)

    @property
    def device(self) -> torch.device:
        return self._device

    def apply(self, f, mean, cov, time):
        mean_f, jac = _value_and_jacobian(f, mean, time)
        cov_fx = jac @ cov
        return mean_f, cov_fx @ jac.mT, cov_fx


class MonteCarloTransform(MomentTransform):
    """Monte-Carlo transform on ``n`` fixed unit points from NumPy's
    ``default_rng(seed)`` (the JAX package's points, bit for bit); mean weight
    ``1/n``, covariance weight ``1/(n-1)``."""

    def __init__(self, unit_sp, wm: float, wc: float, device=None):
        self.unit_sp = f64(unit_sp, resolve_device(device))          # (D, n)
        self.wm, self.wc = float(wm), float(wc)

    @classmethod
    def create(cls, dim: int, n: int = 100, seed: int = 0, device=None) -> "MonteCarloTransform":
        return cls(pts.mc_points(dim, n, seed), *pts.mc_weights(int(n)), device=device)

    @property
    def device(self) -> torch.device:
        return self.unit_sp.device

    def apply(self, f, mean, cov, time):
        dx = chol_small(cov) @ self.unit_sp                    # (M, D, n)
        fx = apply_f_columns(f, mean[..., None] + dx, time)    # (M, E, n)
        mean_f = self.wm * torch.sum(fx, dim=-1)
        dfx = fx - mean_f[..., None]
        return mean_f, self.wc * (dfx @ dfx.mT), self.wc * (dfx @ dx.mT)


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


class TruncatedSigmaPointTransform(MomentTransform):
    """Sigma-point transform aware of an effective input dimension: mean and
    covariance from the rule ``unit_sp_eff`` on the leading ``dim_eff``
    marginal, the cross-covariance from the full rule ``unit_sp``, centred on
    the truncated mean.  ``Wc`` and ``Wcc`` are the dense (diagonal)
    covariance weights of the two rules.

    Not a :class:`SigmaPointTransform`: the fused filters take every one of
    those as a single rule, and would run the wrong one here.
    """

    def __init__(self, unit_sp_eff, wm, Wc, unit_sp, Wcc, dim_eff: int, device=None):
        device = resolve_device(device)
        self.unit_sp_eff = f64(unit_sp_eff, device)              # (dim_eff, N_eff)
        self.wm = f64(wm, device)
        self.Wc = f64(Wc, device)
        self.unit_sp = f64(unit_sp, device)                      # (D, N)
        self.Wcc = f64(Wcc, device)
        self.dim_eff = int(dim_eff)

    @property
    def device(self) -> torch.device:
        return self.wm.device

    def apply(self, f, mean, cov, time):
        if mean.shape[-1] != self.unit_sp.shape[0]:
            # the truncated filters build the measurement rule on
            # obs.dim_state, as the JAX package does (whose matmul fails here)
            raise ValueError(f"the truncated rule is of dimension {self.unit_sp.shape[0]}; "
                             f"got an input of dimension {mean.shape[-1]} (non-additive "
                             "measurement noise augments the input past the state)")
        d = self.dim_eff
        x_eff = mean[..., :d, None] + chol_small(cov[..., :d, :d]) @ self.unit_sp_eff
        dx = chol_small(cov) @ self.unit_sp
        fx_eff = apply_f_columns(f, x_eff, time)
        fx = apply_f_columns(f, mean[..., None] + dx, time)
        mean_f = fx_eff @ self.wm
        dfx_eff = fx_eff - mean_f[..., None]
        dfx = fx - mean_f[..., None]
        return mean_f, dfx_eff @ self.Wc @ dfx_eff.mT, dfx @ self.Wcc @ dx.mT


class TruncatedSphericalRadialTransform(TruncatedSigmaPointTransform):
    """Truncated CKF rule: spherical-radial on ``dim_eff`` and on ``dim``."""

    def __init__(self, dim: int, dim_eff: int, device=None):
        w_eff = pts.sr_weights(dim_eff)
        super().__init__(pts.sr_points(dim_eff), w_eff, np.diag(w_eff), pts.sr_points(dim),
                         np.diag(pts.sr_weights(dim)), dim_eff, device=device)


class TruncatedUnscentedTransform(TruncatedSigmaPointTransform):
    """Truncated unscented rule."""

    def __init__(self, dim: int, dim_eff: int, kappa=None, alpha: float = 1.0,
                 beta: float = 2.0, device=None):
        wm, wc = pts.ut_weights(dim_eff, kappa, alpha, beta)
        _, wc_full = pts.ut_weights(dim, kappa, alpha, beta)
        super().__init__(pts.ut_points(dim_eff, kappa, alpha), wm, np.diag(wc),
                         pts.ut_points(dim, kappa, alpha), np.diag(wc_full), dim_eff,
                         device=device)


class TruncatedGaussHermiteTransform(TruncatedSigmaPointTransform):
    """Truncated Gauss-Hermite rule, ``degree`` points a dimension."""

    def __init__(self, dim: int, dim_eff: int, degree: int = 3, device=None):
        w_eff = pts.gh_weights(dim_eff, degree)
        super().__init__(pts.gh_points(dim_eff, degree), w_eff, np.diag(w_eff),
                         pts.gh_points(dim, degree), np.diag(pts.gh_weights(dim, degree)),
                         dim_eff, device=device)


class TaylorGPQDTransform(MomentTransform):
    """GPQ+D with a single point at the mean (the "Bayesian EKF"): RBF kernel
    ``[alpha, ell]`` (one length-scale, or one a dimension), function value
    and Jacobian observed at the mean.  It tends to the linearization
    transform as the length-scales grow.

    Kept from the JAX package: the expected model variance is added to every
    entry of ``cov_f``, not only its diagonal, and the cross-covariance comes
    out as (E, D), the transpose of the NumPy reference's (D, E).
    """

    def __init__(self, dim: int, ker_par, device=None):
        ker_par = torch.atleast_2d(f64(ker_par, resolve_device(device)))
        self.dim = int(dim)
        self.alpha = ker_par[0, 0]
        self.ell = ker_par[0, 1:] * torch.ones(self.dim, dtype=torch.float64,
                                               device=ker_par.device)

    @property
    def device(self) -> torch.device:
        return self.ell.device

    def apply(self, f, mean, cov, time):
        lam, ilam = self.ell ** 2, self.ell ** -2
        # det(Lam^-1 cov + I) = det(cov + Lam) / prod(lam)
        wm = torch.exp(-0.5 * (pd_logdet(cov + torch.diag(lam)) - torch.sum(torch.log(lam))))
        fm, jac = _value_and_jacobian(f, mean, time)
        mean_f = wm[..., None] * fm
        half = torch.diag(0.5 * lam)
        wc = torch.exp(-0.5 * (pd_logdet(cov + half) - torch.sum(torch.log(0.5 * lam))))
        Wc = 0.5 * lam[:, None] * pd_solve(half + cov, cov)
        a2 = self.alpha ** 2
        model_var = a2 - a2 * wc * (1.0 + torch.diagonal(Wc * ilam, dim1=-2, dim2=-1).sum(-1))
        outer = lambda v: v[..., :, None] * v[..., None, :]  # noqa: E731
        cov_f = (wc[..., None, None] * (outer(fm) + jac @ Wc @ jac.mT) - outer(mean_f)
                 + model_var[..., None, None])
        cov_fx = (lam[:, None] * pd_solve(torch.diag(lam) + cov, cov) @ jac.mT).mT
        return mean_f, cov_f, cov_fx
