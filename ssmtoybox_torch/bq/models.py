"""BQ integrand models (counterpart of :mod:`ssmtoybox_tpu.bq.models`:
the Gaussian-process and Student-t-process models).

A model ties a kernel to a unit point set and produces the Bayesian-quadrature
weights ``wm = q K^-1``, ``Wc = K^-1 Q K^-1``, ``Wcc = R K^-1`` plus the
expected model variance and the integral variance.  Monte-Carlo kernels
(:class:`~ssmtoybox_torch.bq.kernels.RBFStudent`) accumulate the weights in
weight space instead (``projected_weight_stats``).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..points import get_points
from ..utils.arrays import f64
from ..utils.linalg import symmetrize
from .kernels import get_kernel

__all__ = ["BQWeights", "GaussianProcessModel", "StudentTProcessModel", "tp_scale"]


@dataclass(frozen=True)
class BQWeights:
    """Everything ``bq_weights`` produces."""

    wm: torch.Tensor
    Wc: torch.Tensor
    Wcc: torch.Tensor
    model_var: torch.Tensor
    integral_var: torch.Tensor
    q: torch.Tensor
    Q: torch.Tensor
    iK: torch.Tensor


class GaussianProcessModel:
    """GP regression model of the integrand."""

    def __init__(self, dim: int, kern_par, kern_str: str = "rbf", point_str: str = "ut",
                 point_par=None, device=None, **kern_kwargs):
        self.kernel = get_kernel(dim, kern_str, kern_par, device=device, **kern_kwargs)
        self.points = f64(get_points(dim, point_str, point_par), device)
        self.dim_in = dim
        self.num_pts = self.points.shape[1]
        self.str_pts = point_str

    def bq_weights(self, par=None) -> BQWeights:
        """The BQ weight formulas, with the kernel's ``scaling=False`` Gram;
        through ``projected_weight_stats`` where the kernel has it."""
        par = self.kernel.get_parameters(par)
        x = self.points
        iK = self.kernel.eval_inv_dot(par, x, scaling=False)
        if hasattr(self.kernel, "projected_weight_stats"):
            q, wm, Wc, Wcc, tr_QiK, Q = self.kernel.projected_weight_stats(par, x, iK)
            return BQWeights(wm=wm, Wc=symmetrize(Wc), Wcc=Wcc,
                             model_var=self.kernel.exp_x_kxx(par) * (1.0 - tr_QiK),
                             integral_var=self.kernel.exp_xy_kxy(par) - q @ wm,
                             q=q, Q=Q, iK=iK)
        q, R, Q = self.kernel.exp_x_qRQ(par, x)
        model_var = self.kernel.exp_x_kxx(par) * (1.0 - torch.trace(Q @ iK))
        integral_var = self.kernel.exp_xy_kxy(par) - q @ iK @ q
        return BQWeights(wm=q @ iK, Wc=symmetrize(iK @ Q @ iK), Wcc=R @ iK,
                         model_var=model_var, integral_var=integral_var,
                         q=q, Q=Q, iK=iK)

    def exp_model_variance(self, par=None) -> torch.Tensor:
        """``s^2 (1 - tr(Q K^-1))``; the Gram here is scaled, as in the JAX
        package and the reference.  Monte-Carlo kernels accumulate
        ``tr(Q K^-1)`` in projected form."""
        par = self.kernel.get_parameters(par)
        iK = self.kernel.eval_inv_dot(par, self.points)
        if hasattr(self.kernel, "projected_weight_stats"):
            tr_QiK = self.kernel.projected_weight_stats(par, self.points, iK)[4]
            return self.kernel.exp_x_kxx(par) * (1.0 - tr_QiK)
        _, _, Q = self.kernel.exp_x_qRQ(par, self.points)
        return self.kernel.exp_x_kxx(par) * (1.0 - torch.trace(Q @ iK))

    def integral_variance(self, par=None) -> torch.Tensor:
        """``E[k(x, y)] - q^T K^-1 q`` with the unscaled Gram."""
        par = self.kernel.get_parameters(par)
        iK = self.kernel.eval_inv_dot(par, self.points, scaling=False)
        if hasattr(self.kernel, "projected_weight_stats"):
            q, wm = self.kernel.projected_weight_stats(par, self.points, iK)[:2]
            return self.kernel.exp_xy_kxy(par) - q @ wm
        q, _, _ = self.kernel.exp_x_qRQ(par, self.points)
        return self.kernel.exp_xy_kxy(par) - q @ iK @ q


def tp_scale(nu: float, iK: torch.Tensor, fcn_evals: torch.Tensor) -> torch.Tensor:
    """Data-dependent Student-t-process variance scale
    ``(nu - 2 + f iK f^T) / (nu - 2 + N)`` for function values ``fcn_evals``
    (..., E, N); returns (..., E, E)."""
    fe = torch.atleast_2d(fcn_evals)
    return (nu - 2.0 + fe @ iK @ fe.mT) / (nu - 2.0 + iK.shape[-1])


class StudentTProcessModel(GaussianProcessModel):
    """Student-t-process model of the integrand: the GP weights, with the
    model and integral variances rescaled by :func:`tp_scale`; ``nu < 2``
    becomes 3."""

    def __init__(self, dim: int, kern_par, kern_str: str = "rbf", point_str: str = "ut",
                 point_par=None, nu: float = 4.0, device=None, **kern_kwargs):
        super().__init__(dim, kern_par, kern_str, point_str, point_par, device=device,
                         **kern_kwargs)
        self.nu = 3.0 if nu < 2.0 else float(nu)

    def tp_scale(self, iK, fcn_evals) -> torch.Tensor:
        return tp_scale(self.nu, iK, fcn_evals)

    def exp_model_variance(self, par=None, fcn_obs=None, iK=None, gp_emv=None):
        """TP expected model variance; ``iK`` (unscaled Gram) and ``gp_emv``
        may be passed precomputed."""
        par = self.kernel.get_parameters(par)
        if iK is None:
            iK = self.kernel.eval_inv_dot(par, self.points, scaling=False)
        if gp_emv is None:
            gp_emv = super().exp_model_variance(par)
        fe = f64(fcn_obs, self.points.device).reshape(-1, self.num_pts)
        scale = self.tp_scale(iK, fe)
        return (scale * gp_emv).squeeze() if fe.shape[0] == 1 else scale * gp_emv

    def integral_variance(self, par=None, fcn_obs=None, iK=None, gp_ivar=None):
        """TP integral variance; ``iK`` and ``gp_ivar`` may be precomputed."""
        par = self.kernel.get_parameters(par)
        if iK is None:
            iK = self.kernel.eval_inv_dot(par, self.points, scaling=False)
        if gp_ivar is None:
            gp_ivar = super().integral_variance(par)
        fo = f64(fcn_obs, self.points.device).reshape(-1)
        return (self.nu - 2.0 + fo @ iK @ fo) / (self.nu - 2.0 + self.num_pts) * gp_ivar
