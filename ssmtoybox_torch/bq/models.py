"""BQ integrand models (counterpart of :mod:`ssmtoybox_tpu.bq.models`,
Gaussian-process model only).

A model ties a kernel to a unit point set and produces the Bayesian-quadrature
weights ``wm = q K^-1``, ``Wc = K^-1 Q K^-1``, ``Wcc = R K^-1`` plus the
expected model variance and the integral variance.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..points import get_points
from ..utils.arrays import f64
from ..utils.linalg import symmetrize
from .kernels import get_kernel

__all__ = ["BQWeights", "GaussianProcessModel"]


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
                 point_par=None, device=None):
        self.kernel = get_kernel(dim, kern_str, kern_par, device=device)
        self.points = f64(get_points(dim, point_str, point_par), device)
        self.dim_in = dim
        self.num_pts = self.points.shape[1]
        self.str_pts = point_str

    def bq_weights(self, par=None) -> BQWeights:
        """The BQ weight formulas, with the kernel's ``scaling=False`` Gram."""
        par = self.kernel.get_parameters(par)
        x = self.points
        iK = self.kernel.eval_inv_dot(par, x, scaling=False)
        q, R, Q = self.kernel.exp_x_qRQ(par, x)
        model_var = self.kernel.exp_x_kxx(par) * (1.0 - torch.trace(Q @ iK))
        integral_var = self.kernel.exp_xy_kxy(par) - q @ iK @ q
        return BQWeights(wm=q @ iK, Wc=symmetrize(iK @ Q @ iK), Wcc=R @ iK,
                         model_var=model_var, integral_var=integral_var,
                         q=q, Q=Q, iK=iK)

    def exp_model_variance(self, par=None) -> torch.Tensor:
        """``s^2 (1 - tr(Q K^-1))``; the Gram here is scaled, as in the JAX
        package and the reference."""
        par = self.kernel.get_parameters(par)
        iK = self.kernel.eval_inv_dot(par, self.points)
        _, _, Q = self.kernel.exp_x_qRQ(par, self.points)
        return self.kernel.exp_x_kxx(par) * (1.0 - torch.trace(Q @ iK))
