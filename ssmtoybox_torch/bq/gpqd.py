"""GPQ with derivative observations (GPQ+D; counterpart of
:mod:`ssmtoybox_tpu.bq.gpqd`).

The RBF kernel with its derivative blocks (the joint covariance
``[[Kff, Kfd], [Kfd^T, Kdd]]`` of function values and gradients), its
expectations under ``N(0, I)``, the GP model observing both, and the moment
transform that feeds it the integrand's values and Jacobians.  Derivatives
are observed at the points ``which_der`` (all points by default); columns
are the N function values first, then a block of D gradient entries for each
derivative point.  Jacobians come from :func:`~ssmtoybox_torch.utils.autodiff.jacobian`
of the integrand.

The fused filters do not take a GPQ+D transform: its derivative columns have
no kernel form (:mod:`ssmtoybox_torch.ops`).
"""
from __future__ import annotations

import torch

from ..points import get_points
from ..utils.arrays import f64, resolve_device
from ..utils.autodiff import jacobian_in_time
from ..utils.linalg import pd_solve, symmetrize
from .kernels import RBFGauss, _unpack_rbf
from .models import BQWeights, GaussianProcessModel
from .transforms import BQTransform

__all__ = ["RBFGaussDer", "GaussianProcessDerModel", "GaussianProcessDerTransform"]


def _which(which_der, n: int) -> list:
    return list(range(n)) if which_der is None else [int(i) for i in which_der]


def _blocks(t: torch.Tensor) -> torch.Tensor:
    """(Nd, Nd, D, D) blocks as one (Nd D, Nd D) matrix, block (i, j) at rows
    ``i D..``, columns ``j D..``."""
    nd, _, d, _ = t.shape
    return t.permute(0, 2, 1, 3).reshape(nd * d, nd * d)


class RBFGaussDer(RBFGauss):
    """RBF kernel with derivative blocks; expectations w.r.t. ``N(0, I)``."""

    def eval(self, par, x1, x2=None, diag=False, scaling=True, which_der=None):
        """The joint kernel matrix ``[[Kff, Kfd], [Kfd^T, Kdd]]`` of the
        columns of ``x1`` (D, N).  With ``x2`` given (a prediction) it is
        ``[Kff(x1, x2), Kfd(x1, x2_der)]``, ``which_der`` indexing ``x2``;
        with ``diag`` the plain kernel's diagonal."""
        if diag:
            return super().eval(par, x1, x2, diag=True, scaling=scaling)
        sym = x2 is None
        x2 = x1 if sym else x2
        _, ell = _unpack_rbf(par)
        inv_lam = ell ** -2
        Kff = super().eval(par, x1, x2, scaling=scaling)                 # (N1, N2)
        wd = _which(which_der, x2.shape[1])
        nd, d = len(wd), x1.shape[0]
        # XmX[d, i, j] = (Lam^-1 (x1_i - x2_j))[d]
        XmX = (inv_lam[:, None] * x1)[:, :, None] - (inv_lam[:, None] * x2)[:, None, :]
        # Kfd[i, (j, d)] = cov(f(x1_i), df(x2_j)/dx_d)
        Kfd = torch.einsum("ij,dij->ijd", Kff[:, wd], XmX[:, :, wd]).reshape(-1, nd * d)
        if not sym:
            return torch.cat([Kff, Kfd], dim=1)
        Xd = XmX[:, wd][:, :, wd]                                        # (D, Nd, Nd)
        outer = torch.einsum("aij,bij->ijab", Xd, Xd)                    # (Nd, Nd, D, D)
        Kdd = _blocks(Kff[wd][:, wd][:, :, None, None] * (torch.diag(inv_lam) - outer))
        return torch.cat([torch.cat([Kff, Kfd], dim=1), torch.cat([Kfd.T, Kdd], dim=1)])

    def _jittered(self, par, x, scaling, which_der):
        K = self.eval(par, x, scaling=scaling, which_der=which_der)
        return K + self.jitter * torch.eye(K.shape[0], dtype=K.dtype, device=K.device)

    def eval_inv_dot(self, par, x, b=None, scaling=True, which_der=None):
        """``(K + jitter I)^-1 b`` of the joint matrix, symmetrized when ``b``
        is the identity."""
        A = self._jittered(par, x, scaling, which_der)
        if b is None:
            return symmetrize(pd_solve(A, torch.eye(A.shape[0], dtype=A.dtype, device=A.device)))
        return pd_solve(A, b)

    def eval_chol(self, par, x, scaling=True, which_der=None):
        """Lower Cholesky factor of the jittered joint matrix."""
        return torch.linalg.cholesky(self._jittered(par, x, scaling, which_der))

    # -- derivative expectations --------------------------------------------
    def _der_quants(self, par, x):
        _, ell = _unpack_rbf(par)
        inv_lam = ell ** -2                       # diag Lam^-1
        sig_q = 1.0 / (inv_lam + 1.0)             # diag (Lam^-1 + I)^-1
        eta = sig_q[:, None] * x                  # (D, N)
        mu_q = inv_lam[:, None] * eta             # (D, N)
        return inv_lam, sig_q, eta, mu_q

    def _r(self, par, x, scaling, wd):
        inv_lam, _, _, mu_q = self._der_quants(par, x)
        q = self.exp_x_kx(par, x, scaling)
        return q, q[None, wd] * inv_lam[:, None] * (mu_q[:, wd] - x[:, wd])

    def exp_x_dkx(self, par, x, scaling=False, which_der=None):
        """``E_x[k_fd(x, x_n)]``, (Nd D,)."""
        return self._r(par, x, scaling, _which(which_der, x.shape[1]))[1].T.reshape(-1)

    def exp_x_xdkx(self, par, x, scaling=False, which_der=None):
        """``E_x[x k_fd(x, x_m)]``, (D, Nd D)."""
        d = x.shape[0]
        wd = _which(which_der, x.shape[1])
        inv_lam, sig_q, _, mu_q = self._der_quants(par, x)
        q, r = self._r(par, x, scaling, wd)
        # block i: q_i Lam^-1 Sig + mu_q[:, i] r[:, i]^T
        blocks = (q[wd][:, None, None] * torch.diag(inv_lam * sig_q)
                  + torch.einsum("di,ei->ide", mu_q[:, wd], r))         # (Nd, D, D)
        return blocks.movedim(0, 1).reshape(d, -1)

    def _pair_quants(self, par, x, scaling):
        inv_lam, sig_q, eta, _ = self._der_quants(par, x)
        _, ell = _unpack_rbf(par)
        lam = ell ** 2
        inn = inv_lam[:, None] * x                                       # (D, N)
        Q = self.exp_x_kxkx(par, par, x, scaling)                        # (N, N)
        eta_tilde = inv_lam[:, None] * (eta / (lam + sig_q)[:, None])    # (D, N)
        return inv_lam, sig_q, lam, inn, Q, eta_tilde

    def exp_x_kxdkx(self, par, x, scaling=False, which_der=None):
        """``E_x[k_ff(x_n, x) k_fd(x, x_m)]``, (N, Nd D)."""
        d, n = x.shape
        wd = _which(which_der, n)
        _, _, _, inn, Q, eta_tilde = self._pair_quants(par, x, scaling)
        mu_Q = eta_tilde[:, wd, None] + eta_tilde[:, None, :]           # (D, Nd, N)
        body = Q[wd, :][None] * (mu_Q - inn[:, wd, None])                # (D, Nd, N)
        return body.movedim(0, 1).reshape(len(wd) * d, n).T

    def exp_x_dkxdkx(self, par, x, scaling=False, which_der=None):
        """``E_x[k_df(x_n, x) k_fd(x, x_m)]``, (Nd D, Nd D)."""
        wd = _which(which_der, x.shape[1])
        inv_lam, sig_q, lam, inn, Q, eta_tilde = self._pair_quants(par, x, scaling)
        sig_Q = torch.diag(sig_q / (lam + sig_q) * inv_lam)              # (D, D)
        mu_Q = eta_tilde[:, wd, None] + eta_tilde[:, None, wd]          # (D, Nd, Nd)
        di = inn[:, wd, None] - mu_Q
        dj = inn[:, None, wd] - mu_Q
        T = torch.einsum("aij,bij->ijab", di, dj) + sig_Q                # (Nd, Nd, D, D)
        return _blocks(Q[wd][:, wd][:, :, None, None] * T)


class GaussianProcessDerModel(GaussianProcessModel):
    """GP model of the integrand observing function values at every point
    and gradients at the points ``which_der`` (all by default)."""

    def __init__(self, dim: int, kern_par, point_str: str = "ut", point_par=None,
                 which_der=None, device=None):
        device = resolve_device(device)
        self.kernel = RBFGaussDer(dim, kern_par, device=device)
        self.points = f64(get_points(dim, point_str, point_par), device)
        self.dim_in = dim
        self.num_pts = self.points.shape[1]
        self.str_pts = point_str
        self.which_der = tuple(_which(which_der, self.num_pts))

    def predict(self, test_data, fcn_obs, x_obs=None, par=None):
        """Predictive mean and variance at the columns of ``test_data`` from
        the joint observations ``fcn_obs``: the N function values, then the
        Nd D Jacobian entries, in the transform's column layout."""
        x_obs = self.points if x_obs is None else f64(x_obs, self.points.device)
        par = self.kernel.get_parameters(par)
        test_data = f64(test_data, self.points.device)
        iK = self.kernel.eval_inv_dot(par, x_obs, which_der=self.which_der)
        kx = self.kernel.eval(par, test_data, x_obs, which_der=self.which_der)
        kxx = self.kernel.eval(par, test_data, test_data, diag=True)
        y = f64(fcn_obs, self.points.device).reshape(-1)
        if y.shape[0] != kx.shape[1]:
            raise ValueError(
                f"joint observations must stack {x_obs.shape[1]} function values and "
                f"{len(self.which_der) * x_obs.shape[0]} Jacobian entries; got {y.shape[0]}")
        return kx @ iK @ y, kxx - torch.einsum("im,mn,in->i", kx, iK, kx)

    def bq_weights(self, par=None, with_integral_var: bool = True) -> BQWeights:
        """The joint function-and-derivative BQ weights;
        ``with_integral_var=False`` skips the integral variance."""
        par = self.kernel.get_parameters(par)
        x, wd, k = self.points, self.which_der, self.kernel
        iK = k.eval_inv_dot(par, x, scaling=False, which_der=wd)
        q, R, Q = k.exp_x_qRQ(par, x)
        Qfd = k.exp_x_kxdkx(par, x, which_der=wd)
        q_t = torch.cat([q, k.exp_x_dkx(par, x, which_der=wd)])
        Q_t = torch.cat([torch.cat([Q, Qfd], dim=1),
                         torch.cat([Qfd.T, k.exp_x_dkxdkx(par, x, which_der=wd)], dim=1)])
        R_t = torch.cat([R, k.exp_x_xdkx(par, x, which_der=wd)], dim=1)
        return BQWeights(wm=q_t @ iK, Wc=symmetrize(iK @ Q_t @ iK), Wcc=R_t @ iK,
                         model_var=k.exp_x_kxx(par) * (1.0 - torch.trace(Q_t @ iK)),
                         integral_var=(k.exp_xy_kxy(par) - q_t @ iK @ q_t
                                       if with_integral_var else None),
                         q=q_t, Q=Q_t, iK=iK)

    def exp_model_variance(self, par=None, weights=None) -> torch.Tensor:
        """The joint expected model variance of :meth:`bq_weights` (the GP
        model's own formula would mix the joint Gram with function-only
        expectations)."""
        return (self.bq_weights(par) if weights is None else weights).model_var

    def integral_variance(self, par=None, weights=None) -> torch.Tensor:
        """The joint integral variance of :meth:`bq_weights`."""
        return (self.bq_weights(par) if weights is None else weights).integral_var


class GaussianProcessDerTransform(BQTransform):
    """GPQ+D moment transform: the integrand's values at the N points and its
    Jacobians at the points ``which_der``, weighted by the joint model's
    weights."""

    def __init__(self, dim_in: int, dim_out: int, kern_par, point_str: str = "ut",
                 point_par=None, which_der=None, device=None):
        self.model = GaussianProcessDerModel(dim_in, kern_par, point_str, point_par,
                                             which_der, device=device)
        self.which_der = self.model.which_der
        w = self.model.bq_weights()
        super().__init__(self.model.points, w.wm, w.Wc, w.Wcc, w.model_var, dim_out=dim_out,
                         iK=w.iK, integral_var=w.integral_var, device=device)

    @classmethod
    def from_weights(cls, points, wm, Wc, Wcc, model_var, which_der, dim_out: int = 1,
                     iK=None, integral_var=None, device=None) -> "GaussianProcessDerTransform":
        """The transform from precomputed weights (e.g. the JAX transform's
        arrays) and its derivative points, without a model."""
        tf = cls.__new__(cls)
        BQTransform.__init__(tf, points, wm, Wc, Wcc, model_var, dim_out=dim_out, iK=iK,
                             integral_var=integral_var, device=device)
        tf.model = None
        tf.which_der = tuple(int(i) for i in which_der)
        return tf

    def _fcn_eval(self, f, x, time):
        fx = super()._fcn_eval(f, x, time)                               # (M, E, N)
        xd = x[..., list(self.which_der)].mT                             # (M, Nd, D)
        jac = jacobian_in_time(f, xd, time)                              # (M, Nd, E, D)
        return torch.cat([fx, jac.movedim(-3, -2).flatten(-2)], dim=-1)
