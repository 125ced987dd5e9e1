"""BQ kernels and their Gaussian expectations (counterpart of
:mod:`ssmtoybox_tpu.bq.kernels`, RBF kernel only).

Points ``x`` are (D, N) float64 tensors; ``par`` is the (1, D+1) parameter
row ``[s, l_1..l_D]``.  Expectations are w.r.t. ``N(0, I)`` and closed-form.
"""
from __future__ import annotations

import torch

from ..utils.arrays import f64
from ..utils.linalg import maha, pd_solve, symmetrize

__all__ = ["RBFGauss", "get_kernel"]


def _unpack_rbf(par):
    """``[s, l_1..l_D] -> (s, lengthscales)``."""
    par = par.reshape(-1)
    return par[0], par[1:]


class RBFGauss:
    """RBF kernel ``k(x, x') = s^2 exp(-0.5 (x - x')^T Lam^-1 (x - x'))`` with
    ``Lam = diag(l^2)``."""

    def __init__(self, dim: int, par, jitter: float = 1e-8, device=None):
        self.par = torch.atleast_2d(f64(par, device))
        if self.par.shape[-1] != dim + 1:
            raise ValueError(f"RBF parameters must be [s, l_1..l_{dim}]; got shape "
                             f"{tuple(self.par.shape)}")
        self.dim = dim
        self.jitter = jitter

    def get_parameters(self, par=None) -> torch.Tensor:
        return self.par if par is None else torch.atleast_2d(f64(par, self.par.device))

    def eval(self, par, x1, x2=None, diag=False, scaling=True):
        x2 = x1 if x2 is None else x2
        alpha, ell = _unpack_rbf(par)
        log_a2 = 2.0 * torch.log(alpha) if scaling else 0.0
        s1 = x1 / ell[:, None]
        s2 = x2 / ell[:, None]
        if diag:
            dx = s1 - s2
            return torch.exp(log_a2 - 0.5 * torch.sum(dx * dx, dim=0))
        return torch.exp(log_a2 - 0.5 * maha(s1.T, s2.T))

    def eval_inv_dot(self, par, x, b=None, scaling=True):
        """``(K + jitter I)^-1 b`` via Cholesky, symmetrized when ``b`` is
        the identity."""
        K = self.eval(par, x, scaling=scaling)
        eye = torch.eye(x.shape[-1], dtype=K.dtype, device=K.device)
        A = K + self.jitter * eye
        if b is None:
            return symmetrize(pd_solve(A, eye))
        return pd_solve(A, b)

    def exp_x_kx(self, par, x, scaling=False):
        """Kernel mean map ``E_x[k(x, x_i)]``."""
        alpha, ell = _unpack_rbf(par)
        a2 = alpha ** 2 if scaling else 1.0
        lam = ell ** 2
        c = a2 * torch.prod(1.0 / lam + 1.0) ** -0.5
        xl = x / (lam + 1.0)[:, None]
        return c * torch.exp(-0.5 * torch.sum(x * xl, dim=0))

    def exp_x_xkx(self, par, x):
        """``E_x[x k(x, x_i)]``, (D, N)."""
        _, ell = _unpack_rbf(par)
        mu_q = x / (ell ** 2 + 1.0)[:, None]
        return self.exp_x_kx(par, x)[None, :] * mu_q

    def exp_x_kxkx(self, par_0, par_1, x, scaling=False):
        """Kernel correlation matrix ``E_x[k(x, x_i) k(x, x_j)]``."""
        alpha, ell = _unpack_rbf(par_0)
        alpha_1, ell_1 = _unpack_rbf(par_1)
        log_a2 = 2.0 * torch.log(alpha) if scaling else 0.0
        log_a2_1 = 2.0 * torch.log(alpha_1) if scaling else 0.0
        inv_lam = ell ** -2
        inv_lam_1 = ell_1 ** -2

        xi = x / ell[:, None]
        xi = log_a2 - 0.5 * torch.sum(xi * xi, dim=0)                  # (N,)
        xi_1 = x / ell_1[:, None]
        xi_1 = log_a2_1 - 0.5 * torch.sum(xi_1 * xi_1, dim=0)

        x_0 = inv_lam[:, None] * x
        x_1 = inv_lam_1[:, None] * x
        r = inv_lam + inv_lam_1 + 1.0                                  # diag of R^-1

        n = (xi[:, None] + xi_1[None, :]) + 0.5 * maha(x_0.T, -x_1.T, V=torch.diag(1.0 / r))
        return torch.prod(r) ** -0.5 * torch.exp(n)

    def exp_x_kxx(self, par):
        alpha, _ = _unpack_rbf(par)
        return alpha ** 2

    def exp_xy_kxy(self, par):
        alpha, ell = _unpack_rbf(par)
        return alpha ** 2 * torch.prod(2.0 * ell ** -2 + 1.0) ** -0.5

    def exp_x_qRQ(self, par, x):
        """``(q, R, Q)`` for the BQ weights."""
        return self.exp_x_kx(par, x), self.exp_x_xkx(par, x), self.exp_x_kxkx(par, par, x)


def get_kernel(dim: int, kernel: str, par, **kwargs) -> RBFGauss:
    """String-keyed kernel factory.  Only ``"rbf"`` is ported so far
    (ROADMAP, queue 1, item 14)."""
    if kernel.lower() == "rbf":
        return RBFGauss(dim, par, **kwargs)
    raise ValueError(f"Kernel '{kernel}' not supported. Supported: rbf.")
