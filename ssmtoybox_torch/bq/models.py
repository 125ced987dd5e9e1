"""BQ integrand models (counterpart of :mod:`ssmtoybox_tpu.bq.models`:
the Gaussian-process, Bayes-Sard and Student-t-process models).

A model ties a kernel to a unit point set and produces the Bayesian-quadrature
weights ``wm = q K^-1``, ``Wc = K^-1 Q K^-1``, ``Wcc = R K^-1`` plus the
expected model variance and the integral variance.  Monte-Carlo kernels
(:class:`~ssmtoybox_torch.bq.kernels.RBFStudent`) accumulate the weights in
weight space instead (``projected_weight_stats``).
"""
from __future__ import annotations

from dataclasses import dataclass
from math import factorial

import numpy as np
import torch

from ..points import get_points
from ..utils.arrays import f64, resolve_device
from ..utils.combin import total_degree_multi_index, vandermonde
from ..utils.linalg import gen_solve, pd_solve, symmetrize
from .kernels import get_kernel

__all__ = ["BQWeights", "GaussianProcessModel", "BayesSardModel", "StudentTProcessModel",
           "tp_scale"]


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
        device = resolve_device(device)
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


# ---------------------------------------------------------------------------
# Bayes-Sard model
# ---------------------------------------------------------------------------

def _dfact(n: int) -> int:
    """Double factorial with the ``(-1)!! = 0!! = 1`` convention (SciPy >= 1.11
    returns 0 for negative arguments, which breaks ``E[x^0] = (-1)!! = 1``)."""
    out = 1
    while n > 1:
        out *= n
        n -= 2
    return out


def _exp_x_px(multi_ind: np.ndarray) -> np.ndarray:
    """``E[p(x)]_q = prod_d (alpha_d^q - 1)!!`` if every exponent is even, else
    0, under ``N(0, I)``; host-side NumPy, the multi-index is static."""
    dim, num_basis = multi_ind.shape
    out = np.zeros(num_basis)
    for qi in range(num_basis):
        if np.all(multi_ind[:, qi] % 2 == 0):
            out[qi] = np.prod([float(_dfact(int(multi_ind[d, qi]) - 1)) for d in range(dim)])
    return out


def _exp_x_xpx(multi_ind: np.ndarray) -> np.ndarray:
    """``E[x p(x)^T]_{eq}``, (D, Q).  ``E[x_d^(alpha_d + 1)] = alpha_d!!`` for
    odd ``alpha_d``: the JAX package's fix of the reference, which uses plain
    ``alpha_d`` (wrong from degree 5 on)."""
    dim, num_basis = multi_ind.shape
    out = np.zeros((dim, num_basis))
    d_ind = np.arange(dim)
    for d in range(dim):
        for qi in range(num_basis):
            alpha_min_d = multi_ind[d_ind != d, qi]
            if (multi_ind[d, qi] + 1) % 2 == 0 and np.all(alpha_min_d % 2 == 0):
                amd = np.prod([float(_dfact(int(a) - 1)) for a in alpha_min_d])
                out[d, qi] = float(_dfact(int(multi_ind[d, qi]))) * amd
    return out


def _exp_x_pxpx(multi_ind: np.ndarray) -> np.ndarray:
    """``E[p(x) p(x)^T]_{rq}``, (Q, Q)."""
    dim, num_basis = multi_ind.shape
    out = np.zeros((num_basis, num_basis))
    for r in range(num_basis):
        for qi in range(num_basis):
            if np.all((multi_ind[:, r] + multi_ind[:, qi]) % 2 == 0):
                out[r, qi] = np.prod([float(_dfact(int(multi_ind[d, r] + multi_ind[d, qi]) - 1))
                                      for d in range(dim)])
    return out


def _exp_x_kxpx(ell: torch.Tensor, multi_ind: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """``E[k(x) p(x)^T]_{nq}``, (N, Q): the closed form for the unscaled RBF
    kernel with length-scales ``ell`` (D,) times monomials, at points ``x``
    (D, N)."""
    dim, num_basis = multi_ind.shape
    cols = []
    for qi in range(num_basis):
        term = None
        for d in range(dim):
            alpha = int(multi_ind[d, qi])
            ld, xd = ell[d], x[d]
            a = (ld * (1.0 + ld ** 2) ** (-(1 + alpha) / 2.0)
                 * torch.exp(-xd ** 2 / (2.0 * (1.0 + ld ** 2))))
            b = 0.0
            for m in range(alpha // 2 + 1):
                part_1 = float(factorial(alpha)) / (
                    (2 ** m) * float(factorial(m)) * float(factorial(alpha - 2 * m)))
                part_2 = ld ** (2 * m) * (xd / torch.sqrt(1.0 + ld ** 2)) ** (alpha - 2 * m)
                b = b + part_1 * part_2
            ab = a * b
            term = ab if term is None else term * ab
        cols.append(term)
    return torch.stack(cols, dim=1)


def _multi_index(multi_ind, dim: int) -> np.ndarray:
    """An int total degree or a (D, Q) array, as a (D, Q) int64 array."""
    if isinstance(multi_ind, (int, np.integer)):
        return total_degree_multi_index(dim, int(multi_ind))
    return np.atleast_2d(np.asarray(multi_ind, dtype=np.int64))


class BayesSardModel(GaussianProcessModel):
    """GP with a multivariate-polynomial prior mean (the Bayes-Sard model),
    RBF kernel.  ``multi_ind`` is a (D, Q) multi-index of the basis
    monomials, or an int total degree (:func:`total_degree_multi_index`).

    With as many basis functions as points (pi-unisolvent points) the
    weights come through the inverse Vandermonde matrix and reproduce the
    classical UT/GH weights; with fewer, through the general formulas.  The
    Vandermonde matrices come from :func:`~ssmtoybox_torch.utils.combin.vandermonde`,
    which launches the CUDA kernel for points on the card.

    ``compat_kxpx_ell_squared=True`` (default) keeps the reference's
    substitution of the SQUARED length-scale into ``E[k(x) p(x)^T]``, as the
    JAX package does; it moves the expected model variance only, and is
    invisible at ``l = 1``.  ``False`` gives the correct expectation.
    """

    def __init__(self, dim: int, kern_par, multi_ind=2, point_str: str = "ut",
                 point_par=None, compat_kxpx_ell_squared: bool = True, device=None):
        super().__init__(dim, kern_par, "rbf", point_str, point_par, device=device)
        self.mulind = _multi_index(multi_ind, dim)
        self.compat_kxpx_ell_squared = bool(compat_kxpx_ell_squared)

    def _mi(self, multi_ind) -> np.ndarray:
        return self.mulind if multi_ind is None else _multi_index(multi_ind, self.dim_in)

    def _ell(self, par) -> torch.Tensor:
        ell = par.reshape(-1)[1:]
        return ell ** 2 if self.compat_kxpx_ell_squared else ell

    def _eye(self, n: int) -> torch.Tensor:
        return torch.eye(n, dtype=torch.float64, device=self.points.device)

    def _const(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float64, device=self.points.device)

    def bq_weights(self, par=None, multi_ind=None) -> BQWeights:
        """BSQ weights, unisolvent and general branches.  ``V^T K^-1 V`` gets
        ``1e-8 I`` here (and not in :meth:`exp_model_variance` or
        :meth:`integral_variance`), as in the JAX package."""
        par = self.kernel.get_parameters(par)
        x = self.points
        mi = self._mi(multi_ind)
        num_basis = mi.shape[1]
        if mi.shape[0] != self.dim_in:
            raise ValueError(f"Dimension mismatch {mi.shape[0]} != {self.dim_in}: monomial "
                             "dim must equal point dim.")
        if num_basis > self.num_pts:
            raise ValueError(f"Number of basis functions ({num_basis}) must be <= number of "
                             f"points ({self.num_pts}).")
        iK = self.kernel.eval_inv_dot(par, x, scaling=False)
        V = vandermonde(mi, x)
        eye_b = self._eye(num_basis)
        iViKV = pd_solve(V.T @ iK @ V + 1e-8 * eye_b, eye_b)
        px, xpx, pxpx = (self._const(f(mi)) for f in (_exp_x_px, _exp_x_xpx, _exp_x_pxpx))
        kxpx = _exp_x_kxpx(self._ell(par), mi, x)
        q = self.kernel.exp_x_kx(par, x)
        kxy = self.kernel.exp_xy_kxy(par)
        kscale2 = par.reshape(-1)[0] ** 2
        Q = self.kernel.exp_x_kxkx(par, par, x)
        if num_basis == self.num_pts:
            iV = gen_solve(V, eye_b)
            w_m = iV.T @ px
            w_c = iV.T @ pxpx @ iV
            w_cc = xpx @ iV
            model_var = kscale2 * (1.0 - torch.trace(kxpx.T @ iV.T + kxpx @ iV
                                                     - pxpx @ iViKV))
            integral_var = kxy - q @ iV.T @ px - px @ iV @ q + px @ iViKV @ px
        else:
            R = self.kernel.exp_x_xkx(par, x)
            Z = V.T @ iK
            A = V @ iViKV
            b = Z @ q - px
            B = Z @ Q @ Z.T + pxpx - Z @ kxpx - kxpx.T @ Z.T
            D = R @ Z.T - xpx
            w_m = iK @ (q - A @ b)
            w_c = iK @ (Q - A @ B @ A.T) @ iK
            w_cc = (R - D @ A.T) @ iK
            model_var = kscale2 * (1.0 - torch.trace(Q @ iK) + torch.trace(B @ iViKV))
            integral_var = kxy - q @ iK @ q + b @ iViKV @ b
        return BQWeights(wm=w_m, Wc=symmetrize(w_c), Wcc=w_cc, model_var=model_var,
                         integral_var=integral_var, q=q, Q=Q, iK=iK)

    def predict(self, test_data, fcn_obs, x_obs=None, par=None, mulind=None):
        """BSQ-GP predictive mean and variance at ``test_data`` (D, M) given
        ``fcn_obs`` at ``x_obs`` (D, N, default the points); scaled Gram."""
        x_obs = self.points if x_obs is None else f64(x_obs, self.points.device).contiguous()
        test_data = f64(test_data, self.points.device).contiguous()
        mi = self._mi(mulind)
        par = self.kernel.get_parameters(par)
        iK = self.kernel.eval_inv_dot(par, x_obs)
        kx = self.kernel.eval(par, test_data, x_obs)
        kxx = self.kernel.eval(par, test_data, test_data, diag=True)
        V = vandermonde(mi, x_obs)
        Z = V.T @ iK
        iViKV = pd_solve(Z @ V, self._eye(mi.shape[1]))
        A = iViKV @ V.T
        b = Z @ kx.T - vandermonde(mi, test_data).T
        fo = torch.atleast_2d(f64(fcn_obs, self.points.device)).mT
        mean = torch.squeeze((kx - b.T @ A) @ iK @ fo.reshape(x_obs.shape[1], -1))
        var = torch.squeeze(kxx - torch.einsum("im,mn,in->i", kx, iK, kx)
                            + torch.einsum("mi,mn,ni->i", b, iViKV, b))
        return mean, var

    def exp_model_variance(self, par=None, mulind=None) -> torch.Tensor:
        """Expected model variance with the unscaled Gram and no jitter on
        ``V^T K^-1 V``."""
        par = self.kernel.get_parameters(par)
        mi = self._mi(mulind)
        x = self.points
        pxpx = self._const(_exp_x_pxpx(mi))
        kxpx = _exp_x_kxpx(self._ell(par), mi, x)
        kxkx = self.kernel.exp_x_kxkx(par, par, x)
        iK = self.kernel.eval_inv_dot(par, x, scaling=False)
        V = vandermonde(mi, x)
        iViKV = pd_solve(V.T @ iK @ V, self._eye(mi.shape[1]))
        Z = V.T @ iK
        B = Z @ kxkx @ Z.T + pxpx - Z @ kxpx - kxpx.T @ Z.T
        return par.reshape(-1)[0] ** 2 * (1.0 - torch.trace(kxkx @ iK) + torch.trace(B @ iViKV))

    def integral_variance(self, par=None, mulind=None) -> torch.Tensor:
        """Integral variance with the unscaled Gram and no jitter on
        ``V^T K^-1 V``."""
        par = self.kernel.get_parameters(par)
        mi = self._mi(mulind)
        x = self.points
        q = self.kernel.exp_x_kx(par, x)
        iK = self.kernel.eval_inv_dot(par, x, scaling=False)
        V = vandermonde(mi, x)
        b = V.T @ iK @ q - self._const(_exp_x_px(mi))
        iViKV = pd_solve(V.T @ iK @ V, self._eye(mi.shape[1]))
        return self.kernel.exp_xy_kxy(par) - q @ iK @ q + b @ iViKV @ b

    def _mc_batches(self, gen: torch.Generator, num_iter: int, batch_size: int):
        """``num_iter`` batches of ``batch_size`` standard-normal samples, each
        (D, batch_size), drawn from ``gen`` on the points' device."""
        for _ in range(num_iter):
            yield torch.randn((self.dim_in, batch_size), generator=gen, dtype=torch.float64,
                              device=self.points.device)

    def mc_exp_x_kxpx(self, gen: torch.Generator, par=None, mulind=None, num_iter: int = 10,
                      batch_size: int = 100_000) -> torch.Tensor:
        """Monte-Carlo estimate of ``E[k(x) p(x)^T]`` (unscaled kernel), (N, Q),
        from ``num_iter * batch_size`` samples of ``gen``: the verifier of
        :func:`_exp_x_kxpx`."""
        par = self.kernel.get_parameters(par)
        mi = self._mi(mulind)
        x = self.points
        acc = x.new_zeros((x.shape[1], mi.shape[1]))
        for xs in self._mc_batches(gen, num_iter, batch_size):
            acc = acc + self.kernel.eval(par, xs, x, scaling=False).T @ vandermonde(mi, xs)
        return acc / (num_iter * batch_size)

    def mc_exp_x_cov(self, gen: torch.Generator, par=None, mulind=None, num_iter: int = 10,
                     batch_size: int = 100_000) -> torch.Tensor:
        """Monte-Carlo estimate of the BSQ weight-error covariance
        ``E[b b^T]``, ``b = V^T K^-1 k(x) - p(x)`` (scaled kernel), (Q, Q)."""
        par = self.kernel.get_parameters(par)
        mi = self._mi(mulind)
        x = self.points
        ViK = vandermonde(mi, x).T @ self.kernel.eval_inv_dot(par, x)
        acc = x.new_zeros((mi.shape[1], mi.shape[1]))
        for xs in self._mc_batches(gen, num_iter, batch_size):
            b = self.kernel.eval(par, xs, x) @ ViK.T - vandermonde(mi, xs)
            acc = acc + b.T @ b
        return acc / (num_iter * batch_size)

    def neg_log_marginal_likelihood(self, log_par, fcn_obs, x_obs, jitter):
        raise NotImplementedError("BSQ NLML unimplemented, as in the JAX package and the "
                                  "reference")


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
