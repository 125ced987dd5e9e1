"""BQ integrand models (counterpart of :mod:`ssmtoybox_tpu.bq.models`): the
Gaussian-process, Bayes-Sard, Student-t-process and multi-output models.

A model ties a kernel to a unit point set and produces the Bayesian-quadrature
weights ``wm = q K^-1``, ``Wc = K^-1 Q K^-1``, ``Wcc = R K^-1`` plus the
expected model variance and the integral variance.  Monte-Carlo kernels
(:class:`~ssmtoybox_torch.bq.kernels.RBFStudent`) accumulate the single-output
weights in weight space instead (``projected_weight_stats``).  The negative
log marginal likelihoods are plain tensor functions, so autograd gives their
gradients; :meth:`Model.optimize` drives them with SciPy's BFGS.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from math import factorial

import numpy as np
import torch

from ..points import get_points
from ..utils.arrays import f64, resolve_device
from ..utils.combin import total_degree_multi_index, vandermonde
from ..utils.linalg import chol_small, gen_solve, pd_solve, symmetrize
from .kernels import get_kernel

__all__ = ["BQWeights", "Model", "GaussianProcessModel", "BayesSardModel",
           "StudentTProcessModel", "tp_scale", "MOWeights", "mo_gp_emv", "mo_tp_emv",
           "MultiOutputModel", "GaussianProcessMO", "StudentTProcessMO"]


@dataclass(frozen=True)
class BQWeights:
    """Everything ``bq_weights`` produces; ``integral_var`` is None when it
    was not asked for."""

    wm: torch.Tensor
    Wc: torch.Tensor
    Wcc: torch.Tensor
    model_var: torch.Tensor
    integral_var: torch.Tensor | None
    q: torch.Tensor
    Q: torch.Tensor
    iK: torch.Tensor


def _host(t) -> np.ndarray:
    return np.asarray(t.detach().cpu() if isinstance(t, torch.Tensor) else t)


def _gp_nlml_terms(kernel, log_par, fcn_obs, x_obs, jitter):
    """The Cholesky factor's log-diagonal sum and ``a = K^-1 y`` of the
    jittered Gram at ``exp(log_par)``, for the NLMLs."""
    K = kernel.eval(torch.exp(log_par), x_obs) + jitter
    L = chol_small(K)
    a = torch.cholesky_solve(fcn_obs.reshape(L.shape[-1], -1), L).reshape(fcn_obs.shape)
    return torch.sum(torch.log(torch.diagonal(L))), a


class Model:
    """Integrand model base: a kernel and a unit point set."""

    def __init__(self, dim: int, kern_par, kern_str: str = "rbf", point_str: str = "ut",
                 point_par=None, device=None, **kern_kwargs):
        device = resolve_device(device)
        self.kernel = get_kernel(dim, kern_str, kern_par, device=device, **kern_kwargs)
        self.points = f64(get_points(dim, point_str, point_par), device)
        self.dim_in = dim
        self.num_pts = self.points.shape[1]
        self.str_pts = point_str

    def predict(self, test_data, fcn_obs, x_obs=None, par=None):  # pragma: no cover
        raise NotImplementedError

    def neg_log_marginal_likelihood(self, log_par, fcn_obs, x_obs, jitter):  # pragma: no cover
        raise NotImplementedError

    def plot_model(self, test_data, fcn_obs, par=None, fcn_true=None, in_dim=0):
        """Plot of the model's predictive mean and two standard deviations
        over ``test_data`` with the observations at the points; the figure is
        returned, never shown.  matplotlib is imported here, on first use."""
        import matplotlib
        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt

        fcn_obs = np.squeeze(_host(fcn_obs))
        mean, var = self.predict(test_data, fcn_obs, par=par)
        mean, std = _host(mean), np.sqrt(_host(var))
        xplot = np.squeeze(_host(test_data)[in_dim, :])
        fig, ax = plt.subplots()
        ax.fill_between(xplot, mean - 2 * std, mean + 2 * std, color="0.1", alpha=0.15)
        ax.plot(xplot, mean, color="k", lw=2)
        ax.plot(_host(self.points)[in_dim, :], fcn_obs, "ko", ms=8)
        if fcn_true is not None:
            ax.plot(xplot, np.squeeze(_host(fcn_true)), lw=2, ls="--", color="tomato")
        ax.set_title(f"{type(self).__name__} model of the integrand")
        return fig

    def optimize(self, log_par_0, fcn_obs, x_obs, method="BFGS", **kwargs):
        """Minimize the NLML over the log-parameters: SciPy's ``minimize``
        (BFGS by default) on the value and autograd gradient of
        :meth:`neg_log_marginal_likelihood`, evaluated on the model's device
        with ``1e-8 I`` jitter.  Returns SciPy's ``OptimizeResult``."""
        from scipy.optimize import minimize

        dev = self.points.device
        x_obs = f64(x_obs, dev)
        fcn_obs = f64(fcn_obs, dev)
        jitter = 1e-8 * torch.eye(x_obs.shape[1], dtype=torch.float64, device=dev)

        def obj(lp):
            lp = torch.tensor(lp, dtype=torch.float64, device=dev, requires_grad=True)
            v = self.neg_log_marginal_likelihood(lp, fcn_obs, x_obs, jitter)
            (g,) = torch.autograd.grad(v, lp)
            return float(v.detach()), g.cpu().numpy().astype(float)

        return minimize(obj, np.asarray(log_par_0, dtype=float).reshape(-1), method=method,
                        jac=True, **kwargs)


class GaussianProcessModel(Model):
    """GP regression model of the integrand."""

    def bq_weights(self, par=None, with_integral_var: bool = True) -> BQWeights:
        """The BQ weight formulas, with the kernel's ``scaling=False`` Gram;
        through ``projected_weight_stats`` where the kernel has it.
        ``with_integral_var=False`` skips the integral variance (for an
        ``RBFStudent``, one ``E[k(x, y)]`` sweep)."""
        par = self.kernel.get_parameters(par)
        x = self.points
        iK = self.kernel.eval_inv_dot(par, x, scaling=False)
        if hasattr(self.kernel, "projected_weight_stats"):
            q, wm, Wc, Wcc, tr_QiK, Q = self.kernel.projected_weight_stats(par, x, iK)
            return BQWeights(wm=wm, Wc=symmetrize(Wc), Wcc=Wcc,
                             model_var=self.kernel.exp_x_kxx(par) * (1.0 - tr_QiK),
                             integral_var=(self.kernel.exp_xy_kxy(par) - q @ wm
                                           if with_integral_var else None),
                             q=q, Q=Q, iK=iK)
        q, R, Q = self.kernel.exp_x_qRQ(par, x)
        model_var = self.kernel.exp_x_kxx(par) * (1.0 - torch.trace(Q @ iK))
        integral_var = (self.kernel.exp_xy_kxy(par) - q @ iK @ q
                        if with_integral_var else None)
        # Wc = K^-1 Q K^-1 as wm wm^T + K^-1 (Q - q q^T) K^-1, equal in exact
        # arithmetic: the centred form keeps 1^T Wc 1 - (1^T wm)^2, the
        # variance a filter gives a constant integrand, accurate where the
        # Gram matrix is ill-conditioned (the reentry GPQ rule, length-scale
        # 25 on the UT points, cond(K) = 1.9e6: the direct product gets it
        # wrong by more than its size, negative on the card, and the
        # filter's covariance of a position near 6,400 loses positive
        # definiteness)
        wm = q @ iK
        outer = wm[..., :, None] * wm[..., None, :]
        return BQWeights(wm=wm, Wc=symmetrize(outer + iK @ (Q - q[..., :, None] * q[..., None, :])
                                              @ iK),
                         Wcc=R @ iK, model_var=model_var, integral_var=integral_var,
                         q=q, Q=Q, iK=iK)

    def predict(self, test_data, fcn_obs, x_obs=None, par=None):
        """GP predictive mean and variance at the columns of ``test_data``
        (D, M) given ``fcn_obs`` at ``x_obs`` (D, N, default the points);
        scaled Gram."""
        dev = self.points.device
        x_obs = self.points if x_obs is None else f64(x_obs, dev)
        test_data = f64(test_data, dev)
        par = self.kernel.get_parameters(par)
        iK = self.kernel.eval_inv_dot(par, x_obs)
        kx = self.kernel.eval(par, test_data, x_obs)
        kxx = self.kernel.eval(par, test_data, test_data, diag=True)
        fo = torch.atleast_2d(f64(fcn_obs, dev)).mT
        mean = torch.squeeze(kx @ iK @ fo.reshape(x_obs.shape[1], -1))
        var = torch.squeeze(kxx - torch.einsum("im,mn,in->i", kx, iK, kx))
        return mean, var

    def exp_model_variance(self, par=None, weights: BQWeights | None = None) -> torch.Tensor:
        """``s^2 (1 - tr(Q K^-1))``; the Gram here is scaled, as in the JAX
        package and the reference.  Monte-Carlo kernels accumulate
        ``tr(Q K^-1)`` in projected form.  ``weights`` (a :meth:`bq_weights`
        result) short-cuts the computation to its ``model_var``."""
        if weights is not None:
            return weights.model_var
        par = self.kernel.get_parameters(par)
        iK = self.kernel.eval_inv_dot(par, self.points)
        if hasattr(self.kernel, "projected_weight_stats"):
            tr_QiK = self.kernel.projected_weight_stats(par, self.points, iK)[4]
            return self.kernel.exp_x_kxx(par) * (1.0 - tr_QiK)
        _, _, Q = self.kernel.exp_x_qRQ(par, self.points)
        return self.kernel.exp_x_kxx(par) * (1.0 - torch.trace(Q @ iK))

    def integral_variance(self, par=None, weights: BQWeights | None = None) -> torch.Tensor:
        """``E[k(x, y)] - q^T K^-1 q`` with the unscaled Gram; ``weights``
        short-cuts it to their ``integral_var``."""
        if weights is not None:
            return weights.integral_var
        par = self.kernel.get_parameters(par)
        iK = self.kernel.eval_inv_dot(par, self.points, scaling=False)
        if hasattr(self.kernel, "projected_weight_stats"):
            q, wm = self.kernel.projected_weight_stats(par, self.points, iK)[:2]
            return self.kernel.exp_xy_kxy(par) - q @ wm
        q, _, _ = self.kernel.exp_x_qRQ(par, self.points)
        return self.kernel.exp_xy_kxy(par) - q @ iK @ q

    def neg_log_marginal_likelihood(self, log_par, fcn_obs, x_obs, jitter):
        """The GP NLML summed over the outputs, ``fcn_obs`` (N, E), at
        ``exp(log_par)``, the Gram plus ``jitter`` (a matrix)."""
        num_data, num_out = fcn_obs.shape
        half_logdet, a = _gp_nlml_terms(self.kernel, log_par, fcn_obs, x_obs, jitter)
        y_dot_a = torch.sum(fcn_obs * a)
        return (num_out * half_logdet
                + 0.5 * (y_dot_a + num_out * num_data * math.log(2.0 * math.pi)))


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

    def bq_weights(self, par=None, multi_ind=None, with_integral_var: bool = True) -> BQWeights:
        """BSQ weights, unisolvent and general branches.  ``V^T K^-1 V`` gets
        ``1e-8 I`` here (and not in :meth:`exp_model_variance` or
        :meth:`integral_variance`), as in the JAX package.
        ``with_integral_var=False`` skips the integral variance."""
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
        kxy = self.kernel.exp_xy_kxy(par) if with_integral_var else None
        kscale2 = par.reshape(-1)[0] ** 2
        Q = self.kernel.exp_x_kxkx(par, par, x)
        if num_basis == self.num_pts:
            iV = gen_solve(V, eye_b)
            w_m = iV.T @ px
            w_c = iV.T @ pxpx @ iV
            w_cc = xpx @ iV
            model_var = kscale2 * (1.0 - torch.trace(kxpx.T @ iV.T + kxpx @ iV
                                                     - pxpx @ iViKV))
            integral_var = (kxy - q @ iV.T @ px - px @ iV @ q + px @ iViKV @ px
                            if with_integral_var else None)
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
            integral_var = kxy - q @ iK @ q + b @ iViKV @ b if with_integral_var else None
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


def _gammaln(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.special.gammaln(torch.tensor(v, dtype=torch.float64, device=like.device))


class StudentTProcessModel(GaussianProcessModel):
    """Student-t-process model of the integrand: the GP weights, with the
    model and integral variances rescaled by :func:`tp_scale`; ``nu < 2``
    becomes 3."""

    def __init__(self, dim: int, kern_par, kern_str: str = "rbf", point_str: str = "ut",
                 point_par=None, nu: float = 4.0, device=None, **kern_kwargs):
        super().__init__(dim, kern_par, kern_str, point_str, point_par, device=device,
                         **kern_kwargs)
        self.nu = 3.0 if nu < 2.0 else float(nu)

    def predict(self, test_data, fcn_obs, x_obs=None, par=None, nu=None):
        """The GP prediction, its variance rescaled by
        ``(nu - 2 + f K^-1 f) / (nu - 2 + N)`` (scaled Gram)."""
        nu = self.nu if nu is None else nu
        par = self.kernel.get_parameters(par)
        mean, var = super().predict(test_data, fcn_obs, x_obs, par)
        x_obs = self.points if x_obs is None else f64(x_obs, self.points.device)
        iK = self.kernel.eval_inv_dot(par, x_obs)
        fo = f64(fcn_obs, self.points.device).reshape(-1)
        return mean, (nu - 2.0 + fo @ iK @ fo) / (nu - 2.0 + self.num_pts) * var

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

    def neg_log_marginal_likelihood(self, log_par, fcn_obs, x_obs, jitter):
        """The TP NLML of ``fcn_obs`` (N, E): ``log1p(y K^-1 y / (nu - 2))``
        per output and ``-gammaln((nu + N) / 2) + gammaln(nu / 2)``, as in
        the JAX package (the multi-output model's term differs on purpose)."""
        num_data, num_out = fcn_obs.shape
        nu = self.nu
        half_logdet, a = _gp_nlml_terms(self.kernel, log_par, fcn_obs, x_obs, jitter)
        y_dot_a = torch.sum(fcn_obs * a, dim=0)                          # (E,)
        const = (0.5 * num_data * math.log((nu - 2.0) * math.pi)
                 - _gammaln((nu + num_data) / 2.0, a) + _gammaln(nu / 2.0, a))
        log_sum = 0.5 * (nu + num_data) * torch.sum(torch.log1p(y_dot_a / (nu - 2.0)))
        return log_sum + num_out * (half_logdet + const)


# ---------------------------------------------------------------------------
# Multi-output models (EXPERIMENTAL in the reference)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MOWeights:
    """Multi-output BQ weights: ``wm`` (N, E), ``Wc`` (N, N, E, E), ``Wcc``
    (D, N, E), ``q`` (N, E), ``Q`` (N, N, E, E), ``R`` (D, N, E) and ``iK``
    (N, N, E)."""

    wm: torch.Tensor
    Wc: torch.Tensor
    Wcc: torch.Tensor
    q: torch.Tensor
    Q: torch.Tensor
    R: torch.Tensor
    iK: torch.Tensor


def mo_gp_emv(scale, Q, iK) -> torch.Tensor:
    """Per-output MO-GP expected model variance ``s_e^2 (1 - tr(Q_ee iK_e))``,
    (E,)."""
    return scale ** 2 * (1.0 - torch.einsum("nmee,mne->e", Q, iK))


def mo_tp_emv(scale, nu: float, num_pts: int, Q, iK, fcn_obs) -> torch.Tensor:
    """Per-output MO-TP expected model variance: the GP one rescaled by the
    data-dependent Student factor of ``fcn_obs`` (..., E, N); (..., E)."""
    fe = torch.atleast_2d(fcn_obs)
    quad = torch.einsum("...en,nme,...em->...e", fe, iK, fe)
    s = (nu - 2.0 + quad) / (nu - 2.0 + num_pts)
    return scale ** 2 * s * (1.0 - torch.einsum("nmee,mne->e", Q, iK))


class MultiOutputModel(Model):
    """One kernel-parameter row per output.

    ``compat_mirror_wc=True`` (default) keeps the reference's fill of the
    upper output triangle of ``Wc`` by the lower one WITHOUT transposing the
    point axes, before the final symmetrization, as the JAX package does;
    ``False`` computes every block ``iK_e Q_ef iK_f``.
    """

    def __init__(self, dim_in: int, dim_out: int, kern_par, kern_str: str = "rbf",
                 point_str: str = "ut", point_par=None, compat_mirror_wc: bool = True,
                 device=None, **kern_kwargs):
        super().__init__(dim_in, kern_par, kern_str, point_str, point_par, device=device,
                         **kern_kwargs)
        self.dim_out = int(dim_out)
        self.compat_mirror_wc = bool(compat_mirror_wc)

    def bq_weights(self, par=None) -> MOWeights:
        """The tensor-valued weights ``Wc[..., e, f] = iK_e Q_ef iK_f``,
        symmetrized across the point and output axes.  Only the lower-triangle
        blocks of ``Q`` are computed; the upper ones are their point-axis
        transposes (``Q[e, f][i, j] = E[k_e(x, x_i) k_f(x, x_j)]``), which for
        an ``rbf-student`` kernel saves a Monte-Carlo sweep a block."""
        par = self.kernel.get_parameters(par)
        x = self.points
        k = self.kernel
        q = torch.stack([k.exp_x_kx(p, x) for p in par])                     # (E, N)
        R = torch.stack([k.exp_x_xkx(p, x) for p in par])                    # (E, D, N)
        iK = torch.stack([k.eval_inv_dot(p, x, scaling=False) for p in par])  # (E, N, N)
        il, jl = np.tril_indices(self.dim_out)
        Q_low = torch.stack([k.exp_x_kxkx(par[i], par[j], x) for i, j in zip(il, jl)])
        n = x.shape[-1]
        Q = Q_low.new_zeros((self.dim_out, self.dim_out, n, n))
        Q[il, jl] = Q_low
        Q[jl, il] = Q_low.mT                                                 # (E, E, N, N)
        w_m = torch.einsum("en,enm->me", q, iK)
        w_c = torch.einsum("eni,efij,fjm->nmef", iK, Q, iK)
        if self.compat_mirror_wc:
            e = torch.arange(self.dim_out, device=x.device)
            w_c = torch.where((e[:, None] >= e[None, :])[None, None], w_c, w_c.transpose(2, 3))
        w_c = 0.5 * (w_c + w_c.transpose(0, 1).transpose(2, 3))
        w_cc = torch.einsum("edi,ein->dne", R, iK)
        return MOWeights(wm=w_m, Wc=w_c, Wcc=w_cc, q=q.movedim(0, -1),
                         Q=Q.movedim((0, 1), (-2, -1)), R=R.movedim(0, -1),
                         iK=iK.movedim(0, -1))

    def optimize(self, log_par_0, fcn_obs, x_obs, method="BFGS", **kwargs):
        """:meth:`Model.optimize` of each output's NLML term on its own row
        of ``log_par_0`` and ``fcn_obs`` (E, N); returns the (E, num_par)
        optimum and the SciPy results."""
        log_par_0 = np.atleast_2d(np.asarray(log_par_0, dtype=float))
        fcn_obs = f64(fcn_obs, self.points.device)
        results = [super(MultiOutputModel, self).optimize(log_par_0[d], fcn_obs[d, :, None],
                                                          x_obs, method=method, **kwargs)
                   for d in range(self.dim_out)]
        return np.vstack([r.x for r in results]), results

    def predict(self, *args, **kwargs):
        raise NotImplementedError("multi-output predict is not implemented, as in the JAX "
                                  "package and the reference")


class GaussianProcessMO(MultiOutputModel):
    """Multi-output GP model."""

    def exp_model_variance(self, weights: MOWeights, fcn_obs=None) -> torch.Tensor:
        """Per-output EMV, (E,)."""
        return mo_gp_emv(self.kernel.scale, weights.Q, weights.iK)

    def integral_variance(self, fcn_obs=None, par=None) -> torch.Tensor:
        """Per-output integral variance, (E,)."""
        par = self.kernel.get_parameters(par)
        x, k = self.points, self.kernel
        out = []
        for p in par:
            q = k.exp_x_kx(p, x)
            out.append(k.exp_xy_kxy(p) - q @ k.eval_inv_dot(p, x, scaling=False) @ q)
        return torch.stack(out)

    def neg_log_marginal_likelihood(self, log_par, fcn_obs, x_obs, jitter):
        """One output's NLML term, ``fcn_obs`` (N,) or (N, 1)."""
        half_logdet, a = _gp_nlml_terms(self.kernel, log_par, fcn_obs, x_obs, jitter)
        return half_logdet + 0.5 * (torch.sum(fcn_obs * a)
                                    + x_obs.shape[1] * math.log(2.0 * math.pi))


class StudentTProcessMO(MultiOutputModel):
    """Multi-output Student-t process model (``nu`` default 3, kept as given)."""

    def __init__(self, dim_in: int, dim_out: int, kern_par, kern_str: str = "rbf",
                 point_str: str = "ut", point_par=None, nu: float = 3.0, device=None,
                 **kern_kwargs):
        super().__init__(dim_in, dim_out, kern_par, kern_str, point_str, point_par,
                         device=device, **kern_kwargs)
        self.nu = float(nu)

    def exp_model_variance(self, weights: MOWeights, fcn_obs) -> torch.Tensor:
        """Data-scaled per-output EMV of ``fcn_obs`` (..., E, N), (..., E)."""
        return mo_tp_emv(self.kernel.scale, self.nu, self.num_pts, weights.Q, weights.iK,
                         f64(fcn_obs, self.points.device))

    def integral_variance(self, fcn_obs=None, par=None):
        """None: unimplemented, as in the JAX package and the reference."""
        return None

    def neg_log_marginal_likelihood(self, log_par, fcn_obs, x_obs, jitter):
        """One output's Student NLML term: ``log1p(y K^-1 y)`` and
        ``+gammaln(nu / 2 + N) - gammaln(nu / 2)``, as in the JAX package
        (not the single-output model's term)."""
        num_data, nu = x_obs.shape[1], self.nu
        half_logdet, a = _gp_nlml_terms(self.kernel, log_par, fcn_obs, x_obs, jitter)
        const = (0.5 * num_data * math.log((nu - 2.0) * math.pi)
                 + _gammaln(0.5 * nu + num_data, a) - _gammaln(0.5 * nu, a))
        return 0.5 * (nu + num_data) * torch.log1p(torch.sum(fcn_obs * a)) + half_logdet + const
