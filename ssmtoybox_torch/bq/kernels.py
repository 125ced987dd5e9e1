"""BQ kernels and their expectations (counterpart of
:mod:`ssmtoybox_tpu.bq.kernels`).

Points ``x`` are (D, N) float64 tensors; ``par`` holds one parameter row per
output, ``[s, l_1..l_D]`` for the RBF kernels and ``[s, alpha, l_1..l_D]``
for :class:`RQ`.  :class:`RBFGauss` and :class:`RQ` take expectations w.r.t.
``N(0, I)`` in closed form; :class:`RBFStudent` w.r.t. the standard Student
density ``St(0, I, dof)`` by Monte Carlo.  Nothing here detaches: every
expectation is differentiable in ``par`` by autograd.
"""
from __future__ import annotations

import torch

from ..utils import rand
from ..utils.arrays import f64, resolve_device
from ..utils.linalg import chol_small, maha, pd_inv, pd_solve

__all__ = ["Kernel", "RBFGauss", "RBFStudent", "RQ", "get_kernel"]


class Kernel:
    """Kernel base: the parameter rows ``par`` (E, num_par), one per output,
    and the Gram solves.  ``jitter`` stabilises the Gram's inverse."""

    #: the parameter row's width beyond the D length-scales
    num_extra = 1

    def __init__(self, dim: int, par, jitter: float = 1e-8, device=None):
        self.par = torch.atleast_2d(f64(par, resolve_device(device)))
        if self.par.shape[-1] != dim + self.num_extra:
            raise ValueError(f"{type(self).__name__} parameters must be {dim + self.num_extra} "
                             f"wide for dimension {dim}; got shape {tuple(self.par.shape)}")
        self.dim = dim
        self.jitter = jitter

    def get_parameters(self, par=None) -> torch.Tensor:
        """The construction-time parameters, or ``par`` as (E, num_par) in
        the dtype of the construction-time ones (float64, or float32 in a
        copy cast for a float32 search)."""
        if par is None:
            return self.par
        par = par if isinstance(par, torch.Tensor) else f64(par, self.par.device)
        return torch.atleast_2d(par.to(self.par))

    @property
    def scale(self) -> torch.Tensor:
        """Each output's kernel scale ``s``, (E,)."""
        return self.par[:, 0]

    def _jittered(self, par, x, scaling):
        K = self.eval(par, x, scaling=scaling)
        return K + self.jitter * torch.eye(x.shape[-1], dtype=K.dtype, device=K.device)

    def eval_inv_dot(self, par, x, b=None, scaling=True):
        """``(K + jitter I)^-1 b`` via Cholesky, symmetrized when ``b`` is
        the identity."""
        A = self._jittered(par, x, scaling)
        return pd_inv(A) if b is None else pd_solve(A, b)

    def eval_chol(self, par, x, scaling=True):
        """Lower Cholesky factor of the jittered Gram, NaN where it fails (as
        the JAX package's ``cholesky``)."""
        return chol_small(self._jittered(par, x, scaling))

    def exp_x_qRQ(self, par, x):
        """``(q, R, Q)`` for the BQ weights."""
        return self.exp_x_kx(par, x), self.exp_x_xkx(par, x), self.exp_x_kxkx(par, par, x)

    def der_par(self, par_0, x):  # pragma: no cover - interface
        raise NotImplementedError


def _prod(v: torch.Tensor) -> torch.Tensor:
    """``torch.prod(v)`` of a vector of positive entries, its bits, with the
    derivatives of ``exp(sum(log v))``: ``torch.prod``'s backward looks for
    zeros with ``nonzero``, which waits for the card, and the marginalized
    filter differentiates these expectations twice inside its time loop.
    The surrogate's value is subtracted from itself, so it adds exactly 0."""
    s = torch.exp(torch.sum(torch.log(v)))
    return torch.prod(v.detach()) + (s - s.detach())


def _unpack_rbf(par):
    """``[s, l_1..l_D] -> (s, lengthscales)``."""
    par = par.reshape(-1)
    return par[0], par[1:]


class RBFGauss(Kernel):
    """RBF kernel ``k(x, x') = s^2 exp(-0.5 (x - x')^T Lam^-1 (x - x'))`` with
    ``Lam = diag(l^2)``."""

    def eval(self, par, x1, x2=None, diag=False, scaling=True):
        """Gram of the columns of ``x1`` (..., D, N1) and ``x2`` (D, N2)."""
        x2 = x1 if x2 is None else x2
        alpha, ell = _unpack_rbf(par)
        log_a2 = 2.0 * torch.log(alpha) if scaling else 0.0
        s1 = x1 / ell[:, None]
        s2 = x2 / ell[:, None]
        if diag:
            dx = s1 - s2
            return torch.exp(log_a2 - 0.5 * torch.sum(dx * dx, dim=-2))
        return torch.exp(log_a2 - 0.5 * maha(s1.mT, s2.mT))

    def exp_x_kx(self, par, x, scaling=False):
        """Kernel mean map ``E_x[k(x, x_i)]``."""
        alpha, ell = _unpack_rbf(par)
        a2 = alpha ** 2 if scaling else 1.0
        lam = ell ** 2
        c = a2 * _prod(1.0 / lam + 1.0) ** -0.5
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
        return _prod(r) ** -0.5 * torch.exp(n)

    def exp_x_kxx(self, par):
        alpha, _ = _unpack_rbf(par)
        return alpha ** 2

    def exp_xy_kxy(self, par):
        alpha, ell = _unpack_rbf(par)
        return alpha ** 2 * _prod(2.0 * ell ** -2 + 1.0) ** -0.5

    def der_par(self, par_0, x):
        """dK/dpar stacked as (N, N, 1 + D): d/ds, then d/d(log l_d) for the
        length-scales, as the JAX package and the reference return them (for
        a log-parameterized optimizer).  Autograd of the NLML is the
        preferred gradient."""
        par_0 = par_0.reshape(-1)
        alpha, ell = par_0[0], par_0[1:]
        K = self.eval(par_0, x)
        dx2 = (x[:, None, :] - x[:, :, None]) ** 2
        d_el = dx2 * (ell ** -2)[:, None, None] * K[None]
        return torch.cat([(2.0 * K / alpha)[..., None], d_el.movedim(0, -1)], dim=-1)


#: elements of the largest intermediate a Monte-Carlo scan makes at once
_GROUP_ELEMS = 1 << 24


class RBFStudent(RBFGauss):
    """RBF kernel with expectations w.r.t. ``St(0, I, dof)`` by Monte Carlo.

    Two paths, as in the JAX package:

    - the scan path: float64 sample batches, ``num_batches`` of
      ``num_samples // num_batches`` samples drawn from a generator seeded
      with ``seed`` (several batches at once, bounded in memory), folded into
      running sums.  :meth:`projected_weight_stats` (the BQ weights) always
      takes it;
    - the fused path (:mod:`ssmtoybox_torch.ops.student_mc`): one float32
      sample stream in chunks, reduced by the CUDA kernels, differentiable
      through their backward kernels.  :meth:`exp_x_qRQ` and
      :meth:`exp_xy_kxy` take it when :meth:`_kernel_on` says so.

    ``use_kernel`` is the JAX package's ``use_pallas``: ``True`` takes the
    fused path when the kernel's tensors lie on a CUDA card (the scan path
    elsewhere), ``"force"`` takes it everywhere (through the plain versions
    on the CPU), ``False`` never.
    """

    def __init__(self, dim: int, par, jitter: float = 1e-8, dof: float = 4.0,
                 num_samples: int = int(2e6), num_batches: int = 50, seed: int = 0,
                 use_kernel=True, device=None):
        super().__init__(dim, par, jitter, device)
        if use_kernel not in (True, False, "force"):
            raise ValueError(f"use_kernel={use_kernel!r}; expected True, False or 'force'")
        self.dof = float(dof)
        self.num_samples = int(num_samples)
        self.num_batches = int(num_batches)
        self.seed = int(seed)
        self.use_kernel = use_kernel

    def _kernel_on(self) -> bool:
        """The fused path: forced, or permitted and on a CUDA card."""
        if self.use_kernel == "force":
            return True
        return bool(self.use_kernel) and self.par.device.type == "cuda"

    def _generator(self) -> torch.Generator:
        return torch.Generator(device=self.par.device).manual_seed(self.seed)

    # -- the scan path ----------------------------------------------------------
    def _batches(self, num_batches: int, batch_size: int, per_sample: int):
        """Sample batches as (G, D, batch_size) float64 stacks of G batches,
        G chosen so that a fold's (G, batch_size, per_sample) intermediate
        stays under ``_GROUP_ELEMS`` elements."""
        gen = self._generator()
        kw = dict(dtype=torch.float64, device=self.par.device)
        mean, eye = torch.zeros(self.dim, **kw), torch.eye(self.dim, **kw)
        group = max(1, _GROUP_ELEMS // (batch_size * per_sample))
        for b0 in range(0, num_batches, group):
            g = min(group, num_batches - b0)
            yield rand.multivariate_t(gen, mean, eye, self.dof, (g, batch_size)).mT

    def _mc_scan(self, fold, init, num_batches=None, per_sample: int = 1):
        """Accumulate ``fold(batches, acc)`` over the sample batches and divide
        by the number of samples drawn, ``num_batches * (num_samples //
        num_batches)``."""
        num_batches = self.num_batches if num_batches is None else num_batches
        batch_size = self.num_samples // num_batches
        if batch_size < 1:
            raise ValueError(
                f"num_samples={self.num_samples} gives an empty batch with "
                f"num_batches={num_batches}; raise num_samples or lower num_batches")
        acc = init
        for xs in self._batches(num_batches, batch_size, per_sample):
            acc = fold(xs, acc)
        n = num_batches * batch_size
        return tuple(a / n for a in acc) if isinstance(acc, tuple) else acc / n

    def exp_x_kx(self, par, x, scaling=False):
        return self._mc_scan(
            lambda xs, acc: acc + self.eval(par, xs, x, scaling=scaling).sum((0, 1)),
            x.new_zeros(x.shape[-1]), per_sample=x.shape[-1])

    def exp_x_xkx(self, par, x, scaling=False):
        return self._mc_scan(
            lambda xs, acc: acc + (xs @ self.eval(par, xs, x, scaling=scaling)).sum(0),
            x.new_zeros(x.shape), per_sample=x.shape[-1])

    def exp_x_kxkx(self, par_0, par_1, x, scaling=False):
        """``Q[i, j] = E[k_par0(x, x_i) k_par1(x, x_j)]``: the closed-form
        orientation of :class:`RBFGauss`, so ``Q(p1, p0) == Q(p0, p1)^T``
        (the reference accumulates the transpose; the JAX package fixed it)."""
        def fold(xs, acc):
            k0 = self.eval(par_0, xs, x, scaling=scaling)
            k1 = self.eval(par_1, xs, x, scaling=scaling)
            return acc + (k0.mT @ k1).sum(0)

        n = x.shape[-1]
        return self._mc_scan(fold, x.new_zeros((n, n)), per_sample=n)

    def exp_x_kxx(self, par):
        return torch.atleast_2d(par)[0, 0] ** 2

    def projected_weight_stats(self, par, x, iK):
        """Monte-Carlo BQ weight statistics accumulated in WEIGHT space.

        With ``g_s = iK k_s`` per sample: ``wm = E[g]``, ``Wc = E[g g^T]``,
        ``Wcc = E[x g^T]`` and ``tr(Q iK) = E[k^T g]``, plus the raw ``q`` and
        ``Q`` from the same samples.  The composed ``iK Q iK`` would amplify
        any unstructured accumulation error by ``1/lambda_min(K)^2`` (~1e16
        on the FUSION-2017 Student-study parameters) and diverge every TPQ
        filter; these sums carry errors relative to the weights themselves.

        Returns ``(q, wm, Wc, Wcc, tr_QiK, Q)``.
        """
        def fold(xs, acc):
            k = self.eval(par, xs, x, scaling=False)        # (G, B, N)
            g = k @ iK
            q, wm, Wc, Wcc, tr, Q = acc
            return (q + k.sum((0, 1)), wm + g.sum((0, 1)), Wc + (g.mT @ g).sum(0),
                    Wcc + (xs @ g).sum(0), tr + torch.sum(k * g), Q + (k.mT @ k).sum(0))

        d, n = x.shape
        z = x.new_zeros
        return self._mc_scan(fold, (z(n), z(n), z((n, n)), z((d, n)), z(()), z((n, n))),
                             per_sample=n)

    # -- the fused path ---------------------------------------------------------
    def _fused_samples(self, par, chunk: int):
        """The fused path's float32 sample stream, ``(samples, chunk)``."""
        from ..ops.student_mc import chunking
        chunk, _, total = chunking(self.num_samples, chunk)
        kw = dict(dtype=torch.float32, device=par.device)
        samples = rand.multivariate_t(self._generator(), torch.zeros(self.dim, **kw),
                                      torch.eye(self.dim, **kw), self.dof, (total,))
        return samples, chunk

    def exp_x_qRQ(self, par, x):
        """``(q, R, Q)`` from one sample stream: on the fused path one Gram
        evaluation per chunk and three reductions in the ``qrq`` kernel
        (differentiable through ``qrq_bwd``); otherwise the three scans.
        Raw expectations, not weight-grade on ill-conditioned parameters:
        the BQ weights use :meth:`projected_weight_stats`."""
        if not self._kernel_on():
            return super().exp_x_qRQ(par, x)
        from ..ops import student_mc
        samples, chunk = self._fused_samples(par, student_mc.QRQ_CHUNK)
        return student_mc.student_qrq(par, x, samples, chunk)

    def exp_xy_kxy(self, par):
        """``E[k(x, y)]`` over independent Student draws: the off-diagonal
        pairs of each chunk (fused path) or batch (scan path), so the
        estimate divides by the pair count (the reference's ``B``-fold
        overestimate is fixed, as in the JAX package)."""
        scale2 = torch.atleast_2d(par)[0, 0] ** 2
        if self._kernel_on():
            from ..ops import student_mc
            samples, chunk = self._fused_samples(par, student_mc.KXY_CHUNK)
            return scale2 * student_mc.student_kxy(par, samples, chunk)
        # batches of >= 2 samples (pairs need two)
        nb = min(10000, max(1, self.num_samples // 2))

        def fold(xs, acc):
            K = self.eval(par, xs, xs)                      # (G, B, B)
            b = K.shape[-1]
            off = K.sum((1, 2)) - torch.diagonal(K, dim1=-2, dim2=-1).sum(-1)
            return acc + torch.sum(off / (b - 1))

        return self._mc_scan(fold, self.par.new_zeros(()), num_batches=nb,
                             per_sample=self.num_samples // nb)


def _unpack_rq(par):
    """``[s, alpha, l_1..l_D] -> (s, alpha, lengthscales)``."""
    par = par.reshape(-1)
    return par[0], par[1], par[2:]


class RQ(Kernel):
    """Rational-quadratic kernel
    ``k(x, x') = s^2 (1 + (x - x')^T Lam^-1 (x - x') / (2 alpha))^-alpha``
    with approximate Gaussian expectations; parameters ``[s, alpha, l_1..l_D]``.
    """

    num_extra = 2

    def eval(self, par, x1, x2=None, diag=False, scaling=True):
        """Gram of the columns of ``x1`` (..., D, N1) and ``x2`` (D, N2)."""
        x2 = x1 if x2 is None else x2
        s, alpha, ell = _unpack_rq(par)
        s2_ = s ** 2 if scaling else 1.0
        s1 = x1 / ell[:, None]
        s2 = x2 / ell[:, None]
        if diag:
            dx = s1 - s2
            return s2_ * (1.0 + torch.sum(dx * dx, dim=-2) / (2.0 * alpha)) ** (-alpha)
        return s2_ * (1.0 + maha(s1.mT, s2.mT) / (2.0 * alpha)) ** (-alpha)

    def exp_x_kx(self, par, x, scaling=False):
        s, alpha, ell = _unpack_rq(par)
        s2 = s ** 2 if scaling else 1.0
        lam = ell ** 2
        c = s2 * _prod(1.0 / lam + 1.0) ** -0.5
        xl = x / (lam + 1.0)[:, None]
        return c * (1.0 + torch.sum(x * xl, dim=0) / (2.0 * alpha)) ** (-alpha)

    def exp_x_xkx(self, par, x):
        _, _, ell = _unpack_rq(par)
        mu_q = x / (ell ** 2 + 1.0)[:, None]
        return self.exp_x_kx(par, x)[None, :] * mu_q

    def exp_x_kxkx(self, par_0, par_1, x, scaling=False):
        """``E_x[k(x, x_i) k(x, x_j)]`` with the JAX package's sign fix: the
        completed square enters NEGATIVELY, ``n = xi_i + xi_j - z^T R^-1 z``
        (the reference adds it and misses the alpha -> inf RBF limit)."""
        s, alpha, ell = _unpack_rq(par_0)
        s_1, _, ell_1 = _unpack_rq(par_1)
        scale = s ** 2 * s_1 ** 2 if scaling else 1.0
        inv_lam = ell ** -2
        inv_lam_1 = ell_1 ** -2
        xi = x / ell[:, None]
        xi = torch.sum(xi * xi, dim=0)
        xi_1 = x / ell_1[:, None]
        xi_1 = torch.sum(xi_1 * xi_1, dim=0)
        x_0 = inv_lam[:, None] * x
        x_1 = inv_lam_1[:, None] * x
        r = inv_lam + inv_lam_1 + 1.0
        n = (xi[:, None] + xi_1[None, :]) - maha(x_0.T, -x_1.T, V=torch.diag(1.0 / r))
        return scale * _prod(r) ** -0.5 * (1.0 + n / (2.0 * alpha)) ** (-alpha)

    def exp_x_kxx(self, par):
        return par.reshape(-1)[0] ** 2

    def exp_xy_kxy(self, par):
        s, _, ell = _unpack_rq(par)
        return s ** 2 * _prod(2.0 * ell ** -2 + 1.0) ** -0.5

    def der_par(self, par_0, x):
        raise NotImplementedError("RQ.der_par is not implemented, as in the JAX package "
                                  "and the reference")


def get_kernel(dim: int, kernel: str, par, **kwargs) -> Kernel:
    """String-keyed kernel factory: ``"rbf"``, ``"rbf-student"`` or ``"rq"``."""
    kernel = kernel.lower()
    if kernel == "rbf":
        return RBFGauss(dim, par, **kwargs)
    if kernel == "rbf-student":
        return RBFStudent(dim, par, **kwargs)
    if kernel == "rq":
        return RQ(dim, par, **kwargs)
    raise ValueError(f"Kernel '{kernel}' not supported. Supported: rbf, rbf-student, rq.")
