"""Time-parallel iterated posterior-linearization smoother (counterpart of
:mod:`ssmtoybox_tpu.parallel.iplf`).

For nonlinear models (additive or non-additive noise), each iteration

1. linearizes the dynamics and the measurement by statistical linear
   regression (:func:`~ssmtoybox_torch.ssinf.slr_affine`) about the current
   smoothed marginals, all N steps in one batched transform call, and
2. runs the time-parallel affine filter and smoother of
   :mod:`~ssmtoybox_torch.parallel.timescan` (or its square-root form,
   :mod:`~ssmtoybox_torch.parallel.sqrttime`) on the resulting time-varying
   affine model

(García-Fernández, Svensson & Särkkä, IEEE TAC 2017; temporal
parallelization in Yaghoobi et al., IEEE TSP 2022).  On an exactly linear
model SLR recovers the model, so one iteration is the sequential Kalman
filter and RTS smoother.

Each step's SLR sees its own time: the transforms evaluate the model on
(N, points, D) states with ``time`` a float64 tensor (N, 1, 1), so a
time-varying model must broadcast its time against its state argument (...,
D), as the UNGM models do.  The linearizing transforms
(``LinearizationTransform``, ``TaylorGPQDTransform``, GPQ+D) take each row's
Jacobian at that row's time.

The first linearization trajectory (``init``) is the JAX package's; the
observer modes are sequential loops over time, the measurement's value and
Jacobian from one evaluation a step (and a backward pass an output), and
read nothing back from the card.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ssinf import _augment, _with_theta, slr_affine
from ..utils.linalg import chol_small_psd, pd_solve_small, symmetrize, tria
from .common import ieee, mv
from .shardtime import (sharded_parallel_affine_filter, sharded_parallel_affine_smoother,
                        sharded_parallel_affine_sqrt_filter, sharded_parallel_affine_sqrt_smoother)
from .sqrttime import _gain, _joint, parallel_affine_sqrt_filter, parallel_affine_sqrt_smoother
from .timescan import parallel_affine_filter, parallel_affine_smoother

__all__ = ["slr_affine", "parallel_affine_filter", "parallel_affine_smoother",
           "IteratedSmootherResult", "iterated_parallel_smoother"]


@dataclass
class IteratedSmootherResult:
    """Final-iteration moments, state first and time last: filtered
    ``fi_mean`` (D, N), ``fi_cov`` (D, D, N) and smoothed ``sm_mean``,
    ``sm_cov``."""

    fi_mean: torch.Tensor
    fi_cov: torch.Tensor
    sm_mean: torch.Tensor
    sm_cov: torch.Tensor


def _time_like(t, x: torch.Tensor):
    """A time tensor over the leading dimensions of ``x`` reshaped to
    broadcast against it; a number as it is."""
    if not isinstance(t, torch.Tensor):
        return t
    return t.reshape(t.shape + (1,) * (x.ndim - t.ndim))


def _solve_pd(S: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """``S^-1 B`` for positive-definite ``S``: a division when S is 1 x 1
    (the observer's common case, no factorization a step)."""
    if S.shape[-1] == 1:
        return B / S
    return pd_solve_small(S, B)


class _Problem:
    """The models, transforms and record of one smoother call, cast once:
    the prior, the noise moments and the data in ``dtype`` on the models'
    device, and the SLRs and mean maps the iteration and its initial
    trajectory share."""

    def __init__(self, mod_dyn, mod_obs, tf_dyn, tf_obs, data, init_mean=None, init_cov=None,
                 theta_dyn=None, theta_obs=None, dtype=None):
        self.mod_dyn, self.mod_obs = mod_dyn, mod_obs
        self.tf_dyn, self.tf_obs = _with_theta(tf_dyn, theta_dyn), _with_theta(tf_obs, theta_obs)
        m0, P0 = mod_dyn.init_rv.get_stats()[:2]
        m0 = torch.as_tensor(m0 if init_mean is None else init_mean, device=mod_dyn.device)
        self.dtype = dtype = m0.dtype if dtype is None else dtype
        self.device = dev = m0.device
        cast = lambda a: torch.as_tensor(a, device=dev).to(dtype)
        self.m0 = cast(m0)
        self.P0 = cast(P0 if init_cov is None else init_cov)
        self.q_mean, self.q_cov = (cast(a) for a in mod_dyn.noise_rv.get_stats()[:2])
        self.r_mean, self.r_cov = (cast(a) for a in mod_obs.noise_rv.get_stats()[:2])
        self.G = cast(mod_dyn.noise_gain)
        self.GQGt = self.G @ self.q_cov @ self.G.T
        self.dim = self.m0.shape[0]
        self.data = cast(data)
        self.n_steps = self.data.shape[-1]
        # the time of each step, the sequential filter's k - 1
        self.times = torch.arange(self.n_steps, dtype=torch.float64, device=dev)

    def _slr(self, tf, f, m, P, t):
        """SLR of ``f`` about rows ``N(m, P)``, row ``i`` at time ``t[i]``,
        in float64 (the models' dtype), cast to ``dtype``."""
        return tuple(a.to(self.dtype) for a in slr_affine(tf, f, m.double(), P.double(),
                                                          t.reshape(-1, 1, 1)))

    def slr_dyn(self, m, P, t):
        """``(F, b, A_q, Omega)`` of the dynamics, ``A_q`` the noise map of a
        non-additive model (None for additive noise)."""
        mod = self.mod_dyn
        if mod.noise_additive:
            F, b, Om = self._slr(self.tf_dyn, mod.dyn_eval, m, P, t)
            return F, b, None, Om
        A, b, Om = self._slr(self.tf_dyn, mod.dyn_eval,
                             *_augment(m, P, self.q_mean, self.q_cov), t)
        return A[..., :self.dim], b, A[..., self.dim:], Om

    def slr_obs(self, m, P, t):
        """``(H, c, A_r, Omega)`` of the measurement, as :meth:`slr_dyn`."""
        mod = self.mod_obs
        if mod.noise_additive:
            H, c, Om = self._slr(self.tf_obs, mod.meas_eval, m, P, t)
            return H, c, None, Om
        A, c, Om = self._slr(self.tf_obs, mod.meas_eval,
                             *_augment(m, P, self.r_mean, self.r_cov), t)
        return A[..., :self.dim], c, A[..., self.dim:], Om

    def full_dyn(self, m, P, t):
        """``(F, b, Q_eff)`` of the full-covariance scans."""
        F, b, Aq, Om = self.slr_dyn(m, P, t)
        if Aq is None:
            return F, b, Om + self.GQGt
        return F, b + mv(Aq, self.q_mean), Om + Aq @ self.q_cov @ Aq.mT

    def full_obs(self, m, P, t):
        """``(H, c, R_eff)`` of the full-covariance scans."""
        H, c, Ar, Om = self.slr_obs(m, P, t)
        if Ar is None:
            return H, c, Om + self.r_cov
        return H, c + mv(Ar, self.r_mean), Om + Ar @ self.r_cov @ Ar.mT

    def f_mean(self, m, t):
        """The dynamics at the noise mean, rows ``m`` (..., D)."""
        x = m.double()
        if not self.mod_dyn.noise_additive:
            x = torch.cat([x, self.q_mean.double().expand(x.shape[:-1] + self.q_mean.shape)], -1)
        return self.mod_dyn.dyn_eval(x, _time_like(t, m)).to(self.dtype)

    def h_val_jac(self, x, t):
        """The measurement at the noise mean and its Jacobian at rows ``x``
        (..., D), from one evaluation and one backward pass an output (rows
        are independent, so the gradient of a column's sum is each row's)."""
        with torch.enable_grad():
            xx = x.detach().double().requires_grad_(True)
            xin = xx
            if not self.mod_obs.noise_additive:
                r = self.r_mean.double()
                xin = torch.cat([xx, r.expand(xx.shape[:-1] + r.shape)], -1)
            y = self.mod_obs.meas_eval(xin, _time_like(t, xx))
            e = y.shape[-1]
            rows = [torch.autograd.grad(y[..., i].sum(), xx, retain_graph=i + 1 < e)[0]
                    for i in range(e)]
        return torch.stack(rows, -2).to(self.dtype), y.detach().to(self.dtype)


def _observer(prob: _Problem, m, ys, ts, out):
    """The frozen-covariance observer from ``m`` (..., D) over the
    measurements ``ys[k]`` (..., E) at times ``ts[k]``, each new mean written
    to ``out[k]``."""
    p = prob
    F0, _, Q0 = (a[0] for a in p.full_dyn(p.m0[None], p.P0[None], p.times[:1]))
    H0, _, R0 = (a[0] for a in p.full_obs(p.m0[None], p.P0[None], p.times[:1]))
    P = p.P0
    for _ in range(50):            # the steady-state covariance at the prior's SLR
        Pp = symmetrize(F0 @ P @ F0.T + Q0)
        S = H0 @ Pp @ H0.T + R0
        K = pd_solve_small(S, H0 @ Pp).T
        P = symmetrize(Pp - K @ S @ K.T)
    Pp = symmetrize(F0 @ P @ F0.T + Q0)
    for k in range(len(ts)):
        mp = p.f_mean(m, ts[k])
        H, y_pred = p.h_val_jac(mp, ts[k])
        K = _solve_pd(H @ Pp @ H.mT + R0, H @ Pp).mT
        m = mp + mv(K, ys[k] - y_pred)
        out[k] = m


def _initial_trajectory(prob: _Problem, init, block_len: int = 2048, warmup: int = 512):
    """The first linearization means (N + 1, D) at times 0..N (see
    :func:`iterated_parallel_smoother`'s ``init``)."""
    p = prob
    n, dim, dev = p.n_steps, p.dim, p.device
    if not isinstance(init, str):
        lin_m = torch.as_tensor(init, device=dev).to(p.dtype)
        if tuple(lin_m.shape) != (n + 1, dim):
            raise ValueError(f"init trajectory must be ({n + 1}, {dim}); got {tuple(lin_m.shape)}")
        return lin_m
    if init not in ("observer", "block-observer", "rollout", "prior"):
        raise ValueError("init must be 'observer', 'block-observer', 'rollout', 'prior' or an "
                         f"(N+1, D) trajectory; got {init!r}")
    if init == "prior":
        return p.m0.expand(n + 1, dim)
    rolled = p.m0.new_empty(n, dim)
    if init == "rollout":
        m = p.m0
        for k in range(n):
            m = rolled[k] = p.f_mean(m, k)
    elif init == "observer" or n <= block_len:
        _observer(p, p.m0, p.data.T, range(n), rolled)
    else:
        # overlapping blocks, each warmed up from the prior mean, all at once
        n_blocks = -(-n // block_len)
        starts = np.maximum(np.arange(n_blocks) * block_len - warmup, 0)
        idx = np.minimum(starts[:, None] + np.arange(block_len + warmup)[None, :], n - 1)
        idx = torch.as_tensor(idx, device=dev)
        outs = p.m0.new_empty(block_len + warmup, n_blocks, dim)
        _observer(p, p.m0.expand(n_blocks, dim), p.data.T[idx].transpose(0, 1),
                  p.times[idx].T, outs)
        off = torch.as_tensor(np.arange(n_blocks) * block_len - starts, device=dev)
        rows = outs.transpose(0, 1)[torch.arange(n_blocks, device=dev)[:, None],
                                    off[:, None] + torch.arange(block_len, device=dev)]
        rolled = rows.reshape(n_blocks * block_len, dim)[:n]
    return torch.cat([p.m0[None], rolled])


@ieee
def iterated_parallel_smoother(mod_dyn, mod_obs, tf_dyn, tf_obs, data, iterations: int = 10,
                               init_mean=None, init_cov=None, theta_dyn=None, theta_obs=None,
                               init="observer", block_len: int = 2048, warmup: int = 512,
                               sqrt: bool = False, dtype=None, chol_jitter: float = 0.0,
                               scan_block_len: int | None = None,
                               mesh=None, mesh_axis: str = "t") -> IteratedSmootherResult:
    """Iterated posterior-linearization smoother with a time-parallel core.

    ``data`` (dim_y, N).  Each iteration linearizes both models about the
    current smoothed marginals and runs one time-parallel affine filter and
    smoother.  Step ``k`` (1-based) evaluates both models at time ``k - 1``,
    as the sequential filter does.

    ``init`` picks the first linearization trajectory (posterior
    linearization converges only locally, so it picks the basin):

    * ``"observer"``: a frozen-covariance EKF, the predictive covariance from
      50 Riccati steps at the prior's SLR, the gain from the measurement's
      local Jacobian a step, ``m_k = f(m_{k-1}) + K(H_k) (y_k -
      h(f(m_{k-1})))``; sequential over the record;
    * ``"block-observer"``: the same observer on ``ceil(N / block_len)``
      overlapping blocks at once, each started ``warmup`` steps early from
      the prior mean; sequential depth ``block_len + warmup``.  It needs a
      measurement from which the observer re-acquires the state within the
      warm-up (a direct angle, not the pendulum's multimodal ``sin``);
    * ``"rollout"``: the prior mean pushed through the dynamics;
    * ``"prior"``: every point at ``N(m0, P0)``;
    * a tensor (N + 1, D) of linearization means at times 0..N.

    Non-additive noise is regressed over the augmented input ``(x, q) ~
    N((m, q_mean), blockdiag(P, Q))`` and split into a state map and a noise
    map, as the sequential filters do.

    ``sqrt=True`` runs the square-root scans: covariances as factors, the
    effective noise as the stacked factor columns ``[chol_psd(Omega), noise
    map chol(Q)]``, never summed, so that rank-deficient pieces stay exact
    and ``dtype=torch.float32`` keeps definiteness.  ``dtype`` casts the
    prior, the data, every SLR output and the scans; the models and
    transforms are evaluated in float64 and their results cast.
    ``chol_jitter`` adds a diagonal before the residuals are factored.
    ``scan_block_len`` (square-root scans only) bounds the scans'
    temporaries; results equal the unblocked ones to rounding.
    ``theta_dyn``/``theta_obs`` are the BQ transforms' kernel parameters
    (weights derived once a call).  Returned covariances are full (``S
    S^T`` in square-root mode).

    ``mesh`` (a :class:`~ssmtoybox_torch.parallel.mesh.Mesh` with the axis
    ``mesh_axis``) runs every affine filter and smoother pass through the
    sharded scans of :mod:`~ssmtoybox_torch.parallel.shardtime`, in both
    forms: each rank scans its chunk of the record, two ``all_gather`` calls a
    pass.  The SLR of each iteration stays one batched call over the whole
    record on every rank (each rank needs the whole smoothed trajectory for
    the next linearization, which the sharded passes return).  Results equal
    the unsharded smoother's to rounding.  Mutually exclusive with
    ``scan_block_len``: the chunks already bound the temporaries.
    """
    if iterations < 1:
        raise ValueError(f"iterations must be >= 1; got {iterations}")
    if scan_block_len is not None and not sqrt:
        raise ValueError("scan_block_len (the scan by blocks) is only wired into the "
                         "square-root scans: pass sqrt=True with it, or drop it")
    if mesh is not None and scan_block_len is not None:
        raise ValueError("mesh and scan_block_len are mutually exclusive: the sharded scans "
                         "already bound the temporaries to N / n_dev steps a rank")
    p = _Problem(mod_dyn, mod_obs, tf_dyn, tf_obs, data, init_mean, init_cov, theta_dyn,
                 theta_obs, dtype)
    dim, dtype, dev, times, m0, P0 = p.dim, p.dtype, p.device, p.times, p.m0, p.P0

    if sqrt:
        eye = lambda k: chol_jitter * torch.eye(k, dtype=dtype, device=dev)
        S0 = chol_small_psd(P0 + eye(dim))
        Lq, Lr = chol_small_psd(p.q_cov), chol_small_psd(p.r_cov)
        Gq_cols = p.G @ Lq

        def noise_cols(Om, A_noise, L_noise, cols_additive):
            """``[chol_psd(Omega), noise map chol(noise cov)]``: the effective
            noise as stacked factor columns."""
            om = chol_small_psd(Om + eye(Om.shape[-1]))
            more = (cols_additive.expand(om.shape[:-1] + cols_additive.shape[-1:])
                    if A_noise is None else A_noise @ L_noise)
            return torch.cat([om, more], dim=-1)

        def sqrt_dyn(m, P, t):
            F, b, Aq, Om = p.slr_dyn(m, P, t)
            b = b if Aq is None else b + mv(Aq, p.q_mean)
            return F, b, noise_cols(Om, Aq, Lq, Gq_cols)

        def sqrt_obs(m, P, t):
            H, c, Ar, Om = p.slr_obs(m, P, t)
            c = c if Ar is None else c + mv(Ar, p.r_mean)
            return H, c, noise_cols(Om, Ar, Lr, Lr)

    def one_pass(lin_m, lin_P):
        """One SLR and one filter and smoother pass: the next linearization
        moments at times 0..N, the filtered moments (the filtered factor in
        square-root mode) and the smoothed ones."""
        if sqrt:
            Fs, bds, SQs = sqrt_dyn(lin_m[:-1], lin_P[:-1], times)
            Hs, cs, SRs = sqrt_obs(lin_m[1:], lin_P[1:], times)
            if mesh is not None:
                fi_m, fi_S = sharded_parallel_affine_sqrt_filter(Fs, bds, SQs, Hs, cs, SRs, m0, S0,
                                                                 p.data, mesh, mesh_axis)
                sm_m, sm_S = sharded_parallel_affine_sqrt_smoother(Fs, bds, SQs, fi_m, fi_S,
                                                                   mesh, mesh_axis)
            else:
                fi_m, fi_S = parallel_affine_sqrt_filter(Fs, bds, SQs, Hs, cs, SRs, m0, S0,
                                                         p.data, scan_block_len=scan_block_len)
                sm_m, sm_S = parallel_affine_sqrt_smoother(Fs, bds, SQs, fi_m, fi_S,
                                                           scan_block_len=scan_block_len)
            sm_P = torch.einsum("ijn,kjn->ikn", sm_S, sm_S)
            # the step-0 refresh in factor form (one joint QR, as the RTS
            # element): a subtractive downdate here would be the one step of
            # the float32 path not safe for definiteness
            L = _joint(Fs[0] @ S0, SQs[0], S0)
            G0 = _gain(L[:dim, :dim], L[dim:, :dim])
            S0_s = tria(torch.cat([L[dim:, dim:], G0 @ sm_S[:, :, 0]], dim=-1))
            P0_s = S0_s @ S0_s.T
            fi_cov = fi_S
        else:
            Fs, bds, Qs = p.full_dyn(lin_m[:-1], lin_P[:-1], times)
            Hs, cs, Rs = p.full_obs(lin_m[1:], lin_P[1:], times)
            if mesh is not None:
                fi_m, fi_cov = sharded_parallel_affine_filter(Fs, bds, Qs, Hs, cs, Rs, m0, P0,
                                                              p.data, mesh, mesh_axis)
                sm_m, sm_P = sharded_parallel_affine_smoother(Fs, bds, Qs, fi_m, fi_cov, mesh,
                                                              mesh_axis)
            else:
                fi_m, fi_cov = parallel_affine_filter(Fs, bds, Qs, Hs, cs, Rs, m0, P0, p.data)
                sm_m, sm_P = parallel_affine_smoother(Fs, bds, Qs, fi_m, fi_cov)
            # smooth the prior-time state to refresh the step-0 linearization
            Pp1 = symmetrize(Fs[0] @ P0 @ Fs[0].T + Qs[0])
            G0 = pd_solve_small(Pp1, Fs[0] @ P0).T
            P0_s = symmetrize(P0 + G0 @ (sm_P[:, :, 0] - Pp1) @ G0.T)
        m0_s = m0 + G0 @ (sm_m[:, 0] - (Fs[0] @ m0 + bds[0]))
        return (torch.cat([m0_s[None], sm_m.T]), torch.cat([P0_s[None], sm_P.permute(2, 0, 1)]),
                fi_m, fi_cov, sm_m, sm_P)

    lin_m = _initial_trajectory(p, init, block_len, warmup)
    lin_P = P0.expand((p.n_steps + 1,) + P0.shape)
    for _ in range(iterations):
        lin_m, lin_P, fi_m, fi_P, sm_m, sm_P = one_pass(lin_m, lin_P)
    if sqrt:
        fi_P = torch.einsum("ijn,kjn->ikn", fi_P, fi_P)
    return IteratedSmootherResult(fi_mean=fi_m, fi_cov=fi_P, sm_mean=sm_m, sm_cov=sm_P)
