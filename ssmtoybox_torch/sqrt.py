"""Square-root filters and smoothers (counterpart of :mod:`ssmtoybox_tpu.sqrt`).

The full-covariance filters of :mod:`ssmtoybox_torch.ssinf` carry
covariances and refactorize them every step.  These carry the lower Cholesky
factor itself (Van der Merwe and Wan's square-root UKF, for any classical
sigma-point rule and for single-output BQ transforms):

* the covariance stays positive definite by construction, so float32
  (``dtype=torch.float32``) works where the plain recursion loses
  definiteness;
* each factorization is a QR of weighted sigma-point deviations
  (:func:`~ssmtoybox_torch.utils.linalg.tria`), negative covariance weights
  and the gain downdates are rank-1 updates
  (:func:`~ssmtoybox_torch.utils.linalg.cholupdate_small`), and the gain
  takes two triangular solves.

A BQ transform's covariance ``fx Wc fx^T - m m^T + emv I`` factors exactly
because ``Wc - wm wm^T`` is positive semi-definite: its factor ``L_w`` is
computed once, at build time, and each step factors ``[fx L_w, sqrt(emv) I,
noise]`` (TPQ scales the EMV columns from the function values).  The RTS
smoothers factor the joint (x_pred, x_prev) deviations once a step
(classical rules), or closed-form joint columns built on the Schur residual
of the weights (BQ dynamics).  Non-additive noise augments the state: the
augmented factor is ``blkdiag(S, chol(noise cov))``, with jitter columns
``sqrt(1e-9) I`` in place of the additive noise factor.  The Student forms
run the same algebra on factors of scale matrices, with the predictive scale
``(nu - 2) / nu`` as a column multiplier and the posterior rescale ``(nu +
d^T d) / (nu + dim_y)`` as a scalar on the downdated factor.

Conventions of the port: a factory's function takes one record (dim_y, N)
or a batch (M, dim_y, N) and runs one loop over time for the whole batch
(the JAX package ``vmap``s; the port's outputs gain a leading M).  Measurement
``k`` is processed with both models at time ``k - 1``.  ``dtype=None`` is
float64; constants (points, weights, the weight factors, the noise factors)
are computed in float64 on the host, as the JAX package does with NumPy, and
cast once.  Float32 products run without TF32 whatever the process's switch.
A step reads nothing back from the card.
"""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass

import numpy as np
import torch

from .bq.kernels import RBFGauss, RBFStudent
from .bq.transforms import BQTransform, StudentTProcessTransform
from .mtran import (FullySymmetricStudentTransform, GaussHermiteTransform, SigmaPointTransform,
                    SphericalRadialTransform, UnscentedTransform, apply_f_columns)
from .online import streaming_api
from .utils.linalg import cholupdate_small, tri_solve_small, tria

__all__ = ["SqrtFilterResult", "make_sqrt_filter", "make_sqrt_smoother",
           "SquareRootKalman", "SqrtOnlineState", "SqrtStepInfo",
           "make_online_sqrt_filter", "FixedLagSqrtState",
           "make_fixed_lag_sqrt_smoother", "SqrtStudentFilterResult",
           "make_sqrt_studentian_filter", "make_sqrt_studentian_smoother",
           "SqrtStudentOnlineState", "make_online_sqrt_student_filter",
           "SquareRootStudent", "FixedLagSqrtStudentState",
           "make_fixed_lag_sqrt_student_smoother"]


@dataclass
class SqrtFilterResult:
    """Stacked square-root forward-pass moments, time last: ``fi_mean``
    (D, N), ``fi_sqrt`` (D, D, N) lower Cholesky factors and the predicted
    pairs; a batch has a leading M."""

    fi_mean: torch.Tensor
    fi_sqrt: torch.Tensor
    pr_mean: torch.Tensor
    pr_sqrt: torch.Tensor


@dataclass
class SqrtStudentFilterResult:
    """Stacked square-root Student moments, time last: ``fi_smat_sqrt``
    factors the filtered scale matrices, ``fi_cov_sqrt`` the pre-rescale
    matrix the reference stores as the "covariance", ``dof_fi`` (N,) the
    accumulated degrees of freedom.  The moment covariance of a filtered
    marginal is ``dof / (dof - 2) S S^T``."""

    fi_mean: torch.Tensor
    fi_cov_sqrt: torch.Tensor
    fi_smat_sqrt: torch.Tensor
    dof_fi: torch.Tensor
    pr_mean: torch.Tensor
    pr_smat_sqrt: torch.Tensor


# ---------------------------------------------------------------------------
# build-time pieces
# ---------------------------------------------------------------------------

def _host(a) -> np.ndarray:
    """``a`` as a float64 NumPy array (a tensor is copied off its device)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu()
    return np.asarray(a, dtype=np.float64)


def _caster(device, dtype):
    """``cast(a)``: ``a`` as a ``dtype`` tensor on ``device``; arrays go
    through float64, so a float32 constant is rounded once."""
    def cast(a):
        if isinstance(a, torch.Tensor):
            return a.to(device=device, dtype=dtype)
        return torch.as_tensor(np.asarray(a, dtype=np.float64), device=device).to(dtype)
    return cast


def _resolve_dtype(dtype) -> torch.dtype:
    if dtype is None:
        return torch.float64
    if dtype not in (torch.float64, torch.float32):
        raise ValueError(f"dtype must be None, torch.float64 or torch.float32; got {dtype!r}")
    return dtype


@contextlib.contextmanager
def _ieee_matmul():
    """Float32 products in full precision whatever the process's TF32 switch."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _ieee(fn):
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with _ieee_matmul():
            return fn(*args, **kwargs)
    return run


def _rule_arrays(tf, what: str):
    """(unit points, wm, diagonal wc, indices of the negative weights) of a
    classical sigma-point transform, on the host."""
    if not isinstance(tf, SigmaPointTransform):
        raise TypeError(
            f"this square-root component needs a classical sigma-point transform "
            f"for the {what} model (SR/UT/GH/FS rules); got {type(tf).__name__}")
    xi, wm = _host(tf.unit_sp), _host(tf.wm)
    if tf.wc_diag is not None:
        wc = _host(tf.wc_diag)
    else:
        Wc = _host(tf.Wc)
        # exact check: dropping small off-diagonal weights would compute with
        # a truncated rule
        if np.any(Wc != np.diag(np.diag(Wc))):
            raise TypeError(f"{what} transform has a non-diagonal covariance-"
                            f"weight matrix; square-root form requires a "
                            f"classical rule")
        wc = np.diag(Wc)
    neg = tuple(int(i) for i in np.nonzero(wc < 0)[0])
    return xi, wm, wc, neg


def _psd_chol(P: np.ndarray) -> np.ndarray:
    """Lower factor of a noise covariance, with an eigh fallback for a PSD one."""
    try:
        return np.linalg.cholesky(P)
    except np.linalg.LinAlgError:
        w, v = np.linalg.eigh((P + P.T) / 2.0)
        return v * np.sqrt(np.clip(w, 0.0, None))[None, :]


def _shape(data) -> tuple:
    return tuple(data.shape) if hasattr(data, "shape") else np.shape(data)


def _check_record(data, dim_y: int):
    """The class API's single-record entry points refuse a batch."""
    shape = _shape(data)
    if len(shape) != 2 or shape[0] != dim_y:
        raise ValueError(
            f"data must be (dim_y={dim_y}, num_steps); got {shape}. "
            "For a batch of trajectories use forward_pass_batch((M, dim_y, N)).")
    return data


def _check_record_batch(data_batch, dim_y: int):
    """The class API's batch entry points refuse a single record."""
    shape = _shape(data_batch)
    if len(shape) != 3 or shape[1] != dim_y:
        raise ValueError(
            f"data_batch must be (num_traj, dim_y={dim_y}, num_steps); got "
            f"{shape}. For a single trajectory use forward_pass((dim_y, N)).")
    return data_batch


def _jit_cols(d_: int) -> np.ndarray:
    """Jitter columns for non-additive models, whose factors can be exactly
    singular (the bilinear UNGM-NA measurement maps every point to 0 at a
    zero mean)."""
    return np.sqrt(1e-9) * np.eye(d_)


def _lead(cols: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Constant columns ``cols`` (R, C) broadcast over ``like``'s batch."""
    return cols.expand(like.shape[:-2] + cols.shape)


def _sqrt_from_deviations(dev, sqrt_pos, noise_cols, wc, neg_idx):
    """Factor of ``dev diag(wc) dev^T + noise_cols noise_cols^T``: QR over the
    positively weighted columns, rank-1 downdates for the negative weights."""
    S = tria(torch.cat([dev * sqrt_pos, _lead(noise_cols, dev)], dim=-1))
    for i in neg_idx:
        S = cholupdate_small(S, dev[..., :, i], wc[i])
    return S


def _transform_core(tf, what: str, cast, np_dtype, state_dim: int):
    """The square-root pieces of a transform: ``(points, wm, factor, cross,
    statics)`` with ``factor(fx, dfx, noise_cols, out_sqrt_scale=None) -> S``
    and ``cross(S_in, dX_in, fx, dfx) -> P_xy``, for classical rules and
    single-output BQ transforms.  ``statics`` holds what the smoothers' joint
    factorization needs; ``state_dim`` trims a BQ transform's cross weights
    to the state (non-additive models augment the input)."""
    if isinstance(tf, SigmaPointTransform):
        xi, wm, wc, neg = _rule_arrays(tf, what)
        wc_ = cast(wc)
        sqrt_pos = cast(np.sqrt(np.clip(wc, 0.0, None)))

        def factor(fx, dfx, noise_cols, out_sqrt_scale=None):
            # out_sqrt_scale scales the transform's columns, not the noise's
            # (the Student recursion's predictive scale); the downdates scale
            # with the deviations
            dev = dfx if out_sqrt_scale is None else dfx * out_sqrt_scale
            return _sqrt_from_deviations(dev, sqrt_pos, noise_cols, wc, neg)

        def cross(S_in, dX_in, fx, dfx):
            return (dX_in * wc_) @ dfx.mT

        statics = dict(sqrt_pos_d=sqrt_pos, wc_d=wc, neg_d=neg, xi_d=xi, wc_d_np=wc)
        return cast(xi), cast(wm), factor, cross, statics

    if isinstance(tf, BQTransform):
        pts, wm = _host(tf.points), _host(tf.wm)
        # Wc - wm wm^T = iK Cov[k(x, X)] iK is PSD by construction; eigh-clip
        # absorbs the round-off negatives of a singular rule
        C = _host(tf.Wc) - np.outer(wm, wm)
        C = (C + C.T) / 2.0
        s, v = np.linalg.eigh(C)
        L_w = v * np.sqrt(np.clip(s, 0.0, None))[None, :]
        Wcc = _host(tf.Wcc)[:state_dim]
        # a slightly negative EMV degrades to no inflation, not a NaN column
        emv = float(np.clip(_host(tf.model_var), 0.0, None))
        wm_, Wcc_, L_w_ = cast(wm), cast(Wcc), cast(L_w)
        sqrt_emv = np_dtype(np.sqrt(emv))
        eyes = {}

        def eye(e):
            if e not in eyes:
                eyes[e] = torch.eye(e, dtype=wm_.dtype, device=wm_.device)
            return eyes[e]

        if isinstance(tf, StudentTProcessTransform):
            # TPQ: the EMV scale (nu - 2 + f iK f^T) / (nu - 2 + N) from fx
            iK_ = cast(_host(tf.iK))
            nu, num_pts = float(tf.nu), float(pts.shape[-1])
            emv2 = float(sqrt_emv * sqrt_emv)

            def emv_cols(fx):
                scale_d = (nu - 2.0 + ((fx @ iK_) * fx).sum(-1)) / (nu - 2.0 + num_pts)
                se = torch.sqrt(torch.clamp(scale_d, min=0.0) * emv2)
                return se[..., None, :] * eye(fx.shape[-2])
        else:
            def emv_cols(fx):
                e = fx.shape[-2]
                return (float(sqrt_emv) * eye(e)).expand(fx.shape[:-2] + (e, e))

        def factor(fx, dfx, noise_cols, out_sqrt_scale=None):
            # the EMV columns read the unscaled fx (TPQ); out_sqrt_scale
            # multiplies the transform's columns only
            tcols = torch.cat([fx @ L_w_, emv_cols(fx)], dim=-1)
            if out_sqrt_scale is not None:
                tcols = tcols * out_sqrt_scale
            return tria(torch.cat([tcols, _lead(noise_cols, fx)], dim=-1))

        def cross(S_in, dX_in, fx, dfx):
            # the reference's cross-covariance is uncentred: chol R iK fx^T
            return (S_in @ Wcc_) @ fx.mT

        # host pieces only: the smoothers derive their residual factor from
        # them, so a filter pays nothing for it (and an RQ kernel filters)
        kernel = getattr(getattr(tf, "model", None), "kernel", None)
        statics = dict(bq=True, C_np=C, Wcc_np=Wcc, emv_cols_b=emv_cols, cast_b=cast,
                       kernel_b=kernel)
        return cast(pts), wm_, factor, cross, statics

    raise TypeError(
        f"square-root filtering needs a classical sigma-point transform or a "
        f"single-output BQ transform for the {what} model; got {type(tf).__name__} "
        f"— multi-output BQ transforms carry per-output weight tensors and are "
        f"only supported on the full-covariance path")


def _noise_pieces(mod, cov, mean, pts, cast, dim_x, dim_out, root=1.0, gain=None):
    """``(cols, mean_, dX_bot)`` of a model's noise: additive, the factor
    columns (``gain`` in front, ``root`` the Student scale's square root);
    non-additive, jitter columns, the noise mean and the noise block of the
    augmented deviations ``root chol(cov) xi[dim_x:]``."""
    if mod.noise_additive:
        L = _psd_chol(cov)
        return cast(root * (L if gain is None else gain @ L)), None, None
    return (cast(_jit_cols(dim_out)), cast(mean),
            cast(root * _psd_chol(cov) @ _host(pts)[dim_x:]))


def _propagator(f, pts, wm, dim_x, noise_mean, dX_bot):
    """``prop(m, S, time) -> (mean, fX, dfX, dX)``: sigma points of ``(m,
    S S^T)`` (augmented with the noise block for a non-additive model)
    through ``f``, their weighted mean and deviations, and the state block of
    the input deviations."""
    pts_x = pts[:dim_x]

    def prop(m, S, time):
        dX = S @ pts_x
        if noise_mean is None:
            X = m[..., None] + dX
        else:
            m_aug = torch.cat([m, noise_mean.expand(m.shape[:-1] + noise_mean.shape)], dim=-1)
            X = m_aug[..., None] + torch.cat([dX, _lead(dX_bot, dX)], dim=-2)
        # the models' parameters are float64 tensors, which torch does not
        # promote float32 operands to: evaluate in float64, as the JAX
        # package's promotion does, and cast back
        fX = apply_f_columns(f, X.double(), time).to(S.dtype)
        m_f = fX @ wm
        return m_f, fX, fX - m_f[..., None], dX

    return prop


def _gain(S_yy, P_xy):
    """``K = P_xy (S_yy S_yy^T)^-1`` by two triangular substitutions."""
    B = tri_solve_small(S_yy, P_xy.mT, lower=True)
    return tri_solve_small(S_yy.mT, B, lower=False).mT


def _downdate(S, U):
    """Factor of ``S S^T - U U^T``, a rank-1 downdate a column of ``U``."""
    for j in range(U.shape[-1]):
        S = cholupdate_small(S, U[..., :, j], -1.0)
    return S


def _sqrt_machinery(mod_dyn, mod_obs, tf_dyn, tf_obs, dtype):
    """Validate a configuration and build the Gaussian step core.

    Returns ``(cores, cast, m0, S0, dim_y)``: ``cores['step'](m, S, y, time)
    -> (m_pr, S_pr, y_pr, S_yy, m_fi, S_fi)`` is one predict and update of a
    batch; ``time_dev`` and ``meas`` are its halves (the smoothers factor the
    time update's deviations jointly); ``m0``, ``S0`` the prior on the host.
    """
    dtype = _resolve_dtype(dtype)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    cast = _caster(mod_dyn.device, dtype)
    m0_np, P0_np = (_host(a) for a in mod_dyn.init_rv.get_stats()[:2])
    S0_np = _psd_chol(P0_np)
    dim_x = m0_np.shape[0]

    pts_d, wm_d, factor_d, _, statics_d = _transform_core(tf_dyn, "dynamics", cast, np_dtype,
                                                          dim_x)
    pts_o, wm_o, factor_o, cross_o, _ = _transform_core(tf_obs, "measurement", cast, np_dtype,
                                                        dim_x)
    q_mean, q_cov = (_host(a) for a in mod_dyn.noise_rv.get_stats()[:2])
    r_mean, r_cov = (_host(a) for a in mod_obs.noise_rv.get_stats()[:2])
    dim_y = r_cov.shape[0] if mod_obs.noise_additive else int(mod_obs.dim_out)
    Sq, q_mean_, dX_bot_d = _noise_pieces(mod_dyn, q_cov, q_mean, pts_d, cast, dim_x, dim_x,
                                          gain=_host(mod_dyn.noise_gain))
    Sr, r_mean_, dX_bot_o = _noise_pieces(mod_obs, r_cov, r_mean, pts_o, cast, dim_x,
                                          int(mod_obs.dim_out))
    time_dev = _propagator(mod_dyn.dyn_eval, pts_d, wm_d, dim_x, q_mean_, dX_bot_d)
    meas_prop = _propagator(mod_obs.meas_eval, pts_o, wm_o, dim_x, r_mean_, dX_bot_o)

    def meas_core(m_pr, S_pr, y, time):
        """Factor-form measurement update (measurement model at ``time``, as
        the full-covariance filters have it)."""
        y_pr, hX, dhx, dX = meas_prop(m_pr, S_pr, time)
        S_yy = factor_o(hX, dhx, Sr)
        K = _gain(S_yy, cross_o(S_pr, dX, hX, dhx))
        m_fi = m_pr + (K @ (y - y_pr)[..., None])[..., 0]
        return y_pr, S_yy, m_fi, _downdate(S_pr, K @ S_yy)

    def step_core(m, S, y, time):
        m_pr, fX, dfx, _ = time_dev(m, S, time)
        S_pr = factor_d(fX, dfx, Sq)
        y_pr, S_yy, m_fi, S_fi = meas_core(m_pr, S_pr, y, time)
        return m_pr, S_pr, y_pr, S_yy, m_fi, S_fi

    is_bq_dyn = statics_d.get("bq", False)
    cores = dict(step=step_core, time_dev=time_dev, meas=meas_core,
                 statics=dict(statics_d, Sq=Sq), classical_dyn=not is_bq_dyn, bq_dyn=is_bq_dyn)
    return cores, cast, m0_np, S0_np, dim_y


def _as_batch(data):
    """``(data as a batch, whether it was one record)``."""
    return (data[None], True) if data.ndim == 2 else (data, False)


def _unbatch(res, single: bool):
    if not single:
        return res
    return type(res)(*(getattr(res, f)[0] for f in res.__dataclass_fields__))


def _initial(cast, m0, S0, init_mean, init_sqrt, M):
    m = m0 if init_mean is None else cast(init_mean)
    S = S0 if init_sqrt is None else cast(init_sqrt)
    return m.expand((M,) + m.shape[-1:]), S.expand((M,) + S.shape[-2:])


def _stack(outs):
    return (torch.stack(s, dim=-1) for s in zip(*outs))


def make_sqrt_filter(mod_dyn, mod_obs, tf_dyn, tf_obs, dtype=None):
    """Build a square-root Gaussian filter.

    Returns ``filter_fn(data, init_mean=None, init_sqrt=None) ->
    SqrtFilterResult`` over a record (dim_y, N) or a batch (M, dim_y, N).
    ``dtype=torch.float32`` runs the whole recursion in float32.
    """
    cores, cast, m0_np, S0_np, _ = _sqrt_machinery(mod_dyn, mod_obs, tf_dyn, tf_obs, dtype)
    step_core = cores["step"]
    m0, S0 = cast(m0_np), cast(S0_np)

    @_ieee
    def filter_fn(data, init_mean=None, init_sqrt=None):
        data, single = _as_batch(cast(data))
        m, S = _initial(cast, m0, S0, init_mean, init_sqrt, data.shape[0])
        outs = []
        for k in range(1, data.shape[-1] + 1):
            m_pr, S_pr, _, _, m, S = step_core(m, S, data[..., k - 1], k - 1)
            outs.append((m, S, m_pr, S_pr))
        return _unbatch(SqrtFilterResult(*_stack(outs)), single)

    return filter_fn


# ---------------------------------------------------------------------------
# RTS smoothing
# ---------------------------------------------------------------------------

def _rule_recon_scalar(st_) -> float:
    """``c`` with ``sum_i wc_i xi_i xi_i^T = c I`` for the dynamics rule (1
    for SR/UT/GH, ``dof / (dof - 2)`` for the FS Student rule); a rule that
    reconstructs no scalar multiple of identity is refused."""
    recon = st_["xi_d"] @ np.diag(st_["wc_d_np"]) @ st_["xi_d"].T
    c = float(np.trace(recon) / recon.shape[0])
    atol = 1000.0 * float(np.finfo(np.asarray(st_["wc_d_np"]).dtype).eps)
    if not np.allclose(recon, c * np.eye(recon.shape[0]), atol=atol * max(1.0, abs(c))):
        raise TypeError(
            "square-root Student smoothing needs a sigma-point rule whose "
            "covariance weights reconstruct a scalar multiple of identity "
            f"(sum wc_i xi_i xi_i^T = c I); this rule reconstructs\n{recon}")
    return c


def _check_identity_reconstruction(st_):
    """The Gaussian joint factorization reconstructs the filtered covariance
    as ``S (sum_i wc_i xi_i xi_i^T) S^T``: only rules with ``c = 1`` are
    right there (the FS Student rule would inflate every smoothed
    covariance by ``dof / (dof - 2)``)."""
    c = _rule_recon_scalar(st_)
    if abs(c - 1.0) > 1e-9:
        raise TypeError(
            "square-root smoothing requires a sigma-point rule whose "
            "covariance weights reconstruct identity (sum wc_i xi_i xi_i^T "
            f"= I); this rule reconstructs {c:.6g} * I (the FS Student rule "
            "scales by dof/(dof-2)) — use the full-covariance smoother or "
            "the Student square-root smoother for it")


def _split_joint(L, dim):
    """``(L11, G, R22)`` of a joint factor: the predicted factor, the
    smoother gain ``L21 L11^-1`` and the conditional factor."""
    L11, L21, R22 = L[..., :dim, :dim], L[..., dim:, :dim], L[..., dim:, dim:]
    Gt = tri_solve_small(L11.mT, L21.mT, lower=False)
    return L11, Gt.mT, R22


def _classical_joint(st_, dfx, dX_in, dim, ssc=None):
    """Factor of the joint (x_pred, x_prev) deviations of a classical rule,
    ``[[dfx w, Sq], [dX w, 0]]`` (times the Student ``ssc`` on the
    deviations), negative weights as downdates of the stacked deviation."""
    sqrt_pos, Sq = st_["sqrt_pos_d"], st_["Sq"]
    a, b = dfx * sqrt_pos, dX_in * sqrt_pos
    if ssc is not None:
        a, b = a * ssc, b * ssc
    zeros = dX_in.new_zeros(dX_in.shape[:-1] + (Sq.shape[-1],))
    top = torch.cat([a, _lead(Sq, dfx)], dim=-1)
    bot = torch.cat([b, zeros], dim=-1)
    L = tria(torch.cat([top, bot], dim=-2))
    for i in st_["neg_d"]:
        v = torch.cat([dfx[..., :, i], dX_in[..., :, i]], dim=-1)
        L = cholupdate_small(L, v if ssc is None else ssc[..., 0] * v, st_["wc_d"][i])
    return _split_joint(L, dim)


def _kernel_weighting_scalar(kern) -> float:
    """Covariance scalar ``kappa`` of a BQ kernel's weighting density: 1 for
    the Gaussian RBF, ``dof / (dof - 2)`` for the Student-weighted RBF."""
    if isinstance(kern, RBFStudent):          # a subclass of RBFGauss: test it first
        return float(kern.dof) / (float(kern.dof) - 2.0)
    if isinstance(kern, RBFGauss):
        return 1.0
    raise TypeError(
        f"square-root BQ smoothing needs a kernel whose weighting-density "
        f"covariance is a known scalar multiple of identity (RBF-Gauss or "
        f"RBF-Student); got {type(kern).__name__} (a transform built from "
        f"weights alone has no kernel: build it from its model)")


def _bq_joint_pieces(st_):
    """``(kappa, Wcc^T / sqrt(kappa), W_hat)``: the BQ joint columns'
    constants, with ``W_hat W_hat^T = (Wc - wm wm^T) - Wcc^T Wcc / kappa``
    the PSD Schur residual under the kernel's weighting measure."""
    kap = _kernel_weighting_scalar(st_["kernel_b"])
    C2 = st_["C_np"] - (1.0 / kap) * (st_["Wcc_np"].T @ st_["Wcc_np"])
    C2 = (C2 + C2.T) / 2.0
    s2, v2 = np.linalg.eigh(C2)
    cast = st_["cast_b"]
    return (kap, cast(st_["Wcc_np"].T / np.sqrt(kap)),
            cast(v2 * np.sqrt(np.clip(s2, 0.0, None))[None, :]))


def _bq_joint(st_, WccT, W_hat, root_kap, fX, S, dim, ssc=None):
    """Factor of the closed-form BQ joint columns ``[[fx Wcc^T/sqrt(k), fx
    W_hat, emv, Sq], [sqrt(k) S, 0, 0, 0]]`` (the transform's columns and
    the bottom block times the Student ``ssc``)."""
    Sq = st_["Sq"]
    tcols = torch.cat([fX @ WccT, fX @ W_hat, st_["emv_cols_b"](fX)], dim=-1)
    if ssc is None:
        bot = root_kap * S
    else:
        tcols, bot = ssc * tcols, (root_kap * ssc) * S
    top = torch.cat([tcols, _lead(Sq, fX)], dim=-1)
    pad = S.new_zeros(S.shape[:-1] + (top.shape[-1] - dim,))
    L = tria(torch.cat([top, torch.cat([bot, pad], dim=-1)], dim=-2))
    return _split_joint(L, dim)


def _make_predict_joint(cores, dim):
    """``predict_joint(m, S, time) -> (m_pr, S_pr, G, R22)``: the time update
    as the leading block of the joint factor, the smoother gain and the
    conditional factor, for classical or BQ dynamics."""
    st_, time_dev = cores["statics"], cores["time_dev"]
    if cores["classical_dyn"]:
        _check_identity_reconstruction(st_)

        def predict_joint(m, S, time):
            m_pr, _, dfx, dX_in = time_dev(m, S, time)
            return (m_pr,) + _classical_joint(st_, dfx, dX_in, dim)
        return predict_joint

    kap, WccT, W_hat = _bq_joint_pieces(st_)
    if kap > 1.0 + 1e-9:
        # with kappa > 1 the Gaussian conditional P_fi - G P_pr G^T can be
        # indefinite: no factor exists (the Student smoother's predictive
        # scale compensates kappa)
        raise TypeError(
            f"square-root GAUSSIAN smoothing cannot drive a Student-weighted "
            f"kernel (weighting covariance {kap:.4f} x identity > identity): "
            f"the conditional covariance P_fi - G P_pr G^T is indefinite — "
            f"use the Student square-root smoother "
            f"(make_sqrt_studentian_smoother) or the full-covariance "
            f"gaussian_smoother")
    root_kap = float(np.sqrt(kap))

    def predict_joint(m, S, time):
        m_pr, fX, _, _ = time_dev(m, S, time)
        L11, G, R22 = _bq_joint(st_, WccT, W_hat, root_kap, fX, S, dim)
        if kap != 1.0:
            for j in range(dim):
                R22 = cholupdate_small(R22, S[..., :, j], 1.0 - kap)
        return m_pr, L11, G, R22
    return predict_joint


def _rts_back(fi_m, fi_S, pr_m, Gs, R22s):
    """The array square-root RTS pass over lists of time slices: ``m_sm =
    m_fi + G (m_sm_next - m_pr_next)``, ``S_sm = tria([R22, G S_sm_next])``
    with the gain and conditional factor of the time update into the next
    slice; returns the smoothed slices, oldest first."""
    m, S = fi_m[-1], fi_S[-1]
    out = [(m, S)]
    for j in range(len(fi_m) - 2, -1, -1):
        G = Gs[j + 1]
        m = fi_m[j] + (G @ (m - pr_m[j + 1])[..., None])[..., 0]
        S = tria(torch.cat([R22s[j + 1], G @ S], dim=-1))
        out.append((m, S))
    return out[::-1]


def make_sqrt_smoother(mod_dyn, mod_obs, tf_dyn, tf_obs, dtype=None):
    """Build a square-root RTS smoother (textbook indexing).

    Returns ``smooth_fn(data, init_mean=None, init_sqrt=None) ->
    (SqrtFilterResult, sm_mean (D, N), sm_sqrt (D, D, N))`` (a leading M for
    a batch).  The forward pass factors the joint time-update deviations
    ``[[dfx w, S_q], [dX w, 0]] -> [[S_pr, 0], [L21, R22]]``, which gives the
    gain ``G = L21 S_pr^-1`` and the factor ``R22`` of ``P_fi - G P_pr
    G^T``; the backward pass is one QR a step.  BQ dynamics factor the
    closed-form joint columns instead.  (:func:`ssmtoybox_torch.ssinf.
    gaussian_smoother` keeps the reference's off-by-one layout; this one is
    textbook only.)
    """
    cores, cast, m0_np, S0_np, _ = _sqrt_machinery(mod_dyn, mod_obs, tf_dyn, tf_obs, dtype)
    meas_core, dim = cores["meas"], S0_np.shape[0]
    predict_joint = _make_predict_joint(cores, dim)
    m0, S0 = cast(m0_np), cast(S0_np)

    @_ieee
    def smooth_fn(data, init_mean=None, init_sqrt=None):
        data, single = _as_batch(cast(data))
        m, S = _initial(cast, m0, S0, init_mean, init_sqrt, data.shape[0])
        outs, Gs, R22s = [], [], []
        for k in range(1, data.shape[-1] + 1):
            m_pr, S_pr, G, R22 = predict_joint(m, S, k - 1)
            _, _, m, S = meas_core(m_pr, S_pr, data[..., k - 1], k - 1)
            outs.append((m, S, m_pr, S_pr))
            Gs.append(G)
            R22s.append(R22)
        fi_m, fi_S, pr_m, _ = zip(*outs)
        sm_m, sm_S = _stack(_rts_back(fi_m, fi_S, pr_m, Gs, R22s))
        res = _unbatch(SqrtFilterResult(*_stack(outs)), single)
        return (res, sm_m[0], sm_S[0]) if single else (res, sm_m, sm_S)

    return smooth_fn


# ---------------------------------------------------------------------------
# streaming
# ---------------------------------------------------------------------------

@dataclass
class SqrtOnlineState:
    """Streaming square-root carry: ``mean`` (D,) or (B, D), lower factor
    ``sqrt`` (D, D) or (B, D, D), ``step`` the 1-based index of the next
    measurement."""

    mean: torch.Tensor
    sqrt: torch.Tensor
    step: torch.Tensor


@dataclass
class SqrtStepInfo:
    """A step's predicted measurement, innovation and the lower factor of the
    innovation covariance (NIS gating is two triangular solves away)."""

    y_pred: torch.Tensor
    innov: torch.Tensor
    innov_sqrt: torch.Tensor


def _keep(observed, new, old):
    """``new`` where ``observed`` (B,), else ``old``."""
    return torch.where(observed.reshape(observed.shape + (1,) * (new.ndim - 1)), new, old)


def _guarded(pair):
    init, step = pair
    return init, _ieee(step)


def make_online_sqrt_filter(mod_dyn, mod_obs, tf_dyn, tf_obs, batch: bool = False,
                            donate: bool = True, dtype=None):
    """``(init, step)`` for streaming square-root filtering, the factor-form
    twin of :func:`ssmtoybox_torch.online.make_online_filter`:
    ``init(batch_size=None) -> SqrtOnlineState``, ``step(state, y,
    observed=True) -> (SqrtOnlineState, SqrtStepInfo)``; ``batch``,
    ``donate`` and dropouts as there.  In float32 the served state is half
    the bytes of the float64 full-covariance one and positive definite by
    construction."""
    cores, cast, m0_np, S0_np, _ = _sqrt_machinery(mod_dyn, mod_obs, tf_dyn, tf_obs, dtype)
    step_core = cores["step"]
    m0, S0 = cast(m0_np), cast(S0_np)

    def leaves():
        return dict(mean=m0, sqrt=S0, step=torch.ones((), dtype=torch.int64, device=m0.device))

    def one(state, y, observed, time):
        m_pr, S_pr, y_pr, S_yy, m_fi, S_fi = step_core(state.mean, state.sqrt, y, time)
        new = SqrtOnlineState(mean=_keep(observed, m_fi, m_pr), sqrt=_keep(observed, S_fi, S_pr),
                              step=state.step + 1)
        return new, SqrtStepInfo(y_pred=y_pr, innov=y - y_pr, innov_sqrt=S_yy)

    return _guarded(streaming_api(SqrtOnlineState, leaves, one, batch, donate, cast=cast))


@dataclass
class FixedLagSqrtState:
    """Streaming square-root fixed-lag carry: the filter state and ring
    buffers of the last ``lag`` steps, oldest first (a leading batch
    dimension with ``batch=True``): filtered means and factors, and the gain,
    conditional factor and predicted mean of the time update INTO each
    slot."""

    mean: torch.Tensor
    sqrt: torch.Tensor
    step: torch.Tensor
    buf_fi_m: torch.Tensor
    buf_fi_S: torch.Tensor
    buf_G: torch.Tensor
    buf_R22: torch.Tensor
    buf_pr_m: torch.Tensor


def _fresh_bufs(m0, S0, lag):
    """The windows' padding: the prior, and zero gains, with which the
    backward pass carries the padded slots through unchanged."""
    dim = m0.shape[-1]
    return dict(buf_fi_m=m0.expand((lag,) + m0.shape), buf_fi_S=S0.expand((lag,) + S0.shape),
                buf_G=S0.new_zeros((lag, dim, dim)), buf_R22=S0.expand((lag,) + S0.shape),
                buf_pr_m=m0.expand((lag,) + m0.shape))


def _shift_window(state, lag, m_new, S_new, G, R22, m_pr):
    """The buffers shifted by one slot, the newest step last, and the
    lagged smoothed estimate ``(sm_mean, sm_sqrt)`` of the window."""
    shift = lambda buf, new: torch.cat([buf[:, 1:], new[:, None]], dim=1)
    bufs = dict(buf_fi_m=shift(state.buf_fi_m, m_new), buf_fi_S=shift(state.buf_fi_S, S_new),
                buf_G=shift(state.buf_G, G), buf_R22=shift(state.buf_R22, R22),
                buf_pr_m=shift(state.buf_pr_m, m_pr))
    slots = lambda name: [bufs[name][:, j] for j in range(lag)]
    sm = _rts_back(slots("buf_fi_m"), slots("buf_fi_S"), slots("buf_pr_m"), slots("buf_G"),
                   slots("buf_R22"))
    return bufs, sm[0]


def _check_lag(lag, online_name):
    if lag < 2:
        raise ValueError(f"fixed-lag smoothing needs lag >= 2; got {lag} "
                         f"(lag=1 is plain filtering — use {online_name})")


def make_fixed_lag_sqrt_smoother(mod_dyn, mod_obs, tf_dyn, tf_obs, lag: int,
                                 batch: bool = False, donate: bool = True, dtype=None):
    """``(init, step)`` for streaming fixed-lag smoothing in square-root form.

    ``step(state, y, observed=True) -> (FixedLagSqrtState, SqrtStepInfo,
    (sm_mean, sm_sqrt))`` emits the smoothed estimate of the state ``lag -
    1`` steps ago given all data so far, equal to the offline square-root
    RTS on the record cut there; meaningful once ``state.step > lag``.  Every
    buffered quantity is a factor and every backward update one QR.  With
    ``donate`` the shifted buffers are written into the state's own tensors.
    """
    _check_lag(lag, "make_online_sqrt_filter")
    cores, cast, m0_np, S0_np, _ = _sqrt_machinery(mod_dyn, mod_obs, tf_dyn, tf_obs, dtype)
    meas_core, dim = cores["meas"], S0_np.shape[0]
    predict_joint = _make_predict_joint(cores, dim)
    m0, S0 = cast(m0_np), cast(S0_np)

    def leaves():
        return dict(mean=m0, sqrt=S0, step=torch.ones((), dtype=torch.int64, device=m0.device),
                    **_fresh_bufs(m0, S0, lag))

    def one(state, y, observed, time):
        m_pr, S_pr, G, R22 = predict_joint(state.mean, state.sqrt, time)
        y_pr, S_yy, m_fi, S_fi = meas_core(m_pr, S_pr, y, time)
        m_new, S_new = _keep(observed, m_fi, m_pr), _keep(observed, S_fi, S_pr)
        bufs, sm = _shift_window(state, lag, m_new, S_new, G, R22, m_pr)
        new = FixedLagSqrtState(mean=m_new, sqrt=S_new, step=state.step + 1, **bufs)
        return new, SqrtStepInfo(y_pred=y_pr, innov=y - y_pr, innov_sqrt=S_yy), sm

    return _guarded(streaming_api(FixedLagSqrtState, leaves, one, batch, donate, cast=cast))


# ---------------------------------------------------------------------------
# class API
# ---------------------------------------------------------------------------

def _outer(S):
    """``S S^T`` of stacked factors (..., D, D, N)."""
    return torch.einsum("...ijn,...kjn->...ikn", S, S)


class SquareRootKalman:
    """Square-root Kalman filter with a classical rule (``points`` ``"sr"``,
    ``"ut"``, ``"gh"`` or ``"fs"``, hyperparameters ``point_hyp``) or
    prebuilt transforms ``tf_dyn`` and ``tf_obs`` (classical or
    single-output BQ: the square-root GPQ, BSQ and TPQ Kalman filters).
    ``forward_pass`` returns ``(fi_mean, fi_cov)`` with ``fi_cov = S S^T``;
    ``smooth`` the square-root RTS moments; ``dtype=torch.float32`` runs in
    float32."""

    SUPPORTED_POINTS = ("sr", "ut", "gh", "fs")

    @staticmethod
    def _make_rule(points, dim, point_hyp, device):
        hyp = dict(point_hyp or {})
        if points == "sr":
            return SphericalRadialTransform(dim, device=device)
        if points == "ut":
            return UnscentedTransform(dim, **hyp, device=device)
        if points == "gh":
            return GaussHermiteTransform(dim, **hyp, device=device)
        if points == "fs":
            return FullySymmetricStudentTransform(dim, **hyp, device=device)
        raise ValueError(f"unsupported point set {points!r}; choose from "
                         f"{SquareRootKalman.SUPPORTED_POINTS}")

    def __init__(self, dyn, obs, points: str = "ut", point_hyp=None, dtype=None,
                 tf_dyn=None, tf_obs=None):
        if (tf_dyn is None) != (tf_obs is None):
            raise ValueError("pass both tf_dyn and tf_obs, or neither")
        self.mod_dyn, self.mod_obs = dyn, obs
        if tf_dyn is not None:
            self.tf_dyn, self.tf_obs = tf_dyn, tf_obs
        else:
            self.tf_dyn = self._make_rule(points, dyn.dim_in, point_hyp, dyn.device)
            self.tf_obs = self._make_rule(points, obs.dim_in, point_hyp, dyn.device)
        self._filter = make_sqrt_filter(dyn, obs, self.tf_dyn, self.tf_obs, dtype=dtype)
        self._dtype = dtype
        self._smoother = None
        self._result = None

    def forward_pass(self, data):
        res = self._filter(_check_record(data, int(self.mod_obs.dim_out)))
        self._result = res
        return res.fi_mean, _outer(res.fi_sqrt)

    def forward_pass_batch(self, data_batch):
        res = self._filter(_check_record_batch(data_batch, int(self.mod_obs.dim_out)))
        self._result = res
        return res.fi_mean, _outer(res.fi_sqrt)

    def smooth(self, data):
        """Square-root RTS smoothing of one record (textbook indexing):
        ``(sm_mean, sm_cov)`` with ``sm_cov = S S^T``."""
        if self._smoother is None:
            self._smoother = make_sqrt_smoother(self.mod_dyn, self.mod_obs, self.tf_dyn,
                                                self.tf_obs, dtype=self._dtype)
        res, sm_m, sm_S = self._smoother(_check_record(data, int(self.mod_obs.dim_out)))
        self._result = res
        return sm_m, _outer(sm_S)

    def reset(self):
        self._result = None


# ---------------------------------------------------------------------------
# Student-t factor form
# ---------------------------------------------------------------------------

def _sqrt_student_machinery(mod_dyn, mod_obs, tf_dyn, tf_obs, dof, fixed_dof, dtype):
    """The Student step core on factors of scale matrices: the recursion of
    :func:`ssmtoybox_torch.ssinf.studentian_filter_batch`, with the
    predictive scale ``(nu_pr - 2) / nu_pr`` on the transform's columns and
    the posterior rescale ``(nu + d^T d) / (nu + dim_y)`` on the downdated
    factor, ``d`` one triangular solve against the innovation factor.

    Returns ``(cores, cast, m0, S0, dof0, dim_y)``; ``cores['step'](m, S,
    dof_fi, y, time) -> (m_pr, S_pr, y_pr, S_yy, m_fi, S_cov_fi, S_smat_fi,
    dof_next)`` with ``dof_fi`` (B,) in the recursion's dtype.
    """
    dtype = _resolve_dtype(dtype)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    cast = _caster(mod_dyn.device, dtype)
    if dof <= 2.0:                 # the full filter's guard
        dof = 4.0
    dof_f = float(dof)
    x0_mean, x0_smat, x0_dof = (_host(a) for a in mod_dyn.init_rv.get_stats())
    q_mean, q_cov, q_dof = (_host(a) for a in mod_dyn.noise_rv.get_stats())
    r_mean, r_cov, r_dof = (_host(a) for a in mod_obs.noise_rv.get_stats())
    dim_x, dim_y = x0_mean.shape[0], int(mod_obs.dim_out)
    q_dof_f, r_dof_f = float(q_dof), float(r_dof)
    init_scale = (dof_f - 2.0) / dof_f
    S0_np = _psd_chol(init_scale * x0_smat)
    sqrt_iscale = float(np.sqrt(init_scale))

    pts_d, wm_d, factor_d, _, statics_d = _transform_core(tf_dyn, "dynamics", cast, np_dtype,
                                                          dim_x)
    pts_o, wm_o, factor_o, cross_o, _ = _transform_core(tf_obs, "measurement", cast, np_dtype,
                                                        dim_x)
    # noise factors in scale form, (dof - 2) / dof times the covariances
    Sq, q_mean_, dX_bot_d = _noise_pieces(mod_dyn, q_cov, q_mean, pts_d, cast, dim_x, dim_x,
                                          root=sqrt_iscale, gain=_host(mod_dyn.noise_gain))
    Sr, r_mean_, dX_bot_o = _noise_pieces(mod_obs, r_cov, r_mean, pts_o, cast, dim_x, dim_y,
                                          root=sqrt_iscale)
    time_dev = _propagator(mod_dyn.dyn_eval, pts_d, wm_d, dim_x, q_mean_, dX_bot_d)
    meas_prop = _propagator(mod_obs.meas_eval, pts_o, wm_o, dim_x, r_mean_, dX_bot_o)
    dof_cap = min(q_dof_f, r_dof_f)
    scale_init = np_dtype(init_scale)

    def pred_scale(dof_fi):
        """The predictive scale ``(nu_pr - 2) / nu_pr`` (B,) and its root;
        ``fixed_dof`` keeps the heavy tails (``nu_pr = min(dof_fi, q_dof,
        r_dof)``)."""
        if fixed_dof:
            dof_pr = torch.clamp(dof_fi, max=dof_cap)
            scale = (dof_pr - 2.0) / dof_pr
        else:
            scale = torch.full_like(dof_fi, float(scale_init))
        return scale, torch.sqrt(scale)

    def meas_core(m_pr, S_pr, scale, ssc, dof_fi, y, time):
        y_pr, hX, dhx, dX = meas_prop(m_pr, S_pr, time)
        S_yy = factor_o(hX, dhx, Sr, out_sqrt_scale=ssc[:, None, None])
        K = _gain(S_yy, scale[:, None, None] * cross_o(S_pr, dX, hX, dhx))
        m_fi = m_pr + (K @ (y - y_pr)[..., None])[..., 0]
        S_cov_fi = _downdate(S_pr, K @ S_yy)
        # d^T d = r^T (S_yy S_yy^T)^-1 r does not depend on the factor's signs
        delta = tri_solve_small(S_yy, y - y_pr, lower=True)
        scale_fi = (dof_f + torch.sum(delta * delta, dim=-1)) / (dof_f + dim_y)
        S_smat_fi = torch.sqrt(scale_fi)[:, None, None] * S_cov_fi
        return y_pr, S_yy, m_fi, S_cov_fi, S_smat_fi, dof_fi + dim_y

    def step_core(m, S, dof_fi, y, time):
        scale, ssc = pred_scale(dof_fi)
        m_pr, fX, dfx, _ = time_dev(m, S, time)
        S_pr = factor_d(fX, dfx, Sq, out_sqrt_scale=ssc[:, None, None])
        return (m_pr, S_pr) + meas_core(m_pr, S_pr, scale, ssc, dof_fi, y, time)

    # the predictive scale's supremum, for the smoothers' existence check
    scale_sup = (dof_cap - 2.0) / dof_cap if fixed_dof else init_scale
    cores = dict(step=step_core, pred_scale=pred_scale, time_dev=time_dev, meas=meas_core,
                 statics_d=dict(statics_d, Sq=Sq), bq_dyn=statics_d.get("bq", False),
                 scale_sup=scale_sup)
    return cores, cast, x0_mean, S0_np, float(x0_dof), dim_y


def make_sqrt_studentian_filter(mod_dyn, mod_obs, tf_dyn, tf_obs, dof: float = 4.0,
                                fixed_dof: bool = True, dtype=None):
    """Build a square-root Student-t filter, the factor-form twin of
    :func:`ssmtoybox_torch.ssinf.studentian_filter`: ``filter_fn(data,
    init_mean=None, init_sqrt=None) -> SqrtStudentFilterResult`` over a
    record (dim_y, N) or a batch (M, dim_y, N).  ``init_sqrt`` factors the
    initial SCALE matrix (default the prior's ``(dof - 2) / dof`` scale).
    Works with the FS rule and single-output BQ transforms (GPQ on Student
    points, TPQ)."""
    cores, cast, m0_np, S0_np, dof0, _ = _sqrt_student_machinery(
        mod_dyn, mod_obs, tf_dyn, tf_obs, dof, fixed_dof, dtype)
    step_core = cores["step"]
    m0, S0 = cast(m0_np), cast(S0_np)

    @_ieee
    def filter_fn(data, init_mean=None, init_sqrt=None):
        data, single = _as_batch(cast(data))
        m, S = _initial(cast, m0, S0, init_mean, init_sqrt, data.shape[0])
        dof_fi = torch.full(data.shape[:1], dof0, dtype=m0.dtype, device=m0.device)
        outs = []
        for k in range(1, data.shape[-1] + 1):
            m_pr, S_pr, _, _, m, S_cov, S, dof_fi = step_core(m, S, dof_fi, data[..., k - 1],
                                                              k - 1)
            outs.append((m, S_cov, S, dof_fi, m_pr, S_pr))
        return _unbatch(SqrtStudentFilterResult(*_stack(outs)), single)

    return filter_fn


@dataclass
class SqrtStudentOnlineState:
    """Streaming square-root Student carry: mean, factor of the SCALE
    matrix, accumulated dof, 1-based step index."""

    mean: torch.Tensor
    sqrt: torch.Tensor
    dof: torch.Tensor
    step: torch.Tensor


def make_online_sqrt_student_filter(mod_dyn, mod_obs, tf_dyn, tf_obs, dof: float = 4.0,
                                    fixed_dof: bool = True, batch: bool = False,
                                    donate: bool = True, dtype=None):
    """``(init, step)`` for streaming square-root Student filtering, as
    :func:`make_online_sqrt_filter`; a dropped measurement keeps the
    predicted mean and scale and leaves the dof (no information arrived)."""
    cores, cast, m0_np, S0_np, dof0, _ = _sqrt_student_machinery(
        mod_dyn, mod_obs, tf_dyn, tf_obs, dof, fixed_dof, dtype)
    step_core = cores["step"]
    m0, S0 = cast(m0_np), cast(S0_np)

    def leaves():
        return dict(mean=m0, sqrt=S0, dof=cast(dof0),
                    step=torch.ones((), dtype=torch.int64, device=m0.device))

    def one(state, y, observed, time):
        m_pr, S_pr, y_pr, S_yy, m_fi, _, S_fi, dof_next = step_core(
            state.mean, state.sqrt, state.dof, y, time)
        new = SqrtStudentOnlineState(mean=_keep(observed, m_fi, m_pr),
                                     sqrt=_keep(observed, S_fi, S_pr),
                                     dof=_keep(observed, dof_next, state.dof),
                                     step=state.step + 1)
        return new, SqrtStepInfo(y_pred=y_pr, innov=y - y_pr, innov_sqrt=S_yy)

    return _guarded(streaming_api(SqrtStudentOnlineState, leaves, one, batch, donate,
                                  cast=cast))


class SquareRootStudent:
    """Square-root Student filter with the constructor of
    :class:`ssmtoybox_torch.ssinf.FullySymmetricStudent` (``degree`` and
    ``kappa`` pick the FS rule, the noise dofs shape its points), or
    prebuilt transforms ``tf_dyn`` and ``tf_obs`` (the factor-form GPQ
    Student and TP Student filters).  ``forward_pass`` returns ``(fi_mean,
    fi_cov)`` with ``fi_cov`` from the pre-rescale factor, the matrix the
    full filter reports; ``smooth`` the smoothed SCALE matrices."""

    def __init__(self, dyn, obs, degree: int = 3, kappa=None, dof: float = 4.0,
                 fixed_dof: bool = True, dtype=None, tf_dyn=None, tf_obs=None):
        if (tf_dyn is None) != (tf_obs is None):
            raise ValueError("pass both tf_dyn and tf_obs, or neither")
        self.mod_dyn, self.mod_obs = dyn, obs
        if tf_dyn is None:
            dyn_dof = min(dyn.init_rv.dof, dyn.noise_rv.dof)
            obs_dof = min(dyn_dof, obs.noise_rv.dof)
            tf_dyn = FullySymmetricStudentTransform(dyn.dim_in, degree, kappa, dyn_dof,
                                                    device=dyn.device)
            tf_obs = FullySymmetricStudentTransform(obs.dim_in, degree, kappa, obs_dof,
                                                    device=dyn.device)
        self.tf_dyn, self.tf_obs = tf_dyn, tf_obs
        self._filter = make_sqrt_studentian_filter(dyn, obs, tf_dyn, tf_obs, dof=dof,
                                                   fixed_dof=fixed_dof, dtype=dtype)
        self._opts = dict(dof=dof, fixed_dof=fixed_dof, dtype=dtype)
        self._smoother = None
        self._result = None

    def forward_pass(self, data):
        res = self._filter(_check_record(data, int(self.mod_obs.dim_out)))
        self._result = res
        return res.fi_mean, _outer(res.fi_cov_sqrt)

    def forward_pass_batch(self, data_batch):
        res = self._filter(_check_record_batch(data_batch, int(self.mod_obs.dim_out)))
        self._result = res
        return res.fi_mean, _outer(res.fi_cov_sqrt)

    def smooth(self, data):
        """Square-root Student RTS smoothing of one record (textbook
        indexing): ``(sm_mean, sm_smat)`` with ``sm_smat = S S^T``."""
        if self._smoother is None:
            self._smoother = make_sqrt_studentian_smoother(
                self.mod_dyn, self.mod_obs, self.tf_dyn, self.tf_obs, **self._opts)
        res, sm_m, sm_S = self._smoother(_check_record(data, int(self.mod_obs.dim_out)))
        self._result = res
        return sm_m, _outer(sm_S)

    def reset(self):
        self._result = None


def _make_student_predict_joint(cores, dim):
    """``predict_joint(m, S, dof_fi, time) -> (scale, ssc, m_pr, S_pr, G,
    R22)`` for the Student smoothers.

    The joint scale matrix carries the predictive scale ``s`` on its
    predicted and cross blocks but not on the previous filtered block, so
    the shared-deviation factor (bottom rows ``sqrt(s) dX``) reproduces ``s
    c P_fi`` there, ``c`` the rule's reconstruction scalar (the kernel's
    weighting scalar ``kappa`` for BQ dynamics).  The gain and the predicted
    factor are exact anyway; the conditional factor is repaired by the
    rank-``dim`` correction ``(1 - s c) P_fi``, signed rank-1 updates with
    the columns of ``S`` (zero for matched dofs).  ``s c > 1`` is refused:
    the conditional covariance would be indefinite.
    """
    st_ = cores["statics_d"]
    time_dev, pred_scale = cores["time_dev"], cores["pred_scale"]

    def check_exists(c, kind):
        sup = cores["scale_sup"] * c
        if sup > 1.0 + 1e-9:
            raise TypeError(
                f"square-root Student smoothing needs scale*c <= 1: the "
                f"predictive scale reaches {cores['scale_sup']:.4f} while the "
                f"{kind} reconstructs c={c:.4f} times identity "
                f"(scale*c={sup:.4f} > 1), so the conditional covariance "
                f"P_fi - G P_pr G^T is indefinite and has no factor — match "
                f"the rule/kernel dof to the filter and noise dofs, or use "
                f"the full-covariance studentian_smoother")

    def corrected(S, R22, beta):
        for j in range(dim):
            R22 = cholupdate_small(R22, S[..., :, j], beta)
        return R22

    if not cores["bq_dyn"]:
        c = _rule_recon_scalar(st_)
        check_exists(c, "dynamics rule")

        def predict_joint(m, S, dof_fi, time):
            scale, ssc = pred_scale(dof_fi)
            m_pr, _, dfx, dX_in = time_dev(m, S, time)
            L11, G, R22 = _classical_joint(st_, dfx, dX_in, dim, ssc=ssc[:, None, None])
            return scale, ssc, m_pr, L11, G, corrected(S, R22, 1.0 - scale * c)
        return predict_joint

    kap, WccT, W_hat = _bq_joint_pieces(st_)
    check_exists(kap, "kernel weighting density")
    root_kap = float(np.sqrt(kap))

    def predict_joint(m, S, dof_fi, time):
        scale, ssc = pred_scale(dof_fi)
        m_pr, fX, _, _ = time_dev(m, S, time)
        L11, G, R22 = _bq_joint(st_, WccT, W_hat, root_kap, fX, S, dim, ssc=ssc[:, None, None])
        return scale, ssc, m_pr, L11, G, corrected(S, R22, 1.0 - scale * kap)
    return predict_joint


def make_sqrt_studentian_smoother(mod_dyn, mod_obs, tf_dyn, tf_obs, dof: float = 4.0,
                                  fixed_dof: bool = True, dtype=None):
    """Square-root Student-t RTS smoother (textbook indexing), the factor
    twin of :func:`ssmtoybox_torch.ssinf.studentian_smoother`:
    ``smooth_fn(data, init_mean=None, init_sqrt=None) ->
    (SqrtStudentFilterResult, sm_mean, sm_sqrt)``, ``sm_sqrt`` factors of
    the smoothed SCALE matrices (times ``dof / (dof - 2)`` with the last
    ``dof_fi`` for moment covariances)."""
    cores, cast, m0_np, S0_np, dof0, _ = _sqrt_student_machinery(
        mod_dyn, mod_obs, tf_dyn, tf_obs, dof, fixed_dof, dtype)
    meas_core, dim = cores["meas"], S0_np.shape[0]
    predict_joint = _make_student_predict_joint(cores, dim)
    m0, S0 = cast(m0_np), cast(S0_np)

    @_ieee
    def smooth_fn(data, init_mean=None, init_sqrt=None):
        data, single = _as_batch(cast(data))
        m, S = _initial(cast, m0, S0, init_mean, init_sqrt, data.shape[0])
        dof_fi = torch.full(data.shape[:1], dof0, dtype=m0.dtype, device=m0.device)
        outs, Gs, R22s = [], [], []
        for k in range(1, data.shape[-1] + 1):
            scale, ssc, m_pr, S_pr, G, R22 = predict_joint(m, S, dof_fi, k - 1)
            _, _, m_fi, S_cov, S_fi, dof_next = meas_core(m_pr, S_pr, scale, ssc, dof_fi,
                                                          data[..., k - 1], k - 1)
            m, S, dof_fi = m_fi, S_fi, dof_next
            outs.append((m, S_cov, S, dof_fi, m_pr, S_pr))
            Gs.append(G)
            R22s.append(R22)
        fi_m, _, fi_S, _, pr_m, _ = zip(*outs)
        sm_m, sm_S = _stack(_rts_back(fi_m, fi_S, pr_m, Gs, R22s))
        res = _unbatch(SqrtStudentFilterResult(*_stack(outs)), single)
        return (res, sm_m[0], sm_S[0]) if single else (res, sm_m, sm_S)

    return smooth_fn


@dataclass
class FixedLagSqrtStudentState:
    """Streaming square-root Student fixed-lag carry: the filter state
    (mean, SCALE factor, dof) and the ring buffers of
    :class:`FixedLagSqrtState`."""

    mean: torch.Tensor
    sqrt: torch.Tensor
    dof: torch.Tensor
    step: torch.Tensor
    buf_fi_m: torch.Tensor
    buf_fi_S: torch.Tensor
    buf_G: torch.Tensor
    buf_R22: torch.Tensor
    buf_pr_m: torch.Tensor


def make_fixed_lag_sqrt_student_smoother(mod_dyn, mod_obs, tf_dyn, tf_obs, lag: int,
                                         dof: float = 4.0, fixed_dof: bool = True,
                                         batch: bool = False, donate: bool = True,
                                         dtype=None):
    """``(init, step)`` for streaming fixed-lag Student smoothing in
    square-root form, as :func:`make_fixed_lag_sqrt_smoother` with the
    Student joint pieces (the same ``scale*c <= 1`` constraint); emits the
    smoothed SCALE factor; a dropped measurement keeps the prediction and
    does not advance the dof."""
    _check_lag(lag, "make_online_sqrt_student_filter")
    cores, cast, m0_np, S0_np, dof0, _ = _sqrt_student_machinery(
        mod_dyn, mod_obs, tf_dyn, tf_obs, dof, fixed_dof, dtype)
    meas_core, dim = cores["meas"], S0_np.shape[0]
    predict_joint = _make_student_predict_joint(cores, dim)
    m0, S0 = cast(m0_np), cast(S0_np)

    def leaves():
        return dict(mean=m0, sqrt=S0, dof=cast(dof0),
                    step=torch.ones((), dtype=torch.int64, device=m0.device),
                    **_fresh_bufs(m0, S0, lag))

    def one(state, y, observed, time):
        scale, ssc, m_pr, S_pr, G, R22 = predict_joint(state.mean, state.sqrt, state.dof, time)
        y_pr, S_yy, m_fi, _, S_fi, dof_next = meas_core(m_pr, S_pr, scale, ssc, state.dof, y,
                                                        time)
        m_new, S_new = _keep(observed, m_fi, m_pr), _keep(observed, S_fi, S_pr)
        bufs, sm = _shift_window(state, lag, m_new, S_new, G, R22, m_pr)
        new = FixedLagSqrtStudentState(mean=m_new, sqrt=S_new,
                                       dof=_keep(observed, dof_next, state.dof),
                                       step=state.step + 1, **bufs)
        return new, SqrtStepInfo(y_pred=y_pr, innov=y - y_pr, innov_sqrt=S_yy), sm

    return _guarded(streaming_api(FixedLagSqrtStudentState, leaves, one, batch, donate,
                                  cast=cast))
