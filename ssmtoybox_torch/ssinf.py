"""Gaussian and Student-t filters and smoothers (counterpart of
:mod:`ssmtoybox_tpu.ssinf`).

The JAX package runs each trajectory's recursion as one ``lax.scan`` and
batches trajectories with ``vmap``.  Here the batch is a leading dimension
written out and the recursion is a Python loop over time, whose body is a few
dozen batched operations on the card; ``engine="dd"`` runs the whole record
in one CUDA kernel instead, for scalar UNGM configurations
(:mod:`ssmtoybox_torch.ops.scalar_filter`) and for the model pairs of
:mod:`ssmtoybox_torch.ops.vector_filter` (reentry and constant velocity with
the radar, the pendulum, the falling body with its range, the coordinated
turn with four bearings).

Layouts are the JAX package's: one trajectory has data (dim_y, N) and
moments ``fi_mean`` (D, N), ``fi_cov`` (D, D, N); a batch has data
(M, dim_y, N), ``fi_mean`` (M, D, N) and ``fi_cov`` (M, D, D, N).
Measurement ``k`` (1-based) is processed with the dynamics at time ``k - 1``.

Non-additive noise is augmented as in the JAX package: a model whose noise
enters its function is transformed at ``[m, noise mean]`` with the covariance
``block_diag(P, noise cov)``, and the cross-covariances are trimmed to the
state; the additive ``G Q G^T`` and ``R`` terms are added only where the noise
is additive.

The BQ transforms take per-call kernel parameters: ``theta_dyn`` /
``theta_obs`` of :func:`gaussian_filter` and :func:`iterated_gaussian_filter`
derive the weights once per call (the JAX package re-derives them inside its
scan body, every step, to the same values), and the filter's moments are
differentiable in them.  :func:`iterated_gaussian_filter` refines each
measurement update by statistical linear regression (:func:`slr_affine`)
about the current posterior.

Parity quirk kept from the reference: :func:`gaussian_smoother` with
``rts_full=False`` smooths indices ``0..N-3`` only and seeds the first update
with the filtered estimate of step ``N`` against the predictive moments of
step ``N - 1``.  :func:`studentian_filter_batch` keeps the quirks the JAX
package keeps: the scale-derived matrix stored as the covariance, the
measurement cross-covariance trimmed by the dynamics' ``dim_in`` and the
``dof <= 2`` reset.
"""
from __future__ import annotations

import math
import warnings
from dataclasses import dataclass

import torch

from .bq.gpqd import GaussianProcessDerTransform
from .bq.transforms import (BayesSardTransform, GaussianProcessTransform,
                            MultiOutputGaussianProcessTransform,
                            MultiOutputStudentTProcessTransform, StudentTProcessTransform)
from .mtran import (FullySymmetricStudentTransform, GaussHermiteTransform,
                    LinearizationTransform, SphericalRadialTransform, TaylorGPQDTransform,
                    TruncatedGaussHermiteTransform, TruncatedSphericalRadialTransform,
                    TruncatedUnscentedTransform, UnscentedTransform)
from .ops import scalar_filter as _sf
from .ops import vector_filter as _vf
from .utils.arrays import f64, map_tensors
from .utils.linalg import (block_diag, chol_small, gen_solve, pd_logdet, pd_solve_small,
                           symmetrize, tri_solve_small)

__all__ = [
    "FilterResult", "gaussian_filter", "gaussian_filter_batch", "gaussian_smoother",
    "slr_affine", "iterated_gaussian_filter", "IteratedPosteriorLinearizationKalman",
    "MultiOutputGaussianProcessKalman", "MultiOutputStudentProcessStudent",
    "StudentFilterResult", "studentian_filter", "studentian_filter_batch",
    "studentian_smoother",
    "StateSpaceInference", "GaussianInference", "ExtendedKalman", "UnscentedKalman",
    "CubatureKalman", "GaussHermiteKalman", "GaussianProcessKalman", "BayesSardKalman",
    "StudentProcessKalman", "TruncatedUnscentedKalman", "TruncatedCubatureKalman",
    "TruncatedGaussHermiteKalman", "GaussianProcessDerKalman", "ExtendedKalmanGPQD",
    "StudentianInference", "FullySymmetricStudent", "ExtendedStudent", "GPQStudent",
    "StudentProcessStudent", "marginal_filter_batch", "MarginalInference",
    "MarginalizedGaussianProcessKalman",
]

@dataclass
class FilterResult:
    """Stacked forward-pass moments, time last: filtered and predictive
    moments plus the dynamics cross-covariance the RTS pass consumes."""

    fi_mean: torch.Tensor
    fi_cov: torch.Tensor
    pr_mean: torch.Tensor
    pr_cov: torch.Tensor
    pr_xx_cov: torch.Tensor


@dataclass
class StudentFilterResult:
    """Stacked Student forward-pass moments, time last: filtered mean, the
    (pseudo-)covariance, the scale matrix and the degrees of freedom, plus the
    predictive scale-matrix moments :func:`studentian_smoother` consumes."""

    fi_mean: torch.Tensor
    fi_cov: torch.Tensor
    fi_smat: torch.Tensor
    dof_fi: torch.Tensor
    pr_mean: torch.Tensor
    pr_smat: torch.Tensor
    pr_xx_smat: torch.Tensor


def _augment(m, P, noise_mean, noise_cov):
    """The moments of ``[x, noise]`` for a batch ``m`` (M, D), ``P`` (M, D, D)
    and independent noise."""
    return (torch.cat([m, noise_mean.expand(m.shape[:-1] + noise_mean.shape)], dim=-1),
            block_diag(P, noise_cov))


def _gaussian_time_update(mod_dyn, mod_obs, tf_dyn, tf_obs, m, P, time):
    """One Gaussian time update for a batch ``m`` (M, D), ``P`` (M, D, D),
    non-additive noise augmented (module docstring).

    Returns predicted state moments, predicted measurement moments and the
    cross-covariances trimmed to the state.
    """
    q_mean, q_cov = mod_dyn.noise_rv.get_stats()[:2]
    r_mean, r_cov = mod_obs.noise_rv.get_stats()[:2]
    mean, cov = (m, P) if mod_dyn.noise_additive else _augment(m, P, q_mean, q_cov)
    x_mean_pr, x_cov_pr, xx_cov = tf_dyn.apply(mod_dyn.dyn_eval, mean, cov, time)
    if mod_dyn.noise_additive:
        G = mod_dyn.noise_gain
        x_cov_pr = x_cov_pr + G @ q_cov @ G.T
    mean, cov = ((x_mean_pr, x_cov_pr) if mod_obs.noise_additive
                 else _augment(x_mean_pr, x_cov_pr, r_mean, r_cov))
    y_mean_pr, y_cov_pr, xy_cov = tf_obs.apply(mod_obs.meas_eval, mean, cov, time)
    if mod_obs.noise_additive:
        y_cov_pr = y_cov_pr + r_cov
    d = mod_dyn.dim_state
    return x_mean_pr, x_cov_pr, xx_cov[..., :d], y_mean_pr, y_cov_pr, xy_cov[..., :d]


def _kalman_update(x_mean_pr, x_cov_pr, y_mean_pr, y_cov_pr, xy_cov, y):
    """Gaussian measurement update with the Cholesky-solved gain."""
    gain = pd_solve_small(y_cov_pr, xy_cov).mT
    x_mean_fi = x_mean_pr + (gain @ (y - y_mean_pr)[..., None])[..., 0]
    x_cov_fi = x_cov_pr - gain @ y_cov_pr @ gain.mT
    return x_mean_fi, x_cov_fi


def _smoothing_update(m_fi, P_fi, m_sm_next, P_sm_next, m_pr_next, P_pr_next, xx_cov_next):
    """RTS smoothing update."""
    gain = pd_solve_small(P_pr_next, xx_cov_next).mT
    m_sm = m_fi + (gain @ (m_sm_next - m_pr_next)[..., None])[..., 0]
    P_sm = P_fi + gain @ (P_sm_next - P_pr_next) @ gain.mT
    return m_sm, P_sm


def _with_theta(tf, theta):
    """``tf`` applying with the weights of the kernel parameters ``theta``,
    derived once (``tf`` itself for None)."""
    if theta is None:
        return tf
    if not hasattr(tf, "with_kern_par"):
        raise ValueError(f"kernel parameters given for a {type(tf).__name__}, which has "
                         "none: only the BQ transforms take theta")
    return tf.with_kern_par(theta)


def slr_affine(tf, f, mean, cov, time, theta=None):
    """Statistical linear regression of ``f`` about ``N(mean, cov)`` through
    the transform ``tf``, for a batch ``mean`` (M, D), ``cov`` (M, D, D):
    ``(A, b, Omega)`` with ``f(x) ~ A x + b + e``, ``e ~ N(0, Omega)``;
    ``A = C P^-1``, ``b = mu - A m``, ``Omega = S - A P A^T``."""
    mu, S, C = _with_theta(tf, theta).apply(f, mean, cov, time)
    A = pd_solve_small(cov, C.mT).mT                                    # (M, E, D)
    b = mu - (A @ mean[..., None])[..., 0]
    return A, b, symmetrize(S - A @ cov @ A.mT)


def _slr_obs(mod_obs, tf_obs, m, P, time):
    """The measurement's SLR about ``N(m, P)`` with its noise: ``(H, c,
    R_eff)``; non-additive noise regressed jointly, then folded in."""
    r_mean, r_cov = mod_obs.noise_rv.get_stats()[:2]
    if mod_obs.noise_additive:
        H, c, Om = slr_affine(tf_obs, mod_obs.meas_eval, m, P, time)
        return H, c, Om + r_cov
    A, c, Om = slr_affine(tf_obs, mod_obs.meas_eval, *_augment(m, P, r_mean, r_cov), time)
    d = m.shape[-1]
    H, Ar = A[..., :d], A[..., d:]
    return H, c + Ar @ r_mean, Om + Ar @ r_cov @ Ar.mT


def _relinearized_update(mod_obs, tf_obs, m_pr, P_pr, m, P, y, time):
    """One IPLF refinement: the Kalman update of the predictive ``(m_pr,
    P_pr)`` with the measurement linearized about the posterior ``(m, P)``."""
    H, c, R_eff = _slr_obs(mod_obs, tf_obs, m, P, time)
    S = symmetrize(H @ P_pr @ H.mT + R_eff)
    K = pd_solve_small(S, H @ P_pr).mT
    m_new = m_pr + (K @ (y - c - (H @ m_pr[..., None])[..., 0])[..., None])[..., 0]
    return m_new, symmetrize(P_pr - K @ S @ K.mT)


def _filter_f64(mod_dyn, mod_obs, tf_dyn, tf_obs, data, init_mean, init_cov,
                theta_dyn=None, theta_obs=None, iterations: int = 1) -> FilterResult:
    """The eager recursion over a batch ``data`` (M, dim_y, N): with
    ``theta_*`` the BQ transforms' weights are derived from them once, before
    the time loop; ``iterations - 1`` IPLF refinements follow each update."""
    tf_dyn, tf_obs = _with_theta(tf_dyn, theta_dyn), _with_theta(tf_obs, theta_obs)
    M, _, N = data.shape
    m0, P0 = mod_dyn.init_rv.get_stats()[:2]
    D = mod_dyn.dim_state
    m = f64(m0 if init_mean is None else init_mean, data.device).expand(M, D)
    P = f64(P0 if init_cov is None else init_cov, data.device).expand(M, D, D)
    outs = []
    for k in range(1, N + 1):
        m_pr, P_pr, xx, y_pr, S, xy = _gaussian_time_update(
            mod_dyn, mod_obs, tf_dyn, tf_obs, m, P, k - 1)
        y = data[..., k - 1]
        m, P = _kalman_update(m_pr, P_pr, y_pr, S, xy, y)
        for _ in range(iterations - 1):
            m, P = _relinearized_update(mod_obs, tf_obs, m_pr, P_pr, m, P, y, k - 1)
        outs.append((m, P, m_pr, P_pr, xx))
    fi_m, fi_P, pr_m, pr_P, pr_xx = (torch.stack(s, dim=-1) for s in zip(*outs))
    # one host check after the loop: a Cholesky that failed inside it left NaN
    # (utils.linalg.chol_small), as the JAX package does
    bad = int((~torch.isfinite(fi_P)).flatten(1).any(dim=1).sum())
    if bad:
        warnings.warn(f"{bad} of {M} trajectories lost positive definiteness; "
                      "their moments are NaN from that step on", RuntimeWarning)
    return FilterResult(fi_mean=fi_m, fi_cov=fi_P, pr_mean=pr_m, pr_cov=pr_P, pr_xx_cov=pr_xx)


def _filter_fused(mod_dyn, mod_obs, tf_dyn, tf_obs, data, params) -> FilterResult:
    m_fi, P_fi, m_pr, P_pr, xx = _sf.scalar_filter_moments(
        mod_dyn, mod_obs, tf_dyn, tf_obs, data, params=params)
    vec, mat = (lambda s: s.T[:, None, :]), (lambda s: s.T[:, None, None, :])
    return FilterResult(fi_mean=vec(m_fi), fi_cov=mat(P_fi), pr_mean=vec(m_pr),
                        pr_cov=mat(P_pr), pr_xx_cov=mat(xx))


def _filter_fused_vector(data, params) -> FilterResult:
    m_fi, P_fi, m_pr, P_pr, xx = _vf.vector_filter(params, data)
    vec, mat = (lambda s: s.permute(2, 1, 0)), (lambda s: s.permute(3, 1, 2, 0))
    return FilterResult(fi_mean=vec(m_fi), fi_cov=mat(P_fi), pr_mean=vec(m_pr),
                        pr_cov=mat(P_pr), pr_xx_cov=mat(xx))


def gaussian_filter_batch(mod_dyn, mod_obs, tf_dyn, tf_obs, data_batch,
                          init_mean=None, init_cov=None, engine: str = "f64") -> FilterResult:
    """Forward pass over a batch of measurement trajectories (M, dim_y, N).

    ``engine`` keeps the JAX package's names:

    - ``"f64"`` (default): the batched eager recursion in float64.
    - ``"dd"``: on the card, a fused whole-record CUDA kernel in native
      float64 (the JAX package's double-double engine is not needed there);
      on CPU tensors, the kernel's plain PyTorch version.  Scalar states run
      through :mod:`.ops.scalar_filter` (the UNGM transition with the UNGM,
      sine or range measurement, rules of any point count), states of
      dimension 2-8 through :mod:`.ops.vector_filter` (every transition of
      its table with every measurement of it, bearings from any number of
      sensors); models registered with ``ops.register_dyn_dd_vec`` /
      ``register_obs_dd_vec`` / ``register_dyn_dd`` / ``register_obs_dd``
      run in the same kernels (1-D in the scalar one, 2-8-D in the vector
      one).  Both take additive noise and classical rules with diagonal
      weights or BQ rules with a scalar model variance, what the JAX
      package's dd engine takes under the same registrations; anything
      either refuses raises ``ValueError`` naming the reason.
    - ``"auto"``: ``"dd"`` when the configuration supports it, else ``"f64"``.

    The fused results are views in the layout above of time-major streams.
    """
    if engine not in ("f64", "dd", "auto"):
        raise ValueError(f"engine must be 'f64', 'dd' or 'auto'; got {engine!r}")
    params = None
    if engine != "f64":
        lowering = _sf if mod_dyn.dim_state == 1 else _vf
        try:
            params = lowering.prepare(mod_dyn, mod_obs, tf_dyn, tf_obs, init_mean, init_cov)
        except ValueError as e:
            if engine == "dd":
                raise ValueError(f"engine='dd' cannot run this configuration: {e}") from e
    data = f64(data_batch, mod_dyn.device)
    if params is None:
        return _filter_f64(mod_dyn, mod_obs, tf_dyn, tf_obs, data, init_mean, init_cov)
    if mod_dyn.dim_state == 1:
        return _filter_fused(mod_dyn, mod_obs, tf_dyn, tf_obs, data, params)
    return _filter_fused_vector(data, params)


def _eager(mod_dyn, data, run) -> FilterResult:
    """``run`` on ``data`` as a batch: (dim_y, N) is a batch of one whose
    result loses the batch dimension again, (M, dim_y, N) stays a batch."""
    data = f64(data, mod_dyn.device)
    if data.ndim == 3:
        return run(data)
    res = run(data[None])
    return FilterResult(*(getattr(res, f)[0] for f in res.__dataclass_fields__))


def gaussian_filter(mod_dyn, mod_obs, tf_dyn, tf_obs, data, init_mean=None, init_cov=None,
                    theta_dyn=None, theta_obs=None) -> FilterResult:
    """Eager float64 forward pass of one trajectory ``data`` (dim_y, N), or
    of a batch (M, dim_y, N).  ``theta_dyn`` / ``theta_obs`` give the BQ
    transforms kernel parameters for this call (weights derived once, the
    moments differentiable in them); other transforms raise with a theta."""
    return _eager(mod_dyn, data, lambda d: _filter_f64(
        mod_dyn, mod_obs, tf_dyn, tf_obs, d, init_mean, init_cov, theta_dyn, theta_obs))


def iterated_gaussian_filter(mod_dyn, mod_obs, tf_dyn, tf_obs, data, iterations: int = 5,
                             init_mean=None, init_cov=None, theta_dyn=None,
                             theta_obs=None) -> FilterResult:
    """The iterated posterior-linearization filter (IPLF; Garcia-Fernandez et
    al., IEEE TSP 2015) of ``data`` (dim_y, N) or a batch (M, dim_y, N): each
    measurement update is repeated ``iterations - 1`` times with the
    measurement's SLR through ``tf_obs`` about the current posterior.
    ``iterations=1`` is the standard filter; the predictive moments are the
    standard ones, so :func:`gaussian_smoother` applies."""
    if iterations < 1:
        raise ValueError(f"iterations must be >= 1; got {iterations}")
    return _eager(mod_dyn, data, lambda d: _filter_f64(
        mod_dyn, mod_obs, tf_dyn, tf_obs, d, init_mean, init_cov, theta_dyn, theta_obs,
        iterations=int(iterations)))


def gaussian_smoother(result: FilterResult, rts_full: bool = False):
    """RTS backward pass over stacked forward moments, any leading batch dims.

    With ``rts_full=False`` (default) the reference's indexing is reproduced:
    entries ``N-2`` and ``N-1`` (0-based) keep their filtered values and the
    first update pairs ``fi[N-1]`` with the predictive moments of ``N-2``.
    ``rts_full=True`` smooths every step from the last filtered estimate.
    Returns ``(sm_mean, sm_cov)`` in the layout of ``fi_mean``/``fi_cov``.
    """
    return _rts(*(getattr(result, f) for f in
                  ("fi_mean", "fi_cov", "pr_mean", "pr_cov", "pr_xx_cov")),
                rts_full=rts_full)


def _rts(*moments, rts_full: bool):
    """The RTS recursion over stacked moments (time last)."""
    fi_m, fi_P, pr_m, pr_P, pr_xx = (torch.movedim(t, -1, 0) for t in moments)
    n = fi_m.shape[0]
    n_sm = max(n - 1 if rts_full else n - 2, 0)
    m_next, P_next = fi_m[-1], fi_P[-1]
    sm = []
    for k in range(n_sm - 1, -1, -1):
        m_next, P_next = _smoothing_update(fi_m[k], fi_P[k], m_next, P_next,
                                           pr_m[k + 1], pr_P[k + 1], pr_xx[k + 1])
        sm.append((m_next, P_next))
    sm_m, sm_P = fi_m, fi_P
    if sm:
        sm = sm[::-1]
        sm_m = torch.cat([torch.stack([s[0] for s in sm]), fi_m[n_sm:]])
        sm_P = torch.cat([torch.stack([s[1] for s in sm]), fi_P[n_sm:]])
    return torch.movedim(sm_m, 0, -1), torch.movedim(sm_P, 0, -1)


def studentian_filter_batch(mod_dyn, mod_obs, tf_dyn, tf_obs, data_batch,
                            dof: float = 4.0, fixed_dof: bool = True) -> StudentFilterResult:
    """Student-t forward pass over a batch of measurement trajectories
    (M, dim_y, N).

    The transforms act on scale matrices; non-additive noise is augmented
    with its scale matrix.  With ``fixed_dof`` the predictive scale uses
    ``min(dof_fi, q_dof, r_dof)``, else the filter's ``dof`` (``dof <= 2``
    becomes 4).  Layouts as :class:`FilterResult`; ``dof_fi`` is (M, N).

    The measurement cross-covariance is trimmed to the dynamics' ``dim_in``,
    as the JAX package does after the reference; with non-additive noise on
    both models that keeps noise columns in the gain, where the JAX package
    fails, so that case raises ``ValueError``.
    """
    if not (mod_dyn.noise_additive or mod_obs.noise_additive):
        raise ValueError("the Student filter trims the measurement cross-covariance to the "
                         "dynamics' dim_in, as the JAX package does: with non-additive noise "
                         "on both models the gain keeps noise rows; one of the two models "
                         "must have additive noise")
    if dof <= 2.0:
        dof = 4.0
    data = f64(data_batch, mod_dyn.device)
    M, _, N = data.shape
    x0_mean, x0_smat, x0_dof = mod_dyn.init_rv.get_stats()
    q_mean, q_cov, q_dof = mod_dyn.noise_rv.get_stats()
    r_mean, r_cov, r_dof = mod_obs.noise_rv.get_stats()
    G = mod_dyn.noise_gain
    init_scale = (dof - 2.0) / dof
    q_smat, r_smat = init_scale * q_cov, init_scale * r_cov
    GSGt = G @ q_smat @ G.T
    D, E = mod_dyn.dim_state, mod_obs.dim_out
    m = x0_mean.expand(M, D)
    smat = (init_scale * x0_smat).expand(M, D, D)
    dof_fi = float(x0_dof)
    outs = []
    for k in range(1, N + 1):
        if fixed_dof:
            dof_pr = min(dof_fi, q_dof, r_dof)
            scale = (dof_pr - 2.0) / dof_pr
        else:
            scale = (dof - 2.0) / dof
        mean, sm = ((m, smat) if mod_dyn.noise_additive
                    else _augment(m, smat, q_mean, q_smat))
        x_mean_pr, x_cov_pr, xx_cov = tf_dyn.apply(mod_dyn.dyn_eval, mean, sm, k - 1)
        x_smat_pr = scale * x_cov_pr
        if mod_dyn.noise_additive:
            x_smat_pr = x_smat_pr + GSGt
        xx_smat = scale * xx_cov[..., :D]
        mean, sm = ((x_mean_pr, x_smat_pr) if mod_obs.noise_additive
                    else _augment(x_mean_pr, x_smat_pr, r_mean, r_smat))
        y_mean_pr, y_cov_pr, xy_cov = tf_obs.apply(mod_obs.meas_eval, mean, sm, k - 1)
        y_smat_pr = scale * y_cov_pr
        if mod_obs.noise_additive:
            y_smat_pr = y_smat_pr + r_smat
        xy_smat = (scale * xy_cov)[..., :mod_dyn.dim_in]
        # measurement update
        gain = pd_solve_small(y_smat_pr, xy_smat).mT
        dy = data[..., k - 1] - y_mean_pr
        m = x_mean_pr + (gain @ dy[..., None])[..., 0]
        # the scale-derived matrix stored as the covariance (reference FIXME)
        P = x_smat_pr - gain @ y_smat_pr @ gain.mT
        delta = tri_solve_small(chol_small(y_smat_pr), dy)
        smat = ((dof + torch.sum(delta * delta, -1)) / (dof + E))[:, None, None] * P
        dof_fi = dof_fi + E
        outs.append((m, P, smat, x_mean_pr, x_smat_pr, xx_smat))
    fi_m, fi_P, fi_S, pr_m, pr_S, pr_xx = (torch.stack(s, dim=-1) for s in zip(*outs))
    dofs = x0_dof + E * torch.arange(1, N + 1, dtype=torch.float64, device=data.device)
    return StudentFilterResult(fi_mean=fi_m, fi_cov=fi_P, fi_smat=fi_S,
                               dof_fi=dofs.expand(M, N), pr_mean=pr_m, pr_smat=pr_S,
                               pr_xx_smat=pr_xx)


def studentian_filter(mod_dyn, mod_obs, tf_dyn, tf_obs, data,
                      dof: float = 4.0, fixed_dof: bool = True) -> StudentFilterResult:
    """Student-t forward pass of one trajectory ``data`` (dim_y, N): the
    batch path on a batch of one."""
    res = studentian_filter_batch(mod_dyn, mod_obs, tf_dyn, tf_obs,
                                  f64(data, mod_dyn.device)[None], dof, fixed_dof)
    return StudentFilterResult(*(getattr(res, f)[0] for f in res.__dataclass_fields__))


def studentian_smoother(result: StudentFilterResult, rts_full: bool = False):
    """RTS backward pass on the SCALE matrices (Piche, Sarkka & Hartikainen
    2012), any leading batch dims; ``rts_full`` as in
    :func:`gaussian_smoother`.  Returns ``(sm_mean, sm_smat)``; the moment
    covariance of a smoothed marginal is ``dof/(dof - 2) sm_smat`` with the
    terminal ``dof_fi``."""
    return _rts(result.fi_mean, result.fi_smat, result.pr_mean, result.pr_smat,
                result.pr_xx_smat, rts_full=rts_full)


# ---------------------------------------------------------------------------
# Class API mirroring the reference
# ---------------------------------------------------------------------------

class StateSpaceInference:
    """Stateful wrapper with the reference's API surface (``forward_pass``,
    ``backward_pass``, ``reset``); it caches the stacked moments between the
    passes."""

    def __init__(self, mod_dyn, mod_obs, tf_dyn, tf_obs):
        self.mod_dyn = mod_dyn
        self.mod_obs = mod_obs
        self.tf_dyn = tf_dyn
        self.tf_obs = tf_obs
        self.reset()

    def get_flag(self, key):
        return self.flags[key]

    def set_flag(self, key, value):
        self.flags[key] = value

    def _check_batch(self, data_batch) -> torch.Tensor:
        data_batch = f64(data_batch, self.mod_dyn.device)
        if data_batch.ndim != 3 or data_batch.shape[1] != self.mod_obs.dim_out:
            raise ValueError(
                f"data_batch must be (num_traj, dim_y={self.mod_obs.dim_out}, "
                f"num_steps); got {tuple(data_batch.shape)}. For a single trajectory "
                "use forward_pass((dim_y, N)).")
        return data_batch

    def forward_pass(self, data):
        data = f64(data, self.mod_dyn.device)
        if data.ndim != 2 or data.shape[0] != self.mod_obs.dim_out:
            raise ValueError(
                f"data must be (dim_y={self.mod_obs.dim_out}, num_steps); got "
                f"{tuple(data.shape)}. For a batch of trajectories use "
                "forward_pass_batch((M, dim_y, N)).")
        self._result = self._run_forward(data)
        self.fi_mean, self.fi_cov = self._result.fi_mean, self._result.fi_cov
        self.set_flag("filtered", True)
        return self.fi_mean, self.fi_cov

    def backward_pass(self, rts_full: bool = False):
        if not self.get_flag("filtered"):
            raise RuntimeError("forward_pass must run before backward_pass")
        self.sm_mean, self.sm_cov = self._run_backward(self._result, rts_full)
        self.set_flag("smoothed", True)
        return self.sm_mean, self.sm_cov

    def reset(self):
        self._result = None
        self.fi_mean = self.fi_cov = None
        self.sm_mean = self.sm_cov = None
        self.flags = {"filtered": False, "smoothed": False}

    def _run_forward(self, data):  # pragma: no cover - interface
        raise NotImplementedError

    def _run_backward(self, result, rts_full):  # pragma: no cover - interface
        raise NotImplementedError


class GaussianInference(StateSpaceInference):
    """Gaussian filter and RTS smoother."""

    def _run_forward(self, data):
        return gaussian_filter(self.mod_dyn, self.mod_obs, self.tf_dyn, self.tf_obs, data)

    def _run_backward(self, result, rts_full):
        return gaussian_smoother(result, rts_full=rts_full)

    def forward_pass_batch(self, data_batch, engine: str = "f64") -> FilterResult:
        """Filter a whole (M, dim_y, N) batch; ``engine`` as in
        :func:`gaussian_filter_batch`."""
        return gaussian_filter_batch(self.mod_dyn, self.mod_obs, self.tf_dyn, self.tf_obs,
                                     self._check_batch(data_batch), engine=engine)


class IteratedPosteriorLinearizationKalman(GaussianInference):
    """The IPLF with a classical sigma-point rule (``points`` ``"sr"``,
    ``"ut"``, ``"gh"`` or ``"fs"``, hyperparameters ``point_hyp``) and
    ``iterations`` linearizations of each measurement update; it runs
    eagerly (no engine)."""

    SUPPORTED_POINTS = ("sr", "ut", "gh", "fs")

    def __init__(self, dyn, obs, points: str = "ut", point_hyp=None, iterations: int = 5):
        hyp = dict(point_hyp or {})
        dev = dyn.device
        make = {"sr": lambda d: SphericalRadialTransform(d, device=dev),
                "ut": lambda d: UnscentedTransform(d, **hyp, device=dev),
                "gh": lambda d: GaussHermiteTransform(d, **hyp, device=dev),
                "fs": lambda d: FullySymmetricStudentTransform(d, **hyp, device=dev)}
        if points not in make:
            raise ValueError(f"unsupported point set {points!r}; choose from "
                             f"{self.SUPPORTED_POINTS}")
        if points == "sr" and hyp:
            raise ValueError("the spherical-radial rule takes no hyperparameters; got "
                             f"point_hyp={hyp}: drop it or pick points in ('ut', 'gh', 'fs')")
        if iterations < 1:
            raise ValueError(f"iterations must be >= 1; got {iterations}")
        super().__init__(dyn, obs, make[points](dyn.dim_in), make[points](obs.dim_in))
        self.iterations = int(iterations)

    def _run_forward(self, data):
        return iterated_gaussian_filter(self.mod_dyn, self.mod_obs, self.tf_dyn, self.tf_obs,
                                        data, self.iterations)

    def forward_pass_batch(self, data_batch) -> FilterResult:
        """Filter a whole (M, dim_y, N) batch."""
        return iterated_gaussian_filter(self.mod_dyn, self.mod_obs, self.tf_dyn, self.tf_obs,
                                        self._check_batch(data_batch), self.iterations)


class ExtendedKalman(GaussianInference):
    """Extended Kalman filter: linearization by the Jacobians of the
    functions the filter transforms."""

    def __init__(self, dyn, obs):
        super().__init__(dyn, obs, LinearizationTransform(dyn.dim_in, device=dyn.device),
                         LinearizationTransform(obs.dim_in, device=dyn.device))


class UnscentedKalman(GaussianInference):
    """Unscented Kalman filter."""

    def __init__(self, dyn, obs, kappa=None, alpha: float = 1.0, beta: float = 2.0):
        super().__init__(dyn, obs,
                         UnscentedTransform(dyn.dim_in, kappa, alpha, beta, device=dyn.device),
                         UnscentedTransform(obs.dim_in, kappa, alpha, beta, device=dyn.device))


class CubatureKalman(GaussianInference):
    """Cubature Kalman filter (spherical-radial rule)."""

    def __init__(self, dyn, obs):
        super().__init__(dyn, obs, SphericalRadialTransform(dyn.dim_in, device=dyn.device),
                         SphericalRadialTransform(obs.dim_in, device=dyn.device))


class GaussHermiteKalman(GaussianInference):
    """Gauss-Hermite Kalman filter, ``deg`` points a dimension."""

    def __init__(self, dyn, obs, deg: int = 3):
        super().__init__(dyn, obs, GaussHermiteTransform(dyn.dim_in, deg, device=dyn.device),
                         GaussHermiteTransform(obs.dim_in, deg, device=dyn.device))


class GaussianProcessKalman(GaussianInference):
    """Gaussian-process quadrature Kalman filter (GPQKF)."""

    def __init__(self, dyn, obs, kern_par_dyn, kern_par_obs, kernel: str = "rbf",
                 points: str = "ut", point_hyp=None):
        super().__init__(
            dyn, obs,
            GaussianProcessTransform(dyn.dim_in, dyn.dim_state, kern_par_dyn, kernel,
                                     points, point_hyp, device=dyn.device),
            GaussianProcessTransform(obs.dim_in, obs.dim_out, kern_par_obs, kernel,
                                     points, point_hyp, device=dyn.device))


class BayesSardKalman(GaussianInference):
    """Bayes-Sard quadrature Kalman filter (BSQKF): RBF kernel with a
    polynomial prior mean of multi-index ``mulind_dyn`` / ``mulind_obs`` (or
    an int total degree).  With a scalar model variance, ``engine="dd"`` runs
    its rules in the fused scalar or vector filter kernel."""

    def __init__(self, dyn, obs, kern_par_dyn, kern_par_obs, mulind_dyn=2, mulind_obs=2,
                 points: str = "ut", point_hyp=None):
        super().__init__(
            dyn, obs,
            BayesSardTransform(dyn.dim_in, dyn.dim_state, kern_par_dyn, mulind_dyn, points,
                               point_hyp, device=dyn.device),
            BayesSardTransform(obs.dim_in, obs.dim_out, kern_par_obs, mulind_obs, points,
                               point_hyp, device=dyn.device))


class StudentProcessKalman(GaussianInference):
    """TPQ Kalman filter: Student-t-process quadrature transforms (with
    ``dim_out=1``, as in the reference) in the Gaussian filter."""

    def __init__(self, dyn, obs, kern_par_dyn, kern_par_obs, kernel: str = "rbf",
                 points: str = "ut", point_hyp=None, nu: float = 3.0):
        super().__init__(
            dyn, obs,
            StudentTProcessTransform(dyn.dim_in, 1, kern_par_dyn, kernel, points, point_hyp,
                                     nu=nu, device=dyn.device),
            StudentTProcessTransform(obs.dim_in, 1, kern_par_obs, kernel, points, point_hyp,
                                     nu=nu, device=dyn.device))


class TruncatedUnscentedKalman(GaussianInference):
    """UKF whose measurement rule is truncated to the measurement's input
    (``obs.dim_in`` of ``obs.dim_state`` dimensions)."""

    def __init__(self, dyn, obs, kappa=None, alpha: float = 1.0, beta: float = 2.0):
        super().__init__(
            dyn, obs, UnscentedTransform(dyn.dim_in, kappa, alpha, beta, device=dyn.device),
            TruncatedUnscentedTransform(obs.dim_state, obs.dim_in, kappa, alpha, beta,
                                        device=dyn.device))


class TruncatedCubatureKalman(GaussianInference):
    """CKF whose measurement rule is truncated to the measurement's input."""

    def __init__(self, dyn, obs):
        super().__init__(dyn, obs, SphericalRadialTransform(dyn.dim_in, device=dyn.device),
                         TruncatedSphericalRadialTransform(obs.dim_state, obs.dim_in,
                                                           device=dyn.device))


class TruncatedGaussHermiteKalman(GaussianInference):
    """GHKF whose measurement rule is truncated to the measurement's input:
    ``obs.dim_in``, as the JAX package fixes the reference's ``dyn.dim_in``."""

    def __init__(self, dyn, obs, degree: int = 3):
        super().__init__(dyn, obs, GaussHermiteTransform(dyn.dim_in, degree, device=dyn.device),
                         TruncatedGaussHermiteTransform(obs.dim_state, obs.dim_in, degree,
                                                        device=dyn.device))


class GaussianProcessDerKalman(GaussianInference):
    """GPQ+D Kalman filter: GP quadrature observing the integrand's values and
    its Jacobians at the points ``which_der`` (RBF kernel)."""

    def __init__(self, dyn, obs, kern_par_dyn, kern_par_obs, points: str = "ut",
                 point_hyp=None, which_der=None):
        super().__init__(
            dyn, obs,
            GaussianProcessDerTransform(dyn.dim_in, dyn.dim_state, kern_par_dyn, points,
                                        point_hyp, which_der, device=dyn.device),
            GaussianProcessDerTransform(obs.dim_in, obs.dim_out, kern_par_obs, points,
                                        point_hyp, which_der, device=dyn.device))


class ExtendedKalmanGPQD(GaussianInference):
    """EKF through single-point GPQ+D (:class:`TaylorGPQDTransform`); the
    measurement transform takes ``obs.dim_state``, as in the JAX package."""

    def __init__(self, dyn, obs, rbf_par_dyn, rbf_par_obs):
        super().__init__(dyn, obs, TaylorGPQDTransform(dyn.dim_in, rbf_par_dyn, device=dyn.device),
                         TaylorGPQDTransform(obs.dim_state, rbf_par_obs, device=dyn.device))


class MultiOutputGaussianProcessKalman(GaussianInference):
    """GPQ Kalman filter with multi-output GP transforms, one kernel
    parameter row per output (EXPERIMENTAL in the reference: it may lose
    positive definiteness).  It runs eagerly: the fused engines refuse
    multi-output transforms."""

    def __init__(self, dyn, obs, kern_par_dyn, kern_par_obs, kernel: str = "rbf",
                 points: str = "ut", point_hyp=None):
        super().__init__(
            dyn, obs,
            MultiOutputGaussianProcessTransform(dyn.dim_in, dyn.dim_state, kern_par_dyn, kernel,
                                                points, point_hyp, device=dyn.device),
            MultiOutputGaussianProcessTransform(obs.dim_in, obs.dim_out, kern_par_obs, kernel,
                                                points, point_hyp, device=dyn.device))


class StudentianInference(StateSpaceInference):
    """Student-t filter and scale-matrix RTS smoother; ``sm_cov`` holds the
    smoothed scale matrices."""

    def __init__(self, mod_dyn, mod_obs, tf_dyn, tf_obs, dof: float = 4.0,
                 fixed_dof: bool = True):
        super().__init__(mod_dyn, mod_obs, tf_dyn, tf_obs)
        self.dof = 4.0 if dof <= 2.0 else float(dof)
        self.fixed_dof = bool(fixed_dof)

    def _run_forward(self, data):
        return studentian_filter(self.mod_dyn, self.mod_obs, self.tf_dyn, self.tf_obs, data,
                                 self.dof, self.fixed_dof)

    def _run_backward(self, result, rts_full):
        return studentian_smoother(result, rts_full=rts_full)

    def forward_pass_batch(self, data_batch) -> StudentFilterResult:
        """Filter a whole (M, dim_y, N) batch."""
        return studentian_filter_batch(self.mod_dyn, self.mod_obs, self.tf_dyn, self.tf_obs,
                                       self._check_batch(data_batch), self.dof,
                                       self.fixed_dof)


class FullySymmetricStudent(StudentianInference):
    """Fully-symmetric Student filter (FSQ)."""

    def __init__(self, dyn, obs, degree: int = 3, kappa=None, dof: float = 4.0,
                 fixed_dof: bool = True):
        dyn_dof = min(dyn.init_rv.dof, dyn.noise_rv.dof)
        obs_dof = min(dyn_dof, obs.noise_rv.dof)
        super().__init__(
            dyn, obs,
            FullySymmetricStudentTransform(dyn.dim_in, degree, kappa, dyn_dof, device=dyn.device),
            FullySymmetricStudentTransform(obs.dim_in, degree, kappa, obs_dof, device=dyn.device),
            dof, fixed_dof)


class ExtendedStudent(StudentianInference):
    """Student filter by linearization (the EKF's transforms on scale
    matrices)."""

    def __init__(self, dyn, obs, dof: float = 4.0, fixed_dof: bool = True):
        super().__init__(dyn, obs, LinearizationTransform(dyn.dim_in, device=dyn.device),
                         LinearizationTransform(obs.dim_in, device=dyn.device), dof, fixed_dof)


class GPQStudent(StudentianInference):
    """Student filter with GPQ transforms on fully-symmetric points and the
    Student-weighted RBF kernel (GPQSF).  The noise dofs shape the points
    only; ``mc_opts`` reach the kernel."""

    def __init__(self, dyn, obs, kern_par_dyn, kern_par_obs, point_hyp=None,
                 dof: float = 4.0, fixed_dof: bool = True, mc_opts=None):
        point_hyp = dict(point_hyp or {})
        mc_opts = dict(mc_opts or {})
        super().__init__(
            dyn, obs,
            GaussianProcessTransform(dyn.dim_in, 1, kern_par_dyn, "rbf-student", "fs",
                                     dict(point_hyp, dof=dyn.noise_rv.dof), device=dyn.device,
                                     **mc_opts),
            GaussianProcessTransform(obs.dim_in, 1, kern_par_obs, "rbf-student", "fs",
                                     dict(point_hyp, dof=obs.noise_rv.dof), device=dyn.device,
                                     **mc_opts),
            dof, fixed_dof)


class StudentProcessStudent(StudentianInference):
    """TPQSF: Student-t-process quadrature Student filter on fully-symmetric
    points.  ``compat_drop_nu`` as in :class:`StudentTProcessTransform`."""

    def __init__(self, dyn, obs, kern_par_dyn, kern_par_obs, point_par=None,
                 dof: float = 4.0, fixed_dof: bool = True, dof_tp: float = 4.0,
                 compat_drop_nu: bool = True, mc_opts=None):
        point_par = dict(point_par or {})
        super().__init__(
            dyn, obs,
            StudentTProcessTransform(dyn.dim_in, 1, kern_par_dyn, "rbf-student", "fs",
                                     dict(point_par, dof=dyn.noise_rv.dof), nu=dof_tp,
                                     compat_drop_nu=compat_drop_nu, mc_opts=mc_opts,
                                     device=dyn.device),
            StudentTProcessTransform(obs.dim_in, 1, kern_par_obs, "rbf-student", "fs",
                                     dict(point_par, dof=obs.noise_rv.dof), nu=dof_tp,
                                     compat_drop_nu=compat_drop_nu, mc_opts=mc_opts,
                                     device=dyn.device),
            dof, fixed_dof)


class MultiOutputStudentProcessStudent(StudentianInference):
    """TPQ Student filter with multi-output TP transforms on fully-symmetric
    points and the Student-weighted RBF kernel; each noise's ``dof`` shapes
    its transform's points only, ``mc_opts`` reach the kernels."""

    def __init__(self, dyn, obs, kern_par_dyn, kern_par_obs, point_par=None,
                 dof: float = 4.0, fixed_dof: bool = True, dof_tp: float = 4.0, mc_opts=None):
        point_par = dict(point_par or {})
        super().__init__(
            dyn, obs,
            MultiOutputStudentTProcessTransform(
                dyn.dim_in, dyn.dim_state, kern_par_dyn, "rbf-student", "fs",
                dict(point_par, dof=dyn.noise_rv.dof), nu=dof_tp, mc_opts=mc_opts,
                device=dyn.device),
            MultiOutputStudentTProcessTransform(
                obs.dim_in, obs.dim_out, kern_par_obs, "rbf-student", "fs",
                dict(point_par, dof=obs.noise_rv.dof), nu=dof_tp, mc_opts=mc_opts,
                device=dyn.device),
            dof, fixed_dof)


# ---------------------------------------------------------------------------
# Marginalized-parameter inference
# ---------------------------------------------------------------------------

def _marginal_time_update(mod_dyn, mod_obs, tf_dyn, tf_obs, theta, m, P, time, dyn_dim: int):
    """The time update of a batch ``m`` (B, D), ``P`` (B, D, D) through BQ
    transforms whose weights come from each member's own log kernel
    parameters ``theta`` (B, num_par): ``exp(theta[:, :dyn_dim])`` for the
    dynamics, the rest for the measurement."""
    return _gaussian_time_update(mod_dyn, mod_obs,
                                 tf_dyn.with_kern_par_batch(torch.exp(theta[:, :dyn_dim])),
                                 tf_obs.with_kern_par_batch(torch.exp(theta[:, dyn_dim:])),
                                 m, P, time)


def _quad_form(A, x):
    """``x^T A^-1 x`` of a batch of positive-definite ``A`` (B, n, n) and
    vectors ``x`` (B, n)."""
    return torch.sum(x * pd_solve_small(A, x[..., None])[..., 0], dim=-1)


def _grad_hess(fn, theta):
    """Gradient (B, P) and Hessian (B, P, P) of each member's objective,
    ``fn(theta)`` (B,) of ``theta`` (B, P): the gradient of the sum keeps its
    graph, and one batched backward pass through it (``is_grads_batched``, a
    tangent a parameter) gives every member's Hessian rows; members do not
    mix, so nothing (B P)^2 is formed."""
    with torch.enable_grad():
        th = theta.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(fn(th).sum(), th, create_graph=True)
        n = th.shape[-1]
        tangents = torch.eye(n, dtype=th.dtype, device=th.device)[:, None, :].expand(
            n, th.shape[0], n)
        (H,) = torch.autograd.grad(g, th, grad_outputs=tangents, is_grads_batched=True)
    return g.detach(), H.movedim(0, -2)


def marginal_filter_batch(mod_dyn, mod_obs, tf_dyn, tf_obs, data_batch, par_mean0, par_cov0,
                          newton_iters: int = 15, damping: float = 1e-3, inner_dtype=None):
    """Gaussian filter of a batch (M, dim_y, N) with the BQ transforms' log
    kernel parameters marginalized, each trajectory with its own parameter
    posterior: the safeguarded damped-Newton Laplace search of
    :meth:`MarginalInference.forward_pass_compiled`.

    Each step ``k`` (1-based): the default-parameter time update at ``k - 1``
    is stored for the smoother; ``newton_iters`` Newton steps on the negative
    log posterior (no constants) from the previous posterior mean, each with
    the exact Hessian, damped by ``damping I``, its length capped at 3, boxed
    to ``[-6, 6]`` and accepted only if the objective stays finite and does
    not increase, else a gradient step of length 0.1, else none; the Laplace
    covariance ``sym((H + damping I)^-1) + jitter I``, the previous one kept
    where it is not positive definite; a Kalman update at each of the 2 P
    spherical-radial nodes of the parameter posterior, with the transforms at
    time ``k``, in float64; the nodes' moments collapsed with equal weights
    (``sum w_p P_p``, symmetrized), the previous state kept where that is not
    finite or not positive definite.  Every accept or keep choice is a
    ``torch.where``: nothing reads the card's values back to the host.

    ``inner_dtype="float32"`` runs the search (objective, gradient, Hessian,
    node placement) in float32 on float32 copies of the models and
    transforms, with a jitter of 1e-6 (1e-8 in float64); the state moments,
    the node updates and the collapse stay float64.

    Returns the :class:`FilterResult` and the last step's parameter
    posterior ``(mean (M, P), cov (M, P, P), neg_log_post (M,))`` in the
    search's dtype.
    """
    data = f64(data_batch, mod_dyn.device)
    M, _, N = data.shape
    dev = data.device
    idt = torch.float64 if inner_dtype is None else getattr(torch, str(inner_dtype))
    n_par = int(par_mean0.shape[-1])
    n_pts = 2 * n_par
    dyn_dim = mod_dyn.dim_in + 1
    # the spherical-radial rule (points.sr_points / sr_weights), made on the
    # device: nothing in this function copies from the host once data is there
    eye64 = torch.eye(n_par, dtype=torch.float64, device=dev)
    upts = (math.sqrt(n_par) * torch.cat([eye64, -eye64], dim=1)).to(idt)
    wts = torch.full((n_pts,), 1.0 / n_pts, dtype=torch.float64, device=dev)
    if idt == torch.float64:
        mod_dyn_i, mod_obs_i, tf_dyn_i, tf_obs_i = mod_dyn, mod_obs, tf_dyn, tf_obs
    else:
        mod_dyn_i, mod_obs_i, tf_dyn_i, tf_obs_i = map_tensors(
            (mod_dyn, mod_obs, tf_dyn, tf_obs),
            lambda t: t.to(idt) if t.is_floating_point() else t)
    eye = torch.eye(n_par, dtype=idt, device=dev).expand(M, n_par, n_par)
    jitter = (1e-8 if idt == torch.float64 else 1e-6) * eye
    m0, P0 = mod_dyn.init_rv.get_stats()[:2]
    D = mod_dyn.dim_state
    m, P = m0.expand(M, D), P0.expand(M, D, D)
    pm = f64(par_mean0, dev).to(idt).expand(M, n_par)
    pc = f64(par_cov0, dev).to(idt).expand(M, n_par, n_par)
    outs = []
    for k in range(1, N + 1):
        m_pr_d, P_pr_d, xx_d, _, _, _ = _gaussian_time_update(
            mod_dyn, mod_obs, tf_dyn, tf_obs, m, P, k - 1)
        y64 = data[..., k - 1]
        y, m_i, P_i = y64.to(idt), m.to(idt), P.to(idt)

        def neg_log_post(theta, y=y, m_i=m_i, P_i=P_i, k=k, pm=pm, pc=pc):
            # theta (r M, P): r candidates a trajectory, stacked
            tile = lambda t: t.repeat((theta.shape[0] // M,) + (1,) * (t.ndim - 1))
            _, _, _, y_pr, S, _ = _marginal_time_update(
                mod_dyn_i, mod_obs_i, tf_dyn_i, tf_obs_i, theta, tile(m_i), tile(P_i), k,
                dyn_dim)
            return 0.5 * (pd_logdet(S) + _quad_form(S, tile(y) - y_pr)
                          + _quad_form(tile(pc), theta - tile(pm)))

        theta, f_cur = pm, neg_log_post(pm)
        for _ in range(newton_iters):
            g, H = _grad_hess(neg_log_post, theta)
            delta = gen_solve(H + damping * eye, g)
            nrm = torch.linalg.vector_norm(delta, dim=-1, keepdim=True)
            delta = delta * torch.clamp(3.0 / (nrm + 1e-12), max=1.0)
            cand = torch.clamp(theta - delta, -6.0, 6.0)
            g_nrm = torch.linalg.vector_norm(g, dim=-1, keepdim=True)
            grad_step = torch.clamp(theta - 0.1 * g / (g_nrm + 1e-12), -6.0, 6.0)
            f_cand, f_grad = neg_log_post(torch.cat([cand, grad_step])).split(M)
            ok = torch.isfinite(f_cand) & (f_cand <= f_cur)
            ok_grad = torch.isfinite(f_grad) & (f_grad <= f_cur)
            theta = torch.where(ok[:, None], cand,
                                torch.where(ok_grad[:, None], grad_step, theta))
            f_cur = torch.where(ok, f_cand, torch.where(ok_grad, f_grad, f_cur))
        _, H = _grad_hess(neg_log_post, theta)
        pc_cand = symmetrize(gen_solve(H + damping * eye, eye)) + jitter
        L_cand = chol_small(pc_cand)
        pd_ok = torch.isfinite(L_cand).flatten(1).all(dim=1)[:, None, None]
        pc = torch.where(pd_ok, pc_cand, pc)
        L_pc = torch.where(pd_ok, L_cand, chol_small(pc))
        pm = theta

        # one Kalman update a node, all M x 2P of them as one batch, in float64
        nodes = (theta[:, :, None] + L_pc @ upts).to(torch.float64).mT.reshape(-1, n_par)
        rep = lambda t: t[:, None].expand((M, n_pts) + t.shape[1:]).reshape(
            (M * n_pts,) + t.shape[1:])
        m_pr, P_pr, _, y_pr, S, xy = _marginal_time_update(
            mod_dyn, mod_obs, tf_dyn, tf_obs, nodes, rep(m), rep(P), k, dyn_dim)
        means, covs = _kalman_update(m_pr, P_pr, y_pr, S, xy, rep(y64))
        m_new = torch.einsum("bpi,p->bi", means.reshape(M, n_pts, D), wts)
        P_new = symmetrize(torch.einsum("bpij,p->bij", covs.reshape(M, n_pts, D, D), wts))
        state_ok = (torch.isfinite(m_new).all(dim=-1)
                    & torch.isfinite(chol_small(P_new)).flatten(1).all(dim=1))
        m = torch.where(state_ok[:, None], m_new, m)
        P = torch.where(state_ok[:, None, None], P_new, P)
        outs.append((m, P, m_pr_d, P_pr_d, xx_d))
    fi_m, fi_P, pr_m, pr_P, pr_xx = (torch.stack(s, dim=-1) for s in zip(*outs))
    res = FilterResult(fi_mean=fi_m, fi_cov=fi_P, pr_mean=pr_m, pr_cov=pr_P, pr_xx_cov=pr_xx)
    return res, (pm, pc, f_cur)


class MarginalInference(GaussianInference):
    """Gaussian filter whose BQ transforms' log kernel parameters are
    marginalized: each measurement update approximates the parameters'
    posterior by Laplace's method and collapses the Gaussian mixture of the
    Kalman updates at its spherical-radial nodes.

    ``forward_pass`` is the reference's form: SciPy's BFGS on the negative
    log posterior (value and gradient by autograd, one host round trip an
    evaluation), log parameters clipped to ``[-8, 8]`` inside the likelihood
    with a quadratic penalty outside, the Laplace covariance BFGS's inverse
    Hessian plus ``1e-8 I``; where BFGS ends on a non-finite value the
    previous posterior is kept.  ``forward_pass_compiled`` and
    ``forward_pass_batch`` run the damped-Newton search of
    :func:`marginal_filter_batch` with ``newton_iters``, ``damping`` and
    ``inner_dtype`` (attributes, overridable per call).  The smoother
    (``backward_pass``) uses the default-parameter predictive moments stored
    before each update.  The prior over the ``dim_in + 1`` dynamics and
    ``dim_state + 1`` measurement log parameters is ``N(par_mean, par_cov)``,
    zeros and the identity by default.
    """

    def __init__(self, dyn, obs, tf_dyn, tf_obs, par_mean=None, par_cov=None):
        from .points import sr_points, sr_weights

        dev = dyn.device
        self.param_dyn_dim = dyn.dim_in + 1
        self.param_obs_dim = obs.dim_state + 1
        self.param_dim = self.param_dyn_dim + self.param_obs_dim
        kw = dict(dtype=torch.float64, device=dev)
        self.param_prior_mean = (torch.zeros(self.param_dim, **kw) if par_mean is None
                                 else f64(par_mean, dev))
        self.param_prior_cov = (torch.eye(self.param_dim, **kw) if par_cov is None
                                else f64(par_cov, dev))
        self.param_jitter = 1e-8 * torch.eye(self.param_dim, **kw)
        self.param_upts = f64(sr_points(self.param_dim), dev)
        self.param_wts = f64(sr_weights(self.param_dim), dev)
        self.param_pts_num = self.param_upts.shape[1]
        self.newton_iters = 15
        self.damping = 1e-3
        #: precision of the damped-Newton search: None (float64) or "float32"
        self.inner_dtype = None
        super().__init__(dyn, obs, tf_dyn, tf_obs)

    def reset(self):
        super().reset()
        self.param_mean = self.param_prior_mean
        self.param_cov = self.param_prior_cov

    def _predict_meas(self, theta, m, P, k):
        """The time update of a batch of states given log parameters
        ``theta`` (B, P), clipped to ``[-8, 8]`` (beyond, ``exp`` overflows
        the kernel expectations)."""
        return _marginal_time_update(self.mod_dyn, self.mod_obs, self.tf_dyn, self.tf_obs,
                                     torch.clamp(theta, -8.0, 8.0), m, P, k,
                                     self.param_dyn_dim)

    def _neg_log_post(self, theta, y, m, P, k, pm, pc):
        """Negative log posterior of the log parameters ``theta`` (P,) given
        the measurement ``y`` and the state ``N(m, P)``, with the Gaussian
        normalisers and the box penalty ``0.5 |theta - clip(theta)|^2``."""
        _, _, _, y_pr, S, _ = self._predict_meas(theta[None], m[None], P[None], k)
        log2pi = math.log(2.0 * math.pi)
        loglik = -0.5 * (pd_logdet(S[0]) + _quad_form(S, y[None] - y_pr)[0]
                         + y.shape[0] * log2pi)
        logprior = -0.5 * (pd_logdet(pc) + _quad_form(pc[None], (theta - pm)[None])[0]
                           + theta.shape[0] * log2pi)
        box = 0.5 * torch.sum((theta - torch.clamp(theta, -8.0, 8.0)) ** 2)
        return -(loglik + logprior) + box

    def _laplace_step(self, y, m, P, k):
        """BFGS Laplace approximation of the parameter posterior; keeps the
        previous one where BFGS ends on a non-finite point, value or inverse
        Hessian."""
        import numpy as np
        from scipy.optimize import minimize

        pm, pc = self.param_mean, self.param_cov
        dev = pm.device

        def obj(theta):
            th = torch.tensor(theta, dtype=torch.float64, device=dev, requires_grad=True)
            with torch.enable_grad():
                v = self._neg_log_post(th, y, m, P, k, pm, pc)
                (g,) = torch.autograd.grad(v, th)
            return float(v.detach()), g.cpu().numpy().astype(float)

        res = minimize(obj, pm.cpu().numpy().astype(float), method="BFGS", jac=True)
        x = np.asarray(res.x, dtype=float)
        hinv = np.asarray(res.hess_inv, dtype=float)
        if np.isfinite(x).all() and np.isfinite(res.fun) and np.isfinite(hinv).all():
            self.param_mean = torch.clamp(f64(x, dev), -8.0, 8.0)
            self.param_cov = f64(hinv, dev) + self.param_jitter

    def _run_forward(self, data):
        n_pts = self.param_pts_num
        m, P = (t[None] for t in self.mod_dyn.init_rv.get_stats()[:2])
        outs = []
        with torch.no_grad():
            for k in range(1, data.shape[-1] + 1):
                y = data[:, k - 1]
                # default-parameter predictive moments at k - 1, for the smoother
                m_pr_d, P_pr_d, xx_d, _, _, _ = _gaussian_time_update(
                    self.mod_dyn, self.mod_obs, self.tf_dyn, self.tf_obs, m, P, k - 1)
                # the marginalized update evaluates both transforms at time k
                self._laplace_step(y, m[0], P[0], k)
                theta_pts = self.param_mean[:, None] + chol_small(self.param_cov) @ self.param_upts
                m_pr, P_pr, _, y_pr, S, xy = self._predict_meas(
                    theta_pts.T, m.expand(n_pts, -1), P.expand(n_pts, -1, -1), k)
                means, covs = _kalman_update(m_pr, P_pr, y_pr, S, xy, y)
                m = torch.einsum("pi,p->i", means, self.param_wts)[None]
                P = torch.einsum("pij,p->ij", covs, self.param_wts)[None]
                outs.append((m[0], P[0], m_pr_d[0], P_pr_d[0], xx_d[0]))
        fi_m, fi_P, pr_m, pr_P, pr_xx = (torch.stack(s, dim=-1) for s in zip(*outs))
        return FilterResult(fi_mean=fi_m, fi_cov=fi_P, pr_mean=pr_m, pr_cov=pr_P,
                            pr_xx_cov=pr_xx)

    def _newton(self, data, newton_iters, damping, inner_dtype) -> FilterResult:
        with torch.no_grad():
            res, _ = marginal_filter_batch(
                self.mod_dyn, self.mod_obs, self.tf_dyn, self.tf_obs, data,
                self.param_prior_mean, self.param_prior_cov,
                self.newton_iters if newton_iters is None else int(newton_iters),
                self.damping if damping is None else float(damping),
                self.inner_dtype if inner_dtype is None else inner_dtype)
        return res

    def forward_pass_compiled(self, data, newton_iters=None, damping=None, inner_dtype=None):
        """The whole record ``data`` (dim_y, N) through the damped-Newton
        search of :func:`marginal_filter_batch`, from the prior; returns
        ``(fi_mean, fi_cov)`` and keeps the result for the smoother."""
        data = f64(data, self.mod_dyn.device)
        res = self._newton(data[None], newton_iters, damping, inner_dtype)
        self._result = FilterResult(*(getattr(res, f)[0] for f in res.__dataclass_fields__))
        self.fi_mean, self.fi_cov = self._result.fi_mean, self._result.fi_cov
        self.set_flag("filtered", True)
        return self.fi_mean, self.fi_cov

    def forward_pass_batch(self, data_batch, newton_iters=None, damping=None,
                           inner_dtype=None) -> FilterResult:
        """Marginalized filtering of a batch (M, dim_y, N), each trajectory
        with its own parameter posterior (the damped-Newton search); not the
        inherited fixed-parameter batch path."""
        self._result = self._newton(self._check_batch(data_batch), newton_iters, damping,
                                    inner_dtype)
        return self._result


class MarginalizedGaussianProcessKalman(MarginalInference):
    """GPQ Kalman filter with marginalized kernel parameters: GPQ transforms
    built at unit kernel parameters, ``kernel`` on the ``points`` rule."""

    def __init__(self, dyn, obs, kernel: str = "rbf", points: str = "ut", point_hyp=None,
                 par_mean=None, par_cov=None):
        import numpy as np
        super().__init__(
            dyn, obs,
            GaussianProcessTransform(dyn.dim_in, 1, np.ones((1, dyn.dim_in + 1)), kernel, points,
                                     point_hyp, device=dyn.device),
            GaussianProcessTransform(obs.dim_state, 1, np.ones((1, obs.dim_state + 1)), kernel,
                                     points, point_hyp, device=dyn.device),
            par_mean, par_cov)
