"""Online (streaming) Gaussian filtering and fixed-lag smoothing
(counterpart of :mod:`ssmtoybox_tpu.online`).

A deployed tracker receives measurements one at a time and updates its state
in place.  :func:`make_online_filter` and :func:`make_fixed_lag_smoother`
build ``(init, step)`` pairs on the filters' predict and update:

* :class:`OnlineState` is the filter's carry (mean, covariance, 1-based step
  counter), checkpointable with :mod:`ssmtoybox_torch.utils.checkpoint`;
* ``batch=True`` gives every tensor a leading batch dimension: independent
  targets served in one call;
* ``observed=False`` (a bool, or a bool tensor over the batch) skips the
  measurement update through ``torch.where`` and keeps the prediction.

``donate=True`` is the counterpart of the JAX package's donated state
buffers: the step writes the new state into the given state's own tensors and
returns that object, so the caller's old state is consumed and steady-state
serving allocates nothing new for it.  ``init()`` hands out copies of the
prior, never the model's own tensors.

The step runs eagerly, and it never reads the card: the measurement index is
kept on the host beside the state's ``step`` tensor (a state restored from a
checkpoint reads its counter once), and the dynamics take it as a host
number, as the batch filter does.  So a stream equals the batch filter
operation for operation.  There is no CUDA graph replay, for two reasons
measured on the H100: MAGMA's batched Cholesky solve (``cholesky_solve`` on
more than one matrix) allocates device memory and cannot be captured, and a
replayed step would need its time index on the card, whose ``cos`` differs
from the host's in the last bit for some arguments, which a UNGM filter grows
to 1e-8 in 100 steps.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from typing import Optional

import torch

from .ssinf import _gaussian_time_update, _kalman_update, _smoothing_update
from .utils.arrays import f64, map_tensors

__all__ = ["streaming_api", "OnlineState", "StepInfo", "make_online_filter",
           "FixedLagState", "make_fixed_lag_smoother"]


def _tensors(obj) -> tuple:
    return tuple(getattr(obj, f.name) for f in fields(obj))


def streaming_api(state_cls, leaves_fn, one_fn, batch: bool, donate: bool, cast=None):
    """The ``(init, step)`` pair every streaming factory returns.

    * ``init(batch_size=None)`` checks the batch flag and builds the state from
      ``leaves_fn() -> {field: unbatched tensor}``, copies of it, with a
      leading batch dimension of ``batch_size`` when ``batch=True``.
    * ``step(state, y, observed=True)`` runs ``one_fn(state, y, observed,
      time)`` for measurement ``k = state.step`` at ``time = k - 1`` (a host
      int); ``one_fn`` takes and returns batched tensors (an unbatched state
      runs as a batch of one), a scalar ``observed`` broadcast over the batch.
      With ``donate`` the new state is written into ``state``'s tensors.
      ``cast`` converts ``y`` (default: float64 on the state's device).
    """
    def init(batch_size: Optional[int] = None):
        if batch and batch_size is None:
            raise ValueError("batch=True needs init(batch_size=...): an unbatched state "
                             "would not match the batched step")
        if not batch and batch_size is not None:
            raise ValueError("init(batch_size=...) requires batch=True: an unbatched step "
                             "would silently broadcast batched measurements into a corrupt "
                             "state")
        leaves = leaves_fn()
        if batch:
            state = state_cls(**{k: v.expand((batch_size,) + v.shape).clone()
                                 for k, v in leaves.items()})
        else:
            state = state_cls(**{k: v.clone() for k, v in leaves.items()})
        state._index = 1
        return state

    def batched(state, y, observed, time):
        new, *rest = one_fn(state, y, observed, time)
        if donate:
            for t, n in zip(_tensors(state), _tensors(new)):
                t.copy_(n)
            new = state
        return (new, *rest)

    def lifted(state, y, observed, time):
        """An unbatched state run as a batch of one (views of its tensors,
        so that a donated step writes into them)."""
        one = map_tensors(state, lambda t: t[None])
        out = map_tensors(batched(one, y[None], observed.reshape(1), time), lambda t: t[0])
        return (state,) + out[1:] if donate else out

    run = batched if batch else lifted

    def step(state, y, observed=True):
        dev = state.mean.device
        y = f64(y, dev) if cast is None else cast(y)
        observed = (observed.to(dtype=torch.bool, device=dev)
                    if isinstance(observed, torch.Tensor)
                    else torch.full((), bool(observed), dtype=torch.bool, device=dev))
        if batch:
            observed = observed.expand(y.shape[0])
        k = getattr(state, "_index", None)
        if k is None:                   # built elsewhere (restored): read the counter once
            k = int(state.step.reshape(-1)[0])
        out = run(state, y, observed, k - 1)
        out[0]._index = k + 1
        return out

    return init, step


@dataclass
class OnlineState:
    """Streaming filter carry: ``mean`` (D,) or (B, D), ``cov`` (D, D) or
    (B, D, D), ``step`` the 1-based index of the next measurement, a 0-dim or
    (B,) int64 tensor."""

    mean: torch.Tensor
    cov: torch.Tensor
    step: torch.Tensor


@dataclass
class StepInfo:
    """A step's predicted measurement moments and innovation."""

    y_pred: torch.Tensor
    innov: torch.Tensor
    innov_cov: torch.Tensor


def _predict_update(mod_dyn, mod_obs, tf_dyn, tf_obs, state, y, observed, time):
    """One predict (dynamics at ``time``) and update of a batched state; the
    prediction kept where ``observed`` (B,) is false."""
    m_pr, P_pr, xx, y_pr, S, xy = _gaussian_time_update(
        mod_dyn, mod_obs, tf_dyn, tf_obs, state.mean, state.cov, time)
    m_fi, P_fi = _kalman_update(m_pr, P_pr, y_pr, S, xy, y)
    m_new = torch.where(observed[:, None], m_fi, m_pr)
    P_new = torch.where(observed[:, None, None], P_fi, P_pr)
    return m_new, P_new, m_pr, P_pr, xx, StepInfo(y_pred=y_pr, innov=y - y_pr, innov_cov=S)


def make_online_filter(mod_dyn, mod_obs, tf_dyn, tf_obs, batch: bool = False,
                       donate: bool = True):
    """``(init, step)`` for streaming Gaussian filtering.

    ``init(batch_size=None) -> OnlineState`` starts from the model's prior;
    ``step(state, y, observed=True) -> (OnlineState, StepInfo)`` runs one
    predict (dynamics at time ``step - 1``) and update, as the batch filter
    does for measurement ``step``.  ``batch`` and ``donate`` as in the module
    docstring.
    """
    m0, P0 = mod_dyn.init_rv.get_stats()[:2]

    def leaves():
        return dict(mean=m0, cov=P0, step=torch.ones((), dtype=torch.int64, device=m0.device))

    def one(state, y, observed, time):
        m_new, P_new, _, _, _, info = _predict_update(mod_dyn, mod_obs, tf_dyn, tf_obs,
                                                      state, y, observed, time)
        return OnlineState(mean=m_new, cov=P_new, step=state.step + 1), info

    return streaming_api(OnlineState, leaves, one, batch, donate)


@dataclass
class FixedLagState:
    """Streaming fixed-lag smoother carry: the filter's state and ring
    buffers of the last ``lag`` steps' filtered and predictive moments, oldest
    first (``(L, D)``, ``(L, D, D)``, a leading batch dimension with
    ``batch=True``); ``buf_xx[j]`` is the cross-covariance of slot ``j - 1``'s
    state with its prediction at slot ``j``, the RTS gain's."""

    mean: torch.Tensor
    cov: torch.Tensor
    step: torch.Tensor
    buf_fi_m: torch.Tensor
    buf_fi_P: torch.Tensor
    buf_pr_m: torch.Tensor
    buf_pr_P: torch.Tensor
    buf_xx: torch.Tensor


def make_fixed_lag_smoother(mod_dyn, mod_obs, tf_dyn, tf_obs, lag: int, batch: bool = False,
                            donate: bool = True):
    """``(init, step)`` for streaming fixed-lag smoothing: each measurement
    updates the filter and re-smooths the last ``lag`` steps.

    ``step(state, y, observed=True) -> (FixedLagState, StepInfo, (sm_mean,
    sm_cov))`` emits the estimate of ``x_{k - lag + 1}`` given ``y_{1:k}``:
    the RTS recursion over the window (the newest filtered moments seed it,
    each older slot smoothed against the next slot's predictive moments),
    equal to the offline smoother with ``rts_full=True`` on the record cut at
    ``k``.  Meaningful once ``state.step > lag``; before that the window holds
    the prior as padding.  ``batch`` and ``donate`` as in
    :func:`make_online_filter`.
    """
    if lag < 2:
        raise ValueError(f"fixed-lag smoothing needs lag >= 2; got {lag} "
                         "(lag=1 is plain filtering: use make_online_filter)")
    m0, P0 = mod_dyn.init_rv.get_stats()[:2]

    def leaves():
        ms, Ps = m0.expand((lag,) + m0.shape), P0.expand((lag,) + P0.shape)
        return dict(mean=m0, cov=P0, step=torch.ones((), dtype=torch.int64, device=m0.device),
                    buf_fi_m=ms, buf_fi_P=Ps, buf_pr_m=ms, buf_pr_P=Ps, buf_xx=Ps)

    def one(state, y, observed, time):
        m_new, P_new, m_pr, P_pr, xx, info = _predict_update(mod_dyn, mod_obs, tf_dyn,
                                                             tf_obs, state, y, observed, time)
        shift = lambda buf, new: torch.cat([buf[:, 1:], new[:, None]], dim=1)
        bufs = dict(buf_fi_m=shift(state.buf_fi_m, m_new),
                    buf_fi_P=shift(state.buf_fi_P, P_new),
                    buf_pr_m=shift(state.buf_pr_m, m_pr),
                    buf_pr_P=shift(state.buf_pr_P, P_pr), buf_xx=shift(state.buf_xx, xx))
        sm_m, sm_P = bufs["buf_fi_m"][:, -1], bufs["buf_fi_P"][:, -1]
        for j in range(lag - 2, -1, -1):
            sm_m, sm_P = _smoothing_update(
                bufs["buf_fi_m"][:, j], bufs["buf_fi_P"][:, j], sm_m, sm_P,
                bufs["buf_pr_m"][:, j + 1], bufs["buf_pr_P"][:, j + 1], bufs["buf_xx"][:, j + 1])
        new = FixedLagState(mean=m_new, cov=P_new, step=state.step + 1, **bufs)
        return new, info, (sm_m, sm_P)

    return streaming_api(FixedLagState, leaves, one, batch, donate)
