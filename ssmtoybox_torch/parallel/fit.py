"""Kernel-parameter fitting by Adam on a batched NLML (counterpart of
:mod:`ssmtoybox_tpu.parallel.fit`).

The reference fits a BQ model's kernel parameters by BFGS on one set of
function observations (:meth:`~ssmtoybox_torch.bq.models.Model.optimize`
here).  This is the large-batch form: the mean NLML over B independent sets
of function observations at the model's points, minimized by Adam.  On a
:class:`~ssmtoybox_torch.parallel.mesh.Mesh` the sets are split over its
``dp`` axis; each rank differentiates its weighted NLML sum and one
``all_reduce`` a step adds the sums, the weight sums and the gradients, so
that every rank takes the same Adam step.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["nlml_loss", "make_fit_step", "fit_kernel_params"]


def _nlml_values(model, log_par, fcn_obs_batch, x_obs) -> torch.Tensor:
    """The NLML of each set of ``fcn_obs_batch``, (B,)."""
    jitter = model.kernel.jitter * torch.eye(x_obs.shape[1], dtype=x_obs.dtype,
                                             device=x_obs.device)
    return torch.func.vmap(
        lambda fo: model.neg_log_marginal_likelihood(log_par, fo, x_obs, jitter))(fcn_obs_batch)


def nlml_loss(model, log_par, fcn_obs_batch, x_obs, weights=None) -> torch.Tensor:
    """Mean NLML of ``model`` at the log-parameters ``log_par`` over a batch
    ``fcn_obs_batch`` (B, num_pts, dim_out) of function observations at
    ``x_obs`` (D, num_pts); ``weights`` (B,) makes it the weighted mean.
    The Gram takes the kernel's own jitter."""
    vals = _nlml_values(model, log_par, fcn_obs_batch, x_obs)
    if weights is None:
        return vals.mean()
    return torch.sum(vals * weights) / torch.sum(weights)


def _pad_sets(fcn_obs_batch, weights, dp: int):
    """The batch padded to a multiple of ``dp`` with copies of its last set
    of weight zero; returns ``(batch, weights)``."""
    b = fcn_obs_batch.shape[0]
    if weights is None:
        weights = fcn_obs_batch.new_ones(b)
    pad = (-b) % dp
    if pad:
        fcn_obs_batch = torch.cat([fcn_obs_batch,
                                   fcn_obs_batch[-1:].expand((pad,) + fcn_obs_batch.shape[1:])])
        weights = torch.cat([weights, weights.new_zeros(pad)])
    return fcn_obs_batch, weights


def make_fit_step(model, optimizer: torch.optim.Optimizer, mesh=None):
    """One descent step on :func:`nlml_loss`: ``step(fcn_obs_batch, x_obs,
    weights=None) -> loss``, the loss before the step.  ``optimizer`` holds
    the log-parameter tensor (its first parameter), which the step updates
    in place; nothing is read back from the card.

    With a ``mesh`` every rank passes the whole batch and takes its ``dp``
    rows (a batch that ``dp`` does not divide is padded with sets of weight
    zero); the gradient of the weighted mean comes from one ``all_reduce``,
    equal on every rank.
    """
    log_par = optimizer.param_groups[0]["params"][0]

    def step(fcn_obs_batch, x_obs, weights=None):
        optimizer.zero_grad(set_to_none=True)
        if mesh is None:
            loss = nlml_loss(model, log_par, fcn_obs_batch, x_obs, weights)
            loss.backward()
            optimizer.step()
            return loss.detach()
        fo, w = _pad_sets(fcn_obs_batch, weights, mesh.shape["dp"])
        per = fo.shape[0] // mesh.shape["dp"]
        start = mesh.coords["dp"] * per
        fo, w = fo[start:start + per], w[start:start + per]
        local = torch.sum(_nlml_values(model, log_par, fo, x_obs) * w)
        grad, = torch.autograd.grad(local, log_par)
        mine = torch.cat([local.detach()[None], w.sum()[None], grad.reshape(-1)])
        if mesh.coords.get("fb", 0):
            mine = torch.zeros_like(mine)      # fb replicas hold the same sets
        total = mesh.all_reduce(mine)
        log_par.grad = (total[2:] / total[1]).reshape(log_par.shape)
        optimizer.step()
        return total[0] / total[1]

    return step


def fit_kernel_params(model, log_par_0, fcn_obs_batch, x_obs, learning_rate: float = 1e-2,
                      num_steps: int = 200, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit the kernel log-parameters by Adam (``torch.optim.Adam``, its
    defaults: the betas and epsilon of optax's ``adam``) on the batched NLML.
    Returns ``(log_par, losses)``, the losses before each step.  With a
    ``mesh`` the batch is split over its ``dp`` axis (:func:`make_fit_step`);
    the fit equals the unsharded one to rounding."""
    log_par = torch.as_tensor(log_par_0, device=x_obs.device).to(x_obs.dtype).reshape(-1)
    log_par = log_par.clone().requires_grad_(True)
    step = make_fit_step(model, torch.optim.Adam([log_par], lr=learning_rate), mesh)
    weights = None
    if mesh is not None:
        # padded once here, so that the steps only take views of the rows
        fcn_obs_batch, weights = _pad_sets(fcn_obs_batch, None, mesh.shape["dp"])
    losses = [step(fcn_obs_batch, x_obs, weights) for _ in range(num_steps)]
    return log_par.detach(), torch.stack(losses)
