"""Kernel-parameter fitting by Adam on a batched NLML (counterpart of
:mod:`ssmtoybox_tpu.parallel.fit`, without its device mesh).

The reference fits a BQ model's kernel parameters by BFGS on one set of
function observations (:meth:`~ssmtoybox_torch.bq.models.Model.optimize`
here).  This is the large-batch form: the mean NLML over B independent sets
of function observations at the model's points, minimized by Adam.
"""
from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["nlml_loss", "make_fit_step", "fit_kernel_params"]


def _mesh_not_ported(mesh):
    if mesh is not None:
        raise NotImplementedError(
            "fitting over a mesh of cards (mesh=...) is not ported yet; ROADMAP.md queue 1, "
            "item 19b")


def nlml_loss(model, log_par, fcn_obs_batch, x_obs, weights=None) -> torch.Tensor:
    """Mean NLML of ``model`` at the log-parameters ``log_par`` over a batch
    ``fcn_obs_batch`` (B, num_pts, dim_out) of function observations at
    ``x_obs`` (D, num_pts); ``weights`` (B,) makes it the weighted mean.
    The Gram takes the kernel's own jitter."""
    jitter = model.kernel.jitter * torch.eye(x_obs.shape[1], dtype=x_obs.dtype,
                                             device=x_obs.device)
    vals = torch.func.vmap(
        lambda fo: model.neg_log_marginal_likelihood(log_par, fo, x_obs, jitter))(fcn_obs_batch)
    if weights is None:
        return vals.mean()
    return torch.sum(vals * weights) / torch.sum(weights)


def make_fit_step(model, optimizer: torch.optim.Optimizer, mesh=None):
    """One descent step on :func:`nlml_loss`: ``step(fcn_obs_batch, x_obs,
    weights=None) -> loss``, the loss before the step.  ``optimizer`` holds
    the log-parameter tensor (its first parameter), which the step updates
    in place; nothing is read back from the card."""
    _mesh_not_ported(mesh)
    log_par = optimizer.param_groups[0]["params"][0]

    def step(fcn_obs_batch, x_obs, weights=None):
        optimizer.zero_grad(set_to_none=True)
        loss = nlml_loss(model, log_par, fcn_obs_batch, x_obs, weights)
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def fit_kernel_params(model, log_par_0, fcn_obs_batch, x_obs, learning_rate: float = 1e-2,
                      num_steps: int = 200, mesh=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fit the kernel log-parameters by Adam (``torch.optim.Adam``, its
    defaults: the betas and epsilon of optax's ``adam``) on the batched NLML.
    Returns ``(log_par, losses)``, the losses before each step."""
    _mesh_not_ported(mesh)
    log_par = torch.as_tensor(log_par_0, device=x_obs.device).to(x_obs.dtype).reshape(-1)
    log_par = log_par.clone().requires_grad_(True)
    step = make_fit_step(model, torch.optim.Adam([log_par], lr=learning_rate))
    losses = [step(fcn_obs_batch, x_obs) for _ in range(num_steps)]
    return log_par.detach(), torch.stack(losses)
