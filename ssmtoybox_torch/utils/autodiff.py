"""Jacobians by forward-mode automatic differentiation, batched over rows.

The JAX package takes ``jax.jacfwd`` of a per-state function and ``vmap``s
it; here the same is ``torch.func.jacfwd`` under ``torch.func.vmap``.  The
function sees one row at a time, so Python control flow over tensor values
is not allowed in it (the models select with ``torch.where``), and any
non-tensor argument (the time step) stays a Python value in its closure.
"""
from __future__ import annotations

import torch

__all__ = ["jacobian"]


def jacobian(f, args, argnums=(0,)):
    """Jacobian of ``f(*args)`` (vectors in, one vector out) with respect to
    the arguments ``argnums``, side by side, at every row of ``args`` (each
    (..., K_i), leading dimensions broadcast): (..., E, sum of their K_i)."""
    lead = torch.broadcast_shapes(*(a.shape[:-1] for a in args))
    flat = [a.expand(lead + a.shape[-1:]).reshape(-1, a.shape[-1]) for a in args]
    jac = torch.cat(torch.func.vmap(torch.func.jacfwd(f, argnums=argnums))(*flat), dim=-1)
    return jac.reshape(lead + jac.shape[-2:])
