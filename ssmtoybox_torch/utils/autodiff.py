"""Jacobians by forward-mode automatic differentiation, batched over rows.

The JAX package takes ``jax.jacfwd`` of a per-state function and ``vmap``s
it; here the same is ``torch.func.jacfwd`` under ``torch.func.vmap``.  The
function sees one row at a time, so Python control flow over tensor values
is not allowed in it (the models select with ``torch.where``), and any
non-tensor argument (the time step) stays a Python value in its closure.
A time given as a tensor, one entry per row, is an argument of its own
(:func:`jacobian_in_time`), so that each row is differentiated at its time.
"""
from __future__ import annotations

import torch

__all__ = ["jacobian", "jacobian_in_time"]


def jacobian(f, args, argnums=(0,)):
    """Jacobian of ``f(*args)`` (vectors in, one vector out) with respect to
    the arguments ``argnums``, side by side, at every row of ``args`` (each
    (..., K_i), leading dimensions broadcast): (..., E, sum of their K_i)."""
    lead = torch.broadcast_shapes(*(a.shape[:-1] for a in args))
    flat = [a.expand(lead + a.shape[-1:]).reshape(-1, a.shape[-1]) for a in args]
    jac = torch.cat(torch.func.vmap(torch.func.jacfwd(f, argnums=argnums))(*flat), dim=-1)
    return jac.reshape(lead + jac.shape[-2:])


def jacobian_in_time(f, x, time):
    """Jacobian of ``f(x, time)`` with respect to ``x`` at every row of ``x``
    (..., D): (..., E, D).  A number ``time`` is closed over; a tensor
    ``time`` (leading dimensions that broadcast against the rows', then one
    entry) goes in as a second argument, each row with its own entry."""
    if not isinstance(time, torch.Tensor):
        return jacobian(lambda v: f(v, time), (x,))
    return jacobian(f, (x, time.reshape(time.shape or (1,))), argnums=(0,))
