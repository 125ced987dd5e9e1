"""Helpers shared by the time-parallel modules."""
from __future__ import annotations

import numpy as np
import torch

from ..sqrt import _ieee as ieee
from ..utils.arrays import resolve_device

__all__ = ["as_tensors", "ieee", "mv", "rep"]


def as_tensors(*arrays):
    """The arguments as tensors of one device and dtype: those of the first
    tensor among them, else float64 on the default device."""
    like = next((a for a in arrays if isinstance(a, torch.Tensor)), None)
    device = resolve_device(None) if like is None else like.device
    dtype = torch.float64 if like is None else like.dtype
    return tuple(a.to(device=device, dtype=dtype) if isinstance(a, torch.Tensor)
                 else torch.as_tensor(np.array(a, dtype=np.float64), device=device).to(dtype)
                 for a in arrays)


def mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector product ``A v``: (..., E, D) by (..., D)."""
    return (A @ v[..., None])[..., 0]


def rep(a: torch.Tensor, n: int) -> torch.Tensor:
    """``a`` repeated ``n`` times along a new leading axis (a view)."""
    return a.expand((n,) + a.shape)
