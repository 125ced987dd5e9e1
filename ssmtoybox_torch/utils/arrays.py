"""Conversion of array-likes to the port's float64 tensors."""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["f64"]


def f64(a, device=None) -> torch.Tensor:
    """``a`` as a float64 tensor on ``device``; a tensor stays on its own
    device when ``device`` is None, anything else is copied from NumPy."""
    if isinstance(a, torch.Tensor):
        return a.to(dtype=torch.float64, device=device)
    return torch.tensor(np.asarray(a, dtype=np.float64), dtype=torch.float64, device=device)
