"""Samplers driven by an explicit ``torch.Generator``.

Counterpart of :mod:`ssmtoybox_tpu.utils.rand`.  A JAX key and a torch
generator give different numbers from the same seed, so samples are compared
between the two packages only statistically.
"""
from __future__ import annotations

import torch

__all__ = ["multivariate_normal"]


def multivariate_normal(gen: torch.Generator, mean: torch.Tensor, cov: torch.Tensor,
                        shape=()) -> torch.Tensor:
    """Gaussian samples of shape ``(*shape, dim)`` on ``mean``'s device.

    ``gen`` must live on the same device as ``mean``.
    """
    shape = tuple(shape)
    z = torch.randn(*shape, mean.shape[-1], generator=gen, dtype=mean.dtype,
                    device=mean.device)
    L = torch.linalg.cholesky(cov.to(mean.dtype))
    return mean + z @ L.mT
