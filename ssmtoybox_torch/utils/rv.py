"""Random variables (counterpart of :mod:`ssmtoybox_tpu.utils.rv`).

Shape convention matches the reference: ``sample(gen, size)`` returns a
tensor of shape ``(dim, *size)``.  ``StudentRV`` and the mixtures are not
ported yet (ROADMAP, queue 1, item 11).
"""
from __future__ import annotations

import torch

from . import rand
from .arrays import f64

__all__ = ["GaussRV"]


def _as_tuple(size):
    if isinstance(size, int):
        return (size,)
    return tuple(size)


class GaussRV:
    """Gaussian random variable holding float64 ``mean`` (D,) and ``cov`` (D, D)."""

    def __init__(self, dim: int, mean=None, cov=None, device=None):
        kw = dict(dtype=torch.float64, device=device)
        self.mean = (torch.zeros(dim, **kw) if mean is None
                     else torch.atleast_1d(f64(mean, device)))
        self.cov = (torch.eye(dim, **kw) if cov is None
                    else torch.atleast_2d(f64(cov, device)))

    @property
    def dim(self) -> int:
        return self.mean.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.mean.device

    def sample(self, gen: torch.Generator, size) -> torch.Tensor:
        s = rand.multivariate_normal(gen, self.mean, self.cov, _as_tuple(size))
        return torch.movedim(s, -1, 0)

    def get_stats(self):
        return self.mean, self.cov
