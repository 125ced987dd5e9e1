"""Random variables (counterpart of :mod:`ssmtoybox_tpu.utils.rv`).

Shape convention matches the reference: ``sample(gen, size)`` returns a
tensor of shape ``(dim, *size)``.  ``get_stats()`` of a :class:`StudentRV`
returns ``(mean, scale, dof)``, of the others ``(mean, cov)``; callers that
want the first two take ``get_stats()[:2]``.
"""
from __future__ import annotations

import torch

from . import rand
from .arrays import f64, resolve_device

__all__ = ["RandomVariable", "GaussRV", "StudentRV", "GaussianMixtureRV"]


def _as_tuple(size):
    if isinstance(size, int):
        return (size,)
    return tuple(size)


class RandomVariable:
    """Base of the random variables: ``sample(gen, size)`` draws (dim,
    *size) from a ``torch.Generator``, ``get_stats()`` gives the moments."""

    def sample(self, gen: torch.Generator, size) -> torch.Tensor:  # pragma: no cover - interface
        raise NotImplementedError

    def get_stats(self):  # pragma: no cover - interface
        raise NotImplementedError


class GaussRV(RandomVariable):
    """Gaussian random variable holding float64 ``mean`` (D,) and ``cov`` (D, D)."""

    def __init__(self, dim: int, mean=None, cov=None, device=None):
        device = resolve_device(device)
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


class StudentRV(RandomVariable):
    """Student-t random variable: ``mean`` (D,), ``scale`` matrix (D, D) and
    degrees of freedom ``dof``; ``dof <= 2`` becomes 3, as in the reference.

    ``get_stats()`` returns ``(mean, scale, dof)``: the scale matrix, not the
    covariance, which the filters consume as it is (reference parity)."""

    def __init__(self, dim: int, mean=None, scale=None, dof: float = 3.0, device=None):
        device = resolve_device(device)
        kw = dict(dtype=torch.float64, device=device)
        self.mean = (torch.zeros(dim, **kw) if mean is None
                     else torch.atleast_1d(f64(mean, device)))
        self.scale = (torch.eye(dim, **kw) if scale is None
                      else torch.atleast_2d(f64(scale, device)))
        self.dof = 3.0 if dof <= 2.0 else float(dof)

    @property
    def dim(self) -> int:
        return self.mean.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.mean.device

    def sample(self, gen: torch.Generator, size) -> torch.Tensor:
        s = rand.multivariate_t(gen, self.mean, self.scale, self.dof, _as_tuple(size))
        return torch.movedim(s, -1, 0)

    def get_stats(self):
        return self.mean, self.scale, self.dof


class GaussianMixtureRV(RandomVariable):
    """Gaussian mixture: ``means`` (C, D), ``covs`` (C, D, D), weights
    ``alphas`` (C,); ``get_stats()`` gives the moment-matched mean and
    covariance."""

    def __init__(self, dim: int, means, covs, alphas, device=None):
        device = resolve_device(device)
        self.means = torch.stack([f64(m, device).reshape(-1).expand(dim) for m in means])
        self.covs = torch.stack([torch.atleast_2d(f64(c, device)) for c in covs])
        self.alphas = f64(alphas, device)

    @property
    def dim(self) -> int:
        return self.means.shape[-1]

    @property
    def device(self) -> torch.device:
        return self.means.device

    def sample(self, gen: torch.Generator, size) -> torch.Tensor:
        s, _ = rand.gauss_mixture(gen, self.means, self.covs, self.alphas, _as_tuple(size))
        return torch.movedim(s, -1, 0)

    def get_stats(self):
        mean = self.alphas @ self.means
        dm = self.means - mean
        cov = torch.einsum("c,cde->de", self.alphas,
                           self.covs + dm[:, :, None] * dm[:, None, :])
        return mean, cov
