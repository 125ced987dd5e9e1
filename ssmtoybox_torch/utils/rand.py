"""Samplers driven by an explicit ``torch.Generator``.

Counterpart of :mod:`ssmtoybox_tpu.utils.rand`.  A JAX key and a torch
generator give different numbers from the same seed, so samples are compared
between the two packages only statistically.

PyTorch has no Gamma sampler that takes a generator (``torch._standard_gamma``
and ``torch.distributions.Gamma`` draw from the global generator), so
:func:`standard_gamma` is Marsaglia and Tsang's rejection method written with
the generator.
"""
from __future__ import annotations

import math

import torch

__all__ = ["multivariate_normal", "standard_gamma", "multivariate_t", "gauss_mixture",
           "bigauss_mixture"]


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


def standard_gamma(gen: torch.Generator, shape_k: float, size, dtype=torch.float64,
                   device=None) -> torch.Tensor:
    """``Gamma(shape_k, 1)`` samples of shape ``size`` (Marsaglia & Tsang 2000).

    For ``shape_k >= 1``: ``d = k - 1/3``, ``c = 1/sqrt(9 d)``; draw
    ``x ~ N(0, 1)``, ``v = (1 + c x)^3`` and accept ``d v`` when ``v > 0`` and
    ``log u < x^2/2 + d - d v + d log v``.  The rejected entries are redrawn
    together until none is left.  For ``shape_k < 1`` a ``Gamma(k + 1)``
    sample is boosted by ``u^(1/k)``.
    """
    size = tuple(size)
    if shape_k <= 0:
        raise ValueError(f"Gamma shape must be positive; got {shape_k}")
    k = shape_k + 1.0 if shape_k < 1.0 else shape_k
    d = k - 1.0 / 3.0
    c = 1.0 / (9.0 * d) ** 0.5
    out = torch.empty(size, dtype=dtype, device=device).reshape(-1)
    todo = torch.arange(out.numel(), device=device)
    while todo.numel():
        n = todo.numel()
        x = torch.randn(n, generator=gen, dtype=dtype, device=device)
        u = torch.rand(n, generator=gen, dtype=dtype, device=device)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(torch.clamp(v, min=torch.finfo(dtype).tiny)))
        out[todo[ok]] = (d * v)[ok]
        todo = todo[~ok]
    if shape_k < 1.0:
        u = torch.rand(out.numel(), generator=gen, dtype=dtype, device=device)
        out = out * u ** (1.0 / shape_k)
    return out.reshape(size)


def multivariate_t(gen: torch.Generator, mean: torch.Tensor, scale: torch.Tensor, dof: float,
                   shape=()) -> torch.Tensor:
    """Multivariate Student-t samples of shape ``(*shape, dim)`` via the
    Gamma-mixture construction of the JAX package: ``x = mu + n / sqrt(u)``
    with ``n ~ N(0, scale)`` and ``u ~ Gamma(k=dof/2, theta=2/dof)``."""
    shape = tuple(shape)
    u = standard_gamma(gen, dof / 2.0, shape, mean.dtype, mean.device) * (2.0 / dof)
    n = multivariate_normal(gen, torch.zeros_like(mean), scale, shape)
    return mean + n / torch.sqrt(u)[..., None]


def gauss_mixture(gen: torch.Generator, means: torch.Tensor, covs: torch.Tensor,
                  alphas: torch.Tensor, shape=()):
    """Gaussian-mixture samples: a component index per sample from
    ``torch.multinomial``, then that component's Gaussian.

    ``means`` (C, D), ``covs`` (C, D, D), ``alphas`` (C,).  Returns
    ``(samples, indexes)`` of shapes ``(*shape, D)`` and ``shape``.
    """
    shape = tuple(shape)
    ci = torch.multinomial(alphas, math.prod(shape), replacement=True,
                           generator=gen).reshape(shape)
    z = torch.randn(*shape, means.shape[-1], generator=gen, dtype=means.dtype,
                    device=means.device)
    chols = torch.linalg.cholesky(covs)
    return means[ci] + (chols[ci] @ z[..., None])[..., 0], ci


def bigauss_mixture(gen: torch.Generator, m0, c0, m1, c1, alpha: float,
                    shape=()) -> torch.Tensor:
    """Two-component Gaussian-mixture samples of shape ``(*shape, dim)``:
    component 0, ``N(m0, c0)``, with probability ``alpha``, else ``N(m1,
    c1)``.  Both components are drawn for every sample and one is kept, as
    the reference and the JAX package do."""
    shape, dev = tuple(shape), gen.device

    def f64(v):
        return torch.as_tensor(v, dtype=torch.float64, device=dev)

    pick0 = torch.rand(shape, generator=gen, dtype=torch.float64, device=dev) < alpha
    n0 = multivariate_normal(gen, torch.atleast_1d(f64(m0)), torch.atleast_2d(f64(c0)), shape)
    n1 = multivariate_normal(gen, torch.atleast_1d(f64(m1)), torch.atleast_2d(f64(c1)), shape)
    return torch.where(pick0[..., None], n0, n1)
