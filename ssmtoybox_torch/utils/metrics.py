"""Estimation-performance metrics (counterpart of :mod:`ssmtoybox_tpu.utils.metrics`).

The JAX package writes each metric for one (state, estimate) pair and
batches it with ``vmap``; here ``log_cred_ratio`` and ``neg_log_likelihood``
broadcast over leading dimensions directly (``x`` (..., D), ``P`` (..., D, D)),
and the time-series aggregates keep the JAX shapes: ``x, m`` (D, N) and
``P, MSE`` (D, D, N).
"""
from __future__ import annotations

import math

import torch

from .linalg import pd_logdet, pd_solve

__all__ = ["squared_error", "mse_matrix", "log_cred_ratio", "neg_log_likelihood",
           "kl_divergence", "symmetrized_kl_divergence", "bootstrap_var", "rmse", "nci",
           "inclination", "nll_mean", "print_table"]


def squared_error(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Elementwise squared error ``(x - m)**2``."""
    return (x - m) ** 2


def mse_matrix(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Sample mean-square-error matrix averaged over MC runs.

    ``x`` is the true state, (D,) or (D, M); ``m`` the (D, M) estimates.
    """
    dx = (x[:, None] if x.ndim == 1 else x) - m
    return dx @ dx.T / m.shape[-1]


def _quad(A: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    """``dx^T A^-1 dx`` over leading dims."""
    return torch.sum(dx * pd_solve(A, dx[..., None])[..., 0], dim=-1)


def log_cred_ratio(x, m, P, MSE) -> torch.Tensor:
    """Log-credibility ratio ``10 log10(dx^T P^-1 dx / dx^T MSE^-1 dx)``."""
    dx = x - m
    return 10.0 * (torch.log10(_quad(P, dx)) - torch.log10(_quad(MSE, dx)))


def neg_log_likelihood(x, m, P) -> torch.Tensor:
    """Gaussian negative log-likelihood of the estimate."""
    dx = x - m
    d = x.shape[-1]
    return 0.5 * (pd_logdet(P) + _quad(P, dx) + d * math.log(2.0 * math.pi))


def kl_divergence(mean_0, cov_0, mean_1, cov_1, compat_flipped_logdet: bool = True):
    """KL divergence of ``N(mean_0, cov_0)`` from ``N(mean_1, cov_1)``, over
    leading dimensions (means (..., D), covariances (..., D, D)).

    ``compat_flipped_logdet=True`` (default) keeps the NumPy reference's
    log-determinant term ``log(det_0 / det_1)``, whose sign is wrong, as the
    JAX package does for its goldens: the value can be negative.  ``False``
    gives the true divergence.  :func:`symmetrized_kl_divergence` does not
    depend on it: the two terms cancel.
    """
    k = mean_0.shape[-1]
    dmu = mean_0 - mean_1
    trace = torch.diagonal(pd_solve(cov_1, cov_0), dim1=-2, dim2=-1).sum(-1)
    logdets = pd_logdet(cov_0) - pd_logdet(cov_1)
    if not compat_flipped_logdet:
        logdets = -logdets
    return 0.5 * (trace + _quad(cov_1, dmu) + logdets - k)


def symmetrized_kl_divergence(mean_0, cov_0, mean_1, cov_1):
    """``(KL(0 || 1) + KL(1 || 0)) / 2``."""
    return 0.5 * (kl_divergence(mean_0, cov_0, mean_1, cov_1)
                  + kl_divergence(mean_1, cov_1, mean_0, cov_0))


def bootstrap_var(generator: torch.Generator, data: torch.Tensor,
                  samples: int = 1000) -> torch.Tensor:
    """Bootstrap variance of the sample mean of ``data`` (flattened):
    ``samples`` resamples with replacement drawn from ``generator`` on the
    data's device, the population variance of their means."""
    data = data.reshape(-1)
    n = data.shape[0]
    idx = torch.randint(0, n, (samples, n), generator=generator, device=data.device)
    return torch.var(torch.mean(data[idx], dim=1), correction=0)


def rmse(x: torch.Tensor, m: torch.Tensor, axis=None) -> torch.Tensor:
    """Root-mean-square error: the state dimension (axis 0) is summed, then
    the root of the mean over ``axis`` of the remaining array is taken
    (``axis=None`` gives a scalar)."""
    se = torch.sum(squared_error(x, m), dim=0)
    return torch.sqrt(torch.mean(se) if axis is None else torch.mean(se, dim=axis))


def _lcr_series(x, m, P, MSE):
    """Per-time-step log-cred ratios for (D, N) trajectories."""
    return log_cred_ratio(x.T, m.T, torch.movedim(P, -1, 0), torch.movedim(MSE, -1, 0))


def nci(x, m, P, MSE) -> torch.Tensor:
    """Non-credibility index: time-average of the absolute log-cred ratio."""
    return torch.mean(torch.abs(_lcr_series(x, m, P, MSE)))


def inclination(x, m, P, MSE) -> torch.Tensor:
    """Inclination indicator (INC): time-average of the log-cred ratio; above
    zero the filter is optimistic, below pessimistic."""
    return torch.mean(_lcr_series(x, m, P, MSE))


def nll_mean(x, m, P) -> torch.Tensor:
    """Time-averaged Gaussian NLL for (D, N) trajectories."""
    return torch.mean(neg_log_likelihood(x.T, m.T, torch.movedim(P, -1, 0)))


def print_table(data, row_labels=None, col_labels=None, latex=False):
    """Print a results table (a pandas ``DataFrame`` of ``data``, LaTeX too
    with ``latex=True``) and return the frame; pandas is imported here."""
    import numpy as np
    import pandas as pd

    if isinstance(data, torch.Tensor):
        data = data.detach().cpu().numpy()
    df = pd.DataFrame(np.asarray(data), index=row_labels, columns=col_labels)
    print(df)
    if latex:
        print(df.to_latex())
    return df
