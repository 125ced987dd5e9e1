"""Unit sigma-point sets and quadrature weights (NumPy float64).

Vendored from :mod:`ssmtoybox_tpu.points` (spherical-radial, unscented and
Gauss-Hermite rules plus the string-keyed factory) so that the port never
imports the JAX package.  The constructors are host-side NumPy: a transform
turns their output into ``torch.float64`` tensors once, at construction.
"""
from __future__ import annotations

import itertools
from math import factorial

import numpy as np
from numpy.polynomial.hermite_e import hermegauss, hermeval

__all__ = [
    "sr_points", "sr_weights",
    "ut_points", "ut_weights",
    "gh_points", "gh_weights",
    "get_points",
]


def _cartesian(arrays):
    """Cartesian product with first column varying slowest (sklearn order)."""
    return np.array(list(itertools.product(*arrays)), dtype=float)


# -- spherical-radial (CKF) --------------------------------------------------

def sr_points(dim: int) -> np.ndarray:
    """``±sqrt(d) e_i`` — (dim, 2*dim) array."""
    c = np.sqrt(dim)
    return np.hstack((c * np.eye(dim), -c * np.eye(dim)))


def sr_weights(dim: int) -> np.ndarray:
    """Uniform ``1/(2d)`` weights."""
    return (1.0 / (2.0 * dim)) * np.ones(2 * dim)


# -- unscented ----------------------------------------------------------------

def _ut_lambda(dim, kappa, alpha):
    kappa = np.max([3.0 - dim, 0.0]) if kappa is None else kappa
    return alpha ** 2 * (dim + kappa) - dim


def ut_points(dim: int, kappa=None, alpha: float = 1.0) -> np.ndarray:
    """UT unit points ``[0, ±c e_i]`` with ``c = sqrt(d + lam)``."""
    lam = _ut_lambda(dim, kappa, alpha)
    c = np.sqrt(dim + lam)
    return np.hstack((np.zeros((dim, 1)), c * np.eye(dim), -c * np.eye(dim)))


def ut_weights(dim: int, kappa=None, alpha: float = 1.0, beta: float = 2.0):
    """UT mean/covariance weights ``(wm, wc)``."""
    lam = _ut_lambda(dim, kappa, alpha)
    wm = 1.0 / (2.0 * (dim + lam)) * np.ones(2 * dim + 1)
    wc = wm.copy()
    wm[0] = lam / (dim + lam)
    wc[0] = wm[0] + (1.0 - alpha ** 2 + beta)
    return wm, wc


# -- Gauss-Hermite ------------------------------------------------------------

def gh_points(dim: int, degree: int = 3) -> np.ndarray:
    """Tensor-product probabilists' Gauss-Hermite nodes."""
    x, _ = hermegauss(degree)
    return _cartesian([x] * dim).T


def gh_weights(dim: int, degree: int = 3) -> np.ndarray:
    """GH weights re-derived as ``p!/(p^2 He_{p-1}(x)^2)``, as the reference
    does to avoid ``hermegauss``'s own weights."""
    x, _ = hermegauss(degree)
    w = factorial(degree) / (degree ** 2 * hermeval(x, [0.0] * (degree - 1) + [1.0]) ** 2)
    return np.prod(_cartesian([w] * dim), axis=1)


# -- string-keyed factory -----------------------------------------------------

def get_points(dim: int, points: str, point_par: dict | None = None) -> np.ndarray:
    """Point-set factory keyed by the reference's string acronyms.

    The fully-symmetric Student rule (``"fs"``) is not ported yet (ROADMAP,
    queue 1, item 12)."""
    points = points.lower()
    point_par = dict(point_par or {})
    if points == "sr":
        return sr_points(dim)
    if points == "ut":
        point_par.pop("beta", None)
        return ut_points(dim, **point_par)
    if points == "gh":
        return gh_points(dim, **point_par)
    raise ValueError(f"Points '{points}' not supported. Supported: sr, ut, gh.")
