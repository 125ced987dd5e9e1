"""Unit sigma-point sets and quadrature weights (NumPy float64).

Vendored from :mod:`ssmtoybox_tpu.points` (spherical-radial, unscented,
Gauss-Hermite and fully-symmetric Student rules, the seeded Monte-Carlo
points, and the string-keyed factory) so that the port never imports the
JAX package.  The constructors are host-side NumPy: a transform turns their
output into ``torch.float64`` tensors once, at construction.
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
    "symmetric_set", "fs_points", "fs_weights",
    "mc_points", "mc_weights",
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


# -- fully-symmetric (McNamee-Stenger) for Student-t inputs --------------------

_FS_SUPPORTED_DEGREES = (3, 5)


def _fs_defaults(dim, degree, kappa, dof):
    if degree not in _FS_SUPPORTED_DEGREES:
        degree = 3
    kappa = np.max([3.0 - dim, 0.0]) if kappa is None else kappa
    dof = np.max((dof, degree))  # dof > 2p for degree 2p+1
    return degree, kappa, dof


def symmetric_set(dim: int, gen) -> np.ndarray:
    """Fully-symmetric point set from a generator: all sign and position
    permutations of the generator entries, in the reference's column order."""
    nzeros = np.zeros((dim, 1))
    if len(gen) == 0:
        return nzeros
    gen = np.asarray(gen, dtype=float)
    eps = np.spacing(1.0)
    cols = []
    uind = np.arange(dim)
    for i in range(dim):
        u = nzeros.copy()
        u[i] = gen[0]
        if len(gen) > 1:
            if np.abs(gen[0] - gen[1]) < eps:
                V = symmetric_set(dim - i - 1, gen[1:])
                for j in range(V.shape[1]):
                    uu = u.copy()
                    uu[i + 1:, 0] = V[:, j]
                    cols.extend([uu, -uu])
            else:
                V = symmetric_set(dim - 1, gen[1:])
                for j in range(V.shape[1]):
                    uu = u.copy()
                    uu[uind != i, 0] = V[:, j]
                    cols.extend([uu, -uu])
        else:
            cols.extend([u, -u])
    return np.hstack(cols) if cols else np.empty((dim, 0))


def fs_points(dim: int, degree: int = 3, kappa=None, dof: float = 4.0) -> np.ndarray:
    """Fully-symmetric unit points for Student-t densities, degree 3 or 5."""
    degree, kappa, dof = _fs_defaults(dim, degree, kappa, dof)
    I2 = dof / (dof - 2.0)
    if degree == 3:
        u = np.sqrt(I2 * (dim + kappa))
        return u * np.hstack((np.zeros((dim, 1)), np.eye(dim), -np.eye(dim)))
    I4 = 3.0 * dof ** 2 / ((dof - 2.0) * (dof - 4.0))
    u = np.sqrt(I4 / I2)
    return np.hstack((symmetric_set(dim, []), symmetric_set(dim, [u]),
                      symmetric_set(dim, [u, u])))


def fs_weights(dim: int, degree: int = 3, kappa=None, dof: float = 4.0) -> np.ndarray:
    """Fully-symmetric rule weights, degree 3 or 5."""
    degree, kappa, dof = _fs_defaults(dim, degree, kappa, dof)
    if degree == 3:
        w = 1.0 / (2.0 * (dim + kappa)) * np.ones(2 * dim + 1)
        w[0] = kappa / (dim + kappa)
        return w
    I2 = dof / (dof - 2.0)
    I22 = dof ** 2 / ((dof - 2.0) * (dof - 4.0))
    I4 = 3.0 * I22
    A0 = 1.0 - dim * (I2 / I4) ** 2 * (I4 - 0.5 * (dim - 1) * I22)
    A1 = 0.5 * (I2 / I4) ** 2 * (I4 - (dim - 1) * I22)
    A11 = 0.25 * (I2 / I4) ** 2 * I22
    return np.hstack((A0, A1 * np.ones(2 * dim), A11 * np.ones(2 * dim * (dim - 1))))


# -- Monte Carlo ---------------------------------------------------------------

def mc_points(dim: int, n: int, seed: int = 0) -> np.ndarray:
    """(dim, n) standard normal unit points for the Monte-Carlo transform,
    drawn from NumPy's ``default_rng(seed)``: the JAX package's very points."""
    rng = np.random.default_rng(seed)
    return rng.multivariate_normal(np.zeros(dim), np.eye(dim), size=int(n)).T


def mc_weights(n: int):
    """``(1/n, 1/(n-1))``: the mean and covariance weights of ``n`` points."""
    return 1.0 / n, 1.0 / (n - 1)


# -- string-keyed factory -----------------------------------------------------

def get_points(dim: int, points: str, point_par: dict | None = None) -> np.ndarray:
    """Point-set factory keyed by the reference's string acronyms."""
    points = points.lower()
    point_par = dict(point_par or {})
    if points == "sr":
        return sr_points(dim)
    if points == "ut":
        point_par.pop("beta", None)
        return ut_points(dim, **point_par)
    if points == "gh":
        return gh_points(dim, **point_par)
    if points == "fs":
        return fs_points(dim, **point_par)
    raise ValueError(f"Points '{points}' not supported. Supported: sr, ut, gh, fs.")
