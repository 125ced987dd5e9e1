"""Utilities: small linear algebra, metrics, samplers, random variables,
combinatorics, ODE steps and profiling (counterpart of
:mod:`ssmtoybox_tpu.utils`, the same flat namespace)."""
from .linalg import (
    maha,
    mat_sqrt,
    safe_cholesky,
    pd_solve,
    pd_inv,
    symmetrize,
    ellipse_points,
)
from .metrics import (
    squared_error,
    mse_matrix,
    log_cred_ratio,
    neg_log_likelihood,
    kl_divergence,
    symmetrized_kl_divergence,
    bootstrap_var,
    rmse,
    nci,
    inclination,
    nll_mean,
)
from .rand import multivariate_normal, multivariate_t, gauss_mixture, bigauss_mixture
from .rv import RandomVariable, GaussRV, StudentRV, GaussianMixtureRV
from .combin import n_sum_k, total_degree_multi_index, vandermonde, vandermonde_np
from .metrics import print_table
from .ode import ode_euler, ode_runge_kutta_4
from .profiling import trace, timeit, sync

__all__ = [
    "maha", "mat_sqrt", "safe_cholesky", "pd_solve", "pd_inv", "symmetrize", "ellipse_points",
    "squared_error", "mse_matrix", "log_cred_ratio", "neg_log_likelihood", "kl_divergence",
    "symmetrized_kl_divergence", "bootstrap_var", "rmse", "nci", "inclination", "nll_mean",
    "multivariate_normal", "multivariate_t", "gauss_mixture", "bigauss_mixture",
    "RandomVariable", "GaussRV", "StudentRV", "GaussianMixtureRV",
    "n_sum_k", "total_degree_multi_index", "vandermonde", "vandermonde_np",
    "ode_euler", "ode_runge_kutta_4",
    "print_table", "trace", "timeit", "sync",
]
