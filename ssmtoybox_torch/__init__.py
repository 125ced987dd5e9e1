"""ssmtoybox_torch — the PyTorch and CUDA port of ssmtoybox_tpu.

Nonlinear sigma-point and Bayesian-quadrature Kalman filtering in float64,
batched over Monte-Carlo trajectories on an NVIDIA GPU (or the CPU).  The JAX
package ``ssmtoybox_tpu`` is the reference each part is held against; this
package never imports it, nor JAX.
"""
from . import bq, mtran, ops, points, ssinf, ssmod, utils
from .ssinf import (FilterResult, GaussianInference, GaussianProcessKalman,
                    StateSpaceInference, UnscentedKalman, gaussian_filter,
                    gaussian_filter_batch, gaussian_smoother)

__all__ = [
    "bq", "mtran", "ops", "points", "ssinf", "ssmod", "utils",
    "FilterResult", "GaussianInference", "GaussianProcessKalman",
    "StateSpaceInference", "UnscentedKalman", "gaussian_filter",
    "gaussian_filter_batch", "gaussian_smoother",
]
