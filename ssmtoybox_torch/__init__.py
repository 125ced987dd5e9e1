"""ssmtoybox_torch — the PyTorch and CUDA port of ssmtoybox_tpu.

Nonlinear sigma-point and Bayesian-quadrature Kalman and Student-t filtering
in float64, batched over Monte-Carlo trajectories on an NVIDIA GPU.  The
port runs on the CUDA card by default; ``set_device("cpu")`` runs it on the
CPU.  The JAX package ``ssmtoybox_tpu`` is the reference each part is held
against; this package never imports it, nor JAX.
"""
from . import bq, mtran, online, ops, points, ssinf, ssmod, utils
from .ssinf import (BayesSardKalman, CubatureKalman, ExtendedKalman, ExtendedKalmanGPQD,
                    ExtendedStudent, FilterResult, FullySymmetricStudent, GaussHermiteKalman,
                    GaussianInference, GaussianProcessDerKalman, GaussianProcessKalman,
                    GPQStudent, IteratedPosteriorLinearizationKalman, MarginalInference,
                    MarginalizedGaussianProcessKalman,
                    MultiOutputGaussianProcessKalman, MultiOutputStudentProcessStudent,
                    StateSpaceInference, StudentFilterResult, StudentianInference,
                    StudentProcessKalman, StudentProcessStudent, TruncatedCubatureKalman,
                    TruncatedGaussHermiteKalman, TruncatedUnscentedKalman, UnscentedKalman,
                    gaussian_filter, gaussian_filter_batch, gaussian_smoother,
                    iterated_gaussian_filter, slr_affine, studentian_filter,
                    studentian_filter_batch, studentian_smoother)
from .utils.arrays import default_device, set_device

__all__ = [
    "bq", "mtran", "online", "ops", "points", "ssinf", "ssmod", "utils",
    "default_device", "set_device",
    "FilterResult", "GaussianInference", "GaussianProcessKalman",
    "StateSpaceInference", "UnscentedKalman", "GaussHermiteKalman", "CubatureKalman",
    "BayesSardKalman", "ExtendedKalman", "TruncatedUnscentedKalman", "TruncatedCubatureKalman",
    "TruncatedGaussHermiteKalman", "GaussianProcessDerKalman", "ExtendedKalmanGPQD",
    "gaussian_filter", "gaussian_filter_batch", "gaussian_smoother",
    "StudentFilterResult", "StudentianInference", "FullySymmetricStudent", "GPQStudent",
    "StudentProcessStudent", "StudentProcessKalman", "ExtendedStudent", "studentian_filter",
    "studentian_filter_batch", "studentian_smoother",
    "IteratedPosteriorLinearizationKalman", "iterated_gaussian_filter", "slr_affine",
    "MultiOutputGaussianProcessKalman", "MultiOutputStudentProcessStudent",
    "MarginalInference", "MarginalizedGaussianProcessKalman",
]
