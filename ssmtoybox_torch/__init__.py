"""ssmtoybox_torch — the PyTorch and CUDA port of ssmtoybox_tpu.

Nonlinear sigma-point and Bayesian-quadrature Kalman and Student-t filtering
in float64, batched over Monte-Carlo trajectories on an NVIDIA GPU.  The
port runs on the CUDA card by default; ``set_device("cpu")`` runs it on the
CPU.  The JAX package ``ssmtoybox_tpu`` is the reference each part is held
against; this package never imports it, nor JAX.
"""
from . import bq, mtran, online, ops, parallel, points, sqrt, ssinf, ssmod, utils
from .mtran import (FullySymmetricStudentTransform, GaussHermiteTransform,
                    LinearizationTransform, MonteCarloTransform, SigmaPointTransform,
                    SphericalRadialTransform, TaylorGPQDTransform, UnscentedTransform)
from .sqrt import (FixedLagSqrtState, FixedLagSqrtStudentState, SqrtFilterResult,
                   SqrtOnlineState, SqrtStepInfo, SqrtStudentFilterResult,
                   SqrtStudentOnlineState, SquareRootKalman, SquareRootStudent,
                   make_fixed_lag_sqrt_smoother, make_fixed_lag_sqrt_student_smoother,
                   make_online_sqrt_filter, make_online_sqrt_student_filter, make_sqrt_filter,
                   make_sqrt_smoother, make_sqrt_studentian_filter,
                   make_sqrt_studentian_smoother)
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
from .utils.rv import GaussianMixtureRV, GaussRV, StudentRV

__all__ = [
    "bq", "mtran", "online", "ops", "parallel", "points", "sqrt", "ssinf", "ssmod", "utils",
    "default_device", "set_device", "GaussRV", "StudentRV", "GaussianMixtureRV",
    "LinearizationTransform", "MonteCarloTransform", "SigmaPointTransform",
    "SphericalRadialTransform", "UnscentedTransform", "GaussHermiteTransform",
    "FullySymmetricStudentTransform", "TaylorGPQDTransform",
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
    "SqrtFilterResult", "make_sqrt_filter", "make_sqrt_smoother", "SquareRootKalman",
    "SqrtOnlineState", "SqrtStepInfo", "make_online_sqrt_filter", "FixedLagSqrtState",
    "make_fixed_lag_sqrt_smoother", "SqrtStudentFilterResult", "make_sqrt_studentian_filter",
    "make_sqrt_studentian_smoother", "SqrtStudentOnlineState",
    "make_online_sqrt_student_filter", "SquareRootStudent", "FixedLagSqrtStudentState",
    "make_fixed_lag_sqrt_student_smoother",
]
