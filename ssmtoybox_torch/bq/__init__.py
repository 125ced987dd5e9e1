"""Bayesian quadrature: kernels, integrand models and BQ moment transforms."""
from .kernels import RBFGauss, RBFStudent
from .models import GaussianProcessModel, StudentTProcessModel
from .transforms import BQTransform, GaussianProcessTransform, StudentTProcessTransform

__all__ = ["RBFGauss", "RBFStudent", "GaussianProcessModel", "StudentTProcessModel",
           "BQTransform", "GaussianProcessTransform", "StudentTProcessTransform"]
