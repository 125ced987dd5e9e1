"""Bayesian quadrature: kernels, integrand models and BQ moment transforms."""
from .kernels import RBFGauss
from .models import GaussianProcessModel
from .transforms import BQTransform, GaussianProcessTransform

__all__ = ["RBFGauss", "GaussianProcessModel", "BQTransform", "GaussianProcessTransform"]
