"""Bayesian quadrature: kernels, integrand models and BQ moment transforms,
GPQ with derivative observations included."""
from .gpqd import GaussianProcessDerModel, GaussianProcessDerTransform, RBFGaussDer
from .kernels import RBFGauss, RBFStudent
from .models import BayesSardModel, GaussianProcessModel, StudentTProcessModel
from .transforms import (BayesSardTransform, BQTransform, GaussianProcessTransform,
                         StudentTProcessTransform)

__all__ = ["RBFGauss", "RBFStudent", "GaussianProcessModel", "BayesSardModel",
           "StudentTProcessModel", "BQTransform", "GaussianProcessTransform",
           "BayesSardTransform", "StudentTProcessTransform", "RBFGaussDer",
           "GaussianProcessDerModel", "GaussianProcessDerTransform"]
