"""Bayesian quadrature: kernels, integrand models and BQ moment transforms,
single- and multi-output, GPQ with derivative observations included."""
from .gpqd import GaussianProcessDerModel, GaussianProcessDerTransform, RBFGaussDer
from .kernels import RQ, Kernel, RBFGauss, RBFStudent, get_kernel
from .models import (BayesSardModel, GaussianProcessModel, GaussianProcessMO, Model,
                     MultiOutputModel, StudentTProcessModel, StudentTProcessMO)
from .transforms import (BayesSardTransform, BQTransform, GaussianProcessTransform,
                         MultiOutputGaussianProcessTransform, MultiOutputStudentTProcessTransform,
                         StudentTProcessTransform)

__all__ = ["Kernel", "RBFGauss", "RBFStudent", "RQ", "get_kernel", "Model",
           "GaussianProcessModel", "BayesSardModel", "StudentTProcessModel", "MultiOutputModel",
           "GaussianProcessMO", "StudentTProcessMO", "BQTransform", "GaussianProcessTransform",
           "BayesSardTransform", "StudentTProcessTransform",
           "MultiOutputGaussianProcessTransform", "MultiOutputStudentTProcessTransform",
           "RBFGaussDer", "GaussianProcessDerModel", "GaussianProcessDerTransform"]
