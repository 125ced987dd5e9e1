"""Utilities: random variables, samplers, small linear algebra, metrics."""
from .profiling import sync, timeit, trace
from .rv import GaussianMixtureRV, GaussRV, StudentRV

__all__ = ["GaussRV", "StudentRV", "GaussianMixtureRV", "trace", "timeit", "sync"]
