"""Utilities: random variables, samplers, small linear algebra, metrics."""
from .rv import GaussianMixtureRV, GaussRV, StudentRV

__all__ = ["GaussRV", "StudentRV", "GaussianMixtureRV"]
