"""Utilities: random variables, samplers, small linear algebra, metrics."""
from .rv import GaussRV

__all__ = ["GaussRV"]
