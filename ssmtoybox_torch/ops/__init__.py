"""Hand-written CUDA kernels of the port, each with its plain PyTorch twin.

- :mod:`.scalar_filter` — the whole-record scalar filter kernel.
- :mod:`.vector_filter` — the whole-record filter kernel for states of
  dimension 2-8 (reentry and constant velocity with the radar).
- :mod:`.student_mc` — the RBF-Student Monte-Carlo expectations and their
  gradients (four kernels).
- :mod:`.vandermonde` — the Vandermonde matrix of multivariate monomials.
"""
from .scalar_filter import scalar_filter_batch, supports
from .student_mc import student_kxy, student_qrq

__all__ = ["scalar_filter_batch", "supports", "student_qrq", "student_kxy"]
