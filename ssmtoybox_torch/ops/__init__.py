"""Hand-written CUDA kernels of the port, each with its plain PyTorch twin.

- :mod:`.scalar_filter` — the whole-record scalar filter kernel.
"""
from .scalar_filter import scalar_filter_batch, supports

__all__ = ["scalar_filter_batch", "supports"]
