"""Time-parallel filters and smoothers on one card (counterpart of
:mod:`ssmtoybox_tpu.parallel`): the associative scan, the affine and
square-root time scans, the iterated posterior-linearization smoother and
batched NLML fitting.  The JAX package's multi-device meshes and sharded
scans are not ported yet."""
from .fit import fit_kernel_params, make_fit_step, nlml_loss
from .iplf import IteratedSmootherResult, iterated_parallel_smoother, slr_affine
from .scan import associative_scan
from .sqrttime import (parallel_affine_sqrt_filter, parallel_affine_sqrt_smoother,
                       parallel_linear_sqrt_filter, parallel_linear_sqrt_smoother)
from .timescan import (parallel_affine_filter, parallel_affine_smoother, parallel_linear_filter,
                       parallel_linear_smoother)

__all__ = [
    "associative_scan", "nlml_loss", "make_fit_step", "fit_kernel_params",
    "parallel_linear_filter", "parallel_linear_smoother",
    "parallel_affine_sqrt_filter", "parallel_affine_sqrt_smoother",
    "parallel_linear_sqrt_filter", "parallel_linear_sqrt_smoother",
    "slr_affine", "parallel_affine_filter", "parallel_affine_smoother",
    "IteratedSmootherResult", "iterated_parallel_smoother",
]
