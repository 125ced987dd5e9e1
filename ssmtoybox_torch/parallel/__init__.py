"""Time-parallel filters and smoothers and meshes of ranks (counterpart of
:mod:`ssmtoybox_tpu.parallel`): the associative scan, the affine and
square-root time scans, the iterated posterior-linearization smoother,
batched NLML fitting, the time axis split over a mesh, and Monte-Carlo
studies and fits over a mesh."""
from .fit import fit_kernel_params, make_fit_step, nlml_loss
from .iplf import IteratedSmootherResult, iterated_parallel_smoother, slr_affine
from .mesh import (Mesh, filter_bank_sharded, filter_mc_sharded, make_mesh, make_multihost_mesh,
                   mc_metrics_sharded, shard_mc, shard_mc_local)
from .scan import associative_scan
from .shardtime import (sharded_associative_scan, sharded_parallel_affine_filter,
                        sharded_parallel_affine_smoother, sharded_parallel_affine_sqrt_filter,
                        sharded_parallel_affine_sqrt_smoother)
from .sqrttime import (parallel_affine_sqrt_filter, parallel_affine_sqrt_smoother,
                       parallel_linear_sqrt_filter, parallel_linear_sqrt_smoother)
from .timescan import (parallel_affine_filter, parallel_affine_smoother, parallel_linear_filter,
                       parallel_linear_smoother)

__all__ = [
    "make_mesh", "make_multihost_mesh", "shard_mc", "shard_mc_local",
    "filter_mc_sharded", "filter_bank_sharded", "mc_metrics_sharded",
    "nlml_loss", "make_fit_step", "fit_kernel_params",
    "parallel_linear_filter", "parallel_linear_smoother",
    "parallel_affine_sqrt_filter", "parallel_affine_sqrt_smoother",
    "parallel_linear_sqrt_filter", "parallel_linear_sqrt_smoother",
    "slr_affine", "parallel_affine_filter", "parallel_affine_smoother",
    "IteratedSmootherResult", "iterated_parallel_smoother",
    "sharded_associative_scan",
    "sharded_parallel_affine_filter", "sharded_parallel_affine_smoother",
    "sharded_parallel_affine_sqrt_filter",
    "sharded_parallel_affine_sqrt_smoother",
    "associative_scan", "Mesh",
]
