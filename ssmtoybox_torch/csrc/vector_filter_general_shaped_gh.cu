// The shaped one-thread form of the general vector filter kernel for Hopper
// (sm_90a), native float64, under classical Gauss-Hermite rules of at most 11
// points on both transforms (VGS_GH: GH-3 on the pairs of VGS_PAIRS with a
// 2-D state, 9 points; GH-2 on those with a 3-D state, 8); 5 instantiations.
// The same pairs at the UT and CKF counts are instantiated in
// vector_filter_general_shaped.cu, whose launcher (vgs_launch) calls this
// one; the sources build at once, a compiler each, into one library.
//
// Replaces, with the other vector filter kernels, the JAX package's
// ssmtoybox_tpu/ops/ddvec.py:514 dd_filter_batch (jnp double-double, no
// Pallas kernel), at these shapes.
//
// What bounds it on this card, and its design: those of the shaped form
// (vector_filter_general_shaped.cu, vector_filter_general_shaped.cuh): the
// dependency chain of a trajectory, and the step with the point count a
// template argument, each transform's point loops rolled or unrolled on its
// cost (vgs_roll).  Until this form took them, these shapes ran in the
// general one-thread form (vfg_step), N read at run time and every value
// through a scratch buffer in device memory.
//
// Built with --fmad=false (ops/vector_filter.py), as the other vector filter
// kernels: every operation rounds on its own, as in the plain PyTorch
// version, so the two agree to the bit.
#include <cuda_runtime.h>

#include "vector_filter_general_shaped.cuh"

int vgs_launch_gh(const VgsParams& p, const double* y, long long y_b, long long y_e,
                  long long y_k, int B, int n_steps, const VfgStreams& out, cudaStream_t stream) {
  const VfParams& q = p.base;
  VGS_GH(VGS_LAUNCH_IF)
  return static_cast<int>(cudaErrorInvalidValue);
}
