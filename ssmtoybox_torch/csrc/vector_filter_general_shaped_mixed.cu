// The shaped one-thread form of the general vector filter kernel for Hopper
// (sm_90a), native float64, under classical rules at mixed point counts: the
// UKF (2 D + 1 points) on one transform beside the CKF (2 D) on the other,
// either way round, on the table's pairs of VGS_PAIRS; 24 instantiations.
// The same pairs at one count on both transforms are instantiated in
// vector_filter_general_shaped.cu, whose launcher (vgs_launch) calls this
// one; the two sources build at once, a compiler each, into one library.
//
// Replaces, with the other vector filter kernels, the JAX package's
// ssmtoybox_tpu/ops/ddvec.py:514 dd_filter_batch (jnp double-double, no
// Pallas kernel), at these shapes: dd_filter_batch takes a transform for
// each side, so a rule of either count on either side.
//
// What bounds it on this card, and its design: those of the shaped form
// (vector_filter_general_shaped.cu, vector_filter_general_shaped.cuh): the
// dependency chain of a trajectory, and the step with both counts template
// arguments, ND on the time update and NO on the measurement update, each
// transform's point loops rolled or unrolled on its own count (vgs_roll).
// Until this form took them, these shapes ran in the general one-thread
// form (vfg_step), N read at run time and every value through a scratch
// buffer in device memory.
//
// Built with --fmad=false (ops/vector_filter.py), as the other vector filter
// kernels: every operation rounds on its own, as in the plain PyTorch
// version, so the two agree to the bit.
#include <cuda_runtime.h>

#include "vector_filter_general_shaped.cuh"

int vgs_launch_mixed(const VgsParams& p, const double* y, long long y_b, long long y_e,
                     long long y_k, int B, int n_steps, const VfgStreams& out,
                     cudaStream_t stream) {
  const VfParams& q = p.base;
  VGS_MIXED(VGS_LAUNCH_IF)
  return static_cast<int>(cudaErrorInvalidValue);
}
