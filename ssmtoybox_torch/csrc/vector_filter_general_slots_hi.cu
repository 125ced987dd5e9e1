// The slot form of the general vector filter kernel for Hopper (sm_90a),
// native float64: the pairs of VGS_PAIRS with 4-D and 5-D states under
// classical Gauss-Hermite rules of 16-81 points on both transforms
// (VSL_GENERAL_HI: GH-2 and GH-3 on constant velocity with 2 and 3
// bearings, 16 and 81 points; GH-2 on the coordinated turn with the radar
// and 2 and 3 bearings and on reentry with the range and the UNGM
// measurement, 32), a trajectory on G lanes of a warp.  A source of its own
// beside vector_filter_general_slots.cu (the 2-D and 3-D states'), whose
// launcher calls this one's, so that the library's sources build in about
// the same time at once.
//
// Replaces, with the other vector filter kernels, the JAX package's
// ssmtoybox_tpu/ops/ddvec.py:514 dd_filter_batch (jnp double-double, no
// Pallas kernel), at these shapes.
//
// What bounds it, and its design: those of vector_filter_general_slots.cu.
// GH-3 on the 5-D pairs (243 points) runs in the general kernel's warp form.
//
// Built with --fmad=false (ops/vector_filter.py), as the other vector filter
// kernels: every operation rounds on its own, as in the plain PyTorch
// version, so the two agree to the bit.
#include <cuda_runtime.h>

#include "vector_filter_general_slots.cuh"

int vsl_launch_general_hi(const VslParams& p, const double* y, long long y_b, long long y_e,
                          long long y_k, int B, int n_steps, double* m_fi, double* P_fi,
                          double* m_pr, double* P_pr, double* xx, cudaStream_t stream) {
  const VfParams& q = p.base;
  const VfgStreams out = {m_fi, P_fi, m_pr, P_pr, xx};
  VSL_GENERAL_HI(VSL_GENERAL_LAUNCH_IF)
  return static_cast<int>(cudaErrorInvalidValue);
}
