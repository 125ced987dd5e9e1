// The slot form of the general vector filter kernel for Hopper (sm_90a),
// native float64: the pairs of VGS_PAIRS with 2-D and 3-D states under
// classical Gauss-Hermite rules of 16-64 points on both transforms
// (VSL_GENERAL_LO: GH-4 on the pendulum with the radar, the UNGM measurement
// and 3 bearings, 16 points; GH-3 and GH-4 on the falling body with the sine
// and 4 bearings, 27 and 64), a trajectory on G lanes of a warp; the 4-D and
// 5-D states' in vector_filter_general_slots_hi.cu, whose launcher this
// one's calls.  Launched by vsl_launch (vector_filter_slots.cu), the slot
// kernel's entry point; the same pairs' other rules run in the general
// kernel's other forms (vector_filter_general.cu, the shaped form's sources).
//
// Replaces, with the other vector filter kernels, the JAX package's
// ssmtoybox_tpu/ops/ddvec.py:514 dd_filter_batch (jnp double-double, no
// Pallas kernel), at these shapes.
//
// What bounds it on this card: the dependency chain of a trajectory's step
// (two D x D Cholesky factors, N model evaluations, the moment sums over N
// points, an E x E factor and the gain), not bytes.  Until this form took
// them, these shapes ran in the general kernel's one-thread form (vfg_step),
// N read at run time and every value through a scratch buffer in device
// memory.
//
// Design (vector_filter_slots.cuh, vector_filter_general_slots.cuh): the
// slot kernel's step on the general kernel's model policy VgsZoo, each
// shape's design (lanes, the covariance sums split by row or not, offsets
// kept or made again) the one that won on the card.
//
// Built with --fmad=false (ops/vector_filter.py), as the other vector filter
// kernels: every operation rounds on its own, as in the plain PyTorch
// version, so the two agree to the bit.
#include <cuda_runtime.h>

#include "vector_filter_general_slots.cuh"

int vsl_launch_general(const VslParams& p, const double* y, long long y_b, long long y_e,
                       long long y_k, int B, int n_steps, double* m_fi, double* P_fi,
                       double* m_pr, double* P_pr, double* xx, cudaStream_t stream) {
  const VfParams& q = p.base;
  const VfgStreams out = {m_fi, P_fi, m_pr, P_pr, xx};
  VSL_GENERAL_LO(VSL_GENERAL_LAUNCH_IF)
  return vsl_launch_general_hi(p, y, y_b, y_e, y_k, B, n_steps, m_fi, P_fi, m_pr, P_pr, xx,
                               stream);
}
