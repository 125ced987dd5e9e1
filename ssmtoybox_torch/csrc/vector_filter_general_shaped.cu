// The shaped one-thread form of the general vector filter kernel for Hopper
// (sm_90a), native float64: the table's pairs of VGS_PAIRS (the coordinated
// turn with the radar or 2-3 bearings, the pendulum, the falling body,
// constant velocity and reentry with the general kernel's other
// measurements), up to 4 measurement outputs, under classical rules at the
// UT and CKF point counts (2 D + 1 or 2 D on each transform): here one count
// on both transforms, 24 instantiations; the UKF beside the CKF in
// vector_filter_general_shaped_mixed.cu and the Gauss-Hermite counts of at
// most 11 points in vector_filter_general_shaped_gh.cu, whose launchers
// vgs_launch calls.
// The general kernel's other shapes run in vector_filter_general.cu, built
// into the same library; the registered kernel instantiates the same step on
// its generated policies (vector_filter_registered.cu).
//
// Replaces, with the other vector filter kernels, the JAX package's
// ssmtoybox_tpu/ops/ddvec.py:514 dd_filter_batch (jnp double-double, no
// Pallas kernel), at these shapes.
//
// What bounds it on this card: the dependency chain of a trajectory, not
// bytes (0.21 ms for 10,000 x 100 at D = 5 at 3.35 TB/s) and not the f64
// rate: two D x D Cholesky factors, N points through each model, the moment
// sums, an E x E factor and the gain a step, the square roots, divisions and
// transcendentals each a sequence of dependent instructions; 10,000
// trajectories are 313 warps on 528 schedulers.
//
// Design (vector_filter_general_shaped.cuh): the shaped kernel's step on the
// general step's model policies, the shape, the models and both rules'
// kinds template arguments, the rules, R and the measurement's constants by
// value in the constant bank, the points' values and offsets kept on chip,
// no scratch buffer; the point loops of costly models stay loops.
//
// Built with --fmad=false (ops/vector_filter.py), as the other vector filter
// kernels: every operation rounds on its own, as in the plain PyTorch
// version, so the two agree to the bit.
#include <cuda_runtime.h>

#include "vector_filter_general_shaped.cuh"

// Launch on the stream `st` of card `device` without synchronising; the
// layouts of vfs_launch (vector_filter_shaped.cu), no scratch buffer.
// Returns the CUDA error of selecting the device or, after the launch,
// cudaGetLastError(); cudaErrorInvalidValue for a configuration that no
// instantiation takes (vgs_takes).  Mixed point counts go to
// vgs_launch_mixed (vector_filter_general_shaped_mixed.cu), the
// Gauss-Hermite counts to vgs_launch_gh (vector_filter_general_shaped_gh.cu).
extern "C" int vgs_launch(const VgsParams* params, const double* y, long long y_b,
                          long long y_e, long long y_k, int B, int n_steps, int device,
                          double* m_fi, double* P_fi, double* m_pr, double* P_pr, double* xx,
                          void* st) {
  if (B <= 0 || n_steps <= 0) return 0;
  const VgsParams& p = *params;
  const VfParams& q = p.base;
  if (!vgs_takes(q)) return static_cast<int>(cudaErrorInvalidValue);
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: select the tensors' card explicitly
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const VfgStreams out = {m_fi, P_fi, m_pr, P_pr, xx};
  const cudaStream_t stream = static_cast<cudaStream_t>(st);
  if (q.dyn.n != q.obs.n)
    return vgs_launch_mixed(p, y, y_b, y_e, y_k, B, n_steps, out, stream);
  if (q.dyn.n != 2 * q.dim_state && q.dyn.n != 2 * q.dim_state + 1)
    return vgs_launch_gh(p, y, y_b, y_e, y_k, B, n_steps, out, stream);
  VGS_SHAPES(VGS_LAUNCH_IF)
  return static_cast<int>(cudaErrorInvalidValue);
}
