// The kernel of the BQ shapes (vector_filter_shaped_bq.cu) at mixed point
// counts, for Hopper (sm_90a), native float64: the UT count (2 D + 1) on one
// transform beside the CKF count (2 D) on the other, either way round, with
// a BQ rule (GPQ, BSQ; a scalar model variance) on either transform or both,
// on the five model pairs of VFS_PAIRS (VFS_BQ_MIXED, 30 instantiations).
// The same pairs at one count on both transforms are instantiated in
// vector_filter_shaped_bq.cu, whose launcher (vfs_bq_launch) calls this one;
// the two sources build at once, a compiler each, into one library.
//
// Replaces, with the other vector filter kernels, the JAX package's
// ssmtoybox_tpu/ops/ddvec.py:514 dd_filter_batch (jnp double-double, no
// Pallas kernel), at these shapes: dd_filter_batch takes a transform for
// each side, so a rule of either count and kind on either side.
//
// What bounds it on this card, and its design: those of the BQ shapes at one
// count (vector_filter_shaped_bq.cu): the dependency chain of a trajectory,
// one thread a trajectory, both rules (dense Wc included) by value in the
// kernel's parameters, the values on chip; the step with both counts
// template arguments (vfs_step_with<D, E, ND, NO, ...>), ND on the time
// update and NO on the measurement update, as the classical shaped kernel
// takes the UKF beside the CKF.  Until these shapes were instantiated they
// ran in the first-version kernel (vector_filter.cu): N read at run time,
// every value and weight of the quadratic form read from device memory.
//
// Built with --fmad=false (ops/vector_filter.py), as the other vector filter
// kernels: every operation rounds on its own, as in the plain PyTorch
// version, so the two agree to the bit.
#include <cuda_runtime.h>

#include "vector_filter_shaped.cuh"

namespace {

// 64 threads a block, as at one count.
constexpr int kThreads = 64;

struct Streams {
  double *m_fi, *P_fi, *m_pr, *P_pr, *xx;
};

template <int D, int E, int DYN, int OBS, int ND, int NO, int KD, int KO>
__global__ void __launch_bounds__(kThreads)
vector_filter_shaped_bq_mixed_kernel(const __grid_constant__ VfsBqParams p,
                                     const double* __restrict__ y, long long y_b, long long y_e,
                                     long long y_k, int B, int n_steps, const Streams out) {
  const long long b = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= B) return;
  vfs_record<D, E, DYN, OBS, ND, NO, KD, KO>(p, y + b * y_b, y_e, y_k, n_steps, out.m_fi + b,
                                             out.P_fi + b, out.m_pr + b, out.P_pr + b,
                                             out.xx + b, B);
}

}  // namespace

// Launch the mixed-count configuration *params on `stream` (the card already
// selected) without synchronising, with vfs_bq_launch's layouts; returns
// cudaGetLastError() after the launch, cudaErrorInvalidValue for a
// configuration that no instantiation takes.
int vfs_bq_launch_mixed(const VfsBqParams* params, const double* y, long long y_b,
                        long long y_e, long long y_k, int B, int n_steps, double* m_fi,
                        double* P_fi, double* m_pr, double* P_pr, double* xx,
                        cudaStream_t stream) {
  const VfParams& q = params->base;
  const Streams out = {m_fi, P_fi, m_pr, P_pr, xx};
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(B) + kThreads - 1) /
                                                kThreads);
  bool ran = false;
#define VFS_BQ_MIXED_LAUNCH_IF(D, E, DYN, OBS, ND, NO, KD, KO)                               \
  if (!ran && q.dyn_model == DYN && q.obs_model == OBS && q.dim_state == D &&                \
      q.dim_out == E && q.dyn.n == ND && q.obs.n == NO && q.dyn.kind == KD &&                \
      q.obs.kind == KO) {                                                                    \
    vector_filter_shaped_bq_mixed_kernel<D, E, DYN, OBS, ND, NO, KD, KO>                     \
        <<<blocks, kThreads, 0, stream>>>(*params, y, y_b, y_e, y_k, B, n_steps, out);       \
    ran = true;                                                                              \
  }
  VFS_BQ_MIXED(VFS_BQ_MIXED_LAUNCH_IF)
#undef VFS_BQ_MIXED_LAUNCH_IF
  if (!ran) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
