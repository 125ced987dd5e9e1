// Whole-record Gaussian sigma-point filter for small vector states on Hopper
// (sm_90a), native float64, for the configurations of the main path: the
// reentry and constant-velocity models with the range-bearing radar, and the
// pendulum, the falling body with its range and the coordinated turn with
// four bearings, under classical rules at the UT and CKF point counts (2 D +
// 1 or 2 D on each transform: one count on both, or the UKF beside the CKF)
// and at the Gauss-Hermite counts of at most 11 points on both transforms
// (VFS_GH: the pendulum under GH-3, the falling body under GH-2), both
// counts template arguments.  The fused vector filter's other
// configurations of these pairs run in the library's other kernels: GPQ and
// BSQ rules at the UT and CKF counts in vector_filter_shaped_bq.cu and
// vector_filter_shaped_bq_mixed.cu, Gauss-Hermite rules of 16-81 points in
// vector_filter_slots.cu, rules of many points in the general kernel's warp
// form, everything else (other Gauss-Hermite counts, a BQ rule at a
// Gauss-Hermite count) in the first-version kernel of vector_filter.cu.
//
// Replaces, as that kernel does, ssmtoybox_tpu/ops/ddvec.py:514
// dd_filter_batch (jnp double-double, no Pallas kernel).
//
// What bounds it on this card: the dependency chain of a trajectory, not
// bytes (0.21 ms for 10,000 x 100 at 3.35 TB/s) and not the f64 rate.  A
// step is two 5 x 5 Cholesky factors, 11 points through the model and 11
// through the radar, the moment sums, a 2 x 2 factor and the gain, the f64
// square roots, divides, exp and atan2 each a sequence of dependent
// instructions with a branch to its slow path; 10,000 trajectories are 313
// warps on 528 schedulers, so nothing hides them.
//
// Design (vector_filter_shaped.cuh): one thread a trajectory, as the first
// version; the rules' shape and constants at compile time; every point's
// value and offset computed once and kept on chip (registers, or L1 where the
// reentry, coordinated-turn or bearing loops stay loops to fit the instruction
// cache), no
// scratch buffer in device memory; time-major streams, neighbouring
// trajectories at neighbouring addresses.  Splitting a trajectory over 2, 4
// or 8 lanes of a warp (the points split, the sums split by entry and
// gathered by shuffle, as the scalar filter kernel does) was measured and
// lost: the Cholesky factors, the gain and the update then run in every
// lane, and the extra instructions cost more than the shorter chain saved
// (PERF.md, section 6).
//
// Built with --fmad=false, as the first version: every operation rounds on its
// own, as in the plain PyTorch version, so the two agree to the bit.
#include <cuda_runtime.h>

#include "vector_filter_shaped.cuh"

namespace {

// 64 threads a block: 10,000 trajectories are 157 blocks, one or two an SM.
constexpr int kThreads = 64;

struct Streams {
  double *m_fi, *P_fi, *m_pr, *P_pr, *xx;
};

template <int D, int E, int DYN, int OBS, int ND, int NO>
__global__ void __launch_bounds__(kThreads)
vector_filter_shaped_kernel(const __grid_constant__ VfsParams p, const double* __restrict__ y,
                            long long y_b, long long y_e, long long y_k, int B, int n_steps,
                            const Streams out) {
  const long long b = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= B) return;
  vfs_record<D, E, DYN, OBS, ND, NO>(p, y + b * y_b, y_e, y_k, n_steps, out.m_fi + b,
                                     out.P_fi + b, out.m_pr + b, out.P_pr + b, out.xx + b, B);
}

}  // namespace

// Launch on `stream` of card `device` without synchronising; the layouts of
// vf_launch (vector_filter.cu), no scratch buffer.  Returns the CUDA error of
// selecting the device or, after the launch, cudaGetLastError();
// cudaErrorInvalidValue for a configuration that no instantiation takes (a
// rule of another kind, point counts that VFS_SHAPES does not list, a model
// pair without a kernel form).
extern "C" int vfs_launch(const VfsParams* params, const double* y, long long y_b,
                          long long y_e, long long y_k, int B, int n_steps, int device,
                          double* m_fi, double* P_fi, double* m_pr, double* P_pr, double* xx,
                          void* stream) {
  if (B <= 0 || n_steps <= 0) return 0;
  const VfParams& q = params->base;
  if (q.dyn.kind != 0 || q.obs.kind != 0) return static_cast<int>(cudaErrorInvalidValue);
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: select the tensors' card explicitly
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Streams out = {m_fi, P_fi, m_pr, P_pr, xx};
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(B) + kThreads - 1) /
                                                kThreads);
  bool ran = false;
#define VFS_LAUNCH_IF(D, E, DYN, OBS, ND, NO)                                               \
  if (!ran && q.dyn_model == DYN && q.obs_model == OBS && q.dim_state == D &&               \
      q.dim_out == E && q.dyn.n == ND && q.obs.n == NO) {                                   \
    vector_filter_shaped_kernel<D, E, DYN, OBS, ND, NO>                                     \
        <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*params, y, y_b, y_e,  \
                                                                     y_k, B, n_steps, out); \
    ran = true;                                                                             \
  }
  VFS_SHAPES(VFS_LAUNCH_IF)
#undef VFS_LAUNCH_IF
  if (!ran) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
