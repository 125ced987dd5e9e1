// Whole-record Gaussian filter for small vector states on Hopper (sm_90a),
// native float64, for Bayesian-quadrature rules (GPQ, BSQ; a scalar model
// variance) at the UT and CKF point counts: N = 2 D + 1 or 2 D on both
// transforms, a BQ rule on either transform or both, N and both kinds
// template arguments.  The model pairs are those of the classical shaped
// kernel (vector_filter_shaped.cu): reentry and constant velocity with the
// radar, the pendulum, the falling body with its range and the coordinated
// turn with four bearings.  A BQ rule beside the other count (2 D + 1 beside
// 2 D, either way round) runs in vector_filter_shaped_bq_mixed.cu, built
// into the same library, which this file's launcher calls; two classical
// rules at these counts, mixed or not, run in the classical shaped kernel,
// Gauss-Hermite rules of fewer than 243 points in the first version
// (vector_filter.cu).
//
// Replaces, as those kernels do, ssmtoybox_tpu/ops/ddvec.py:514
// dd_filter_batch (jnp double-double, no Pallas kernel).
//
// What bounds it on this card: the dependency chain of a trajectory, not
// bytes (0.21 ms for 10,000 x 100 at D = 5 at 3.35 TB/s) and not the f64
// rate; a BQ transform adds the N x N quadratic form, N^2 EO multiply-adds
// (605 at N = 11, EO = 5), to the chain of the classical step.
//
// Design (vector_filter_shaped.cuh, vfs_bq_moments): the classical shaped
// kernel's, one thread a trajectory, no scratch buffer in device memory, the
// point loops of the reentry, coordinated-turn and bearing models kept as
// loops to fit the instruction cache.  What the first version reads from
// device memory N^2 EO times a transform, the point values and the weights
// Wc, here stays on chip: the values in registers (or the thread's L1-cached
// local memory where the point loops stay loops), the weights by value in the
// kernel's parameters, in the constant bank, every thread reading the same
// address.  Both rules by value are 4,064 bytes, so the parameters (5,968
// bytes) pass the 4 KB that kernels could take before CUDA 12.1; the
// header's static_assert holds them to 12.1's 32,764.
//
// Built with --fmad=false, as the other two: every operation rounds on its
// own, as in the plain PyTorch version, so the two agree to the bit.
#include <cuda_runtime.h>

#include "vector_filter_shaped.cuh"

namespace {

// 64 threads a block: 10,000 trajectories are 157 blocks, one or two an SM.
constexpr int kThreads = 64;

struct Streams {
  double *m_fi, *P_fi, *m_pr, *P_pr, *xx;
};

template <int D, int E, int DYN, int OBS, int N, int KD, int KO>
__global__ void __launch_bounds__(kThreads)
vector_filter_shaped_bq_kernel(const __grid_constant__ VfsBqParams p,
                               const double* __restrict__ y, long long y_b, long long y_e,
                               long long y_k, int B, int n_steps, const Streams out) {
  const long long b = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= B) return;
  vfs_record<D, E, DYN, OBS, N, N, KD, KO>(p, y + b * y_b, y_e, y_k, n_steps, out.m_fi + b,
                                           out.P_fi + b, out.m_pr + b, out.P_pr + b, out.xx + b,
                                           B);
}

}  // namespace

// The mixed point counts' launcher (vector_filter_shaped_bq_mixed.cu).
int vfs_bq_launch_mixed(const VfsBqParams* params, const double* y, long long y_b,
                        long long y_e, long long y_k, int B, int n_steps, double* m_fi,
                        double* P_fi, double* m_pr, double* P_pr, double* xx,
                        cudaStream_t stream);

// Launch on `stream` of card `device` without synchronising; the layouts of
// vfs_launch (vector_filter_shaped.cu).  Returns the CUDA error of selecting
// the device or, after the launch, cudaGetLastError();
// cudaErrorInvalidValue for a configuration that no instantiation takes
// (both rules classical, a count other than 2 D + 1 or 2 D, a model pair
// without a kernel form).
extern "C" int vfs_bq_launch(const VfsBqParams* params, const double* y, long long y_b,
                             long long y_e, long long y_k, int B, int n_steps, int device,
                             double* m_fi, double* P_fi, double* m_pr, double* P_pr,
                             double* xx, void* stream) {
  if (B <= 0 || n_steps <= 0) return 0;
  const VfParams& q = params->base;
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: select the tensors' card explicitly
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  if (q.dyn.n != q.obs.n)
    return vfs_bq_launch_mixed(params, y, y_b, y_e, y_k, B, n_steps, m_fi, P_fi, m_pr, P_pr, xx,
                               static_cast<cudaStream_t>(stream));
  const Streams out = {m_fi, P_fi, m_pr, P_pr, xx};
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(B) + kThreads - 1) /
                                                kThreads);
  bool ran = false;
#define VFS_BQ_LAUNCH_IF(D, E, DYN, OBS, N, KD, KO)                                          \
  if (!ran && q.dyn_model == DYN && q.obs_model == OBS && q.dim_state == D &&                \
      q.dim_out == E && q.dyn.n == N && q.dyn.kind == KD && q.obs.kind == KO) {              \
    vector_filter_shaped_bq_kernel<D, E, DYN, OBS, N, KD, KO>                                \
        <<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(*params, y, y_b, y_e,   \
                                                                     y_k, B, n_steps, out);  \
    ran = true;                                                                              \
  }
  VFS_BQ_SHAPES(VFS_BQ_LAUNCH_IF)
#undef VFS_BQ_LAUNCH_IF
  if (!ran) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
