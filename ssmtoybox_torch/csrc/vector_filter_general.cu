// The general whole-record vector filter for Hopper (sm_90a), native float64:
// every model pair of the vector filter's table (reentry, constant velocity,
// the pendulum, the falling body and the coordinated turn, each with the
// radar, the sine, the range, the UNGM measurement of a state component or
// bearings from 1-8 sensors), classical (UKF, CKF, Gauss-Hermite) and BQ
// (GPQ, BSQ) rules with a scalar model variance.
//
// Replaces, with the first version (vector_filter.cu) and the shaped kernels
// (vector_filter_shaped.cu, vector_filter_shaped_bq.cu), the JAX package's
// ssmtoybox_tpu/ops/ddvec.py:514 dd_filter_batch, its engine="dd" for D <= 8,
// for the pairs those kernels have no instantiation of: ops/vector_filter.py
// (kernel_of) sends the five pairs they take to them as before, and every
// other pair here (CT + radar, bearings from 1-3 or 5-8 sensors, the UNGM
// measurement on a vector state, ...).
//
// What bounds it on this card: as for the first version, not bytes and not the
// f64 rate but the dependency chain of one trajectory (Cholesky factors,
// points through the models, moment sums, the gain solve).
//
// Design (simple and right; the step in vector_filter_general.cuh):
// - one thread a trajectory; D (2-5) and EB, a bound on the measurement
//   dimension E (2, 4, 8), are template arguments, 12 instantiations in all;
//   the transition among those of its D, the measurement, E, both rule kinds
//   and point counts are read at run time, the same in every thread, so no
//   branch diverges; every loop over measurement components runs EB
//   predicated iterations;
// - as in the first version: the rules' constants through the read-only path
//   (__ldg), the function values in a scratch buffer interleaved by
//   trajectory, time-major outputs, measurements read through three strides.
//
// Built with --fmad=false (ops/vector_filter.py), as the other vector filter
// kernels: every operation rounds on its own, as in the plain PyTorch
// version, so the two agree to the bit.
#include <cuda_runtime.h>

#include "vector_filter_general.cuh"

namespace {

// 64 threads a block, as the first version.
constexpr int kThreads = 64;

struct Streams {
  double *m_fi, *P_fi, *m_pr, *P_pr, *xx;
};

template <int D, int EB>
__global__ void __launch_bounds__(kThreads)
vector_filter_general_kernel(const __grid_constant__ VfParams p, const double* __restrict__ y,
                             long long y_b, long long y_e, long long y_k, int B, int n_steps,
                             const Streams out, double* __restrict__ scratch) {
  const long long b = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= B) return;
  vfg_record<D, EB>(p, y + b * y_b, y_e, y_k, n_steps, scratch + b, B, out.m_fi + b,
                    out.P_fi + b, out.m_pr + b, out.P_pr + b, out.xx + b, B);
}

template <int D, int EB>
void launch(const VfParams& p, const double* y, long long y_b, long long y_e, long long y_k,
            int B, int n_steps, const Streams& out, double* scratch, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(B) + kThreads - 1) /
                                                kThreads);
  vector_filter_general_kernel<D, EB><<<blocks, kThreads, 0, stream>>>(
      p, y, y_b, y_e, y_k, B, n_steps, out, scratch);
}

}  // namespace

// Launch on `stream` of card `device` without synchronising, with the
// layouts of vf_launch (vector_filter.cu): measurement e of step k of
// trajectory b at y[b * y_b + e * y_e + k * y_k], time-major outputs, scratch
// of max(n_dyn * D, n_obs * E) * B doubles.  Returns the CUDA error of
// selecting the device or, after the launch, cudaGetLastError();
// cudaErrorInvalidValue for a configuration the general step does not take.
extern "C" int vfg_launch(const VfParams* params, const double* y, long long y_b, long long y_e,
                          long long y_k, int B, int n_steps, int device, double* m_fi,
                          double* P_fi, double* m_pr, double* P_pr, double* xx, double* scratch,
                          void* stream) {
  if (B <= 0 || n_steps <= 0) return 0;
  const VfParams& p = *params;
  if (!vfg_takes(p)) return static_cast<int>(cudaErrorInvalidValue);
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: select the tensors' card explicitly
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Streams out = {m_fi, P_fi, m_pr, P_pr, xx};
  const int eb = vfg_bound(p.dim_out);
#define VFG_LAUNCH_IF(D, EB)                                                              \
  if (p.dim_state == D && eb == EB)                                                       \
    launch<D, EB>(p, y, y_b, y_e, y_k, B, n_steps, out, scratch,                          \
                  static_cast<cudaStream_t>(stream));
  VFG_SHAPES(VFG_LAUNCH_IF)
#undef VFG_LAUNCH_IF
  return static_cast<int>(cudaGetLastError());
}
