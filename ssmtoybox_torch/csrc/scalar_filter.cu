// Whole-record scalar sigma-point filter for Hopper (sm_90a), native float64.
//
// Replaces the TPU kernel ssmtoybox_tpu/ops/ddscan_pallas.py::pallas_scalar_filter,
// which runs the whole filter record of a tile of trajectories inside one
// launch in double-double f32 pairs.  Here the card has native f64, so the
// step (scalar_filter_step.cuh) is plain f64 arithmetic.
//
// Design: one thread per trajectory.  The state (m, P) stays in registers and
// the thread loops over all N steps, so the record costs one launch instead of
// the ~30 small launches per step of an eager PyTorch filter.  Measurements
// come time-major, y[k * B + b], so at step k neighbouring threads read
// neighbouring addresses (the counterpart of the TPU kernel's (T, N, S, LANE)
// retile); the five output streams are written time-major the same way.
//
// It is built with --fmad=false (ops/scalar_filter.py): every operation rounds
// on its own, as in the plain PyTorch twin, so kernel and twin agree to the
// last bit instead of drifting apart under the chaotic UNGM map.
//
// What bounds it on this card: each thread runs a latency-bound sequential
// chain of f64 operations, with an f64 divide and two f64 square roots per
// step.  10,000 trajectories make only ~79 blocks of 128 threads for 132 SMs,
// so most of the card's f64 units idle.  Making the kernel fast (more
// independent work per SM, overlapping the chains) is left for later work.
#include <cuda_runtime.h>

#include "scalar_filter_step.cuh"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
scalar_filter_kernel(const SfParams p, const double* __restrict__ y,
                     const double* __restrict__ c, int B, int N,
                     double* __restrict__ m_fi, double* __restrict__ P_fi,
                     double* __restrict__ m_pr, double* __restrict__ P_pr,
                     double* __restrict__ xx) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  double m = p.m0, P = p.P0;
  for (int k = 0; k < N; ++k) {
    const size_t o = static_cast<size_t>(k) * B + b;
    const SfStep s = sf_step(p, m, P, y[o], __ldg(c + k));
    m_pr[o] = s.m_pr;
    P_pr[o] = s.P_pr;
    xx[o] = s.xx;
    m_fi[o] = s.m_fi;
    P_fi[o] = s.P_fi;
    m = s.m_fi;
    P = s.P_fi;
  }
}

}  // namespace

// Launch on `stream` of card `device` without synchronising.  y is (N, B)
// time-major, c is (N,), the five outputs are (N, B).  Returns the CUDA error
// of selecting the device or, after the launch, cudaGetLastError().
extern "C" int sf_launch(const SfParams* params, const double* y, const double* c,
                         int B, int N, int device, double* m_fi, double* P_fi,
                         double* m_pr, double* P_pr, double* xx, void* stream) {
  if (B <= 0 || N <= 0) return 0;
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: select the tensors' card explicitly
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = (B + kThreads - 1) / kThreads;
  scalar_filter_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *params, y, c, B, N, m_fi, P_fi, m_pr, P_pr, xx);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
