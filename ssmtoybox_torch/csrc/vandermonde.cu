// Vandermonde matrix of multivariate monomials for Hopper (sm_90a), float64.
//
// Replaces the TPU kernel ssmtoybox_tpu/ops/pallas_ops.py::_vandermonde_kernel
// (via pallas_ops.vandermonde), which unrolls a static multi-index over one
// VMEM block in float32 because Mosaic has no f64 ALU; the library's BSQ code
// therefore called the exact f64 jnp version instead.  The card has native
// f64, so this one kernel computes exactly what utils/combin.py::vandermonde
// computes, and BayesSardModel runs it for every weight build and in the
// Monte-Carlo verifiers.
//
// Design: one thread per output element out[n, b] (row-major (N, Q)), with b
// fastest, so neighbouring threads store to neighbouring addresses; a
// grid-stride loop covers any N * Q.  Each block stages the (D, Q) int32
// multi-index in dynamic shared memory (<= 48 KB, the wrapper checks); each
// thread reads its point's D coordinates x[:, n] (threads of one row read the
// same address, a broadcast).  The per-element product is vdm_entry in
// vandermonde_cols.cuh.
//
// What bounds it on this card: the bytes written.  It reads D * N * 8 B and
// writes N * Q * 8 B (168 MB at N = 1e6, Q = 21) against 3.35 TB/s, and does
// at most a few f64 multiplies an output element, far under the f64 rate.
#include <cuda_runtime.h>

#include "vandermonde_cols.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
vandermonde_kernel(const double* __restrict__ x, const int* __restrict__ mul, int D,
                   long long N, int Q, double* __restrict__ out) {
  extern __shared__ int s_mul[];
  for (int i = threadIdx.x; i < D * Q; i += blockDim.x) s_mul[i] = mul[i];
  __syncthreads();
  const long long total = N * Q;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long idx = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       idx < total; idx += stride) {
    const long long n = idx / Q;
    const int b = static_cast<int>(idx - n * Q);
    out[idx] = vdm_entry(x + n, N, s_mul + b, Q, D);
  }
}

}  // namespace

// Launch on `stream` of card `device` without synchronising.  x is (D, N)
// row-major f64, mul (D, Q) row-major int32, out (N, Q) row-major f64.
// Returns the CUDA error of selecting the device or, after the launch,
// cudaGetLastError().
extern "C" int vdm_launch(const double* x, const int* mul, int D, long long N, int Q,
                          int device, double* out, void* stream) {
  if (N <= 0 || Q <= 0) return 0;
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: select the tensors' card explicitly
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const long long total = N * Q;
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;  // 16 blocks an SM, then stride
  const size_t smem = static_cast<size_t>(D) * Q * sizeof(int);
  vandermonde_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                       static_cast<cudaStream_t>(stream)>>>(x, mul, D, N, Q, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vdm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
