// RBF-Student Monte-Carlo expectations and their gradients for Hopper
// (sm_90a), float32 with per-block partial sums.
//
// Replaces two TPU kernels of ssmtoybox_tpu/ops/pallas_ops.py:
//   student_kxy_kernel     <- _student_kxy_kernel       (pairwise E[k(x, y)])
//   student_kxy_bwd_kernel <- _student_kxy_bwd_kernel   (its lengthscale VJP)
// and shares its library with the q/R/Q kernels (student_qrq.cu), which
// nvcc compiles beside it.  The per-element math lives in
// student_mc_rows.cuh.
//
// Precision contract (the TPU kernels'): every block sums in float32 over the
// samples (or the sample pairs) of one chunk and writes its own partial; the
// host sums the partials in float64.  No atomics, so a run is
// repeatable and the comparison with the plain PyTorch versions keeps its
// footing; no tensor cores, so no TF32 rounding reaches the partials that
// the ill-conditioned BQ weight solve would amplify.
//
// Pairwise E[k(x, y)] and its backward (student_kxy_kernel<D>,
// student_kxy_bwd_kernel<D>): the symmetric half of every chunk's sample-
// sample Gram, summed without ever being stored.  One block of 256 threads a
// chunk (<= 1024 samples) stages the chunk once into dynamic shared memory,
// scaled so that a pair's exponent comes out in base 2 (16 KB at D <= 4, 32 KB
// above), and walks the 64 x 64 tiles on or above the diagonal of the chunk's
// Gram (136 of 256 at 1024 samples).  D is a template parameter: a thread
// keeps the 4 row vectors of its 4 x 4 micro-tile in registers, loads a
// column vector with one or two 16-byte loads for 4 pairs, and evaluates a
// pair from registers in the difference form k = ex2(-|u_r - u_c|^2): 2 D + 2
// instructions with the sum (the backward adds acc_d += k (u_rd - u_cd)^2,
// 4 D in all, and nothing else: no row sums, no raw samples).  Tiles off the
// diagonal run without masks; on a diagonal tile the pairs below the diagonal
// are dropped when the kernel is compiled, and only the micro-tile's own
// diagonal and a ragged end are masked.  The forward adds the diagonal as
// the exact float C.  A thread's sums are reduced by warp shuffles and then
// over the 8 warps in turn, so a launch repeats to the bit.
//
// The bound is the special-function unit (one ex2 for each of the
// C (C - 1) / 2 pairs, 16 a clock an SM: 0.245 ms at 1,953 x 1,024), with
// the schedulers' instruction rate above it in this form (10.6 and 16.6
// instructions a pair at D = 4, 128 thread-instructions a clock an SM: 0.33
// and 0.52 ms at 1.98 GHz); the chunk is read from device memory once.  On
// an H100 80GB HBM3 (700 W) a launch at that shape takes 0.42 ms forward (48
// registers, 5 blocks an SM) and 0.63 ms backward (77 registers, 2 blocks an
// SM), CUDA events around 20 launches (tools/kxy_variants.py); the kernels
// of one block a (chunk, 128 rows) that walked the whole Gram through a
// run-time D took 5.3 and 10.1 ms.
#include <cuda_runtime.h>

#include "student_mc_rows.cuh"

namespace {

// ---- the pairwise kernels ---------------------------------------------------

// blocks an SM the pairwise kernels' registers must allow: at D <= 4 for the
// forward and the backward kernel, 2 above
#ifndef SMC_KXY_MIN_BLOCKS_FWD
#define SMC_KXY_MIN_BLOCKS_FWD 5  // 48 registers: 1,953 blocks fill 3 rounds of 660
#endif
#ifndef SMC_KXY_MIN_BLOCKS_BWD
#define SMC_KXY_MIN_BLOCKS_BWD 2
#endif
template <int D, bool BWD>
constexpr int kKxyMinBlocks = D > 4 ? 2 : BWD ? SMC_KXY_MIN_BLOCKS_BWD : SMC_KXY_MIN_BLOCKS_FWD;

// The chunk blockIdx.x of the pairwise kernels: stage, walk the tiles
// (smc_kxy_thread), reduce, and write the block's NA = 1 (forward) or D
// (backward) results to out[blockIdx.x * NA ...].
template <int D, bool BWD>
__device__ __forceinline__ void kxy_block(const float* __restrict__ inv_l,
                                          const float* __restrict__ xs, int chunk,
                                          float* __restrict__ out) {
  constexpr int NA = BWD ? D : 1;
  constexpr int kWarps = SMC_KXY_THREADS / 32;
  extern __shared__ float4 kxy_planes[];
  __shared__ float scale[SMC_MAX_D];
  __shared__ float red[kWarps * NA];
  float* s = reinterpret_cast<float*>(kxy_planes);
  const int tid = threadIdx.x;
  if (tid < D) scale[tid] = inv_l[tid] * SMC_KXY_SCALE;
  __syncthreads();
  smc_kxy_stage<D>(xs + static_cast<size_t>(blockIdx.x) * chunk * D, scale, chunk, s, tid,
                   SMC_KXY_THREADS);
  __syncthreads();
  float v[NA];
  smc_kxy_thread<D, BWD>(s, chunk, tid, v);
#pragma unroll
  for (int a = 0; a < NA; ++a) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v[a] += __shfl_down_sync(0xffffffffu, v[a], off);
    if (tid % 32 == 0) red[(tid / 32) * NA + a] = v[a];
  }
  __syncthreads();
  if (tid < NA) {
    float half = 0.f;
    for (int w = 0; w < kWarps; ++w) half += red[w * NA + tid];
    out[static_cast<size_t>(blockIdx.x) * NA + tid] = smc_kxy_finish<BWD>(half, chunk, scale[tid]);
  }
}

template <int D>
__global__ void __launch_bounds__(SMC_KXY_THREADS, kKxyMinBlocks<D, false>)
student_kxy_kernel(const float* __restrict__ inv_l, const float* __restrict__ xs, int chunk,
                   float* __restrict__ out) {
  kxy_block<D, false>(inv_l, xs, chunk, out);
}

template <int D>
__global__ void __launch_bounds__(SMC_KXY_THREADS, kKxyMinBlocks<D, true>)
student_kxy_bwd_kernel(const float* __restrict__ inv_l, const float* __restrict__ xs, int chunk,
                       float* __restrict__ out) {
  kxy_block<D, true>(inv_l, xs, chunk, out);
}

template <int D>
cudaError_t kxy_launch(bool bwd, const float* inv_l, const float* xs, int num_chunks, int chunk,
                       float* out, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * 4 * SMC_KXY_PLANES(D) * smc_kxy_padded(chunk);
  if (bwd)
    student_kxy_bwd_kernel<D><<<num_chunks, SMC_KXY_THREADS, bytes, stream>>>(inv_l, xs, chunk, out);
  else
    student_kxy_kernel<D><<<num_chunks, SMC_KXY_THREADS, bytes, stream>>>(inv_l, xs, chunk, out);
  return cudaGetLastError();
}

// Launch the pairwise kernel instantiated for D (1..SMC_MAX_D).
cudaError_t kxy_dispatch(bool bwd, const float* inv_l, const float* xs, int num_chunks,
                         int chunk, int D, int device, float* out, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 1: return kxy_launch<1>(bwd, inv_l, xs, num_chunks, chunk, out, st);
    case 2: return kxy_launch<2>(bwd, inv_l, xs, num_chunks, chunk, out, st);
    case 3: return kxy_launch<3>(bwd, inv_l, xs, num_chunks, chunk, out, st);
    case 4: return kxy_launch<4>(bwd, inv_l, xs, num_chunks, chunk, out, st);
    case 5: return kxy_launch<5>(bwd, inv_l, xs, num_chunks, chunk, out, st);
    case 6: return kxy_launch<6>(bwd, inv_l, xs, num_chunks, chunk, out, st);
    case 7: return kxy_launch<7>(bwd, inv_l, xs, num_chunks, chunk, out, st);
    case 8: return kxy_launch<8>(bwd, inv_l, xs, num_chunks, chunk, out, st);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// Every launcher runs on `stream` of card `device` without synchronising and
// returns the CUDA error of selecting the device or of the launch
// (cudaGetLastError()).  The library links its
// own CUDA runtime, whose current device is not PyTorch's.

// out: (num_chunks,) sums of the chunks' Gram matrices, diagonal included.
extern "C" int smc_kxy_launch(const float* inv_l, const float* xs, int num_chunks, int chunk,
                              int D, int device, float* out, void* stream) {
  return static_cast<int>(
      kxy_dispatch(false, inv_l, xs, num_chunks, chunk, D, device, out, stream));
}

// out: (num_chunks, D) sums over the pairs r < c of k (x_rd - x_cd)^2, t / 2.
extern "C" int smc_kxy_bwd_launch(const float* inv_l, const float* xs, int num_chunks,
                                  int chunk, int D, int device, float* out, void* stream) {
  return static_cast<int>(
      kxy_dispatch(true, inv_l, xs, num_chunks, chunk, D, device, out, stream));
}

extern "C" const char* smc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
