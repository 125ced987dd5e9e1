// RBF-Student Monte-Carlo expectations and their gradients for Hopper
// (sm_90a), float32 with per-block partial sums.
//
// Replaces four TPU kernels of ssmtoybox_tpu/ops/pallas_ops.py:
//   student_qrq_kernel     <- _student_exp_kernel       (q, R, Q per chunk)
//   student_qrq_bwd_kernel <- _student_qRQ_bwd_kernel   (its VJP partials)
//   student_kxy_kernel     <- _student_kxy_kernel       (pairwise E[k(x, y)])
//   student_kxy_bwd_kernel <- _student_kxy_bwd_kernel   (its lengthscale VJP)
// The per-element math lives in student_mc_rows.cuh.
//
// Precision contract (the TPU kernels'): every block sums in float32 over the
// samples of one chunk (or one tile of rows of a chunk) and writes its own
// partial; the host sums the partials in float64.  No atomics, so a run is
// repeatable and the comparison with the plain PyTorch versions keeps its
// footing; no tensor cores, so no TF32 rounding reaches the partials that
// the ill-conditioned BQ weight solve would amplify.
//
// q/R/Q and its backward: one block per chunk of samples (4096 on the study
// path).  The block walks its chunk in tiles of SMC_TILE samples: it stages
// the tile's raw and scaled samples, evaluates the tile's Gram against the
// N <= 128 points in shared memory, and each thread adds the tile's
// contribution to the outputs it owns (output o belongs to thread
// o mod blockDim), whose running sums also live in shared memory.  At the
// study shape (D = 4, N = 9, 2e6 samples) this reads 32 MB and does ~3e8
// flops: it is bound by latency and by the ~490 blocks it has, not by the
// card's bandwidth or arithmetic.
//
// Pairwise E[k(x, y)] and its backward: one block per (chunk, tile of
// SMC_ROWS rows); the chunk's scaled samples (<= 1024 x 8 floats) are staged
// in shared memory and each thread sums one row against all columns of the
// chunk, so the chunk's 1024 x 1024 Gram never exists in memory.  A block
// tree-reduces its rows in a fixed order.  At the study shape (~2e9 pairs)
// it is bound by instruction issue and shared-memory loads (the row and the
// column go through a runtime-D loop), with 37 KB of static shared memory a
// block capping residency at 6 blocks an SM; on an H100 80GB HBM3 (700 W)
// the forward pass took 5.3 ms, ~11x the time the pairs' exp alone needs.
#include <cuda_runtime.h>

#include "student_mc_rows.cuh"

namespace {

constexpr int kThreads = 256;

// float offsets of the dynamic shared memory of the q/R/Q kernels
struct QrqLayout {
  int p, p2, x, s, s2, k, m, rowsum, acc, total;
  __host__ __device__ QrqLayout(int N, int D, int n_out) {
    p = 0;
    p2 = p + N * D;
    x = p2 + N;
    s = x + SMC_TILE * D;
    s2 = s + SMC_TILE * D;
    k = s2 + SMC_TILE;
    m = k + SMC_TILE * N;
    rowsum = m + SMC_TILE * N;
    acc = rowsum + SMC_TILE;
    total = acc + n_out;
  }
};

// Stage the points (scaled) and zero the accumulators.
__device__ void qrq_setup(const float* __restrict__ xp, const float* il, int N, int D,
                          int n_out, float* p, float* p2, float* acc) {
  for (int n = threadIdx.x; n < N; n += blockDim.x) p2[n] = smc_scale(xp + n * D, il, D, p + n * D);
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) acc[o] = 0.f;
}

// Stage T samples of a tile (raw and scaled) and their Gram against the points.
__device__ void qrq_tile(const float* __restrict__ xt, const float* il, int T, int N, int D,
                         const float* p, const float* p2, float* x, float* s, float* s2,
                         float* k) {
  __syncthreads();  // the previous tile has been consumed
  for (int e = threadIdx.x; e < T * D; e += blockDim.x) x[e] = xt[e];
  __syncthreads();
  for (int t = threadIdx.x; t < T; t += blockDim.x) s2[t] = smc_scale(x + t * D, il, D, s + t * D);
  __syncthreads();
  for (int e = threadIdx.x; e < T * N; e += blockDim.x) {
    const int t = e / N, n = e % N;
    k[e] = smc_gram(s + t * D, p + n * D, s2[t], p2[n], D);
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads)
student_qrq_kernel(const float* __restrict__ inv_l, const float* __restrict__ xs,
                   const float* __restrict__ xp, int chunk, int N, int D,
                   float* __restrict__ out) {
  extern __shared__ float sm[];
  __shared__ float il[SMC_MAX_D];
  const int n_out = N + D * N + N * N;
  const QrqLayout L(N, D, n_out);
  if (threadIdx.x < D) il[threadIdx.x] = inv_l[threadIdx.x];
  __syncthreads();
  qrq_setup(xp, il, N, D, n_out, sm + L.p, sm + L.p2, sm + L.acc);
  const float* xc = xs + static_cast<size_t>(blockIdx.x) * chunk * D;
  for (int t0 = 0; t0 < chunk; t0 += SMC_TILE) {
    const int T = min(SMC_TILE, chunk - t0);
    qrq_tile(xc + static_cast<size_t>(t0) * D, il, T, N, D, sm + L.p, sm + L.p2, sm + L.x,
             sm + L.s, sm + L.s2, sm + L.k);
    for (int o = threadIdx.x; o < n_out; o += blockDim.x)
      sm[L.acc + o] += smc_qrq_term(o, T, N, D, sm + L.x, sm + L.k);
  }
  float* oc = out + static_cast<size_t>(blockIdx.x) * n_out;
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) oc[o] = sm[L.acc + o];
}

__global__ void __launch_bounds__(kThreads)
student_qrq_bwd_kernel(const float* __restrict__ inv_l, const float* __restrict__ xs,
                       const float* __restrict__ xp, const float* __restrict__ gq,
                       const float* __restrict__ gR, const float* __restrict__ gQ2, int chunk,
                       int N, int D, float* __restrict__ out) {
  extern __shared__ float sm[];
  __shared__ float il[SMC_MAX_D];
  const int n_out = N + D * N + D;
  const QrqLayout L(N, D, n_out);
  if (threadIdx.x < D) il[threadIdx.x] = inv_l[threadIdx.x];
  __syncthreads();
  qrq_setup(xp, il, N, D, n_out, sm + L.p, sm + L.p2, sm + L.acc);
  const float* xc = xs + static_cast<size_t>(blockIdx.x) * chunk * D;
  for (int t0 = 0; t0 < chunk; t0 += SMC_TILE) {
    const int T = min(SMC_TILE, chunk - t0);
    qrq_tile(xc + static_cast<size_t>(t0) * D, il, T, N, D, sm + L.p, sm + L.p2, sm + L.x,
             sm + L.s, sm + L.s2, sm + L.k);
    for (int e = threadIdx.x; e < T * N; e += blockDim.x) {
      const int t = e / N, n = e % N;
      sm[L.m + e] = smc_bwd_m(n, N, D, sm + L.x + t * D, sm + L.k + t * N, gq, gR, gQ2);
    }
    __syncthreads();
    for (int t = threadIdx.x; t < T; t += blockDim.x) {
      float r = 0.f;
      for (int n = 0; n < N; ++n) r += sm[L.m + t * N + n];
      sm[L.rowsum + t] = r;
    }
    __syncthreads();
    for (int o = threadIdx.x; o < n_out; o += blockDim.x)
      sm[L.acc + o] += smc_bwd_term(o, T, N, D, sm + L.x, sm + L.m, sm + L.rowsum);
  }
  float* oc = out + static_cast<size_t>(blockIdx.x) * n_out;
  for (int o = threadIdx.x; o < n_out; o += blockDim.x) oc[o] = sm[L.acc + o];
}

// Stage the scaled samples of chunk blockIdx.x and their squared norms.
__device__ void kxy_stage(const float* __restrict__ inv_l, const float* __restrict__ xc,
                          int chunk, int D, float* il, float* s, float* s2) {
  if (threadIdx.x < D) il[threadIdx.x] = inv_l[threadIdx.x];
  __syncthreads();
  for (int c = threadIdx.x; c < chunk; c += blockDim.x) s2[c] = smc_scale(xc + c * D, il, D, s + c * D);
  __syncthreads();
}

// Sum of v over the block's SMC_ROWS threads in a fixed tree order.
__device__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int h = SMC_ROWS / 2; h > 0; h >>= 1) {
    if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
    __syncthreads();
  }
  const float r = red[0];
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(SMC_ROWS)
student_kxy_kernel(const float* __restrict__ inv_l, const float* __restrict__ xs, int chunk,
                   int D, float* __restrict__ out) {
  __shared__ float il[SMC_MAX_D];
  __shared__ float s[SMC_KXY_MAX_CHUNK * SMC_MAX_D];
  __shared__ float s2[SMC_KXY_MAX_CHUNK];
  __shared__ float red[SMC_ROWS];
  kxy_stage(inv_l, xs + static_cast<size_t>(blockIdx.x) * chunk * D, chunk, D, il, s, s2);
  const int r = blockIdx.y * SMC_ROWS + threadIdx.x;
  const float v = r < chunk ? smc_kxy_row(r, chunk, D, s, s2, nullptr, nullptr) : 0.f;
  const float total = block_sum(v, red);
  if (threadIdx.x == 0) out[static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y] = total;
}

__global__ void __launch_bounds__(SMC_ROWS)
student_kxy_bwd_kernel(const float* __restrict__ inv_l, const float* __restrict__ xs, int chunk,
                       int D, float* __restrict__ out) {
  __shared__ float il[SMC_MAX_D];
  __shared__ float s[SMC_KXY_MAX_CHUNK * SMC_MAX_D];
  __shared__ float s2[SMC_KXY_MAX_CHUNK];
  __shared__ float red[SMC_ROWS];
  const float* xc = xs + static_cast<size_t>(blockIdx.x) * chunk * D;
  kxy_stage(inv_l, xc, chunk, D, il, s, s2);
  const int r = blockIdx.y * SMC_ROWS + threadIdx.x;
  float kx[SMC_MAX_D];
  float rs = 0.f;
  if (r < chunk) rs = smc_kxy_row(r, chunk, D, s, s2, xc, kx);
  // t_d / 2 = sum_r x_rd^2 rowsum_r - x_rd (k x)_rd; the diagonal pair adds 0
  float* oc = out + (static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y) * D;
  for (int d = 0; d < D; ++d) {
    const float x = r < chunk ? xc[r * D + d] : 0.f;
    const float v = r < chunk ? x * x * rs - x * kx[d] : 0.f;
    const float total = block_sum(v, red);
    if (threadIdx.x == 0) oc[d] = total;
  }
}

// Raise the dynamic shared-memory limit of `kernel` when `bytes` needs it.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace

// Every launcher runs on `stream` of card `device` without synchronising and
// returns the CUDA error of selecting the device, of the shared-memory
// attribute, or of the launch (cudaGetLastError()).  The library links its
// own CUDA runtime, whose current device is not PyTorch's.

// out: (num_chunks, N + D N + N N) per-chunk partials of (q, R, Q).
extern "C" int smc_qrq_launch(const float* inv_l, const float* xs, const float* xp,
                              int num_chunks, int chunk, int N, int D, int device, float* out,
                              void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t bytes = sizeof(float) * QrqLayout(N, D, N + D * N + N * N).total;
  e = allow_smem(student_qrq_kernel, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  student_qrq_kernel<<<num_chunks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      inv_l, xs, xp, chunk, N, D, out);
  return static_cast<int>(cudaGetLastError());
}

// out: (num_chunks, N + D N + D) per-chunk partials (cs, B, u).
extern "C" int smc_qrq_bwd_launch(const float* inv_l, const float* xs, const float* xp,
                                  const float* gq, const float* gR, const float* gQ2,
                                  int num_chunks, int chunk, int N, int D, int device,
                                  float* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t bytes = sizeof(float) * QrqLayout(N, D, N + D * N + D).total;
  e = allow_smem(student_qrq_bwd_kernel, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  student_qrq_bwd_kernel<<<num_chunks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      inv_l, xs, xp, gq, gR, gQ2, chunk, N, D, out);
  return static_cast<int>(cudaGetLastError());
}

// out: (num_chunks, tiles) row-tile sums of the chunks' Gram matrices.
extern "C" int smc_kxy_launch(const float* inv_l, const float* xs, int num_chunks, int chunk,
                              int D, int device, float* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(num_chunks, (chunk + SMC_ROWS - 1) / SMC_ROWS);
  student_kxy_kernel<<<grid, SMC_ROWS, 0, static_cast<cudaStream_t>(stream)>>>(
      inv_l, xs, chunk, D, out);
  return static_cast<int>(cudaGetLastError());
}

// out: (num_chunks, tiles, D) row-tile partials of t / 2.
extern "C" int smc_kxy_bwd_launch(const float* inv_l, const float* xs, int num_chunks,
                                  int chunk, int D, int device, float* out, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(num_chunks, (chunk + SMC_ROWS - 1) / SMC_ROWS);
  student_kxy_bwd_kernel<<<grid, SMC_ROWS, 0, static_cast<cudaStream_t>(stream)>>>(
      inv_l, xs, chunk, D, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* smc_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
