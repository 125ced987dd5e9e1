// RBF-Student Monte-Carlo expectations q/R/Q and their gradient for Hopper
// (sm_90a), float32 with per-block partial sums; built into one library with
// student_mc.cu.
//
// Replaces two TPU kernels of ssmtoybox_tpu/ops/pallas_ops.py:
//   student_qrq_kernel, student_qrq_large_kernel          <- _student_exp_kernel
//   student_qrq_bwd_kernel, student_qrq_bwd_large_kernel  <- _student_qRQ_bwd_kernel
// The math lives in student_mc_rows.cuh.
//
// Precision contract (the TPU kernels'): every block sums in float32 over the
// samples of one chunk and writes its own partial; the host sums the
// partials in float64.  No atomics, so a launch repeats to the bit; no
// tensor cores, so no TF32 rounding reaches the partials that the
// ill-conditioned BQ weight solve would amplify.
//
// The kernels (student_qrq_kernel<D, NB>, student_qrq_bwd_kernel
// <D, NB>, student_qrq_large_kernel<D>, student_qrq_bwd_large_kernel<D>):
// one block a chunk of samples (4,096 on the study path), the design in
// student_mc_rows.cuh.  At the study shape (D = 4, N = 9, 2e6 samples) the
// forward must read 32 MB (9.5 us at 3.35 TB/s) and do ~5.8e8 f32 operations
// (8.6 us), the backward ~8.6e8 (12.9 us).  The small path (N up to the
// bucket of D, 9 at D = 4) keeps every sum of a sample in registers and
// reads nothing but the samples; its cost is the instructions of a sample
// (the Gram row, an ex2 a point, and one FMA a sum: 90 forward, ~180
// backward) and one reduction a block (shuffles in each warp, then the
// warps in turn).  The large path (N up to
// 128) is bound by shared-memory loads of the staged Gram: two 16-byte loads
// for 16 FMAs in a forward micro-tile.
//
#include <cuda_runtime.h>

#include "student_mc_rows.cuh"

namespace {

// Blocks an SM the small path's registers must allow: a forward kernel whose
// thread keeps at most 100 sums fits 128 registers, so 4 blocks of 128
// threads an SM and the study's 488 chunks in one wave (D = 4, N = 9: 0.0229
// against 0.0258 ms unbounded); more sums would spill there (D = 5, N = 11:
// 0.128 against 0.036 ms).  The backward kernels are not bounded (4 blocks:
// within 5% either way).
template <int D, int NB>
constexpr int kQrqMinBlocks = smc_qrq_fwd_sums(D, NB) <= 100 ? 4 : 1;

// The small path: one block of SMC_QRQ_THREADS a chunk, D and the point
// bucket NB compiled in, N <= NB points real.
template <int D, int NB, bool BWD>
__device__ __forceinline__ void qrq_small_block(const float* __restrict__ inv_l,
                                                const float* __restrict__ xs,
                                                const float* __restrict__ xp,
                                                const float* __restrict__ gq,
                                                const float* __restrict__ gR,
                                                const float* __restrict__ gQ2, int chunk, int N,
                                                float* __restrict__ out) {
  constexpr int NA = smc_qrq_sums(D, NB, BWD);
  constexpr int kWarps = SMC_QRQ_THREADS / 32;
  __shared__ __align__(16) float sm[SmcQrqSmall<D, NB, BWD>::total];
  __shared__ float red[kWarps * NA];
  const int tid = threadIdx.x;
  float il[D];
  smc_qrq_il<D>(inv_l, il);
  smc_qrq_small_stage<D, NB, BWD>(xp, il, gq, gR, gQ2, N, sm, tid, SMC_QRQ_THREADS);
  __syncthreads();
  float acc[NA];
  smc_qrq_small_thread<D, NB, BWD>(xs + static_cast<size_t>(blockIdx.x) * chunk * D, chunk, tid,
                                   SMC_QRQ_THREADS, il, sm, N, acc);
  constexpr int Q = (NA + 31) / 32;
  const int lane = tid % 32;
  smc_qrq_warp_sums<NA>(acc, lane, [](float x, int off) {
    return __shfl_xor_sync(0xffffffffu, x, off);
  });
#pragma unroll
  for (int i = 0; i < Q; ++i)
    if (Q * lane + i < NA) red[(tid / 32) * NA + Q * lane + i] = acc[i];
  __syncthreads();
  float* oc = out + static_cast<size_t>(blockIdx.x) * (BWD ? N + D * N + D : N + D * N + N * N);
  for (int a = tid; a < NA; a += SMC_QRQ_THREADS) {
    float s = red[a];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w * NA + a];
    smc_qrq_small_put<D, NB, BWD>(a, s, N, oc);
  }
}

template <int D, int NB>
__global__ void __launch_bounds__(SMC_QRQ_THREADS, kQrqMinBlocks<D, NB>)
student_qrq_kernel(const float* __restrict__ inv_l, const float* __restrict__ xs,
                   const float* __restrict__ xp, int chunk, int N, float* __restrict__ out) {
  qrq_small_block<D, NB, false>(inv_l, xs, xp, nullptr, nullptr, nullptr, chunk, N, out);
}

template <int D, int NB>
__global__ void __launch_bounds__(SMC_QRQ_THREADS)
student_qrq_bwd_kernel(const float* __restrict__ inv_l, const float* __restrict__ xs,
                       const float* __restrict__ xp, const float* __restrict__ gq,
                       const float* __restrict__ gR, const float* __restrict__ gQ2, int chunk,
                       int N, float* __restrict__ out) {
  qrq_small_block<D, NB, true>(inv_l, xs, xp, gq, gR, gQ2, chunk, N, out);
}

// The large path, forward: one block of SMC_QRQ_LARGE_THREADS a chunk.
template <int D>
__global__ void __launch_bounds__(SMC_QRQ_LARGE_THREADS)
student_qrq_large_kernel(const float* __restrict__ inv_l, const float* __restrict__ xs,
                         const float* __restrict__ xp, int chunk, int N,
                         float* __restrict__ out) {
  extern __shared__ float4 qrq_smem[];
  float* sm = reinterpret_cast<float*>(qrq_smem);
  const SmcQrqLarge L(D, N, false);
  const int tid = threadIdx.x;
  float il[D];
  smc_qrq_il<D>(inv_l, il);
  smc_qrq_stage_points<D>(xp, il, N, L.NP, sm + L.p, sm + L.c, tid, SMC_QRQ_LARGE_THREADS);
  int g, ai[SMC_QRQ_MT_MAX], jj[SMC_QRQ_MT_MAX];
  const int cnt = smc_qrq_roles(L, tid, &g, ai, jj);
  float acc[SMC_QRQ_MT_MAX * 16];
#pragma unroll
  for (int a = 0; a < SMC_QRQ_MT_MAX * 16; ++a) acc[a] = 0.f;
  smc_qrq_tiles<D>(xs + static_cast<size_t>(blockIdx.x) * chunk * D, chunk, il, sm + L.p,
                   sm + L.c, N, L, sm + L.v, sm + L.raw, tid, SMC_QRQ_LARGE_THREADS,
                   [] { __syncthreads(); }, [&](const float* V) {
                     if (cnt) smc_qrq_large_fwd_tile(V, L, g, cnt, ai, jj, acc);
                   });
  float* oc = out + static_cast<size_t>(blockIdx.x) * (N + D * N + N * N);
  if (L.G == 1) {
#pragma unroll
    for (int u = 0; u < SMC_QRQ_MT_MAX; ++u)
      if (u < cnt)
        for (int e = 0; e < 16; ++e)
          smc_qrq_large_put(L, D, N, smc_qrq_mt_of(L, tid, u), e, acc[u * 16 + e], oc);
    return;
  }
  float* red = sm + L.v;
  __syncthreads();
  if (cnt)
    for (int e = 0; e < 16; ++e) red[(g * L.MT + tid % L.MT) * 16 + e] = acc[e];
  __syncthreads();
  for (int o = tid; o < L.MT * 16; o += SMC_QRQ_LARGE_THREADS) {
    float s = red[o];
    for (int gg = 1; gg < L.G; ++gg) s += red[gg * L.MT * 16 + o];
    smc_qrq_large_put(L, D, N, o / 16, o % 16, s, oc);
  }
}

// The large path, backward.
template <int D>
__global__ void __launch_bounds__(SMC_QRQ_LARGE_THREADS)
student_qrq_bwd_large_kernel(const float* __restrict__ inv_l, const float* __restrict__ xs,
                             const float* __restrict__ xp, const float* __restrict__ gq,
                             const float* __restrict__ gR, const float* __restrict__ gQ2,
                             int chunk, int N, float* __restrict__ out) {
  extern __shared__ float4 qrq_smem[];
  float* sm = reinterpret_cast<float*>(qrq_smem);
  const SmcQrqLarge L(D, N, true);
  const int tid = threadIdx.x;
  float il[D];
  smc_qrq_il<D>(inv_l, il);
  smc_qrq_stage_points<D>(xp, il, N, L.NP, sm + L.p, sm + L.c, tid, SMC_QRQ_LARGE_THREADS);
  smc_qrq_stage_cot(gq, gR, gQ2, D, N, L.NP, sm + L.gq, sm + L.gR, sm + L.gQ2, tid,
                    SMC_QRQ_LARGE_THREADS);
  const int slice = tid % L.nb, g = tid / L.nb;
  float acc[4 + 5 * D];
#pragma unroll
  for (int a = 0; a < 4 + 5 * D; ++a) acc[a] = 0.f;
  smc_qrq_tiles<D>(xs + static_cast<size_t>(blockIdx.x) * chunk * D, chunk, il, sm + L.p,
                   sm + L.c, N, L, sm + L.v, sm + L.raw, tid, SMC_QRQ_LARGE_THREADS,
                   [] { __syncthreads(); }, [&](const float* V) {
                     if (g < L.G)
                       smc_qrq_large_bwd_tile<D>(V, L, N, sm + L.gq, sm + L.gR, sm + L.gQ2, g,
                                                 slice, acc);
                   });
  float* red = sm + L.v;
  __syncthreads();
  if (g < L.G)
#pragma unroll
    for (int a = 0; a < 4 + 5 * D; ++a) red[(g * L.nb + slice) * L.ew + a] = acc[a];
  __syncthreads();
  float* oc = out + static_cast<size_t>(blockIdx.x) * (N + D * N + D);
  for (int o = tid; o < N + D * N + D; o += SMC_QRQ_LARGE_THREADS)
    oc[o] = smc_qrq_large_bwd_sum(L, D, N, o, red);
}

// Raise the dynamic shared-memory limit of `kernel` when `bytes` needs it.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// What a q/R/Q launch is given (gq, gR, gQ2 null for the forward).
struct QrqArgs {
  const float *inv_l, *xs, *xp, *gq, *gR, *gQ2;
  int num_chunks, chunk, N;
  float* out;
  bool bwd;
  cudaStream_t stream;
};

template <int D, int NB>
cudaError_t qrq_small_launch(const QrqArgs& a) {
  if (a.bwd)
    student_qrq_bwd_kernel<D, NB><<<a.num_chunks, SMC_QRQ_THREADS, 0, a.stream>>>(
        a.inv_l, a.xs, a.xp, a.gq, a.gR, a.gQ2, a.chunk, a.N, a.out);
  else
    student_qrq_kernel<D, NB><<<a.num_chunks, SMC_QRQ_THREADS, 0, a.stream>>>(
        a.inv_l, a.xs, a.xp, a.chunk, a.N, a.out);
  return cudaGetLastError();
}

template <int D>
cudaError_t qrq_large_launch(const QrqArgs& a) {
  const size_t bytes = sizeof(float) * SmcQrqLarge(D, a.N, a.bwd).total;
  cudaError_t e;
  if (a.bwd) {
    if ((e = allow_smem(student_qrq_bwd_large_kernel<D>, bytes)) != cudaSuccess) return e;
    student_qrq_bwd_large_kernel<D><<<a.num_chunks, SMC_QRQ_LARGE_THREADS, bytes, a.stream>>>(
        a.inv_l, a.xs, a.xp, a.gq, a.gR, a.gQ2, a.chunk, a.N, a.out);
  } else {
    if ((e = allow_smem(student_qrq_large_kernel<D>, bytes)) != cudaSuccess) return e;
    student_qrq_large_kernel<D><<<a.num_chunks, SMC_QRQ_LARGE_THREADS, bytes, a.stream>>>(
        a.inv_l, a.xs, a.xp, a.chunk, a.N, a.out);
  }
  return cudaGetLastError();
}

// The small path's bucket of D if it holds a.N, else the large path.
template <int D>
cudaError_t qrq_by_points(const QrqArgs& a) {
  constexpr int NB = smc_qrq_bucket(D);
  if constexpr (NB > 0)
    if (a.N <= NB) return qrq_small_launch<D, NB>(a);
  return qrq_large_launch<D>(a);
}

cudaError_t qrq_dispatch(const QrqArgs& a, int D, int device) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return e;
  switch (D) {
    case 1: return qrq_by_points<1>(a);
    case 2: return qrq_by_points<2>(a);
    case 3: return qrq_by_points<3>(a);
    case 4: return qrq_by_points<4>(a);
    case 5: return qrq_by_points<5>(a);
    case 6: return qrq_by_points<6>(a);
    case 7: return qrq_by_points<7>(a);
    case 8: return qrq_by_points<8>(a);
  }
  return cudaErrorInvalidValue;
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
  const QrqArgs a{inv_l, xs, xp, nullptr, nullptr, nullptr, num_chunks, chunk, N, out, false,
                  static_cast<cudaStream_t>(stream)};
  return static_cast<int>(qrq_dispatch(a, D, device));
}

// out: (num_chunks, N + D N + D) per-chunk partials (cs, B, u).
extern "C" int smc_qrq_bwd_launch(const float* inv_l, const float* xs, const float* xp,
                                  const float* gq, const float* gR, const float* gQ2,
                                  int num_chunks, int chunk, int N, int D, int device,
                                  float* out, void* stream) {
  const QrqArgs a{inv_l, xs, xp, gq, gR, gQ2, num_chunks, chunk, N, out, true,
                  static_cast<cudaStream_t>(stream)};
  return static_cast<int>(qrq_dispatch(a, D, device));
}
