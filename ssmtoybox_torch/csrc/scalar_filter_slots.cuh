// The slot design of the scalar filter kernel's general and registered forms
// (sfs_record, scalar_filter_step_general.cuh) as a CUDA kernel, for Hopper
// (sm_90a), native float64: included by scalar_filter_slots.cu (the kernel's
// own models) and scalar_filter_registered.cu (models registered at run
// time).
//
// What bounds it: as the shaped form (scalar_filter.cu), the dependency chain
// of one trajectory's step and, at many slots, the f64 issue rate, since
// every lane of a trajectory repeats the sums.  Its design: the shaped form's
// (slots and lanes as template arguments, the values gathered by shuffles,
// nothing through device memory, the rules' vectors by value), with a BQ
// rule's Wc staged in shared memory once a block and the models taken from a
// policy.  A lane past the last trajectory works on a copy of the last one
// (the shuffles need the whole warp) and stores nothing.
//
// SFS_VECTORS_IN_SHARED=1 (for tools/sf_variants.py) copies the rules'
// vectors into shared memory too, and the sums read them there.
#pragma once

#include <cuda_runtime.h>

#include "scalar_filter_step_general.cuh"

// 64 threads a block (both designs): 10,000 trajectories of 2 lanes are 313
// blocks, 2 or 3 an SM; blocks of 256 leave some SMs with twice the warps of
// others (+20%, measured on the shaped form).
#ifndef SF_THREADS
#define SF_THREADS 64
#endif

struct SfStreams {
  double *m_fi, *P_fi, *m_pr, *P_pr, *xx;
};
static_assert(sizeof(SfrParams) + sizeof(SfsRules) + sizeof(SfStreams) + 64 <= 4096,
              "the slot design's kernel parameters fit the 4 KB of every CUDA version");

template <int KD, int KO, int N, class Model, class P>
__global__ void __launch_bounds__(SF_THREADS)
scalar_filter_slots_kernel(const __grid_constant__ P p, const __grid_constant__ SfsRules v,
                           const double* __restrict__ y, long long y_step, long long y_traj,
                           const double* __restrict__ s, int n_s, int B, int n_steps,
                           const SfStreams out) {
  constexpr int G = sfs_lanes(KD, KO, N);
  static_assert(G == 1 || G == 2 || G == 4 || G == 8, "lanes divide a warp");
  static_assert(SF_THREADS % 32 == 0, "whole warps a block");
  __shared__ SfSlotWc<KD, N> wd;
  __shared__ SfSlotWc<KO, N> wo;
  const int t = static_cast<int>(threadIdx.x);
  sfs_stage(wd, sf_base(p).dyn, t, SF_THREADS);
  sfs_stage(wo, sf_base(p).obs, t, SF_THREADS);
  __syncthreads();
  const SfSlotRule<KD, N> rd = sfs_rule(v.dyn, wd, sf_base(p).dyn);
  const SfSlotRule<KO, N> ro = sfs_rule(v.obs, wo, sf_base(p).obs);
  const long long traj = (static_cast<long long>(blockIdx.x) * SF_THREADS + threadIdx.x) / G;
  const int lane = static_cast<int>(threadIdx.x) % G;
  const bool live = traj < B;
  const long long b = live ? traj : B - 1;
  sfs_record<KD, KO, N, G, Model>(p, rd, ro, lane, y + b * y_traj, y_step, s, n_s, n_steps, B,
                                  live && lane == 0, out.m_fi + b, out.P_fi + b, out.m_pr + b,
                                  out.P_pr + b, out.xx + b);
}

// Launch the slot design <KD, KO, N> on Model's functors made from p and the
// rules' vectors v, on
// `stream`, without synchronising; cudaGetLastError() after the launch.
template <int KD, int KO, int N, class Model, class P>
cudaError_t sfs_launch(const P& p, const SfsRules& v, const double* y, long long y_step,
                       long long y_traj, const double* s, int n_s, int B, int n_steps,
                       const SfStreams& out, cudaStream_t stream) {
  constexpr int G = sfs_lanes(KD, KO, N);
  const long long threads = static_cast<long long>(B) * G;
  const unsigned blocks = static_cast<unsigned>((threads + SF_THREADS - 1) / SF_THREADS);
  scalar_filter_slots_kernel<KD, KO, N, Model><<<blocks, SF_THREADS, 0, stream>>>(
      p, v, y, y_step, y_traj, s, n_s, B, n_steps, out);
  return cudaGetLastError();
}
