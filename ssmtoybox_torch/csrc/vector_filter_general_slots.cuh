// The slot form of the general and registered vector filter kernels: the
// slot kernel's step (vsl_record, vector_filter_slots.cuh) on their model
// policies, a trajectory on G lanes of a warp, classical Gauss-Hermite rules
// of 16-81 points on both transforms of up to 4 measurement outputs on
// states of 2-5 dimensions, in native float64.
//
// - The general kernel's pairs of VGS_PAIRS (VSL_GENERAL) run on VgsZoo,
//   their parameters the slot kernel's VslParams (the table's models read
//   their constants from base); vector_filter_general_slots.cu and _hi.cu
//   instantiate them, vsl_launch (vector_filter_slots.cu) launches them.
// - A registered configuration runs on its generated policy (VFR_SLOTS,
//   vector_filter_registered.cu), which states N and the design that
//   vsr_design names; its parameters (VsrParams) also hold its forms'
//   constants by value.
//
// Shared by the CUDA sources and the host shim
// (vector_filter_general_slots_host.cpp), which g++ builds with the lanes
// collapsed to one, so that the CPU tests hold this exact arithmetic against
// the plain PyTorch version in ssmtoybox_torch/ops/vector_filter.py.
//
// What it replaced: these shapes ran in the general and registered kernels'
// one-thread form (vfg_step, vector_filter_general.cuh), N read at run
// time, the rules read through __ldg, every function value sent out to a
// scratch buffer in device memory and back, one thread a trajectory.
#pragma once

#include "vector_filter_general_shaped.cuh"
#include "vector_filter_slots.cuh"

// The registered slot form's parameters: the slot kernel's (models,
// initial moments, G Q G^T, R, both rules by value) and a registered
// transition's and measurement's constants, VGS_MAX_C each.  11,488 bytes.
struct VsrParams {
  VfParams base;
  VslRule dyn;
  VslRule obs;
  double dyn_c[VGS_MAX_C];
  double obs_c[VGS_MAX_C];
};
static_assert(sizeof(VsrParams) == 11488,
              "the layout the ctypes mirror (ops/vector_filter.py) expects");
static_assert(sizeof(VsrParams) + 128 <= 32764,
              "a kernel's parameters take at most 32,764 bytes (CUDA 12.1 and later)");

// Lane `lane`'s view of a registered configuration's parameters: its forms'
// constants beside the rules' views.
template <class Design>
VF_HD VslLaneParams<Design> vsl_view(const VsrParams& p, int lane, unsigned mask) {
  return {p.base, {p.dyn, lane, mask}, {p.obs, lane, mask}, p.dyn_c, p.obs_c};
}

#ifdef __CUDACC__
// Threads a block: 64, as the five pairs' slot kernel.
constexpr int kVslThreads = 64;
static_assert(kVslThreads % 32 == 0, "whole warps a block");

// The slot form on a model policy: G lanes a trajectory (Design), the
// models of Model, parameters Params (VslParams or VsrParams).  The lanes
// of trajectories past the last return; the shuffles name the others.
template <int D, int E, int N, class Model, class Design, class Params>
__global__ void __launch_bounds__(kVslThreads)
vector_filter_general_slots_kernel(const __grid_constant__ Params p, const double* __restrict__ y,
                                   long long y_b, long long y_e, long long y_k,
                                   const double* __restrict__ s, int n_s, int B, int n_steps,
                                   const VfgStreams out) {
  constexpr int G = Design::G;
  const long long b = (static_cast<long long>(blockIdx.x) * kVslThreads + threadIdx.x) / G;
  const int lane = static_cast<int>(threadIdx.x) % G;
  const unsigned mask = __ballot_sync(0xffffffffu, b < B);
  if (b >= B) return;
  vsl_record<D, E, N, Design, Model>(p, lane, mask, y + b * y_b, y_e, y_k, n_steps, s, n_s,
                                     out.m_fi + b, out.P_fi + b, out.m_pr + b, out.P_pr + b,
                                     out.xx + b, B);
}

// Launch the instantiation (D, E, N, Model, Design, Params) on `stream`
// without synchronising; cudaGetLastError() after the launch.
template <int D, int E, int N, class Model, class Design, class Params>
int vsl_launch_as(const Params& p, const double* y, long long y_b, long long y_e, long long y_k,
                  const double* s, int n_s, int B, int n_steps, const VfgStreams& out,
                  cudaStream_t stream) {
  const long long threads = static_cast<long long>(B) * Design::G;
  const unsigned blocks = static_cast<unsigned>((threads + kVslThreads - 1) / kVslThreads);
  vector_filter_general_slots_kernel<D, E, N, Model, Design, Params>
      <<<blocks, kVslThreads, 0, stream>>>(p, y, y_b, y_e, y_k, s, n_s, B, n_steps, out);
  return static_cast<int>(cudaGetLastError());
}

// Within a launcher (p, q = p.base, y, its strides, B, n_steps, out and
// stream in scope): launch the general pair's instantiation F(D, E, DYN, OBS,
// N, G, SPLIT, KEEP) of VSL_GENERAL if it is q's, and return what
// vsl_launch_as returns.
#define VSL_GENERAL_LAUNCH_IF(D, E, DYN, OBS, N, LANES, SPLIT, KEEP)                        \
  if (q.dyn_model == DYN && q.obs_model == OBS && q.dim_state == D && q.dim_out == E &&      \
      q.dyn.n == N)                                                                          \
    return vsl_launch_as<D, E, N, VgsZoo<D, E, DYN, OBS>, VSL_DESIGN(LANES, SPLIT, KEEP)>(   \
        p, y, y_b, y_e, y_k, nullptr, 0, B, n_steps, out, stream);
#endif
