// The general form of the scalar filter kernel (scalar_filter.cu,
// scalar_filter_step_general.cuh) instantiated on 1-D models registered at
// run time, for Hopper (sm_90a), native float64.
//
// Replaces, with scalar_filter.cu, the TPU kernel
// ssmtoybox_tpu/ops/ddscan_pallas.py::pallas_scalar_filter, whose step the
// JAX package builds from whatever scalar model a user registered
// (ops/ddfilter.py:222-253, register_dyn_dd / register_obs_dd): here the
// registered model's C++ statements are compiled into the step.
//
// The header sfr_forms.cuh is generated by ops/scalar_filter.py
// (build_registered) into a directory of build/kernels and names the
// instantiations:
//   SFR_PAIRS(F)  F(index, Model, KD, KO, N) for each configuration the
//                 library was built for: Model the policy whose functors
//                 evaluate its transition and measurement (a registered
//                 form's statements, or the kernel's own UNGM transition and
//                 measurements), KD and KO its rules' kinds, N its slot count
//                 (sf_slots), 0 above SF_MAX_SLOTS points.
//
// What bounds it, and its design: those of the general form in
// scalar_filter.cu.  Up to SF_MAX_SLOTS points the slot design
// (scalar_filter_slots.cuh: compile-time slots and lanes, the rules staged in
// shared memory, no scratch); above, one thread a trajectory, the rules from
// device memory, the function values through a scratch buffer interleaved by
// trajectory.  A registered model reads its constants from device memory
// (SfrParams) and a transition this step's stream values from s[k * n_s].
// Built with --fmad=false like scalar_filter.cu.
#include <cuda_runtime.h>

#include "scalar_filter_slots.cuh"
#include "sfr_forms.cuh"

namespace {

// 64 threads a block, as the general form in scalar_filter.cu.
constexpr int kThreads = SF_THREADS;

template <class Model>
__global__ void __launch_bounds__(kThreads)
scalar_filter_registered_kernel(const __grid_constant__ SfrParams p, const double* __restrict__ y,
                                long long y_step, long long y_traj, const double* __restrict__ s,
                                int n_s, int B, int n_steps, const SfStreams out,
                                double* __restrict__ scratch) {
  const long long b = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= B) return;
  sfg_record<Model>(p, p.base, y + b * y_traj, y_step, s, n_s, n_steps, scratch + b, B,
                    out.m_fi + b, out.P_fi + b, out.m_pr + b, out.P_pr + b, out.xx + b);
}

// Configuration <Model, KD, KO, N> in its design.
template <class Model, int KD, int KO, int N>
cudaError_t run(const SfrParams& p, const SfsRules* v, const double* y, long long y_step,
                long long y_traj, const double* s, int n_s, int B, int n_steps,
                const SfStreams& out, double* scratch, cudaStream_t stream) {
  if constexpr (N > 0) {
    return sfs_launch<KD, KO, N, Model>(p, *v, y, y_step, y_traj, s, n_s, B, n_steps, out,
                                        stream);
  } else {
    const unsigned blocks = static_cast<unsigned>((static_cast<long long>(B) + kThreads - 1) /
                                                  kThreads);
    scalar_filter_registered_kernel<Model><<<blocks, kThreads, 0, stream>>>(
        p, y, y_step, y_traj, s, n_s, B, n_steps, out, scratch);
    return cudaGetLastError();
  }
}

}  // namespace

// Launch configuration `pair` (an index of SFR_PAIRS) on `stream` of card
// `device` without synchronising: the layouts of sfg_launch (the slot design
// takes the rules' vectors vecs and no scratch, which may be null; the
// one-thread design the reverse), the stream values of step k at s[k * n_s].  Returns the CUDA error of selecting the device or, after the
// launch, cudaGetLastError(); cudaErrorInvalidValue if `pair` is not one of
// the library's, the rules cannot run or are not of its kinds and slots.
extern "C" int sfr_launch(int pair, const SfrParams* params, const SfsRules* vecs,
                          const double* y, long long y_step, long long y_traj, const double* s,
                          int n_s, int B, int n_steps, int device, double* m_fi, double* P_fi,
                          double* m_pr, double* P_pr, double* xx, double* scratch,
                          void* stream) {
  if (B <= 0 || n_steps <= 0) return 0;
  const SfrParams& p = *params;
  if (!sfg_rules_ok(p.base)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const SfStreams out = {m_fi, P_fi, m_pr, P_pr, xx};
  const int slots = sf_slots(p.base.dyn.n, p.base.obs.n);
#define SFR_LAUNCH_IF(I, MODEL, KD, KO, N)                                                 \
  if (pair == I) {                                                                         \
    if (p.base.dyn.kind != KD || p.base.obs.kind != KO || slots != N)                      \
      return static_cast<int>(cudaErrorInvalidValue);                                      \
    return static_cast<int>(run<MODEL, KD, KO, N>(p, vecs, y, y_step, y_traj, s, n_s, B,  \
                                                  n_steps, out, scratch,                  \
                                                  static_cast<cudaStream_t>(stream)));    \
  }
  SFR_PAIRS(SFR_LAUNCH_IF)
#undef SFR_LAUNCH_IF
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* sfr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
