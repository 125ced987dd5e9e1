// The general vector filter kernel (vector_filter_general.cuh) instantiated on
// models registered at run time, for Hopper (sm_90a), native float64.
//
// Replaces, with the other vector filter kernels, the JAX package's
// ssmtoybox_tpu/ops/ddvec.py:514 dd_filter_batch for the models a user
// registers there (register_dyn_dd_vec / register_obs_dd_vec, ddvec.py:65-81,
// and the scalar registry's 1-D forms adapted, ddvec.py:252-297): the JAX
// package runs such a model inside its fused dd scan, the port inside this
// kernel.
//
// The header vfr_forms.cuh is generated by ops/vector_filter.py
// (build_registered) from the registered forms' C++ statements, into a
// directory of build/kernels, and names the instantiations:
//   VFR_PAIRS(F)  F(index, D, EB, G, Model) for each configuration the
//                 library was built for: D (1-8); G 0 for one thread a
//                 trajectory at the bound EB on E (2, 4, 8; 0 for the wide
//                 form) as in vector_filter_general.cu, G = VFL_G lanes
//                 a trajectory (the lane-group form, vector_filter_lanes.cuh;
//                 EB 0) or G = VFL_WARP (the warp form; EB 0); Model the policy whose functors evaluate the
//                 configuration's transition and measurement (a registered
//                 form's statements, or the table's model through VfgDynFn /
//                 VfgObsFn).
//   VFR_SHAPED(F) F(index, D, E, Model) for each configuration of the shaped
//                 one-thread form (vector_filter_general_shaped.cuh): D (2-5),
//                 E (1-4); Model's policy states the rules' point counts ND
//                 and NO (the UT or CKF count each, or the Gauss-Hermite count
//                 on both) and kinds KD, KO, the costs of its models, and
//                 evaluates them with their constants by value in the
//                 parameters (VgsParams).
//   VFR_SLOTS(F)  F(index, D, E, Model) for each configuration of the slot
//                 form (vector_filter_general_slots.cuh): D (2-5), E (1-4),
//                 both rules classical with Model::N points (16-81, a
//                 Gauss-Hermite count of a table shape); Model's policy
//                 states N and the design vsr_design names for (D, E, N)
//                 (G lanes a trajectory, split, keep: the design the table's
//                 shape of that D and N with the nearest E won on the card),
//                 whether each model is costly, and evaluates them with
//                 their constants by value in the parameters (VsrParams).
// Only the configurations the caller asked for are instantiated.
//
// What bounds it, and its design: those of vector_filter_general.cu: one
// thread a trajectory up to 4 outputs on states of up to 5 dimensions (the
// shaped form where both rules have the UT or CKF point count, the slot
// form's G lanes a trajectory where both are classical at a Gauss-Hermite
// count of 16-81 points that the table's slot shapes have at that D, the
// general one-thread step elsewhere), the lane-group form above, the warp
// form for rules of many points (ops/vector_filter.py, lanes_of); a registered
// transition reads its constants from device memory (VfgParams::dyn_c) and
// this step's values of its per-step streams from s[k * n_s] (the streams
// time-major, (T, n_s)).  Built with
// --fmad=false like the other vector filter kernels, so that a form whose
// statements perform the plain version's operations in its order agrees with
// it to the bit.
#include <cuda_runtime.h>

#include "vector_filter_general_slots.cuh"
#include "vector_filter_lanes.cuh"
#include "vfr_forms.cuh"

namespace {

// Configuration (D, EB, G, Model) of VFR_PAIRS: the one-thread form (G = 0)
// if the parameters' bound on E is EB, else cudaErrorInvalidValue; the
// lane-group form on G = VFL_G lanes a trajectory, or the warp form (G =
// VFL_WARP).
template <int D, int EB, int G, class Model>
int vfr_run(const VfgParams& p, const double* y, long long y_b, long long y_e, long long y_k,
            const double* s, int n_s, int B, int n_steps, const VfgStreams& out,
            double* scratch, cudaStream_t stream) {
  static_assert(G == 0 || G == VFL_G || G == VFL_WARP,
                "the lane-group form runs on VFL_G lanes, the warp form on VFL_WARP");
  if constexpr (G == 0) {
    if (vfg_bound(p.base.dim_out) != EB) return static_cast<int>(cudaErrorInvalidValue);
    vfg_launch_as<D, EB, Model>(p, y, y_b, y_e, y_k, s, n_s, B, n_steps, out, scratch, stream);
    return static_cast<int>(cudaGetLastError());
  } else {
    return vfl_launch_as<D, G, Model>(p, y, y_b, y_e, y_k, s, n_s, B, n_steps, out, stream);
  }
}

}  // namespace

// Launch configuration `pair` (an index of VFR_PAIRS) on `stream` of card
// `device` without synchronising: the layouts of vfg_launch, and the
// transition's stream values of step k at s[k * n_s]; the scratch buffer is
// read by the one-thread form only.  Returns the CUDA error of selecting the
// device or, after the launch, cudaGetLastError(); cudaErrorInvalidValue if
// `pair` is not one of the library's or its D and bound on E are not those of
// the parameters, the rules cannot run, or a lane-group shape's arrays do not
// fit in a block's shared memory.
extern "C" int vfr_launch(int pair, const VfgParams* params, const double* y, long long y_b,
                          long long y_e, long long y_k, const double* s, int n_s, int B,
                          int n_steps, int device, double* m_fi, double* P_fi, double* m_pr,
                          double* P_pr, double* xx, double* scratch, void* stream) {
  if (B <= 0 || n_steps <= 0) return 0;
  const VfgParams& p = *params;
  if (!vfg_rules_ok(p.base)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const VfgStreams out = {m_fi, P_fi, m_pr, P_pr, xx};
#define VFR_LAUNCH_IF(I, D, EB, G, MODEL)                                                  \
  if (pair == I && p.base.dim_state == D)                                                  \
    return vfr_run<D, EB, G, MODEL>(p, y, y_b, y_e, y_k, s, n_s, B, n_steps, out, scratch, \
                                    static_cast<cudaStream_t>(stream));
  VFR_PAIRS(VFR_LAUNCH_IF)
#undef VFR_LAUNCH_IF
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launch configuration `pair` (an index of VFR_SHAPED) in the shaped
// one-thread form on `stream` of card `device` without synchronising: the
// layouts of vfr_launch, no scratch buffer.  Returns the CUDA error of
// selecting the device or, after the launch, cudaGetLastError();
// cudaErrorInvalidValue if `pair` is not one of the library's shaped
// configurations or its D, E, point counts or kinds are not those of the
// parameters.
extern "C" int vfr_shaped_launch(int pair, const VgsParams* params, const double* y,
                                 long long y_b, long long y_e, long long y_k, const double* s,
                                 int n_s, int B, int n_steps, int device, double* m_fi,
                                 double* P_fi, double* m_pr, double* P_pr, double* xx,
                                 void* stream) {
  if (B <= 0 || n_steps <= 0) return 0;
  const VgsParams& p = *params;
  const VfParams& q = p.base;
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const VfgStreams out = {m_fi, P_fi, m_pr, P_pr, xx};
#define VFR_SHAPED_LAUNCH_IF(I, D, E, MODEL)                                                  \
  if (pair == I && q.dim_state == D && q.dim_out == E && q.dyn.n == MODEL::ND &&              \
      q.obs.n == MODEL::NO && q.dyn.kind == MODEL::KD && q.obs.kind == MODEL::KO)             \
    return vgs_launch_as<D, E, MODEL::ND, MODEL::NO, MODEL::KD, MODEL::KO, MODEL>(            \
        p, y, y_b, y_e, y_k, s, n_s, B, n_steps, out, static_cast<cudaStream_t>(stream));
  VFR_SHAPED(VFR_SHAPED_LAUNCH_IF)
#undef VFR_SHAPED_LAUNCH_IF
  return static_cast<int>(cudaErrorInvalidValue);
}

// Launch configuration `pair` (an index of VFR_SLOTS) in the slot form on
// `stream` of card `device` without synchronising: the layouts of
// vfr_launch, no scratch buffer.  Returns the CUDA error of selecting the
// device or, after the launch, cudaGetLastError(); cudaErrorInvalidValue if
// `pair` is not one of the library's slot configurations or its D, E, point
// counts or kinds are not those of the parameters.
extern "C" int vfr_slots_launch(int pair, const VsrParams* params, const double* y,
                                long long y_b, long long y_e, long long y_k, const double* s,
                                int n_s, int B, int n_steps, int device, double* m_fi,
                                double* P_fi, double* m_pr, double* P_pr, double* xx,
                                void* stream) {
  if (B <= 0 || n_steps <= 0) return 0;
  const VsrParams& p = *params;
  const VfParams& q = p.base;
  if (q.dyn.kind != 0 || q.obs.kind != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const VfgStreams out = {m_fi, P_fi, m_pr, P_pr, xx};
#define VFR_SLOTS_LAUNCH_IF(I, D, E, MODEL)                                                   \
  if (pair == I && q.dim_state == D && q.dim_out == E && q.dyn.n == MODEL::N &&               \
      q.obs.n == MODEL::N)                                                                    \
    return vsl_launch_as<D, E, MODEL::N, MODEL,                                               \
                         VslDesign<MODEL::G, MODEL::split, MODEL::keep>>(                     \
        p, y, y_b, y_e, y_k, s, n_s, B, n_steps, out, static_cast<cudaStream_t>(stream));
  VFR_SLOTS(VFR_SLOTS_LAUNCH_IF)
#undef VFR_SLOTS_LAUNCH_IF
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* vfr_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
