// Host builds of the vector filter steps (vector_filter_step.cuh, and
// vector_filter_shaped.cuh for the BQ shapes, vector_filter_general.cuh and
// vector_filter_lanes.cuh, which include it),
// for testing the kernels' arithmetic on a machine without a GPU.  Each entry
// picks the template instantiation as its CUDA launcher does (the model pair,
// then the kinds and point count of both rules) and runs the trajectories one
// after another, with the kernel's layouts: time-major outputs and, for the
// first version and the general step, a scratch buffer interleaved by
// trajectory; the lane-group form runs its G lanes one after another in each
// phase, a trajectory's shared memory a host buffer filled with NaN before the
// trajectory starts (so a read of an entry no phase wrote shows), the staged
// rules another.
//
// Built with -DVFR_REGISTERED beside a generated vfr_forms.cuh
// (ops/vector_filter.py, build_registered), it holds only vfr_host_run and
// vfr_shaped_host_run, the general step's forms on the registered models, as
// vector_filter_registered.cu launches them.  The classical shaped kernel and
// the general kernel's shaped one-thread form have host builds of their own
// (vector_filter_shaped_host.cpp, vector_filter_general_shaped_host.cpp).
#include <algorithm>
#include <limits>
#include <vector>

#include "vector_filter_lanes.cuh"

namespace {

// The lane-group form on G lanes (VFL_G, or VFL_WARP: the warp form) on the
// trajectories one after another, the rules staged where a block stages them.
template <int D, int G, class Model>
void vfl_host(const VfgParams& p, const double* y, long long y_b, long long y_e, long long y_k,
              const double* s, int n_s, int B, int n_steps, double* m_fi, double* P_fi,
              double* m_pr, double* P_pr, double* xx) {
  const VflFit fit = vfl_fit(p.base, G);
  std::vector<double> staged(fit.stage), sm(fit.size);
  const VflRules rules = vfl_stage(p, staged.data(), fit.stage, 0, 1);
  for (int b = 0; b < B; ++b) {
    std::fill(sm.begin(), sm.end(), std::numeric_limits<double>::quiet_NaN());
    vfl_record<D, G, Model>(p, rules, sm.data(), y + b * y_b, y_e, y_k, n_steps, s, n_s,
                            m_fi + b, P_fi + b, m_pr + b, P_pr + b, xx + b, B, VflLane{0});
  }
}

}  // namespace

#ifdef VFR_REGISTERED
#include "vector_filter_general_shaped.cuh"
#include "vfr_forms.cuh"

namespace {

// Configuration (D, EB, G, Model) of VFR_PAIRS on the trajectories one after
// another: the one-thread form (G = 0) if the parameters' bound on E is EB,
// the lane-group form on G = VFL_G lanes a trajectory or the warp form (G =
// VFL_WARP); whether it ran.
template <int D, int EB, int G, class Model>
bool vfr_host(const VfgParams& p, const double* y, long long y_b, long long y_e, long long y_k,
              const double* s, int n_s, int B, int n_steps, double* m_fi, double* P_fi,
              double* m_pr, double* P_pr, double* xx, double* scratch) {
  static_assert(G == 0 || G == VFL_G || G == VFL_WARP,
                "the lane-group form runs on VFL_G lanes, the warp form on VFL_WARP");
  if constexpr (G == 0) {
    if (vfg_bound(p.base.dim_out) != EB) return false;
    for (int b = 0; b < B; ++b)
      vfg_record<D, EB, Model>(p, y + b * y_b, y_e, y_k, n_steps, s, n_s, scratch + b, B,
                               m_fi + b, P_fi + b, m_pr + b, P_pr + b, xx + b, B);
  } else {
    vfl_host<D, G, Model>(p, y, y_b, y_e, y_k, s, n_s, B, n_steps, m_fi, P_fi, m_pr, P_pr, xx);
  }
  return true;
}

}  // namespace

// Configuration `pair` of VFR_PAIRS on the trajectories one after another,
// with vfr_launch's layouts.  Returns the state dimension of the
// instantiation that ran, 0 if `pair` does not take the configuration.
extern "C" int vfr_host_run(int pair, const VfgParams* params, const double* y, long long y_b,
                            long long y_e, long long y_k, const double* s, int n_s, int B,
                            int n_steps, double* m_fi, double* P_fi, double* m_pr,
                            double* P_pr, double* xx, double* scratch) {
  const VfgParams& p = *params;
  if (!vfg_rules_ok(p.base)) return 0;
#define VFR_RUN_IF(I, D, EB, G, MODEL)                                                    \
  if (pair == I && p.base.dim_state == D)                                                 \
    return vfr_host<D, EB, G, MODEL>(p, y, y_b, y_e, y_k, s, n_s, B, n_steps, m_fi, P_fi, \
                                     m_pr, P_pr, xx, scratch) ? D : 0;
  VFR_PAIRS(VFR_RUN_IF)
#undef VFR_RUN_IF
  return 0;
}

// Configuration `pair` of VFR_SHAPED in the shaped one-thread form on the
// trajectories one after another, with vfr_shaped_launch's layouts.  Returns
// the state dimension of the instantiation that ran, 0 if `pair` does not
// take the configuration.
extern "C" int vfr_shaped_host_run(int pair, const VgsParams* params, const double* y,
                                   long long y_b, long long y_e, long long y_k, const double* s,
                                   int n_s, int B, int n_steps, double* m_fi, double* P_fi,
                                   double* m_pr, double* P_pr, double* xx) {
  const VfParams& q = params->base;
#define VFR_SHAPED_RUN_IF(I, D, E, MODEL)                                                     \
  if (pair == I && q.dim_state == D && q.dim_out == E && q.dyn.n == MODEL::ND &&              \
      q.obs.n == MODEL::NO && q.dyn.kind == MODEL::KD && q.obs.kind == MODEL::KO) {           \
    for (int b = 0; b < B; ++b)                                                               \
      vgs_record<D, E, MODEL::ND, MODEL::NO, MODEL::KD, MODEL::KO, MODEL>(                    \
          *params, y + b * y_b, y_e, y_k, n_steps, s, n_s, m_fi + b, P_fi + b, m_pr + b,      \
          P_pr + b, xx + b, B);                                                               \
    return D;                                                                                 \
  }
  VFR_SHAPED(VFR_SHAPED_RUN_IF)
#undef VFR_SHAPED_RUN_IF
  return 0;
}

#else
#include "vector_filter_shaped.cuh"

namespace {

template <int D, int E, int DYN, int OBS, int KD, int KO>
void run(const VfParams& p, const double* y, long long y_b, long long y_e, long long y_k, int B,
         int n_steps, double* m_fi, double* P_fi, double* m_pr, double* P_pr, double* xx,
         double* scratch) {
  for (int b = 0; b < B; ++b)
    vf_record<D, E, DYN, OBS, KD, KO>(p, y + b * y_b, y_e, y_k, n_steps, scratch + b, B,
                                      m_fi + b, P_fi + b, m_pr + b, P_pr + b, xx + b, B);
}

}  // namespace

// Returns the state dimension of the instantiation that ran, 0 if none takes
// the configuration.
extern "C" int vf_host_run(const VfParams* params, const double* y, long long y_b,
                           long long y_e, long long y_k, int B, int n_steps, double* m_fi,
                           double* P_fi, double* m_pr, double* P_pr, double* xx,
                           double* scratch) {
  const VfParams& p = *params;
  if (p.dyn.n < 1 || p.obs.n < 1 || (p.dyn.kind | p.obs.kind) >> 1) return 0;
  int ran = 0;
#define VF_KINDS(D, E, DYN, OBS, KD, KO)                                                  \
  if (p.dyn.kind == KD && p.obs.kind == KO) {                                             \
    run<D, E, DYN, OBS, KD, KO>(p, y, y_b, y_e, y_k, B, n_steps, m_fi, P_fi, m_pr, P_pr,  \
                                xx, scratch);                                             \
    ran = D;                                                                              \
  }
#define VF_RUN_IF(D, E, DYN, OBS)                                                         \
  if (!ran && p.dyn_model == DYN && p.obs_model == OBS && p.dim_state == D &&             \
      p.dim_out == E) {                                                                   \
    VF_KINDS(D, E, DYN, OBS, 0, 0) VF_KINDS(D, E, DYN, OBS, 0, 1)                         \
    VF_KINDS(D, E, DYN, OBS, 1, 0) VF_KINDS(D, E, DYN, OBS, 1, 1)                         \
  }
  VF_MODELS(VF_RUN_IF)
#undef VF_RUN_IF
#undef VF_KINDS
  return ran;
}

// The same for the step of the kernel of the BQ shapes
// (vector_filter_shaped.cuh, vector_filter_shaped_bq.cu): N = 2 D + 1 or 2 D
// points on both rules, a BQ rule on one transform or both.  Returns the
// state dimension of the instantiation that ran, 0 if none takes the
// configuration.
extern "C" int vfs_bq_host_run(const VfsBqParams* params, const double* y, long long y_b,
                               long long y_e, long long y_k, int B, int n_steps, double* m_fi,
                               double* P_fi, double* m_pr, double* P_pr, double* xx) {
  const VfParams& q = params->base;
  if (q.dyn.n != q.obs.n) return 0;
  int ran = 0;
#define VFS_BQ_RUN_IF(D, E, DYN, OBS, N, KD, KO)                                          \
  if (!ran && q.dyn_model == DYN && q.obs_model == OBS && q.dim_state == D &&              \
      q.dim_out == E && q.dyn.n == N && q.dyn.kind == KD && q.obs.kind == KO) {            \
    for (int b = 0; b < B; ++b)                                                            \
      vfs_record<D, E, DYN, OBS, N, N, KD, KO>(*params, y + b * y_b, y_e, y_k, n_steps,    \
                                               m_fi + b, P_fi + b, m_pr + b, P_pr + b,     \
                                               xx + b, B);                                 \
    ran = D;                                                                               \
  }
  VFS_BQ_SHAPES(VFS_BQ_RUN_IF)
#undef VFS_BQ_RUN_IF
  return ran;
}

// The same for the steps of the general kernel (vector_filter_general.cuh,
// vector_filter_lanes.cuh): every model pair; `lanes` 0: the one-thread form,
// E outputs at the bound EB that holds them (the wide form above 8); VFL_G:
// the lane-group form on that many lanes a trajectory; VFL_WARP: the warp
// form.  Returns the state dimension of the instantiation that ran, 0 if the
// general step does not take the configuration.
extern "C" int vfg_host_run(const VfgParams* params, const double* y, long long y_b,
                            long long y_e, long long y_k, int B, int n_steps, double* m_fi,
                            double* P_fi, double* m_pr, double* P_pr, double* xx,
                            double* scratch, int lanes) {
  const VfgParams& p = *params;
  if (!vfg_takes(p.base)) return 0;
  const int eb = vfg_bound(p.base.dim_out);
  int ran = 0;
#define VFL_RUN_IF(D)                                                                      \
  if (p.base.dim_state == D && lanes == VFL_G) {                                           \
    vfl_host<D, VFL_G, VfgZoo<D, 0>>(p, y, y_b, y_e, y_k, nullptr, 0, B, n_steps, m_fi,    \
                                     P_fi, m_pr, P_pr, xx);                                \
    ran = D;                                                                               \
  }                                                                                        \
  if (p.base.dim_state == D && lanes == VFL_WARP) {                                        \
    vfl_host<D, VFL_WARP, VfgZoo<D, 0>>(p, y, y_b, y_e, y_k, nullptr, 0, B, n_steps, m_fi, \
                                        P_fi, m_pr, P_pr, xx);                             \
    ran = D;                                                                               \
  }
  VFL_SHAPES(VFL_RUN_IF)
#undef VFL_RUN_IF
#define VFG_RUN_IF(D, EB)                                                                  \
  if (p.base.dim_state == D && eb == EB && lanes == 0) {                                   \
    for (int b = 0; b < B; ++b)                                                            \
      vfg_record<D, EB, VfgZoo<D, EB>>(p, y + b * y_b, y_e, y_k, n_steps, nullptr, 0,      \
                                       scratch + b, B, m_fi + b, P_fi + b, m_pr + b,       \
                                       P_pr + b, xx + b, B);                               \
    ran = D;                                                                               \
  }
  VFG_SHAPES(VFG_RUN_IF)
#undef VFG_RUN_IF
  return ran;
}
#endif
