// Host builds of the vector filter steps (vector_filter_step.cuh, and
// vector_filter_shaped.cuh and vector_filter_general.cuh, which include it),
// for testing the kernels' arithmetic on a machine without a GPU.  Each entry
// picks the template instantiation as its CUDA launcher does (the model pair,
// then the kinds and point count of both rules) and runs the trajectories one
// after another, with the kernel's layouts: time-major outputs and, for the
// first version and the general step, a scratch buffer interleaved by
// trajectory.
//
// Built with -DVFR_REGISTERED beside a generated vfr_forms.cuh
// (ops/vector_filter.py, build_registered), it holds only vfr_host_run, the
// general step on the registered models, as vector_filter_registered.cu
// launches it.
#include "vector_filter_general.cuh"

#ifdef VFR_REGISTERED
#include "vfr_forms.cuh"

// Configuration `pair` of VFR_PAIRS on the trajectories one after another,
// with vfr_launch's layouts.  Returns the state dimension of the
// instantiation that ran, 0 if `pair` does not take the configuration.
extern "C" int vfr_host_run(int pair, const VfgParams* params, const double* y, long long y_b,
                            long long y_e, long long y_k, const double* s, int n_s, int B,
                            int n_steps, double* m_fi, double* P_fi, double* m_pr,
                            double* P_pr, double* xx, double* scratch) {
  const VfgParams& p = *params;
  if (!vfg_rules_ok(p.base)) return 0;
  const int eb = vfg_bound(p.base.dim_out);
  int ran = 0;
#define VFR_RUN_IF(I, D, EB, MODEL)                                                        \
  if (pair == I && p.base.dim_state == D && eb == EB) {                                    \
    for (int b = 0; b < B; ++b)                                                            \
      vfg_record<D, EB, MODEL>(p, y + b * y_b, y_e, y_k, n_steps, s, n_s, scratch + b, B,  \
                               m_fi + b, P_fi + b, m_pr + b, P_pr + b, xx + b, B);         \
    ran = D;                                                                               \
  }
  VFR_PAIRS(VFR_RUN_IF)
#undef VFR_RUN_IF
  return ran;
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

// The same for the step of the shaped kernel (vector_filter_shaped.cuh):
// both rules classical with N = 2 D + 1 or 2 D points.  Returns the state
// dimension of the instantiation that ran, 0 if none takes the configuration.
extern "C" int vfs_host_run(const VfsParams* params, const double* y, long long y_b,
                            long long y_e, long long y_k, int B, int n_steps, double* m_fi,
                            double* P_fi, double* m_pr, double* P_pr, double* xx) {
  const VfParams& q = params->base;
  if (q.dyn.kind != 0 || q.obs.kind != 0 || q.dyn.n != q.obs.n) return 0;
  int ran = 0;
#define VFS_RUN_IF(D, E, DYN, OBS, N)                                                      \
  if (!ran && q.dyn_model == DYN && q.obs_model == OBS && q.dim_state == D &&              \
      q.dim_out == E && q.dyn.n == N) {                                                    \
    for (int b = 0; b < B; ++b)                                                            \
      vfs_record<D, E, DYN, OBS, N>(*params, y + b * y_b, y_e, y_k, n_steps, m_fi + b,     \
                                    P_fi + b, m_pr + b, P_pr + b, xx + b, B);              \
    ran = D;                                                                               \
  }
  VFS_SHAPES(VFS_RUN_IF)
#undef VFS_RUN_IF
  return ran;
}

// The same for the step of the kernel of the BQ shapes
// (vector_filter_shaped_bq.cu): N = 2 D + 1 or 2 D points on both rules, a
// BQ rule on one transform or both.  Returns the state dimension of the
// instantiation that ran, 0 if none takes the configuration.
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
      vfs_record<D, E, DYN, OBS, N, KD, KO>(*params, y + b * y_b, y_e, y_k, n_steps,       \
                                            m_fi + b, P_fi + b, m_pr + b, P_pr + b, xx + b, \
                                            B);                                            \
    ran = D;                                                                               \
  }
  VFS_BQ_SHAPES(VFS_BQ_RUN_IF)
#undef VFS_BQ_RUN_IF
  return ran;
}

// The same for the step of the general kernel (vector_filter_general.cuh):
// every model pair, E outputs run at the bound EB that holds them (the wide
// form above 8).  Returns the state dimension of the instantiation that ran,
// 0 if the general step does not take the configuration.
extern "C" int vfg_host_run(const VfgParams* params, const double* y, long long y_b,
                            long long y_e, long long y_k, int B, int n_steps, double* m_fi,
                            double* P_fi, double* m_pr, double* P_pr, double* xx,
                            double* scratch) {
  const VfgParams& p = *params;
  if (!vfg_takes(p.base)) return 0;
  const int eb = vfg_bound(p.base.dim_out);
  int ran = 0;
#define VFG_RUN_IF(D, EB)                                                                  \
  if (p.base.dim_state == D && eb == EB) {                                                 \
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
