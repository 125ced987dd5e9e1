// Host build of the general and registered kernels' slot form
// (vector_filter_general_slots.cuh), for testing its arithmetic on a machine
// without a GPU: the lanes collapse to one (vsl_from_lane returns the lane's
// own value, and a split of the sums needs two lanes; each shape's choice of
// keeping the offsets stands), the trajectories one after another with the
// kernels' layouts (time-major outputs, no scratch buffer).  A library of its
// own, so that its tests compile these instantiations only.
//
// Built as is, it holds vsg_host_run, the general kernel's pairs of
// VSL_GENERAL picked as vsl_launch picks them.  Built with -DVFR_REGISTERED
// beside a generated vfr_forms.cuh (ops/vector_filter.py, build_registered),
// it holds only vfr_slots_host_run, the registered configurations of
// VFR_SLOTS as vfr_slots_launch (vector_filter_registered.cu) launches them.
#include "vector_filter_general_slots.cuh"

#ifdef VFR_REGISTERED
#include "vfr_forms.cuh"

// Configuration `pair` of VFR_SLOTS on the trajectories one after another,
// with vfr_slots_launch's layouts.  Returns the state dimension of the
// instantiation that ran, 0 if `pair` does not take the configuration.
extern "C" int vfr_slots_host_run(int pair, const VsrParams* params, const double* y,
                                  long long y_b, long long y_e, long long y_k, const double* s,
                                  int n_s, int B, int n_steps, double* m_fi, double* P_fi,
                                  double* m_pr, double* P_pr, double* xx) {
  const VfParams& q = params->base;
  if (q.dyn.kind != 0 || q.obs.kind != 0) return 0;
#define VFR_SLOTS_RUN_IF(I, D, E, MODEL)                                                     \
  if (pair == I && q.dim_state == D && q.dim_out == E && q.dyn.n == MODEL::N &&              \
      q.obs.n == MODEL::N) {                                                                 \
    using Design = VslDesign<1, MODEL::split, MODEL::keep>;                                  \
    for (int b = 0; b < B; ++b)                                                              \
      vsl_record<D, E, MODEL::N, Design, MODEL>(*params, 0, ~0u, y + b * y_b, y_e, y_k,      \
                                                n_steps, s, n_s, m_fi + b, P_fi + b,         \
                                                m_pr + b, P_pr + b, xx + b, B);              \
    return D;                                                                                \
  }
  VFR_SLOTS(VFR_SLOTS_RUN_IF)
#undef VFR_SLOTS_RUN_IF
  return 0;
}

#else

// The general kernel's pairs of VSL_GENERAL on the trajectories one after
// another, with vsl_launch's layouts.  Returns the state dimension of the
// instantiation that ran, 0 if none takes the configuration.
extern "C" int vsg_host_run(const VslParams* params, const double* y, long long y_b,
                            long long y_e, long long y_k, int B, int n_steps, double* m_fi,
                            double* P_fi, double* m_pr, double* P_pr, double* xx) {
  const VfParams& q = params->base;
  if (vsl_lanes_of(q) == 0) return 0;
#define VSG_RUN_IF(D, E, DYN, OBS, N, LANES, SPLIT, KEEP)                                    \
  if (q.dyn_model == DYN && q.obs_model == OBS && q.dim_state == D && q.dim_out == E &&      \
      q.dyn.n == N) {                                                                        \
    using Design = VslDesign<1, SPLIT, KEEP>;                                                \
    for (int b = 0; b < B; ++b)                                                              \
      vsl_record<D, E, N, Design, VgsZoo<D, E, DYN, OBS>>(*params, 0, ~0u, y + b * y_b, y_e, \
                                                          y_k, n_steps, nullptr, 0,          \
                                                          m_fi + b, P_fi + b, m_pr + b,      \
                                                          P_pr + b, xx + b, B);              \
    return D;                                                                                \
  }
  VSL_GENERAL(VSG_RUN_IF)
#undef VSG_RUN_IF
  return 0;
}

#endif
