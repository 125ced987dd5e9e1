// Host build of the slot kernel's step (vector_filter_slots.cuh), for testing
// its arithmetic on a machine without a GPU: the instantiations of
// vector_filter_slots.cu (VSL_SHAPES) on one lane a trajectory (the lanes
// collapse to one: vsl_from_lane returns the lane's own value, and a split of
// the sums needs two lanes; each shape's choice of keeping the offsets
// stands), picked as its
// launcher picks them, the trajectories one after another with the kernel's
// layouts (time-major outputs, no scratch buffer).  A library of its own, so
// that its tests compile these 5 instantiations only.
#include "vector_filter_slots.cuh"

// Returns the state dimension of the instantiation that ran, 0 if none takes
// the configuration (vsl_lanes_of).
extern "C" int vsl_host_run(const VslParams* params, const double* y, long long y_b,
                            long long y_e, long long y_k, int B, int n_steps, double* m_fi,
                            double* P_fi, double* m_pr, double* P_pr, double* xx) {
  const VfParams& q = params->base;
  if (vsl_lanes_of(q) == 0) return 0;
#define VSL_RUN_IF(D, E, DYN, OBS, N, LANES, SPLIT, KEEP)                                    \
  if (q.dyn_model == DYN && q.obs_model == OBS && q.dim_state == D && q.dim_out == E &&      \
      q.dyn.n == N) {                                                                        \
    using Design = VslDesign<1, SPLIT, KEEP>;                                                \
    for (int b = 0; b < B; ++b)                                                              \
      vsl_record<D, E, N, Design, VfsZoo<D, E, DYN, OBS>>(*params, 0, ~0u, y + b * y_b, y_e, \
                                                          y_k, n_steps, nullptr, 0,          \
                                                          m_fi + b, P_fi + b, m_pr + b,      \
                                                          P_pr + b, xx + b, B);              \
    return D;                                                                                \
  }
  VSL_SHAPES(VSL_RUN_IF)
#undef VSL_RUN_IF
  return 0;
}

