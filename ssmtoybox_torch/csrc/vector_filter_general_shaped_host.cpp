// Host build of the general kernel's shaped one-thread form
// (vector_filter_general_shaped.cuh), for testing its arithmetic on a
// machine without a GPU: the instantiations of vector_filter_general_shaped.cu,
// vector_filter_general_shaped_mixed.cu (the mixed point counts) and
// vector_filter_general_shaped_gh.cu (the Gauss-Hermite counts),
// picked as their launchers pick them, the trajectories one after another
// with the kernel's layouts (time-major outputs, no scratch buffer).  A
// library of its own, beside vector_filter_host.cpp, so that the tests of the
// other steps do not compile these 53 instantiations.
#include "vector_filter_general_shaped.cuh"

// Returns the state dimension of the instantiation that ran, 0 if none takes
// the configuration (vgs_takes).
extern "C" int vgs_host_run(const VgsParams* params, const double* y, long long y_b,
                            long long y_e, long long y_k, int B, int n_steps, double* m_fi,
                            double* P_fi, double* m_pr, double* P_pr, double* xx) {
  const VgsParams& p = *params;
  const VfParams& q = p.base;
  if (!vgs_takes(q)) return 0;
  int ran = 0;
#define VGS_RUN_IF(D, E, DYN, OBS, ND, NO)                                                  \
  if (!ran && q.dyn_model == DYN && q.obs_model == OBS && q.dim_state == D &&               \
      q.dim_out == E && q.dyn.n == ND && q.obs.n == NO) {                                   \
    for (int b = 0; b < B; ++b)                                                             \
      vgs_record<D, E, ND, NO, 0, 0, VgsZoo<D, E, DYN, OBS>>(                               \
          p, y + b * y_b, y_e, y_k, n_steps, nullptr, 0, m_fi + b, P_fi + b, m_pr + b,      \
          P_pr + b, xx + b, B);                                                             \
    ran = D;                                                                                \
  }
  VGS_SHAPES(VGS_RUN_IF)
  VGS_MIXED(VGS_RUN_IF)
  VGS_GH(VGS_RUN_IF)
#undef VGS_RUN_IF
  return ran;
}
