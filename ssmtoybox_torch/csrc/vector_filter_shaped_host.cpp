// Host build of the classical shaped kernel's step (vector_filter_shaped.cuh),
// for testing its arithmetic on a machine without a GPU: the instantiations
// of vector_filter_shaped.cu, one count on both rules, the mixed counts and
// the Gauss-Hermite counts, picked as its launcher picks them.  A library of
// its own, beside vector_filter_host.cpp, so that a test of these 22
// instantiations does not compile the other steps' (and the other steps'
// tests not these).
#include "vector_filter_shaped.cuh"

// The shaped step on the trajectories one after another, with vfs_launch's
// layouts (time-major outputs, no scratch buffer): both rules classical with
// 2 D + 1 or 2 D points each, or the Gauss-Hermite count of VFS_GH on both.
// Returns the state dimension of the
// instantiation that ran, 0 if none takes the configuration.
extern "C" int vfs_host_run(const VfsParams* params, const double* y, long long y_b,
                            long long y_e, long long y_k, int B, int n_steps, double* m_fi,
                            double* P_fi, double* m_pr, double* P_pr, double* xx) {
  const VfParams& q = params->base;
  if (q.dyn.kind != 0 || q.obs.kind != 0) return 0;
  int ran = 0;
#define VFS_RUN_IF(D, E, DYN, OBS, ND, NO)                                                 \
  if (!ran && q.dyn_model == DYN && q.obs_model == OBS && q.dim_state == D &&              \
      q.dim_out == E && q.dyn.n == ND && q.obs.n == NO) {                                  \
    for (int b = 0; b < B; ++b)                                                            \
      vfs_record<D, E, DYN, OBS, ND, NO>(*params, y + b * y_b, y_e, y_k, n_steps,          \
                                         m_fi + b, P_fi + b, m_pr + b, P_pr + b, xx + b, \
                                         B);                                              \
    ran = D;                                                                               \
  }
  VFS_SHAPES(VFS_RUN_IF)
#undef VFS_RUN_IF
  return ran;
}
