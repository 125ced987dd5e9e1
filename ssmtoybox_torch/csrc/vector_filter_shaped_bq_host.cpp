// Host build of the step of the BQ shapes at mixed point counts
// (vector_filter_shaped.cuh, the instantiations of
// vector_filter_shaped_bq_mixed.cu), for testing its arithmetic on a machine
// without a GPU, picked as its launcher picks them.  A library of its own,
// beside vector_filter_host.cpp (whose build takes the BQ shapes at one
// count and the other steps), so that a test of these 30 instantiations
// compiles no other step.
#include "vector_filter_shaped.cuh"

// The step on the trajectories one after another, with vfs_bq_launch's
// layouts (time-major outputs, no scratch buffer): the UT count on one rule
// beside the CKF count on the other, a BQ rule on either or both.  Returns
// the state dimension of the instantiation that ran, 0 if none takes the
// configuration.
extern "C" int vfs_bq_mixed_host_run(const VfsBqParams* params, const double* y, long long y_b,
                                     long long y_e, long long y_k, int B, int n_steps,
                                     double* m_fi, double* P_fi, double* m_pr, double* P_pr,
                                     double* xx) {
  const VfParams& q = params->base;
  int ran = 0;
#define VFS_BQ_MIXED_RUN_IF(D, E, DYN, OBS, ND, NO, KD, KO)                                \
  if (!ran && q.dyn_model == DYN && q.obs_model == OBS && q.dim_state == D &&              \
      q.dim_out == E && q.dyn.n == ND && q.obs.n == NO && q.dyn.kind == KD &&              \
      q.obs.kind == KO) {                                                                  \
    for (int b = 0; b < B; ++b)                                                            \
      vfs_record<D, E, DYN, OBS, ND, NO, KD, KO>(*params, y + b * y_b, y_e, y_k, n_steps,  \
                                                 m_fi + b, P_fi + b, m_pr + b, P_pr + b,   \
                                                 xx + b, B);                               \
    ran = D;                                                                               \
  }
  VFS_BQ_MIXED(VFS_BQ_MIXED_RUN_IF)
#undef VFS_BQ_MIXED_RUN_IF
  return ran;
}
