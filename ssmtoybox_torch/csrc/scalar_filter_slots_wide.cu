// The slot design of the scalar filter kernel's general form on the kernel's
// own models above SF_NARROW_SLOTS points, for Hopper (sm_90a), native
// float64: every pair of rule kinds at 20, 24 and SF_MAX_SLOTS (32) slots
// (SFS_WIDE_SHAPES, 12 instantiations), launched by sfg_launch
// (scalar_filter.cu) for rules of 17-32 points.  A third source beside
// scalar_filter.cu and scalar_filter_slots.cu, so that nvcc builds the three
// at once and the slowest build does not grow.
//
// Replaces, with scalar_filter.cu, the TPU kernel
// ssmtoybox_tpu/ops/ddscan_pallas.py::pallas_scalar_filter; the design is in
// scalar_filter_slots.cuh and scalar_filter_step_general.cuh.  Until these
// counts were instantiated, rules of 17-32 points ran one thread a
// trajectory, their values through a scratch buffer in device memory.  Built
// with --fmad=false like scalar_filter.cu.
#include "scalar_filter_slots.cuh"

// Launch the configuration p (its rules' vectors v) at `slots` slots (sf_slots
// of its rules, above SF_NARROW_SLOTS) with sfg_launch's layouts;
// cudaErrorInvalidValue for a shape not instantiated.
cudaError_t sfs_launch_zoo_wide(const SfgParams& p, const SfsRules& v, const double* y,
                                long long y_step, long long y_traj, const double* c, int B,
                                int n_steps, int slots, const SfStreams& out,
                                cudaStream_t stream) {
#define SFS_LAUNCH_IF(KD, KO, N)                                                           \
  if (p.dyn.kind == KD && p.obs.kind == KO && slots == N)                                  \
    return sfs_launch<KD, KO, N, SfgZoo>(p, v, y, y_step, y_traj, c, 1, B, n_steps, out,   \
                                         stream);
  SFS_WIDE_SHAPES(SFS_LAUNCH_IF)
#undef SFS_LAUNCH_IF
  return cudaErrorInvalidValue;
}
