// The slot design of the scalar filter kernel's general form on the kernel's
// own models (the UNGM transition with the UNGM, sine or range measurement),
// for Hopper (sm_90a), native float64: every pair of rule kinds at every slot
// count up to SF_NARROW_SLOTS (SFS_SHAPES, 28 instantiations), launched by
// sfg_launch (scalar_filter.cu) for rules of at most SF_NARROW_SLOTS points;
// the counts above it are scalar_filter_slots_wide.cu's.  Its own source, so
// that nvcc builds it beside scalar_filter.cu, at once.
//
// Replaces, with scalar_filter.cu, the TPU kernel
// ssmtoybox_tpu/ops/ddscan_pallas.py::pallas_scalar_filter; the design is in
// scalar_filter_slots.cuh and scalar_filter_step_general.cuh.  Built with
// --fmad=false like scalar_filter.cu.
#include "scalar_filter_slots.cuh"

// Launch the configuration p (its rules' vectors v) at `slots` slots (sf_slots
// of its rules) with sfg_launch's layouts; cudaErrorInvalidValue for a shape
// not instantiated.
cudaError_t sfs_launch_zoo(const SfgParams& p, const SfsRules& v, const double* y,
                           long long y_step, long long y_traj, const double* c, int B,
                           int n_steps, int slots, const SfStreams& out, cudaStream_t stream) {
#define SFS_LAUNCH_IF(KD, KO, N)                                                           \
  if (p.dyn.kind == KD && p.obs.kind == KO && slots == N)                                  \
    return sfs_launch<KD, KO, N, SfgZoo>(p, v, y, y_step, y_traj, c, 1, B, n_steps, out,   \
                                         stream);
  SFS_SHAPES(SFS_LAUNCH_IF)
#undef SFS_LAUNCH_IF
  return cudaErrorInvalidValue;
}
