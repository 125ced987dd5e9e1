// The general whole-record vector filter for Hopper (sm_90a), native float64:
// every model pair of the vector filter's table (reentry, constant velocity,
// the pendulum, the falling body and the coordinated turn, each with the
// radar, the sine, the range, the UNGM measurement of a state component or
// bearings from any number of sensors), classical (UKF, CKF, Gauss-Hermite)
// and BQ (GPQ, BSQ) rules with a scalar model variance.  The same kernel,
// instantiated on the models a user registers, is vector_filter_registered.cu.
//
// Replaces, with the first version (vector_filter.cu) and the shaped kernels
// (vector_filter_shaped.cu, vector_filter_shaped_bq.cu), the JAX package's
// ssmtoybox_tpu/ops/ddvec.py:514 dd_filter_batch, its engine="dd" for D <= 8,
// for the pairs those kernels have no instantiation of: ops/vector_filter.py
// (kernel_of) sends the five pairs they take to them as before, and every
// other pair here (CT + radar, bearings from 1-3 or 5 and more sensors, the
// UNGM measurement on a vector state, ...).
//
// What bounds it on this card: as for the first version, not bytes and not the
// f64 rate but the dependency chain of one trajectory (Cholesky factors,
// points through the models, moment sums, the gain solve).
//
// Design (the steps in vector_filter_general.cuh and vector_filter_lanes.cuh):
// - one thread a trajectory up to 4 measurement outputs, and for the shapes
//   the lane-group form does not take; where both rules are classical at one
//   UT or CKF count on a pair of VGS_PAIRS, the shaped one-thread form of
//   vector_filter_general_shaped.cu (built into the same library) runs it
//   instead; here D (2-5) and EB, a
//   bound on the measurement dimension E (2, 4, 8, or 0 for the wide form of
//   any E), are template arguments, 16 instantiations in all; the transition
//   among those of its D, the measurement, E, both rule kinds and point
//   counts are read at run time, the same in every thread, so no branch
//   diverges; every loop over measurement components runs EB predicated
//   iterations, or, in the wide form, E iterations over arrays in the scratch
//   buffer;
// - more than 4 outputs, the lane-group form (vector_filter_lanes.cuh): a
//   trajectory on VFL_G = 8 lanes of a warp, its arrays in shared memory,
//   the work split by entry (4 instantiations, D = 2-5); the launcher's
//   `lanes` says which form runs (ops/vector_filter.py, lanes_of): a shape
//   whose arrays do not fit in shared memory, or of at most 8 outputs that
//   leaves an SM too few warps of that form (many points), keeps the
//   one-thread form;
// - rules of many points (Gauss-Hermite), the warp form of the same header:
//   a trajectory on a whole warp, each lane evaluating every 32nd point, the
//   offsets of a tile of 32 points recomputed for the sums that need them
//   (4 instantiations, D = 2-5);
// - the measurement's constants and R are read from device memory, so E has
//   no cap;
// - as in the first version: the rules' constants through the read-only path
//   (__ldg), the one-thread forms' function values in a scratch buffer
//   interleaved by trajectory, time-major outputs, measurements read through
//   three strides.
//
// Built with --fmad=false (ops/vector_filter.py), as the other vector filter
// kernels: every operation rounds on its own, as in the plain PyTorch
// version, so the two agree to the bit.
#include <cuda_runtime.h>

#include "vector_filter_lanes.cuh"

// Launch on `stream` of card `device` without synchronising, with the
// layouts of vf_launch (vector_filter.cu): measurement e of step k of
// trajectory b at y[b * y_b + e * y_e + k * y_k], time-major outputs.
// `lanes` 0: the one-thread form at the bound that holds E, scratch of
// vfg_values(p) * B doubles (and 2 E + 2 E^2 + 4 D E more a trajectory for
// E > 8, the wide form); VFL_G: the lane-group form on that many lanes a
// trajectory, no scratch; VFL_WARP: the warp form, no scratch.  Returns the CUDA error of selecting the device or,
// after the launch, cudaGetLastError(); cudaErrorInvalidValue for a
// configuration the
// general step does not take, other `lanes`, or a lane-group shape whose
// arrays do not fit in a block's shared memory.
extern "C" int vfg_launch(const VfgParams* params, const double* y, long long y_b, long long y_e,
                          long long y_k, int B, int n_steps, int device, double* m_fi,
                          double* P_fi, double* m_pr, double* P_pr, double* xx, double* scratch,
                          int lanes, void* stream) {
  if (B <= 0 || n_steps <= 0) return 0;
  const VfgParams& p = *params;
  if (!vfg_takes(p.base) || (lanes != 0 && lanes != VFL_G && lanes != VFL_WARP))
    return static_cast<int>(cudaErrorInvalidValue);
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: select the tensors' card explicitly
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const VfgStreams out = {m_fi, P_fi, m_pr, P_pr, xx};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (lanes != 0) {
#define VFL_LAUNCH_IF(D)                                                                   \
  if (p.base.dim_state == D)                                                               \
    return lanes == VFL_WARP                                                               \
               ? vfl_launch_as<D, VFL_WARP, VfgZoo<D, 0>>(p, y, y_b, y_e, y_k, nullptr, 0, \
                                                          B, n_steps, out, st)             \
               : vfl_launch_as<D, VFL_G, VfgZoo<D, 0>>(p, y, y_b, y_e, y_k, nullptr, 0, B, \
                                                       n_steps, out, st);
    VFL_SHAPES(VFL_LAUNCH_IF)
#undef VFL_LAUNCH_IF
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int eb = vfg_bound(p.base.dim_out);
#define VFG_LAUNCH_IF(D, EB)                                                              \
  if (p.base.dim_state == D && eb == EB)                                                  \
    vfg_launch_as<D, EB, VfgZoo<D, EB>>(p, y, y_b, y_e, y_k, nullptr, 0, B, n_steps, out,  \
                                        scratch, st);
  VFG_SHAPES(VFG_LAUNCH_IF)
#undef VFG_LAUNCH_IF
  return static_cast<int>(cudaGetLastError());
}

#ifdef VFL_CLOCKS
// The clocks of each phase of the warp form summed over the warps into
// out[0 .. 16) since the last call, which sets them to 0 (vfl_mark; slots 14
// and 15 are a warp's last mark and its next slot).
extern "C" int vfl_clock_totals(long long* out) {
  static long long rows[VFL_CLOCK_WARPS][16];
  cudaError_t rc = cudaDeviceSynchronize();
  if (rc == cudaSuccess) rc = cudaMemcpyFromSymbol(rows, vfl_clocks, sizeof(rows));
  if (rc != cudaSuccess) return static_cast<int>(rc);
  for (int i = 0; i < 16; ++i) out[i] = 0;
  for (int w = 0; w < VFL_CLOCK_WARPS; ++w)
    for (int i = 0; i < 14; ++i) out[i] += rows[w][i];
  static long long zeros[VFL_CLOCK_WARPS][16];
  return static_cast<int>(cudaMemcpyToSymbol(vfl_clocks, zeros, sizeof(zeros)));
}
#endif
