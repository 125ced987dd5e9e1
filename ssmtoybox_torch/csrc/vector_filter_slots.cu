// The slot kernel of the vector filter for Hopper (sm_90a), native float64:
// Gauss-Hermite rules of 16-81 points on both transforms of the five model
// pairs with a kernel form (VSL_SHAPES: reentry + radar and CT + 4 bearings
// under GH-2, 32 points; constant velocity + radar under GH-2 and GH-3, 16
// and 81; the falling body + range under GH-3, 27), a trajectory on G lanes
// of a warp; its launcher also launches the general kernel's pairs'
// Gauss-Hermite shapes (VSL_GENERAL, vector_filter_general_slots.cu and
// _hi.cu).  The same five pairs' other rules run in the library's other
// kernels: the UT, CKF and Gauss-Hermite counts of at most 11 points in
// vector_filter_shaped.cu and vector_filter_shaped_bq*.cu, rules of 243
// points and more in the general kernel's warp form, everything else in the
// first version (vector_filter.cu).
//
// Replaces, with the other vector filter kernels, the JAX package's
// ssmtoybox_tpu/ops/ddvec.py:514 dd_filter_batch (jnp double-double, no
// Pallas kernel), at these shapes.
//
// What bounds it on this card: the dependency chain of a trajectory's step
// (two D x D Cholesky factors, N model evaluations, the moment sums over N
// points, an E x E factor and the gain), not bytes (0.21 ms for 10,000 x 100
// at D = 5 at 3.35 TB/s) and, at 81 points, partly the f64 issue rate: every
// lane repeats the sums.  The first version ran these shapes one thread a
// trajectory with N read at run time and every value through a scratch
// buffer in device memory, 313 warps for 10,000 trajectories, 2.4 an SM.
//
// Design (vector_filter_slots.cuh): the shaped kernels' step with N a
// template argument; a trajectory's points split over G lanes (2 or 4, each
// shape's in VSL_SHAPES), each lane evaluating its own points whole, the
// values gathered by shuffles for the sums, the mean's on every lane, the
// covariances' on every lane or split by output row; the rules by value in
// the constant bank; nothing through device memory but the measurements and
// the outputs.
//
// Built with --fmad=false (ops/vector_filter.py), as the other vector filter
// kernels: every operation rounds on its own, as in the plain PyTorch
// version, so the two agree to the bit.
#include <cuda_runtime.h>

#include "vector_filter_slots.cuh"

namespace {

// Threads a block: 64, 32 trajectories of 2 lanes or 16 of 4.
constexpr int kThreads = 64;
static_assert(kThreads % 32 == 0, "whole warps a block");

struct Streams {
  double *m_fi, *P_fi, *m_pr, *P_pr, *xx;
};

template <int D, int E, int DYN, int OBS, int N, class Design>
__global__ void __launch_bounds__(kThreads)
vector_filter_slots_kernel(const __grid_constant__ VslParams p, const double* __restrict__ y,
                           long long y_b, long long y_e, long long y_k, int B, int n_steps,
                           const Streams out) {
  constexpr int G = Design::G;
  const long long b = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) / G;
  const int lane = static_cast<int>(threadIdx.x) % G;
  // the lanes of trajectories past the last return; the shuffles name the others
  const unsigned mask = __ballot_sync(0xffffffffu, b < B);
  if (b >= B) return;
  vsl_record<D, E, N, Design, VfsZoo<D, E, DYN, OBS>>(p, lane, mask, y + b * y_b, y_e, y_k,
                                                      n_steps, nullptr, 0, out.m_fi + b,
                                                      out.P_fi + b, out.m_pr + b, out.P_pr + b,
                                                      out.xx + b, B);
}

}  // namespace

// Launch on `stream` of card `device` without synchronising; the layouts of
// vf_launch (vector_filter.cu), no scratch buffer.  Returns the CUDA error of
// selecting the device or, after the launch, cudaGetLastError();
// cudaErrorInvalidValue for a configuration that no instantiation of
// VSL_SHAPES or VSL_GENERAL takes (vsl_lanes_of).  The general kernel's pairs
// (VSL_GENERAL) go to vsl_launch_general (vector_filter_general_slots.cu).
extern "C" int vsl_launch(const VslParams* params, const double* y, long long y_b,
                          long long y_e, long long y_k, int B, int n_steps, int device,
                          double* m_fi, double* P_fi, double* m_pr, double* P_pr, double* xx,
                          void* stream) {
  if (B <= 0 || n_steps <= 0) return 0;
  const VfParams& q = params->base;
  if (vsl_lanes_of(q) == 0) return static_cast<int>(cudaErrorInvalidValue);
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: select the tensors' card explicitly
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Streams out = {m_fi, P_fi, m_pr, P_pr, xx};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define VSL_LAUNCH_IF(D, E, DYN, OBS, N, LANES, SPLIT, KEEP)                                \
  if (q.dyn_model == DYN && q.obs_model == OBS && q.dim_state == D && q.dim_out == E &&      \
      q.dyn.n == N) {                                                                        \
    using Design = VSL_DESIGN(LANES, SPLIT, KEEP);                                           \
    const long long threads = static_cast<long long>(B) * Design::G;                         \
    const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);      \
    vector_filter_slots_kernel<D, E, DYN, OBS, N, Design>                                    \
        <<<blocks, kThreads, 0, st>>>(*params, y, y_b, y_e, y_k, B, n_steps, out);           \
    return static_cast<int>(cudaGetLastError());                                             \
  }
  VSL_SHAPES(VSL_LAUNCH_IF)
#undef VSL_LAUNCH_IF
  return vsl_launch_general(*params, y, y_b, y_e, y_k, B, n_steps, m_fi, P_fi, m_pr, P_pr, xx,
                            st);
}

// The lanes a trajectory of the configuration runs on in this build
// (vsl_lanes_of), 0 if no instantiation takes it: what tools/lane_variants.py
// asks of a build that sets VSL_LANES.
extern "C" int vsl_lanes_on(const VfParams* params) { return vsl_lanes_of(*params); }
