// Whole-record Gaussian sigma-point filter for small vector states on Hopper
// (sm_90a), native float64: the reentry and constant-velocity models with the
// range-bearing radar, the pendulum, the falling body with its range and the
// coordinated turn with four bearings, classical (UKF, CKF, Gauss-Hermite)
// and BQ (GPQ, BSQ) rules with a scalar model variance.
//
// Replaces ssmtoybox_tpu/ops/ddvec.py:514 dd_filter_batch, the JAX package's
// engine="dd" for D <= 8: a lax.scan of double-double f32-pair arithmetic in
// jnp (no Pallas kernel), because the TPU has no f64 unit.  The card has one,
// so the step (vector_filter_step.cuh) is plain f64 arithmetic, and the whole
// record of every trajectory runs inside one launch in place of the eager
// filter's ~100 small device operations a step.
//
// What bounds it on this card: not bytes (a step writes 85 doubles a
// trajectory at D = 5 and reads 2: 0.68 GB for 10,000 x 100, 0.2 ms at
// 3.35 TB/s) and not the f64 rate, but the dependency chain of one
// trajectory.  A step is a 5 x 5 Cholesky (five dependent square roots and
// divides), N points through the model (two square roots, an exponential and
// two divides each, or a square root and an arctangent), the moment sums, a second
// 5 x 5 Cholesky, a 2 x 2 one and the gain solve, every link waiting for the
// one before; 10,000 trajectories are 313 warps, 2.4 an SM, so nothing hides
// the latencies.
//
// Design, first version (simple and right; faster designs are later work):
// - one thread a trajectory; D, E, the two models and the two rule kinds are
//   template arguments, so the small matrices live in registers and their
//   loops unroll; the number of points N is read at run time (3 ... 243);
// - the rules' constants are read through the read-only path (__ldg, the
//   same address in every lane of a warp), never held in registers;
// - the N function values of a transform go to a scratch buffer interleaved
//   by trajectory (coalesced), written in the mean pass and read back for
//   the centred classical sums or the BQ quadratic form (N^2 reads);
// - the five output streams are time-major, out[(k, component, b)], so that
//   neighbouring threads store to neighbouring addresses; measurements are
//   read through three strides, so any layout of the caller's (B, E, T)
//   batch is read without a copy.
//
// What it runs (ops/vector_filter.py, kernel_of): every configuration of its
// five pairs when sent here by force, as the tests and chip_smoke.py send
// it; routed, only the counts below 243 points that no other kernel takes
// (Gauss-Hermite of other degrees, GH-4 on the pendulum and the falling body
// say; a BQ rule at a Gauss-Hermite count; Gauss-Hermite beside another
// count).  The UT and CKF counts, one on both transforms or the two mixed,
// of either kind, run in the shaped kernels (vector_filter_shaped.cu,
// vector_filter_shaped_bq.cu and vector_filter_shaped_bq_mixed.cu), and so
// do both classical rules at the Gauss-Hermite count of at most 11 points
// (vector_filter_shaped.cu); classical Gauss-Hermite rules of 16-81 points
// in the slot kernel (vector_filter_slots.cu); rules of 243 points and more
// in the general kernel's warp form.
//
// Built with --fmad=false (ops/vector_filter.py): every operation rounds on
// its own, as in the plain PyTorch version, so the two can agree to the bit.
#include <cuda_runtime.h>

#include "vector_filter_step.cuh"

namespace {

// 64 threads a block: 10,000 trajectories are 157 blocks, one or two an SM.
constexpr int kThreads = 64;

struct Streams {
  double *m_fi, *P_fi, *m_pr, *P_pr, *xx;
};

template <int D, int E, int DYN, int OBS, int KD, int KO>
__global__ void __launch_bounds__(kThreads)
vector_filter_kernel(const __grid_constant__ VfParams p, const double* __restrict__ y,
                     long long y_b, long long y_e, long long y_k, int B, int n_steps,
                     const Streams out, double* __restrict__ scratch) {
  const long long b = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= B) return;
  vf_record<D, E, DYN, OBS, KD, KO>(p, y + b * y_b, y_e, y_k, n_steps, scratch + b, B,
                                    out.m_fi + b, out.P_fi + b, out.m_pr + b, out.P_pr + b,
                                    out.xx + b, B);
}

template <int D, int E, int DYN, int OBS, int KD, int KO>
void launch(const VfParams& p, const double* y, long long y_b, long long y_e, long long y_k,
            int B, int n_steps, const Streams& out, double* scratch, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(B) + kThreads - 1) /
                                                kThreads);
  vector_filter_kernel<D, E, DYN, OBS, KD, KO><<<blocks, kThreads, 0, stream>>>(
      p, y, y_b, y_e, y_k, B, n_steps, out, scratch);
}

}  // namespace

// Launch on `stream` of card `device` without synchronising.  Measurement e of
// step k of trajectory b is y[b * y_b + e * y_e + k * y_k]; the outputs are
// time-major, m_fi / m_pr (n_steps, D, B) and P_fi / P_pr / xx (n_steps, D,
// D, B); scratch holds max(n_dyn * D, n_obs * E) * B doubles.  Returns the
// CUDA error of selecting the device or, after the launch,
// cudaGetLastError(); cudaErrorInvalidValue for a configuration that no
// instantiation takes.
extern "C" int vf_launch(const VfParams* params, const double* y, long long y_b, long long y_e,
                         long long y_k, int B, int n_steps, int device, double* m_fi,
                         double* P_fi, double* m_pr, double* P_pr, double* xx, double* scratch,
                         void* stream) {
  if (B <= 0 || n_steps <= 0) return 0;
  const VfParams& p = *params;
  if (p.dyn.n < 1 || p.obs.n < 1 || (p.dyn.kind | p.obs.kind) >> 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: select the tensors' card explicitly
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Streams out = {m_fi, P_fi, m_pr, P_pr, xx};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  bool ran = false;
#define VF_KINDS(D, E, DYN, OBS, KD, KO)                                                  \
  if (p.dyn.kind == KD && p.obs.kind == KO) {                                             \
    launch<D, E, DYN, OBS, KD, KO>(p, y, y_b, y_e, y_k, B, n_steps, out, scratch, s);     \
    ran = true;                                                                           \
  }
#define VF_LAUNCH_IF(D, E, DYN, OBS)                                                      \
  if (!ran && p.dyn_model == DYN && p.obs_model == OBS && p.dim_state == D &&             \
      p.dim_out == E) {                                                                   \
    VF_KINDS(D, E, DYN, OBS, 0, 0) VF_KINDS(D, E, DYN, OBS, 0, 1)                         \
    VF_KINDS(D, E, DYN, OBS, 1, 0) VF_KINDS(D, E, DYN, OBS, 1, 1)                         \
  }
  VF_MODELS(VF_LAUNCH_IF)
#undef VF_LAUNCH_IF
#undef VF_KINDS
  if (!ran) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* vf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
