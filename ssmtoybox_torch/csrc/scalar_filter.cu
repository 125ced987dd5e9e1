// Whole-record scalar sigma-point filter for Hopper (sm_90a), native float64.
//
// Replaces the TPU kernel ssmtoybox_tpu/ops/ddscan_pallas.py::pallas_scalar_filter,
// which runs the whole filter record of a tile of trajectories inside one
// launch in double-double f32 pairs.  Here the card has native f64, so the
// step (scalar_filter_step.cuh) is plain f64 arithmetic.
//
// What bounds it on this card: not bytes (240 MB at 10,000 x 500, 0.07 ms) and
// not the f64 rate, but the dependency chain of one trajectory.  A step is
// sqrt -> points -> divide -> moments -> sqrt -> points -> moments -> divide,
// every link waiting for the one before, 500 times over, and the f64 square
// root and divide are software sequences of some twenty dependent
// instructions each.  10,000 trajectories, one a thread, are 313 warps on 528
// warp schedulers: every warp alone on its scheduler, the launch as long as
// one thread's chain.
//
// Design: a shorter chain a trajectory, and more warps to fill its gaps.
// - The rule's shape is a template argument (kinds of both rules, N slots):
//   every point loop is N straight-line iterations with no predicate, and a
//   classical rule carries no BQ branch.  The launcher picks the smallest of
//   the instantiated slot counts (3, 5, 7, 8) that holds both rules; the
//   wrapper pads a shorter rule with zero weights, which add nothing, so
//   every shape of 1..8 points and either kind runs, bit-equal to the twin.
// - A trajectory takes G lanes of one warp (SF_LANES).  A lane evaluates the
//   model functions at its own slots (its own f64 divide) and, for a BQ rule,
//   its own rows of Wc f; two 32-bit shuffles a double gather the values.
//   All sums then run in every lane in the twin's sequential order, so the
//   lanes agree to the bit and nothing depends on G.  No lane leaves early
//   (the shuffles need the whole warp): a lane past the last trajectory works
//   on a copy of the last one and stores nothing.
// - A lane keeps its slots' points and rows of Wc in registers for the whole
//   record, read once from the parameters (constant bank); y and c of step
//   k + 1 are loaded before the arithmetic of step k.
// - Measurements are read through two strides, so a caller's trajectory-major
//   (B, N) batch needs no transposed copy; the five output streams are
//   time-major, out[k * B + b], so neighbouring trajectories store to
//   neighbouring addresses.
//
// The general form (scalar_filter_general_kernel, step in
// scalar_filter_step_general.cuh) takes what the shaped instantiations do not:
// rules of any point count (GH-9 and up, GPQ and BSQ on those points) and the
// sine and range measurements of a 1-D state.  Up to SF_MAX_SLOTS (32) points
// it runs the slot design (scalar_filter_slots.cu up to 16 slots,
// scalar_filter_slots_wide.cu above, scalar_filter_slots.cuh): the shaped
// form's step at 3, 5, 7, 8, 9, 12, 16, 20, 24 or 32 slots on lanes, the
// models as a policy's functors, the rules' vectors by value and a BQ rule's
// dense weights staged in shared memory.  Above
// that, one thread a trajectory: the point count, both kinds and the
// measurement read at run time (the same in every thread of a launch, so no
// branch diverges), the rules read from device memory and the function
// values through a scratch buffer interleaved by trajectory.  Both designs
// take the models as functors of a policy: scalar_filter_registered.cu runs
// them on models registered at run time.  ops/scalar_filter.py sends a
// configuration to the shaped instantiations whenever they take it (UNGM
// measurement, at most SF_MAX_PTS points), so the main path keeps its
// kernel.
//
// It is built with --fmad=false (ops/scalar_filter.py): every operation rounds
// on its own, as in the plain PyTorch twin, so kernel and twin agree to the
// last bit instead of drifting apart under the chaotic UNGM map.
//
// Build settings, for tools/sf_variants.py (the shipped build sets none):
//   SF_LANES=1|2|4|8    lanes a trajectory at every slot count
//   SF_THREADS=32|64|128|256   threads a block
//   SF_SPREAD_STORES=1  lanes 0..3 (0..4 of 8) store one stream each
//   SF_RUNTIME_SHAPE=1  the step with run-time shapes, one thread a trajectory
#include <cuda_runtime.h>

#include "scalar_filter_slots.cuh"
#include "scalar_filter_step.cuh"
#include "scalar_filter_step_general.cuh"
#ifdef SF_RUNTIME_SHAPE
#include "scalar_filter_step_rt.cuh"
#endif

#ifndef SF_SPREAD_STORES
#define SF_SPREAD_STORES 0
#endif

namespace {

constexpr int kThreads = SF_THREADS;
static_assert(kThreads % 32 == 0 && kThreads <= 1024, "whole warps a block");

struct Streams {
  double *m_fi, *P_fi, *m_pr, *P_pr, *xx;
};

template <int KD, int KO, int N, int G>
__global__ void __launch_bounds__(kThreads)
scalar_filter_kernel(const __grid_constant__ SfParams p, const double* __restrict__ y,
                     long long y_step, long long y_traj, const double* __restrict__ c,
                     int B, int n_steps, const Streams out) {
  static_assert(G == 1 || G == 2 || G == 4 || G == 8, "lanes divide a warp");
  const long long t = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int lane = static_cast<int>(threadIdx.x) % G;
  const long long traj = t / G;
  const bool live = traj < B;
  const int b = live ? static_cast<int>(traj) : B - 1;

  SfStepper<KD, KO, N, G> filter;
  filter.load(p, lane);
  const double* yb = y + b * y_traj;
#if SF_SPREAD_STORES
  // lane j < 4 stores stream j; the fifth goes to lane 4 of 8, or to lane 0
  double* const mine = (lane == 0 ? out.m_fi : lane == 1 ? out.P_fi : lane == 2 ? out.m_pr
                        : lane == 3 ? out.P_pr : out.xx) + b;
  const bool stores = live && lane < (G >= 8 ? 5 : G);
#endif

  double m = p.m0, P = p.P0;
  double y_next = yb[0], c_next = __ldg(c);
  for (int k = 0; k < n_steps; ++k) {
    const double y_k = y_next, c_k = c_next;
    if (k + 1 < n_steps) {
      y_next = yb[(k + 1) * y_step];
      c_next = __ldg(c + k + 1);
    }
    const SfStep s = filter.step(p, m, P, y_k, c_k);
    const size_t row = static_cast<size_t>(k) * B;
#if SF_SPREAD_STORES
    if (G >= 4) {
      const double v = lane == 0 ? s.m_fi : lane == 1 ? s.P_fi : lane == 2 ? s.m_pr
                       : lane == 3 ? s.P_pr : s.xx;
      if (stores) mine[row] = v;
      if (G == 4 && live && lane == 0) out.xx[row + b] = s.xx;
    } else
#endif
    if (live && lane == 0) {
      out.m_pr[row + b] = s.m_pr;
      out.P_pr[row + b] = s.P_pr;
      out.xx[row + b] = s.xx;
      out.m_fi[row + b] = s.m_fi;
      out.P_fi[row + b] = s.P_fi;
    }
    m = s.m_fi;
    P = s.P_fi;
  }
}

// The general form above SF_MAX_SLOTS points: one thread a trajectory, any
// rule, any 1-D measurement.
__global__ void __launch_bounds__(kThreads)
scalar_filter_general_kernel(const __grid_constant__ SfgParams p, const double* __restrict__ y,
                             long long y_step, long long y_traj, const double* __restrict__ c,
                             int B, int n_steps, const Streams out, double* __restrict__ scratch) {
  const long long b = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (b >= B) return;
  sfg_record<SfgZoo>(p, p, y + b * y_traj, y_step, c, 1, n_steps, scratch + b, B, out.m_fi + b,
                     out.P_fi + b, out.m_pr + b, out.P_pr + b, out.xx + b);
}

#ifdef SF_RUNTIME_SHAPE
__global__ void __launch_bounds__(kThreads)
scalar_filter_rt_kernel(const __grid_constant__ SfParams p, const double* __restrict__ y,
                        long long y_step, long long y_traj, const double* __restrict__ c,
                        int B, int n_steps, const Streams out) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= B) return;
  double m = p.m0, P = p.P0;
  for (int k = 0; k < n_steps; ++k) {
    const size_t o = static_cast<size_t>(k) * B + b;
    const SfStep s = sf_step_rt(p, m, P, y[k * y_step + b * y_traj], __ldg(c + k));
    out.m_pr[o] = s.m_pr;
    out.P_pr[o] = s.P_pr;
    out.xx[o] = s.xx;
    out.m_fi[o] = s.m_fi;
    out.P_fi[o] = s.P_fi;
    m = s.m_fi;
    P = s.P_fi;
  }
}
#endif

// Dependent-issue latencies, for the chain floor of a step: one warp runs
// `iters` rounds of 16 dependent operations of each type (so that the loop's
// own branch does not count) and reads the SM's clock around them.
// out[0..6]: clocks an add, a multiply, a divide, a square root (with the add
// that feeds it back), a double moved by two shuffles, an exp (with the
// multiply that feeds it back), an atan2 and a sine (with the add that feeds
// it back); the last three are the vector filter's transcendentals.
#define SF_TIME_CHAIN(SLOT, INIT, OP)                                  \
  {                                                                    \
    double x = INIT;                                                   \
    const long long t0 = clock64();                                    \
    _Pragma("unroll 1") for (int i = 0; i < iters; ++i) {              \
      _Pragma("unroll") for (int u = 0; u < 16; ++u) x = OP;           \
    }                                                                  \
    const long long t1 = clock64();                                    \
    keep += x;                                                         \
    if (threadIdx.x == 0) out[SLOT] = static_cast<double>(t1 - t0) / (16.0 * iters); \
  }

__global__ void sf_latency_kernel(double a, int iters, double* __restrict__ out) {
  double keep = 0.0;
  SF_TIME_CHAIN(0, a, x + a)
  SF_TIME_CHAIN(1, 1.0, x * a)
  SF_TIME_CHAIN(2, a, a / x)
  SF_TIME_CHAIN(3, a, sqrt(x) + a)
  SF_TIME_CHAIN(4, a + threadIdx.x, sf_from_lane<8>(x, (threadIdx.x + 1) & 7))
  // exp(x) c, atan2(x, c) and sin(x) + c settle at 0.49, 1.35 and 1.24
  const double c = 0.3 * a;
  SF_TIME_CHAIN(5, c, exp(x) * c)
  SF_TIME_CHAIN(6, c, atan2(x, c))
  SF_TIME_CHAIN(7, c, sin(x) + c)
  if (threadIdx.x == 0) out[8] = keep;
}

template <int KD, int KO, int N>
void launch(const SfParams& p, const double* y, long long y_step, long long y_traj,
            const double* c, int B, int n_steps, const Streams& out, cudaStream_t stream) {
#ifdef SF_RUNTIME_SHAPE
  scalar_filter_rt_kernel<<<(B + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      p, y, y_step, y_traj, c, B, n_steps, out);
#else
  constexpr int G = sf_lanes(KD, KO, N);
  const long long threads = static_cast<long long>(B) * G;
  const unsigned blocks = static_cast<unsigned>((threads + kThreads - 1) / kThreads);
  scalar_filter_kernel<KD, KO, N, G><<<blocks, kThreads, 0, stream>>>(
      p, y, y_step, y_traj, c, B, n_steps, out);
#endif
}

}  // namespace

// The slot design's launchers: up to SF_NARROW_SLOTS slots
// (scalar_filter_slots.cu) and above (scalar_filter_slots_wide.cu).
cudaError_t sfs_launch_zoo(const SfgParams& p, const SfsRules& v, const double* y,
                           long long y_step, long long y_traj, const double* c, int B,
                           int n_steps, int slots, const SfStreams& out, cudaStream_t stream);
cudaError_t sfs_launch_zoo_wide(const SfgParams& p, const SfsRules& v, const double* y,
                                long long y_step, long long y_traj, const double* c, int B,
                                int n_steps, int slots, const SfStreams& out,
                                cudaStream_t stream);

// Launch on `stream` of card `device` without synchronising.  Measurement k
// of trajectory b is y[k * y_step + b * y_traj], c is (n_steps,), the five
// outputs are (n_steps, B) row-major.  params->dyn and params->obs hold zeros
// past their n points.  Returns the CUDA error of selecting the device or,
// after the launch, cudaGetLastError(); cudaErrorInvalidValue for a shape
// that no instantiation takes.
extern "C" int sf_launch(const SfParams* params, const double* y, long long y_step,
                         long long y_traj, const double* c, int B, int n_steps, int device,
                         double* m_fi, double* P_fi, double* m_pr, double* P_pr, double* xx,
                         void* stream) {
  if (B <= 0 || n_steps <= 0) return 0;
  const SfRule &d = params->dyn, &o = params->obs;
  if (d.n < 1 || d.n > SF_MAX_PTS || o.n < 1 || o.n > SF_MAX_PTS || (d.kind | o.kind) >> 1)
    return static_cast<int>(cudaErrorInvalidValue);
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: select the tensors' card explicitly
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const Streams out = {m_fi, P_fi, m_pr, P_pr, xx};
  const int slots = sf_slots(d.n, o.n);
#define SF_LAUNCH_IF(KD, KO, N)                                                          \
  if (d.kind == KD && o.kind == KO && slots == N)                                        \
    launch<KD, KO, N>(*params, y, y_step, y_traj, c, B, n_steps, out,                    \
                      static_cast<cudaStream_t>(stream));
  SF_SHAPES(SF_LAUNCH_IF)
#undef SF_LAUNCH_IF
  return static_cast<int>(cudaGetLastError());
}

// Launch the general form on `stream` of card `device` without synchronising:
// the layouts of sf_launch; rules of at most SF_MAX_SLOTS points in the slot
// design (their vectors in *vecs, host memory; scratch unused, may be null),
// larger ones one thread a trajectory with scratch of max(n_dyn, n_obs) * B
// doubles (vecs unused).  params->dyn and params->obs point to their
// constants in device memory.  Returns the CUDA error of
// selecting the device or, after the launch, cudaGetLastError();
// cudaErrorInvalidValue for a rule kind, point count or measurement that the
// form does not take.
extern "C" int sfg_launch(const SfgParams* params, const SfsRules* vecs, const double* y,
                          long long y_step, long long y_traj, const double* c, int B,
                          int n_steps, int device, double* m_fi, double* P_fi, double* m_pr,
                          double* P_pr, double* xx, double* scratch, void* stream) {
  if (B <= 0 || n_steps <= 0) return 0;
  const SfgParams& p = *params;
  if (!sfg_rules_ok(p) || p.obs_model < 0 || p.obs_model > SF_OBS_RANGE)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int slots = sf_slots(p.dyn.n, p.obs.n);
  if (slots)
    return static_cast<int>((slots > SF_NARROW_SLOTS ? sfs_launch_zoo_wide : sfs_launch_zoo)(
        p, *vecs, y, y_step, y_traj, c, B, n_steps, slots, {m_fi, P_fi, m_pr, P_pr, xx},
        static_cast<cudaStream_t>(stream)));
  const Streams out = {m_fi, P_fi, m_pr, P_pr, xx};
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(B) + kThreads - 1) /
                                                kThreads);
  scalar_filter_general_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      p, y, y_step, y_traj, c, B, n_steps, out, scratch);
  return static_cast<int>(cudaGetLastError());
}

// Lanes a trajectory and threads a block of this build for rules of kinds
// kind_dyn, kind_obs at `slots` slots (1 lane for the run-time-shape build).
extern "C" void sf_geometry(int kind_dyn, int kind_obs, int slots, int* lanes, int* threads) {
#ifdef SF_RUNTIME_SHAPE
  *lanes = 1;
#else
  *lanes = sf_lanes(kind_dyn, kind_obs, slots);
#endif
  *threads = kThreads;
}

// The design of a launch (sf_design_of in scalar_filter_step_general.cuh).
extern "C" void sf_design(int shaped, int kind_dyn, int kind_obs, int n_dyn, int n_obs,
                          int* slots, int* lanes) {
  sf_design_of(shaped, kind_dyn, kind_obs, n_dyn, n_obs, slots, lanes);
}

// Clocks of a dependent add, multiply, divide, square root (and add),
// two-shuffle move of a double, exp (and multiply) and atan2 into out[0..6]
// (device memory, 8 doubles).
extern "C" int sf_latency(int device, int iters, double* out, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  sf_latency_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(1.0000001, iters, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* sf_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
