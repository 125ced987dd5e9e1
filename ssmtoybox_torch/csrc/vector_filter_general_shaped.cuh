// The shaped one-thread form of the general and registered vector filter
// kernels (vector_filter_general_shaped.cu, vector_filter_registered.cu): one
// trajectory a thread, up to 4 measurement outputs on states of 2-5
// dimensions, each rule at the UT or CKF point count of the state (ND on the
// dynamics, NO on the measurement, each 2 D + 1 or 2 D: one count on both,
// or the UKF beside the CKF), or both classical rules at the Gauss-Hermite
// count of at most 11 points (vfs_gh_count: GH-3 on 2-D states, GH-2 on 3-D
// ones), in native float64.
//
// Shared by the CUDA kernels and the host shims (vector_filter_general_shaped_host.cpp,
// and vector_filter_host.cpp built for a registered library), which g++
// builds, so that the CPU tests hold this exact code against the plain
// PyTorch version in ssmtoybox_torch/ops/vector_filter.py.  Every sum runs in
// the plain version's order, from 0.0 upwards.
//
// What held the general one-thread form (vfg_step, vector_filter_general.cuh)
// back at these shapes: its point loops ran N read at run time, the rules'
// points and weights came through pointers into device memory, each point's
// offset was computed twice, every function value went out to a scratch
// buffer in device memory and came back for the covariance sums, R and the
// measurement's constants came from device memory, E was padded to a bound
// (2, 4 or 8) with every loop over outputs predicated, and every measurement
// of the table sat behind a run-time switch.  This form is the shaped
// kernel's step (vfs_step_with, vector_filter_shaped.cuh) on the general
// step's model policies:
// - D, E, both point counts and both rules' kinds (classical, BQ) are
//   template arguments, and
//   so are the models: the table's pair by its ids (VgsZoo), or a registered
//   configuration's policy generated by ops/vector_filter.py;
// - both rules travel by value in the parameters (VgsParams), in the constant
//   bank, and so do R, the table measurement's constants (in base) and a
//   registered form's constants (dyn_c, obs_c): every thread reads the same
//   address, nothing waits on device memory but the measurements, a
//   registered transition's per-step stream values and the outputs;
// - each point's value and offset are computed once and kept on chip: in
//   registers where the point loops unroll, in the thread's local memory (L1)
//   where they stay loops; no scratch buffer.
//
// Unrolled or not.  The shaped header records the instruction-cache finding
// (vector_filter_shaped.cuh): the coordinated turn and the bearings' atan2
// unrolled to 13,900-15,200 instructions and lost.  Here a policy states the
// cost of one evaluation of each model, its transcendental calls and
// divisions (dyn_cost, obs_cost), and a transform's point loops stay loops
// where cost x N passes VGS_UNROLL_BUDGET (vgs_roll, on each transform's own
// count): the coordinated turn
// (4 x 10-11), reentry (5 x 10-11) and 3 or 4 bearings at 10-11 points stay
// loops; the radar (2 x 11) and 1-2 bearings unroll, as the shaped kernel's
// radar does.  A build may set the budget (tools/lane_variants.py times the
// variants).
#pragma once

#include "vector_filter_general.cuh"
#include "vector_filter_shaped.cuh"

// Largest number of a registered form's constants the parameters hold by
// value; a form with more keeps the general one-thread form.
#define VGS_MAX_C 32

// cost x N above which a transform's point loops stay loops (vgs_roll).
#ifndef VGS_UNROLL_BUDGET
#define VGS_UNROLL_BUDGET 24
#endif

// The parameters of the shaped one-thread form, by value: the vector
// kernels' (models, initial moments, G Q G^T, R rows VF_MAX_DIM apart, a
// table measurement's constants and state components; of its rule fields
// only the kinds and point counts, which the launchers check), both rules of
// either kind (VfsBqRule), and a registered transition's and measurement's
// constants.  6,480 bytes.
struct VgsParams {
  VfParams base;
  VfsBqRule dyn;
  VfsBqRule obs;
  double dyn_c[VGS_MAX_C];
  double obs_c[VGS_MAX_C];
};
static_assert(sizeof(VgsParams) == 6480, "the layout the ctypes mirror (ops/vector_filter.py) expects");
static_assert(sizeof(VgsParams) + 128 <= 32764,
              "a kernel's parameters take at most 32,764 bytes (CUDA 12.1 and later)");

// Whether a transform of N points through a model of this cost keeps its
// point loops as loops.
VF_HD constexpr bool vgs_roll(int cost, int N) { return cost * N > VGS_UNROLL_BUDGET; }

// The transcendental calls and divisions of one evaluation of a table model.
VF_HD constexpr int vgs_dyn_cost(int dyn) {
  return dyn == VF_DYN_REENTRY ? 5 : dyn == VF_DYN_CT ? 4 : dyn == VF_DYN_CV ? 0 : 1;
}
VF_HD constexpr int vgs_obs_cost(int obs, int E) {
  return obs == VF_OBS_RADAR ? 2 : obs == VF_OBS_BEARING ? E : obs == VF_OBS_UNGM ? 0 : 1;
}

// The table measurement OBS of E outputs, its constants and state components
// by value in the parameters' base.
template <int D, int OBS, int E>
struct VgsObsFn {
  const VfParams& p;
  template <class H>
  VF_HD void operator()(const double (&x)[D], H&& h) const {
    if constexpr (OBS == VF_OBS_BEARING) {
      vf_bearings<E>(p.obs_c, p.obs_idx, x, E, h);
    } else {
      static_assert(VfObs<OBS>::E == E, "model dimensions");
      VfObs<OBS>::template eval<D>(p.obs_c, p.obs_idx, x, h);
    }
  }
};

// Whether a model of this cost is costly in the slot form
// (vector_filter_slots.cuh): whether its point loops stay loops at the
// shaped forms' largest count, VFS_MAX_PTS; the table's reentry, coordinated
// turn and 3 or more bearings are, the radar is not, as vfs_rolled has them.
VF_HD constexpr bool vgs_rolled(int cost) { return vgs_roll(cost, VFS_MAX_PTS); }

// The model policy of a pair of the table's models: the functors on the
// parameters' base (VgsParams, or a lane's view of the slot form's), the
// cost of an evaluation of each, and whether each is costly in the slot
// form.
template <int D, int E, int DYN, int OBS>
struct VgsZoo {
  static_assert(VfDyn<DYN>::D == D, "model dimensions");
  static constexpr int dyn_cost = vgs_dyn_cost(DYN), obs_cost = vgs_obs_cost(OBS, E);
  static constexpr bool dyn_rolled = vgs_rolled(dyn_cost), obs_rolled = vgs_rolled(obs_cost);
  template <class Params>
  VF_HD static VfDynFn<D, DYN> dyn(const Params& p, const double*) {
    return {p.base};
  }
  template <class Params>
  VF_HD static VgsObsFn<D, OBS, E> obs(const Params& p) {
    return {p.base};
  }
};

// A whole record of one trajectory in this form (vfs_record_as's layouts),
// the models of Model, ND and NO points on the dynamics and measurement
// rules, each transform's loops rolled as vgs_roll says of its own count.
template <int D, int E, int ND, int NO, int KD, int KO, class Model>
VF_HD void vgs_record(const VgsParams& p, const double* y, long long y_e, long long y_k, int T,
                      const double* s, int n_s, double* m_fi, double* P_fi, double* m_pr,
                      double* P_pr, double* xx, long long cs) {
  static_assert(D >= 2 && D <= VFS_MAX_DIM && E >= 1 && E <= 4, "the form's shapes");
  static_assert(vfs_counts_ok(D, ND, NO), "the UT and CKF point counts, or the Gauss-Hermite one");
  static_assert(ND != NO || ND != vfs_gh_count(D) || (KD == 0 && KO == 0),
                "classical rules at the Gauss-Hermite count");
  vfs_record_as<D, E, ND, NO, KD, KO, vgs_roll(Model::dyn_cost, ND),
                vgs_roll(Model::obs_cost, NO), Model>(p, y, y_e, y_k, T, s, n_s, m_fi, P_fi,
                                                      m_pr, P_pr, xx, cs);
}

// The table's pairs the general kernel runs in this form, (D, E, dynamics,
// measurement): the general kernel's pairs of up to 4 outputs that
// chip_smoke.py drives (phases 15 and 27), each given to X with F.  Every
// other pair keeps the general one-thread form.
#define VGS_PAIRS(X, F)                                                                       \
  X(F, 5, 2, VF_DYN_CT, VF_OBS_RADAR) X(F, 5, 2, VF_DYN_CT, VF_OBS_BEARING)                   \
  X(F, 5, 3, VF_DYN_CT, VF_OBS_BEARING) X(F, 2, 2, VF_DYN_PENDULUM, VF_OBS_RADAR)             \
  X(F, 2, 1, VF_DYN_PENDULUM, VF_OBS_UNGM) X(F, 2, 3, VF_DYN_PENDULUM, VF_OBS_BEARING)        \
  X(F, 3, 1, VF_DYN_REENTRY1D, VF_OBS_PENDULUM_SIN) X(F, 3, 4, VF_DYN_REENTRY1D, VF_OBS_BEARING) \
  X(F, 4, 2, VF_DYN_CV, VF_OBS_BEARING) X(F, 4, 3, VF_DYN_CV, VF_OBS_BEARING)                 \
  X(F, 5, 1, VF_DYN_REENTRY, VF_OBS_RANGE) X(F, 5, 1, VF_DYN_REENTRY, VF_OBS_UNGM)

// The instantiations of the general kernel's shaped form, F(D, E, DYN, OBS,
// ND, NO), under classical rules: one point count on both transforms, the
// UT's or the CKF's, in vector_filter_general_shaped.cu (VGS_SHAPES, 24); the
// two counts mixed, the UKF beside the CKF either way round, in
// vector_filter_general_shaped_mixed.cu (VGS_MIXED, 24); the Gauss-Hermite
// count of the pairs of 2-D and 3-D states (vfs_gh_count: 9 and 8 points) in
// vector_filter_general_shaped_gh.cu (VGS_GH, 5).  Each a source of its own
// so that the library's sources still build in about the same time at once.
// GPQ, BSQ and mixed kinds of the table's pairs keep the general one-thread
// form; a registered configuration is instantiated with the kinds it has.
#define VGS_SHAPES(F) VGS_PAIRS(VFS_SHAPES_OF, F)
#define VGS_MIXED(F) VGS_PAIRS(VFS_MIXED_OF, F)
#define VGS_GH(F)                                                                     \
  F(2, 2, VF_DYN_PENDULUM, VF_OBS_RADAR, 9, 9) F(2, 1, VF_DYN_PENDULUM, VF_OBS_UNGM, 9, 9) \
  F(2, 3, VF_DYN_PENDULUM, VF_OBS_BEARING, 9, 9)                                       \
  F(3, 1, VF_DYN_REENTRY1D, VF_OBS_PENDULUM_SIN, 8, 8)                                  \
  F(3, 4, VF_DYN_REENTRY1D, VF_OBS_BEARING, 8, 8)

// Whether the general kernel's shaped form has an instantiation of q: a pair
// of VGS_PAIRS at its D and E, both rules classical with 2 D + 1 or 2 D points
// each, or with the Gauss-Hermite count of VGS_GH on both.
inline bool vgs_takes(const VfParams& q) {
  if (q.dyn.kind != 0 || q.obs.kind != 0) return false;
  bool found = false;
#define VGS_TAKES_IF(D, E, DYN, OBS, ND, NO)                                            \
  found = found || (q.dyn_model == DYN && q.obs_model == OBS && q.dim_state == D &&     \
                    q.dim_out == E && q.dyn.n == ND && q.obs.n == NO);
  VGS_SHAPES(VGS_TAKES_IF)
  VGS_MIXED(VGS_TAKES_IF)
  VGS_GH(VGS_TAKES_IF)
#undef VGS_TAKES_IF
  return found;
}

#ifdef __CUDACC__
// Threads a block: 32, one warp.  10,000 trajectories are then 313 blocks,
// 2 or 3 warps an SM, where 64 threads a block left 25 SMs 4 warps and the
// rest 2: 1-3% faster on the 5-D lanes, level on the 2-D ones (raw launches
// in turns, PERF.md section 6).  A build may set VGS_THREADS
// (tools/lane_variants.py times 64 and 128).
#ifndef VGS_THREADS
#define VGS_THREADS 32
#endif
constexpr int kVgsThreads = VGS_THREADS;

// The shaped one-thread kernel: one thread a trajectory, the models of Model.
template <int D, int E, int ND, int NO, int KD, int KO, class Model>
__global__ void __launch_bounds__(kVgsThreads)
vector_filter_general_shaped_kernel(const __grid_constant__ VgsParams p,
                                    const double* __restrict__ y, long long y_b, long long y_e,
                                    long long y_k, const double* __restrict__ s, int n_s, int B,
                                    int n_steps, const VfgStreams out) {
  const long long b = static_cast<long long>(blockIdx.x) * kVgsThreads + threadIdx.x;
  if (b >= B) return;
  vgs_record<D, E, ND, NO, KD, KO, Model>(p, y + b * y_b, y_e, y_k, n_steps, s, n_s,
                                          out.m_fi + b, out.P_fi + b, out.m_pr + b,
                                          out.P_pr + b, out.xx + b, B);
}

// Launch the instantiation (D, E, ND, NO, KD, KO, Model) on `stream` without
// synchronising; cudaGetLastError() after the launch.
template <int D, int E, int ND, int NO, int KD, int KO, class Model>
int vgs_launch_as(const VgsParams& p, const double* y, long long y_b, long long y_e,
                  long long y_k, const double* s, int n_s, int B, int n_steps,
                  const VfgStreams& out, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(B) + kVgsThreads - 1) /
                                                kVgsThreads);
  vector_filter_general_shaped_kernel<D, E, ND, NO, KD, KO, Model>
      <<<blocks, kVgsThreads, 0, stream>>>(p, y, y_b, y_e, y_k, s, n_s, B, n_steps, out);
  return static_cast<int>(cudaGetLastError());
}

// Within a launcher (p, q = p.base, y, its strides, B, n_steps, out and
// stream in scope): launch the table pair's instantiation F(D, E, DYN, OBS,
// ND, NO) if it is q's, and return what vgs_launch_as returns.
#define VGS_LAUNCH_IF(D, E, DYN, OBS, ND, NO)                                                \
  if (q.dyn_model == DYN && q.obs_model == OBS && q.dim_state == D && q.dim_out == E &&      \
      q.dyn.n == ND && q.obs.n == NO)                                                        \
    return vgs_launch_as<D, E, ND, NO, 0, 0, VgsZoo<D, E, DYN, OBS>>(p, y, y_b, y_e, y_k,    \
                                                                     nullptr, 0, B, n_steps, \
                                                                     out, stream);

// The launcher of the table pairs' mixed point counts
// (vector_filter_general_shaped_mixed.cu), which vgs_launch calls once it
// has selected the device: what vgs_launch_as returns, cudaErrorInvalidValue
// if no instantiation of VGS_MIXED takes the configuration.
int vgs_launch_mixed(const VgsParams& p, const double* y, long long y_b, long long y_e,
                     long long y_k, int B, int n_steps, const VfgStreams& out,
                     cudaStream_t stream);

// The launcher of the table pairs' Gauss-Hermite counts
// (vector_filter_general_shaped_gh.cu), which vgs_launch calls for a count
// other than 2 D + 1 and 2 D: what vgs_launch_as returns,
// cudaErrorInvalidValue if no instantiation of VGS_GH takes the
// configuration.
int vgs_launch_gh(const VgsParams& p, const double* y, long long y_b, long long y_e,
                  long long y_k, int B, int n_steps, const VfgStreams& out, cudaStream_t stream);
#endif
