// The slot kernel of the vector filter (vector_filter_slots.cu): Gauss-Hermite
// rules of 16-81 points on both transforms, a trajectory on G lanes of a warp
// (G a template argument: 1, 2, 4 or 8), in native float64: the five model
// pairs of VFS_PAIRS (VSL_SHAPES), the general kernel's pairs of VGS_PAIRS
// (VSL_GENERAL, vector_filter_general_slots.cuh) and the registered kernel's
// slot form (VFR_SLOTS, vector_filter_registered.cu).
//
// Shared by the CUDA kernels and host shims (vector_filter_slots_host.cpp,
// vector_filter_general_slots_host.cpp), which g++ builds with the lanes
// collapsed to one (vsl_from_lane returns the lane's own value), so that the
// CPU tests hold this exact arithmetic against the plain PyTorch version in
// ssmtoybox_torch/ops/vector_filter.py; the card holds the lanes' gather
// (chip_smoke.py, phase 15).
//
// The step is the shaped kernels' (vfs_step_with, vector_filter_shaped.cuh):
// D, E, N, the models and both rules' kinds template arguments, the models
// from a policy (vsl_record's Model: VfsZoo for the five pairs, VgsZoo for
// the general kernel's, a generated policy for a registered configuration).
// Only the moments of a transform differ (vsl_moments, through
// vfs_transform's overload for a lane's view of a rule):
// - lane l of a trajectory's G evaluates points l, l + G, l + 2 G, ... whole
//   (x_j = m + L xi_j, f(x_j)) and keeps their values on chip (registers where
//   its point loops unroll, the thread's local memory where they stay loops);
// - every lane repeats the Cholesky factors, the gain and the update, so that
//   no lane waits on another there;
// - for each sum, point j's values (or centred values) reach every lane by a
//   shuffle from lane j mod G; the mean's sums run on every lane, in the
//   plain version's order, from 0.0 upwards; the covariance and
//   cross-covariance sums either run on every lane too or are split by output
//   row (lane l the rows l, l + G, ..., each row over every point in the
//   plain version's order, then gathered by shuffle), and the offsets L xi_j
//   of the cross-covariance either come by shuffle from the lane that made
//   them or are made again, the same operations in the same order, so that
//   all lanes hold the same bits; each table shape's design is the one that
//   won on the card (VSL_SHAPES, VSL_GENERAL), a registered configuration's
//   the one vsr_design names from them;
// - the rules travel by value in the parameters (VslParams, 10,976 bytes, in
//   the constant bank; a registered configuration's VsrParams, 11,488 bytes,
//   also hold its forms' constants): the sums read them at an index the whole
//   warp shares;
// - nothing goes through device memory but the measurements, a registered
//   transition's per-step stream values and the five output streams.  The
//   lanes of a trajectory store the same values to the same addresses; a
//   group of lanes past the last trajectory returns at once, and the
//   shuffles name only the live lanes of the warp.
#pragma once

#include "vector_filter_shaped.cuh"

// Largest state and point count of the slot kernel's rules: the five pairs'
// states (up to 5-D) and GH-3 on the 4-D constant-velocity model (81).
#define VSL_MAX_DIM 5
#define VSL_MAX_PTS 81

// A classical rule by value: unit points (dim_in, n), rows VSL_MAX_PTS apart,
// mean and diagonal covariance weights.  4,536 bytes.
struct VslRule {
  double xi[VSL_MAX_DIM * VSL_MAX_PTS];
  double wm[VSL_MAX_PTS];
  double wc[VSL_MAX_PTS];
};

// The kernel's parameters: the first version's (models, initial moments,
// G Q G^T, R; of its rule fields only the kinds and point counts, which the
// launcher checks) and both rules by value.  10,976 bytes: past the 4 KB of
// CUDA before 12.1, within the 32,764 bytes that sm_70 and later take from
// CUDA 12.1 on.
struct VslParams {
  VfParams base;
  VslRule dyn;
  VslRule obs;
};
static_assert(sizeof(VslRule) == 4536 && sizeof(VslParams) == 10976,
              "the layout the ctypes mirror (ops/vector_filter.py) expects");
static_assert(sizeof(VslParams) + 128 <= 32764,
              "a kernel's parameters take at most 32,764 bytes (CUDA 12.1 and later)");

// A design of the slot kernel: G lanes a trajectory (1, 2, 4 or 8); whether
// the lanes split the covariance and cross-covariance sums by output row
// (split: lane l accumulates rows l, l + G, ... over every point, each row
// gathered by shuffle at the end) or every lane runs every sum; whether a
// lane keeps its points' offsets L xi_j beside their values for the other
// lanes to take by shuffle (keep) or every lane makes each point's offset
// again for the cross-covariance.  A build may set VSL_LANES, VSL_SPLIT or
// VSL_KEEP_OFFSETS for every shape (tools/lane_variants.py).
template <int G_, bool SPLIT, bool KEEP>
struct VslDesign {
  static_assert(G_ == 1 || G_ == 2 || G_ == 4 || G_ == 8, "lanes divide a warp");
  static constexpr int G = G_;
  static constexpr bool split = SPLIT && G_ > 1, keep = KEEP;
};
#ifdef VSL_LANES
#define VSL_G(g) VSL_LANES
#else
#define VSL_G(g) g
#endif
#ifdef VSL_SPLIT
#define VSL_S(split) VSL_SPLIT
#else
#define VSL_S(split) split
#endif
#ifdef VSL_KEEP_OFFSETS
#define VSL_K(keep) VSL_KEEP_OFFSETS
#else
#define VSL_K(keep) keep
#endif
// The design a shape of VSL_SHAPES names, as this build takes it.
#define VSL_DESIGN(G, SPLIT, KEEP) VslDesign<VSL_G(G), VSL_S(SPLIT), VSL_K(KEEP)>

// Whether the point loops of a transform of N points stay loops: above 16
// points (at 16 rolled and unrolled loops ran alike on constant velocity
// with the radar), or through a model whose loops stay loops in the shaped
// kernel already (reentry, the coordinated turn, the bearings).
VF_HD constexpr bool vsl_roll(bool costly, int N) { return costly || N > 16; }

// v of lane src of the G lanes of this thread's trajectory (G consecutive
// lanes of a warp; `mask` the live lanes of the warp, every one calling).
template <int G>
VF_HD double vsl_from_lane(double v, int src, unsigned mask) {
  if constexpr (G == 1) {
    return v;
  } else {
#ifdef __CUDA_ARCH__
    const int lo = __shfl_sync(mask, __double2loint(v), src, G);
    const int hi = __shfl_sync(mask, __double2hiint(v), src, G);
    return __hiloint2double(hi, lo);
#else
    (void)src;
    (void)mask;
    return v;  // the host build has one lane
#endif
  }
}

// One lane's view of a rule in the design Design: the rule, the lane (0 ..
// G - 1) and the live lanes of the warp.
template <class Design>
struct VslView {
  const VslRule& R;
  int lane;
  unsigned mask;
};

// Lane `lane`'s view of the parameters, what vfs_step_with and a model
// policy take: base, the two rules' views and a registered configuration's
// constants of its transition and measurement forms (VsrParams'; nullptr in
// a table pair's VslParams, whose models read base).
template <class Design>
struct VslLaneParams {
  const VfParams& base;
  VslView<Design> dyn;
  VslView<Design> obs;
  const double* dyn_c;
  const double* obs_c;
};

// Lane `lane`'s view of a table pair's parameters (VslParams); the view of
// a registered configuration's (VsrParams) is vector_filter_general_slots.cuh's.
template <class Design>
VF_HD VslLaneParams<Design> vsl_view(const VslParams& p, int lane, unsigned mask) {
  return {p.base, {p.dyn, lane, mask}, {p.obs, lane, mask}, nullptr, nullptr};
}

// dx = L xi_j, point j's offset from the mean, vfs_moments' sum.
template <int D>
VF_HD void vsl_offset(const VslRule& R, const double (&L)[D][D], int j, double (&dx)[D]) {
#pragma unroll
  for (int a = 0; a < D; ++a) {
    double acc = 0.0;
#pragma unroll
    for (int c = 0; c <= a; ++c) acc = acc + L[a][c] * R.xi[c * VSL_MAX_PTS + j];
    dx[a] = acc;
  }
}

// The covariance and cross-covariance sums of vsl_moments split by output
// row: lane l accumulates rows a = k G + l (k < ceil(EO / G)) of cov (the
// whole row: d_a d_b and d_b d_a are the same bits) and of cross over every
// point, in the plain version's order; then row a reaches every lane from
// lane a mod G, its lower triangle and cross row.  v: this lane's points'
// values (and offsets, if the design keeps them), K doubles each.
template <int D, int EO, int N, class Design, bool ROLL, int S, int K>
VF_HD void vsl_split_sums(const VslView<Design>& V, const double (&L)[D][D],
                          const double (&mu)[EO], const double (&v)[S][K],
                          double (&cov)[EO][EO], double (&cross)[EO][D]) {
  constexpr int G = Design::G;
  constexpr int RK = (EO + G - 1) / G;  // rows a lane
  [[maybe_unused]] constexpr int U = ROLL ? 1 : S;
  const VslRule& R = V.R;
  double rc[RK][EO], rx[RK][D];
#pragma unroll
  for (int k = 0; k < RK; ++k) {
#pragma unroll
    for (int b = 0; b < EO; ++b) rc[k][b] = 0.0;
#pragma unroll
    for (int c = 0; c < D; ++c) rx[k][c] = 0.0;
  }
  VFS_PRAGMA(unroll (U))
  for (int i = 0; i < S; ++i) {
    double own[EO];
#pragma unroll
    for (int e = 0; e < EO; ++e) own[e] = v[i][e] - mu[e];
#pragma unroll
    for (int r = 0; r < G; ++r) {
      const int j = i * G + r;
      if (N % G != 0 && j >= N) break;
      double d[EO], dx[D];
#pragma unroll
      for (int e = 0; e < EO; ++e) d[e] = vsl_from_lane<G>(own[e], r, V.mask);
      if constexpr (K > EO) {
#pragma unroll
        for (int c = 0; c < D; ++c) dx[c] = vsl_from_lane<G>(v[i][EO + c], r, V.mask);
      } else {
        vsl_offset<D>(R, L, j, dx);
      }
      const double w = R.wc[j];
#pragma unroll
      for (int k = 0; k < RK; ++k) {
        const double da = vf_pick(d, k * G + V.lane);
#pragma unroll
        for (int b = 0; b < EO; ++b) rc[k][b] = rc[k][b] + w * (da * d[b]);
#pragma unroll
        for (int c = 0; c < D; ++c) rx[k][c] = rx[k][c] + w * (da * dx[c]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < EO; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) cov[a][b] = vsl_from_lane<G>(rc[a / G][b], a % G, V.mask);
#pragma unroll
    for (int c = 0; c < D; ++c) cross[a][c] = vsl_from_lane<G>(rx[a / G][c], a % G, V.mask);
  }
#pragma unroll
  for (int a = 0; a < EO; ++a) {
#pragma unroll
    for (int b = a + 1; b < EO; ++b) cov[a][b] = cov[b][a];
  }
}

// Moments of f over the classical rule of V at the Gaussian (m, L L^T), on
// lane V.lane of the design's G: mean mu, covariance cov (full, mirrored
// from the lower triangle) and cross-covariance cross[e][d], the same on
// every lane and equal to vfs_moments' bits.  ROLL: the loops over a lane's
// points stay loops (its values then in local memory).
template <int D, int EO, int N, class Design, bool ROLL, class F>
VF_HD void vsl_moments(const VslView<Design>& V, const double (&m)[D], const double (&L)[D][D],
                       const F& f, double (&mu)[EO], double (&cov)[EO][EO],
                       double (&cross)[EO][D]) {
  static_assert(N <= VSL_MAX_PTS && D <= VSL_MAX_DIM, "a VslRule's shape");
  constexpr int G = Design::G;
  constexpr int S = (N + G - 1) / G;  // points a lane: lane, lane + G, ...
  [[maybe_unused]] constexpr int U = ROLL ? 1 : S;
  const VslRule& R = V.R;
  constexpr int K = Design::keep ? EO + D : EO;
  double v[S][K];  // this lane's points: their values (and offsets)
  VFS_PRAGMA(unroll (U))
  for (int i = 0; i < S; ++i) {
    // a lane without an i-th point (N not a multiple of G) takes the last
    // point again: no sum reads it
    const int j = i * G + V.lane < N ? i * G + V.lane : N - 1;
    double x[D], fx[EO];
    vsl_offset<D>(R, L, j, x);
#pragma unroll
    for (int a = 0; a < D; ++a) {
      if constexpr (Design::keep) v[i][EO + a] = x[a];
      x[a] = m[a] + x[a];
    }
    f(x, fx);
#pragma unroll
    for (int e = 0; e < EO; ++e) v[i][e] = fx[e];
  }
#pragma unroll
  for (int e = 0; e < EO; ++e) mu[e] = 0.0;
  VFS_PRAGMA(unroll (U))
  for (int i = 0; i < S; ++i) {
#pragma unroll
    for (int r = 0; r < G; ++r) {
      const int j = i * G + r;  // the same on every lane
      if (N % G != 0 && j >= N) break;
      const double w = R.wm[j];
#pragma unroll
      for (int e = 0; e < EO; ++e) mu[e] = mu[e] + w * vsl_from_lane<G>(v[i][e], r, V.mask);
    }
  }
  if constexpr (Design::split) {
    vsl_split_sums<D, EO, N, Design, ROLL>(V, L, mu, v, cov, cross);
    return;
  }
#pragma unroll
  for (int a = 0; a < EO; ++a) {
#pragma unroll
    for (int b = 0; b < EO; ++b) cov[a][b] = 0.0;
#pragma unroll
    for (int c = 0; c < D; ++c) cross[a][c] = 0.0;
  }
  VFS_PRAGMA(unroll (U))
  for (int i = 0; i < S; ++i) {
    double own[EO];  // this lane's i-th point, centred
#pragma unroll
    for (int e = 0; e < EO; ++e) own[e] = v[i][e] - mu[e];
#pragma unroll
    for (int r = 0; r < G; ++r) {
      const int j = i * G + r;
      if (N % G != 0 && j >= N) break;
      double d[EO], dx[D];
#pragma unroll
      for (int e = 0; e < EO; ++e) d[e] = vsl_from_lane<G>(own[e], r, V.mask);
      if constexpr (Design::keep) {
#pragma unroll
        for (int c = 0; c < D; ++c) dx[c] = vsl_from_lane<G>(v[i][EO + c], r, V.mask);
      } else {
        vsl_offset<D>(R, L, j, dx);
      }
      const double w = R.wc[j];
#pragma unroll
      for (int a = 0; a < EO; ++a) {
#pragma unroll
        for (int b = 0; b <= a; ++b) cov[a][b] = cov[a][b] + w * (d[a] * d[b]);
#pragma unroll
        for (int c = 0; c < D; ++c) cross[a][c] = cross[a][c] + w * (d[a] * dx[c]);
      }
    }
  }
#pragma unroll
  for (int a = 0; a < EO; ++a) {
#pragma unroll
    for (int b = a + 1; b < EO; ++b) cov[a][b] = cov[b][a];
  }
}

// The moments of a transform through a lane's view of its rule: what
// vfs_step_with calls (vfs_transform's overloads, vector_filter_shaped.cuh).
template <int KIND, int D, int EO, int N, bool ROLL, class F, class Design>
VF_HD void vfs_transform(const VslView<Design>& V, const double (&m)[D],
                         const double (&L)[D][D], const F& f, double (&mu)[EO],
                         double (&cov)[EO][EO], double (&cross)[EO][D]) {
  static_assert(KIND == 0, "the slot kernel takes classical rules");
  vsl_moments<D, EO, N, Design, ROLL>(V, m, L, f, mu, cov, cross);
}

// A whole record of one trajectory on lane `lane` of the design's G
// (vfs_record_as's layouts): the models of the policy Model (which states
// whether each model is costly: dyn_rolled, obs_rolled), N points on both
// classical rules, each transform's loops rolled as vsl_roll says; a
// registered transition's n_s stream values of step k at s[k * n_s].
// Params: VslParams, or VsrParams (vector_filter_general_slots.cuh).
template <int D, int E, int N, class Design, class Model, class Params>
VF_HD void vsl_record(const Params& p, int lane, unsigned mask, const double* y, long long y_e,
                      long long y_k, int T, const double* s, int n_s, double* m_fi, double* P_fi,
                      double* m_pr, double* P_pr, double* xx, long long cs) {
  const VslLaneParams<Design> q = vsl_view<Design>(p, lane, mask);
  vfs_record_as<D, E, N, N, 0, 0, vsl_roll(Model::dyn_rolled, N), vsl_roll(Model::obs_rolled, N),
                Model>(q, y, y_e, y_k, T, s, n_s, m_fi, P_fi, m_pr, P_pr, xx, cs);
}

// The slot kernel's shapes, F(D, E, DYN, OBS, N, G, SPLIT, KEEP): the
// Gauss-Hermite counts of 12-242 points of the five pairs of VFS_PAIRS that
// the card showed faster here than in the first version, each in the design
// that won its turns against the others (NVIDIA H100 80GB HBM3 at 700 W, raw
// launches at 10,000 x 100, tools/lane_variants.py --slots; PERF.md, section
// 6): reentry + radar under GH-2 (32 points) on 4 lanes, the sums split and
// the offsets kept (3.16 ms; 3.94 on 2 lanes repeating the sums, 5.50 in the
// first version); CT + 4 bearings under GH-2 (32) on 2 lanes repeating the
// sums (5.72; 6.27 split on 4, 7.77 first); constant velocity + radar under
// GH-2 (16) on 4 lanes, split, offsets kept (1.13; 1.30 repeated, 1.77
// first) and GH-3 (81) on 4 lanes, split, the offsets made again (5.65;
// 7.17 with them kept, 7.37 repeated, 10.07 first); the falling body + range
// under GH-3 (27) on 4 lanes, split, offsets kept (1.16; 1.48 repeated on 2,
// 1.67 first).
#define VSL_SHAPES(F)                                          \
  F(5, 2, VF_DYN_REENTRY, VF_OBS_RADAR, 32, 4, true, true)     \
  F(5, 4, VF_DYN_CT, VF_OBS_BEARING, 32, 2, false, false)      \
  F(4, 2, VF_DYN_CV, VF_OBS_RADAR, 16, 4, true, true)          \
  F(4, 2, VF_DYN_CV, VF_OBS_RADAR, 81, 4, true, false)         \
  F(3, 1, VF_DYN_REENTRY1D, VF_OBS_RANGE, 27, 4, true, true)

// The general kernel's shapes in the slot kernel, F(D, E, DYN, OBS, N, G,
// SPLIT, KEEP) (vector_filter_general_slots.cu): the pairs of VGS_PAIRS
// (vector_filter_general_shaped.cuh) under classical Gauss-Hermite rules of
// 12-81 points on both transforms, the 2-D and 3-D states' (VSL_GENERAL_LO)
// and the 4-D and 5-D states' (VSL_GENERAL_HI), each list a source of its
// own: GH-4 on the 2-D pairs (16 points), GH-3 and GH-4 on the 3-D ones (27,
// 64), GH-2 and GH-3 on the 4-D ones (16, 81), GH-2 on the 5-D ones (32).
// GH-3 on the 5-D pairs (243 points) runs in the general kernel's warp form.
// Each in the design that won its turns against the 13 others and the
// general one-thread form it left (NVIDIA H100 80GB HBM3 at 700 W, raw
// launches at 10,000 x 100, tools/lane_variants.py --slots; PERF.md, section
// 6): 4 lanes, the sums split by row and the offsets kept, on 12 of them
// (pendulum + radar GH-4 0.594 ms, 0.646 with the offsets made again, 1.506
// one thread; CT + radar GH-2 3.171, 3.612, 5.758; CT + 2 and 3 bearings GH-2
// 3.418 and 4.108, 3.809 and 4.443, 6.573 and 8.985, where CT + 4 bearings
// runs on 2 lanes repeating the sums); 2 lanes, split, kept on the pendulum +
// UNGM GH-4 (0.365; 0.375 on 4, 1.008 one thread); 4 lanes, split, the
// offsets made again at 64 and 81 points with bearings (falling body + 4
// bearings GH-4 5.156, 5.527 kept, 14.247 one thread; CV + 2 and 3 bearings
// GH-3 6.060 and 6.992, 7.574 and 8.786 kept, 15.352 and 17.259 one thread).
#define VSL_GENERAL_LO(F)                                                \
  F(2, 2, VF_DYN_PENDULUM, VF_OBS_RADAR, 16, 4, true, true)              \
  F(2, 1, VF_DYN_PENDULUM, VF_OBS_UNGM, 16, 2, true, true)               \
  F(2, 3, VF_DYN_PENDULUM, VF_OBS_BEARING, 16, 4, true, true)            \
  F(3, 1, VF_DYN_REENTRY1D, VF_OBS_PENDULUM_SIN, 27, 4, true, true)      \
  F(3, 4, VF_DYN_REENTRY1D, VF_OBS_BEARING, 27, 4, true, true)           \
  F(3, 1, VF_DYN_REENTRY1D, VF_OBS_PENDULUM_SIN, 64, 4, true, true)      \
  F(3, 4, VF_DYN_REENTRY1D, VF_OBS_BEARING, 64, 4, true, false)

#define VSL_GENERAL_HI(F)                                                \
  F(4, 2, VF_DYN_CV, VF_OBS_BEARING, 16, 4, true, true)                  \
  F(4, 3, VF_DYN_CV, VF_OBS_BEARING, 16, 4, true, true)                  \
  F(4, 2, VF_DYN_CV, VF_OBS_BEARING, 81, 4, true, false)                 \
  F(4, 3, VF_DYN_CV, VF_OBS_BEARING, 81, 4, true, false)                 \
  F(5, 2, VF_DYN_CT, VF_OBS_RADAR, 32, 4, true, true)                    \
  F(5, 2, VF_DYN_CT, VF_OBS_BEARING, 32, 4, true, true)                  \
  F(5, 3, VF_DYN_CT, VF_OBS_BEARING, 32, 4, true, true)                  \
  F(5, 1, VF_DYN_REENTRY, VF_OBS_RANGE, 32, 4, true, true)               \
  F(5, 1, VF_DYN_REENTRY, VF_OBS_UNGM, 32, 4, true, true)

#define VSL_GENERAL(F) VSL_GENERAL_LO(F) VSL_GENERAL_HI(F)

// The lanes of q's instantiation in VSL_SHAPES or VSL_GENERAL (both rules
// classical, N on both) in this build, 0 if none takes it.
inline int vsl_lanes_of(const VfParams& q) {
  if (q.dyn.kind != 0 || q.obs.kind != 0 || q.dyn.n != q.obs.n) return 0;
  int lanes = 0;
#define VSL_LANES_IF(D, E, DYN, OBS, N, LANES, SPLIT, KEEP)                             \
  if (q.dyn_model == DYN && q.obs_model == OBS && q.dim_state == D && q.dim_out == E && \
      q.dyn.n == N)                                                                     \
    lanes = VSL_G(LANES);
  VSL_SHAPES(VSL_LANES_IF)
  VSL_GENERAL(VSL_LANES_IF)
#undef VSL_LANES_IF
  return lanes;
}

// A design of the slot kernel by value: G lanes (0: none), split, keep.
struct VslDesignOf {
  int G;
  bool split, keep;
};

// The design of a registered configuration's slot form (VFR_SLOTS,
// vector_filter_registered.cu), which cannot be timed model by model: the
// design of the table's shape (VSL_SHAPES, VSL_GENERAL) of the same state
// dimension D and point count N whose output count is nearest E, the first
// listed among equals; G = 0 where no table shape has that D and N, and the
// configuration keeps the one-thread form.  The table shapes' designs are
// the card's (tools/lane_variants.py --slots, PERF.md section 6).
inline VslDesignOf vsr_design(int D, int E, int N) {
  VslDesignOf best = {0, false, false};
  int dist = 1 << 30;
#define VSR_NEAREST(D_, E_, DYN, OBS, N_, LANES, SPLIT, KEEP)  \
  if (D_ == D && N_ == N && (E_ - E) * (E_ - E) < dist) {    \
    dist = (E_ - E) * (E_ - E);                              \
    best = {LANES, SPLIT, KEEP};                             \
  }
  VSL_SHAPES(VSR_NEAREST)
  VSL_GENERAL(VSR_NEAREST)
#undef VSR_NEAREST
  return best;
}

#ifdef __CUDACC__
// The launchers of the general kernel's pairs in the slot kernel, which
// vsl_launch (vector_filter_slots.cu) calls once it has selected the device
// for a configuration outside VSL_SHAPES: vsl_launch_general
// (vector_filter_general_slots.cu) launches the instantiations of
// VSL_GENERAL_LO and passes any other configuration to vsl_launch_general_hi
// (vector_filter_general_slots_hi.cu), VSL_GENERAL_HI's; the layouts of
// vsl_launch; cudaGetLastError() after the launch, cudaErrorInvalidValue if
// no instantiation takes the configuration.
int vsl_launch_general(const VslParams& p, const double* y, long long y_b, long long y_e,
                       long long y_k, int B, int n_steps, double* m_fi, double* P_fi,
                       double* m_pr, double* P_pr, double* xx, cudaStream_t stream);
int vsl_launch_general_hi(const VslParams& p, const double* y, long long y_b, long long y_e,
                          long long y_k, int B, int n_steps, double* m_fi, double* P_fi,
                          double* m_pr, double* P_pr, double* xx, cudaStream_t stream);
#endif
