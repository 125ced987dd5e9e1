// The scalar filter step of every 1-D rule and every 1-D measurement, in
// native float64, one thread a trajectory: the general form of the scalar
// filter kernel (scalar_filter.cu, scalar_filter_general_kernel), for what the
// shaped step (scalar_filter_step.cuh) does not take: rules of more than
// SF_MAX_PTS points (Gauss-Hermite of degree 9 and up, GPQ and BSQ on those
// points), the sine and range measurements of a 1-D state, and (the same
// step on other functors, scalar_filter_registered.cu) models registered at
// run time.
//
// Models.  sfg_record takes the transition and measurement from a model
// policy: Model::dyn(p, s) the transition of a step whose per-step stream
// values are s[0 .. n_s), Model::obs(p) the measurement.  SfgZoo is the UNGM
// transition (one stream, its 8 cos(1.2 k)) with the measurement of
// obs_model; a registered model's policy is generated from its C++
// statements (ops/scalar_filter.py, build_registered).
//
// Shared by the CUDA kernel and the host shim (scalar_filter_host.cpp), so
// that the CPU tests hold this exact code against the plain PyTorch version in
// ssmtoybox_torch/ops/scalar_filter.py (_scalar_filter_plain).
//
// The rule's point count n, both kinds and the measurement are read at run
// time; they are the same in every thread of a launch, so their branches do
// not diverge.  The rules' constants live in device memory and are read
// through SFG_LDG (the read-only path on the card; the same address in every
// lane of a warp), as the first-version vector filter reads its rules: a BQ
// rule's dense Wc is n^2 doubles, which no by-value struct holds for any n.
// The n function values of a transform go to a scratch buffer, value i of a
// trajectory at scratch[i * ss] (the kernel interleaves the trajectories,
// ss = B), written in the mean pass and read back for the centred classical
// sums or the BQ quadratic form.  Every sum runs in the plain version's order
// (_moments_plain), from 0.0 upwards, so that kernel, host build and plain
// version agree to the bit.
#pragma once

#include "scalar_filter_step.cuh"

#ifdef __CUDA_ARCH__
#define SFG_LDG(p) __ldg(p)
#else
#define SFG_LDG(p) (*(p))
#endif

// Measurement models of a 1-D state (ids shared with ops/scalar_filter.py).
#define SF_OBS_UNGM 0   // UNGMMeasurement: 0.05 x^2
#define SF_OBS_SIN 1    // Pendulum2DMeasurement of a 1-D state: sin(x)
#define SF_OBS_RANGE 2  // RangeMeasurement: sqrt(sx^2 + (x - sy)^2), obs_c = sx^2, sy

// A 1-D quadrature rule, its constants in memory the step reads (device
// memory for the kernel).  kind 0: classical, diagonal covariance weights wc.
// kind 1: BQ, dense weights Wc (n x n, row-major), cross weights wcc and the
// expected model variance emv.
struct SfgRule {
  int kind;
  int n;
  const double* xi;   // (n,) unit sigma points
  const double* wm;   // (n,)
  const double* wc;   // (n,), kind 0
  const double* Wc;   // (n, n), kind 1
  const double* wcc;  // (n,), kind 1
  double emv;         // kind 1
};

// Everything the general form takes besides the data streams: 168 bytes.
struct SfgParams {
  SfgRule dyn;
  SfgRule obs;
  int obs_model;    // SF_OBS_*
  double obs_c[2];  // the measurement's constants (the range's sx^2, sy)
  double m0;        // initial mean
  double P0;        // initial variance
  double gqg;       // G Q G, additive process-noise variance
  double r;         // additive measurement-noise variance
};
static_assert(sizeof(SfgRule) == 56 && sizeof(SfgParams) == 168,
              "SfgRule and SfgParams are mirrored by ctypes in ops/scalar_filter.py");

// The measurement of p, its model read at run time.
struct SfgObs {
  int model;
  double c0, c1;
  SF_HD double operator()(double x) const {
    if (model == SF_OBS_SIN) return sin(x);
    if (model == SF_OBS_RANGE) {
      const double d = x - c1;
      return sqrt(c0 + d * d);
    }
    return sf_ungm_obs(x);
  }
};

// Moments of f at the points m + L xi_i under rule R: mean mu, variance var
// and cross-covariance cross with the input.
template <class F>
SF_HD void sfg_moments(const SfgRule& R, double m_in, double L, const F& f, double* scratch,
                       long long ss, double* mu, double* var, double* cross) {
  const int n = R.n;
  double m = 0.0;
  for (int i = 0; i < n; ++i) {
    const double v = f(m_in + L * SFG_LDG(R.xi + i));
    scratch[i * ss] = v;
    m += SFG_LDG(R.wm + i) * v;
  }
  double v = 0.0, c = 0.0;
  if (R.kind == 0) {
    for (int i = 0; i < n; ++i) {
      const double w = SFG_LDG(R.wc + i);
      const double d = scratch[i * ss] - m;
      v += w * (d * d);
      c += w * ((L * SFG_LDG(R.xi + i)) * d);
    }
  } else {
    double q = 0.0, s = 0.0;
    for (int i = 0; i < n; ++i) {
      double row = 0.0;
      for (int j = 0; j < n; ++j)
        row += SFG_LDG(R.Wc + static_cast<long long>(i) * n + j) * scratch[j * ss];
      const double fi = scratch[i * ss];
      q += fi * row;
      s += SFG_LDG(R.wcc + i) * fi;
    }
    v = q - m * m + R.emv;
    c = s * L;
  }
  *mu = m;
  *var = v;
  *cross = c;
}

// One filter step from the filtered state (m, P) of the previous step, with
// measurement y, the transition f and the measurement h; the function values
// go through scratch (this trajectory's slot 0, slots ss apart).
template <class Dyn, class Obs>
SF_HD SfStep sfg_step_with(const SfgParams& p, double m, double P, double y, const Dyn& f,
                           const Obs& h, double* scratch, long long ss) {
  SfStep s;
  const double L = sqrt(P);
  double Pf;
  sfg_moments(p.dyn, m, L, f, scratch, ss, &s.m_pr, &Pf, &s.xx);
  s.P_pr = Pf + p.gqg;

  const double L2 = sqrt(s.P_pr);
  double y_pr, S0, C;
  sfg_moments(p.obs, s.m_pr, L2, h, scratch, ss, &y_pr, &S0, &C);
  const double S = S0 + p.r;
  const double K = C / S;
  s.m_fi = s.m_pr + K * (y - y_pr);
  s.P_fi = s.P_pr - (K * K) * S;
  return s;
}

// One filter step of the UNGM transition with the dynamics constant c of
// this step and the measurement of p.
SF_HD SfStep sfg_step(const SfgParams& p, double m, double P, double y, double c,
                      double* scratch, long long ss) {
  return sfg_step_with(p, m, P, y, SfgDyn{c}, SfgObs{p.obs_model, p.obs_c[0], p.obs_c[1]},
                       scratch, ss);
}

// The model policy of the kernel's own models: the UNGM transition at its
// step's constant s[0], the measurement of obs_model.
struct SfgZoo {
  SF_HD static SfgDyn dyn(const SfgParams&, const double* s) { return {SFG_LDG(s)}; }
  SF_HD static SfgObs obs(const SfgParams& p) { return {p.obs_model, p.obs_c[0], p.obs_c[1]}; }
};

// The general form's parameters for models registered at run time: the
// rules, noise and initial moments of base (whose obs_model and obs_c are
// read only by a measurement of the kernel's own), and the constants of a
// registered transition and measurement in device memory.  184 bytes.
struct SfrParams {
  SfgParams base;
  const double* dyn_c;
  const double* obs_c;
};
static_assert(sizeof(SfrParams) == 184, "SfrParams is mirrored by ctypes in ops/scalar_filter.py");

// A whole record of one trajectory: n_steps steps from the initial moments
// of q, measurement k at y[k * y_step], the n_s stream values of step k at
// s[k * n_s], the models of Model made from p; output k of this trajectory
// at out_*[k * ss] (time-major, ss = B), its scratch slots ss apart.
template <class Model, class P>
SF_HD void sfg_record(const P& p, const SfgParams& q, const double* y, long long y_step,
                      const double* s, int n_s, int n_steps, double* scratch, long long ss,
                      double* m_fi, double* P_fi, double* m_pr, double* P_pr, double* xx) {
  double m = q.m0, Pv = q.P0;
  for (int k = 0; k < n_steps; ++k) {
    const SfStep st = sfg_step_with(q, m, Pv, y[k * y_step],
                                    Model::dyn(p, s + static_cast<long long>(k) * n_s),
                                    Model::obs(p), scratch, ss);
    const long long o = static_cast<long long>(k) * ss;
    m_pr[o] = st.m_pr;
    P_pr[o] = st.P_pr;
    xx[o] = st.xx;
    m_fi[o] = st.m_fi;
    P_fi[o] = st.P_fi;
    m = st.m_fi;
    Pv = st.P_fi;
  }
}

// Whether the general form's rules can run: kinds 0 or 1, at least one point
// each.
SF_HD bool sfg_rules_ok(const SfgParams& p) {
  return p.dyn.n >= 1 && p.obs.n >= 1 && ((p.dyn.kind | p.obs.kind) >> 1) == 0;
}

// The general parameters of the kernel's own models and of registered ones.
SF_HD const SfgParams& sf_base(const SfgParams& p) { return p; }
SF_HD const SfgParams& sf_base(const SfrParams& p) { return p.base; }

// ---------------------------------------------------------------------------
// The slot design: rules of up to SF_MAX_SLOTS points on compile-time slots
// ---------------------------------------------------------------------------
//
// The general and registered forms run a configuration whose rules have at
// most SF_MAX_SLOTS points on the shaped form's step (SfStepper), with the
// model policy's functors in place of the UNGM models: N = sf_slots(n_dyn,
// n_obs) slots (3, 5, 7, 8, 9, 12, 16, 20, 24 or 32; a shorter rule padded
// with zero weights), G = sfs_lanes(KD, KO, N) lanes a trajectory, each lane
// evaluating the models at its own slots and, for a BQ rule, its own rows of
// Wc f; the values gathered by shuffles, every sum in every lane in the plain
// version's order.  No value goes to device memory between the mean and the
// sums.  The rules' vectors (SfsRules, 2 KB) travel by value, as the shaped
// form's rules do, so that every sum reads its weights from the constant
// bank; a BQ rule's dense Wc (2 KB at 16 points, 8.4 KB at 32) is staged once
// a block from its SfgRule pointer into shared memory (SfSlotWc), where each
// lane reads its own rows, rows an odd number of doubles apart so that the G
// rows the lanes of a trajectory read at once lie in G banks.  Above
// SF_MAX_SLOTS points the one-thread form (sfg_record) runs.

// A rule's vectors for the slot design, zero past its n points.
struct SfsVec {
  double xi[SF_MAX_SLOTS];
  double wm[SF_MAX_SLOTS];
  double wc[SF_MAX_SLOTS];   // kind 0
  double wcc[SF_MAX_SLOTS];  // kind 1
};

// Both rules' vectors, the slot design's by-value parameter: 2,048 bytes.
struct SfsRules {
  SfsVec dyn;
  SfsVec obs;
};
static_assert(sizeof(SfsRules) == 2048, "SfsRules is mirrored by ctypes in ops/scalar_filter.py");

// A BQ rule's dense weights staged for the slot design: rows kStride doubles
// apart, zero past n (kRows of them, so that a lane's slots past N read zero
// rows at any G up to 8).
template <int KIND, int N>
struct SfSlotWc {
  static constexpr int kStride = N | 1;
  static constexpr int kRows = (N + 7) / 8 * 8;
  double Wc[KIND == 1 ? kRows * kStride : 1];
};

// What the slot design's step reads of a rule: its vectors (the by-value
// parameter), its staged Wc and its expected model variance.
template <int KIND, int N>
struct SfSlotRule {
  const double (&xi)[SF_MAX_SLOTS];
  const double (&wm)[SF_MAX_SLOTS];
  const double (&wc)[SF_MAX_SLOTS];
  const double (&wcc)[SF_MAX_SLOTS];
  const SfSlotWc<KIND, N>& w;
  double emv;
};

template <int KIND, int N>
SF_HD SfSlotRule<KIND, N> sfs_rule(const SfsVec& v, const SfSlotWc<KIND, N>& w,
                                   const SfgRule& R) {
  return {v.xi, v.wm, v.wc, v.wcc, w, KIND == 1 ? R.emv : 0.0};
}

template <int KIND, int N>
SF_HD double sf_wc(const SfSlotRule<KIND, N>& R, int s, int j) {
  return R.w.Wc[s * SfSlotWc<KIND, N>::kStride + j];
}

// Stage rule R's Wc into S: entries t, t + dt, ... of it, for thread t of dt
// (the host build: 0 of 1).
template <int KIND, int N>
SF_HD void sfs_stage(SfSlotWc<KIND, N>& S, const SfgRule& R, int t, int dt) {
  if constexpr (KIND == 1) {
    const int n = R.n;
    constexpr int W = SfSlotWc<KIND, N>::kStride;
    for (int e = t; e < SfSlotWc<KIND, N>::kRows * W; e += dt) {
      const int i = e / W, j = e % W;
      S.Wc[e] = i < n && j < n ? SFG_LDG(R.Wc + static_cast<long long>(i) * n + j) : 0.0;
    }
  }
}

// Lanes a trajectory of the slot design, by the kinds of both rules and the
// slot count (SFS_LANES=1|2|4|8 sets one count for every shape, for
// tools/sf_variants.py).
// Measured at 10,000 x 500 on an H100 (tools/sf_variants.py): up to 8 slots
// a classical configuration here has the sine, the range or a registered
// measurement, whose evaluation four lanes split best (1-2 points a lane; the
// UNGM measurement alone would take two); at 9-16 slots every lane repeats
// the sums of 9-16 points and two lanes beat four by 6-14%; a BQ rule's rows
// of Wc f pay for four lanes from 12 slots (at 16: 1.30 ms against 1.97 on
// two), two from 5 (at 9: 0.77 against 0.82 on four), one thread at 3 as in
// the shaped form.  Above 16 slots: UNGM GH-17 / GH-24 / GH-32 1.02 / 1.20
// / 1.66 ms on two lanes against 1.12 / 1.28 / 1.64 on four and 1.64 / 1.82
// / 2.45 on eight (the registered growth model's GH-17 the reverse: 1.42 on
// four, 1.64 on two); GPQ on GH-17 / GH-24 / GH-32 points 2.03 / 2.80 /
// 5.34 on four against 3.24 / 4.05 / 6.51 on two and 2.87 / 3.38 / 5.18 on
// eight, which pays for itself at 32 rows of 32.
SF_HD constexpr int sfs_lanes(int kind_dyn, int kind_obs, int n_slots) {
#ifdef SFS_LANES
  return SFS_LANES;
#else
  if ((kind_dyn | kind_obs) == 0) return n_slots <= 8 ? 4 : 2;
  return n_slots <= 3 ? 1 : n_slots <= 9 ? 2 : n_slots <= 24 ? 4 : 8;
#endif
}

// The design of a launch, which ops/scalar_filter.py (geometry) asks through
// the libraries' sf_design: for rules of kinds kind_dyn, kind_obs and n_dyn,
// n_obs points in the shaped form (shaped) or in the general and registered
// forms, the slot count (sf_slots; 0 above SF_MAX_SLOTS points, where the
// general and registered forms run one thread a trajectory) and the lanes a
// trajectory (sf_lanes, sfs_lanes; 1 for one thread a trajectory).
SF_HD void sf_design_of(int shaped, int kind_dyn, int kind_obs, int n_dyn, int n_obs,
                        int* slots, int* lanes) {
  *slots = sf_slots(n_dyn, n_obs);
  *lanes = shaped ? sf_lanes(kind_dyn, kind_obs, *slots)
           : *slots ? sfs_lanes(kind_dyn, kind_obs, *slots) : 1;
}

// A whole record of one trajectory on lane `lane` of its G: n_steps steps
// from the initial moments of q under the staged rules rd and ro, measurement
// k at y[k * y_step], the n_s stream values of step k at s[k * n_s], the
// models of Model made from p; if `store`, output k at out_*[k * ss].
template <int KD, int KO, int N, int G, class Model, class P>
SF_HD void sfs_record(const P& p, const SfSlotRule<KD, N>& rd, const SfSlotRule<KO, N>& ro,
                      int lane, const double* y, long long y_step, const double* s, int n_s,
                      int n_steps, long long ss, bool store, double* m_fi, double* P_fi,
                      double* m_pr, double* P_pr, double* xx) {
  const SfgParams& q = sf_base(p);
  SfStepper<KD, KO, N, G, false> filter;
  filter.load(rd, ro, lane);
  const auto h = Model::obs(p);
  auto f_next = Model::dyn(p, s);
  double m = q.m0, Pv = q.P0, y_next = y[0];
  for (int k = 0; k < n_steps; ++k) {
    const double y_k = y_next;
    const auto f_k = f_next;
    if (k + 1 < n_steps) {
      y_next = y[(k + 1) * y_step];
      f_next = Model::dyn(p, s + static_cast<long long>(k + 1) * n_s);
    }
    const SfStep st = filter.step(rd, ro, q.gqg, q.r, m, Pv, y_k, f_k, h);
    if (store) {
      const long long o = static_cast<long long>(k) * ss;
      m_pr[o] = st.m_pr;
      P_pr[o] = st.P_pr;
      xx[o] = st.xx;
      m_fi[o] = st.m_fi;
      P_fi[o] = st.P_fi;
    }
    m = st.m_fi;
    Pv = st.P_fi;
  }
}

// The zoo's slot shapes: every pair of kinds at every slot count up to
// SF_NARROW_SLOTS (SFS_SHAPES, scalar_filter_slots.cu) and above it
// (SFS_WIDE_SHAPES, scalar_filter_slots_wide.cu), F(KD, KO, N).
#define SFS_COUNTS_OF(F, KD, KO) F(KD, KO, 3) F(KD, KO, 5) F(KD, KO, 7) F(KD, KO, 8) \
  F(KD, KO, 9) F(KD, KO, 12) F(KD, KO, 16)
#define SFS_WIDE_COUNTS_OF(F, KD, KO) F(KD, KO, 20) F(KD, KO, 24) F(KD, KO, 32)
#define SFS_KINDS(X, F) X(F, 0, 0) X(F, 0, 1) X(F, 1, 0) X(F, 1, 1)
#define SFS_SHAPES(F) SFS_KINDS(SFS_COUNTS_OF, F)
#define SFS_WIDE_SHAPES(F) SFS_KINDS(SFS_WIDE_COUNTS_OF, F)
