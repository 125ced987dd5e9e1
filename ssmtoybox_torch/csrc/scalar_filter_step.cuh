// One step of the scalar sigma-point filter for the univariate nonlinear
// growth model (UNGM), in native float64, with the rule's shape known at
// compile time and the work of one trajectory spread over G lanes.
//
// Shared by the CUDA kernel (scalar_filter.cu) and a host shim
// (scalar_filter_host.cpp) that g++ builds with G = 1, so the CPU tests can
// hold this exact code against the PyTorch twin in
// ssmtoybox_torch/ops/scalar_filter.py.
//
// Step (the JAX package's ops/ddfilter.py::_prepare, in f64 instead of
// double-double):
//   time update   L = sqrt(P), x_i = m + L xi_i, f_i = f(x_i; c_k)
//                 (m_pr, Pf, xx) = rule_dyn(f), P_pr = Pf + G Q G
//   measurement   L2 = sqrt(P_pr), h_i = h(m_pr + L2 xi_i)
//                 (y_pr, S0, C) = rule_obs(h), S = S0 + R
//   update        K = C / S, m_fi = m_pr + K (y - y_pr), P_fi = P_pr - K^2 S
// with f(x; c) = 0.5 x + 25 x / (1 + x^2) + c, c_k = 8 cos(1.2 (k - 1)),
// and h(x) = 0.05 x^2.
//
// Shape.  SfStepper<KD, KO, N, G>: KD / KO the kind of the dynamics and the
// measurement rule, N the slots of both rules (a rule of fewer points is
// padded with zero weights, which add nothing), G the lanes of a trajectory.
// Every loop over points has N straight-line iterations.
//
// Lanes.  Slot s belongs to lane s % G as its (s / G)-th.  A lane evaluates
// the model functions (the f64 divide of the dynamics) at its own slots and,
// for a BQ rule, its own rows of Wc f; the values are then gathered, so that
// every lane holds all N.  Every sum runs in every lane, over the gathered
// values, in the order of the twin: sequentially from point 0.  The lanes of a
// trajectory so hold the same state to the bit, kernel and twin agree to the
// bit whatever G is, and only the long sequences (divides, rows) are split.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define SF_HD __host__ __device__ __forceinline__
#define SF_UNROLL _Pragma("unroll")
#else
#define SF_HD inline
#define SF_UNROLL
#endif

// Most points of a rule: 7-point Gauss-Hermite and BSQ-GH7 rules fit.  The
// parameters (two rules) travel by value, 1,600 bytes of the 4 KB a kernel's
// parameters may take.
#define SF_MAX_PTS 8

// A 1-D quadrature rule.  kind 0: classical, centered moments with diagonal
// covariance weights wc.  kind 1: Bayesian quadrature, uncentered moments
// with the dense weights Wc (row-major, rows SF_MAX_PTS apart), cross weights
// wcc and the expected model variance emv.  Entries past n are zero.
struct SfRule {
  int kind;
  int n;
  double xi[SF_MAX_PTS];
  double wm[SF_MAX_PTS];
  double wc[SF_MAX_PTS];
  double Wc[SF_MAX_PTS * SF_MAX_PTS];
  double wcc[SF_MAX_PTS];
  double emv;
};

struct SfParams {
  SfRule dyn;
  SfRule obs;
  double m0;   // initial mean
  double P0;   // initial variance
  double gqg;  // G Q G, additive process-noise variance
  double r;    // additive measurement-noise variance
};

struct SfStep {
  double m_pr, P_pr, xx, m_fi, P_fi;
};

// The slot counts of the shaped form, for each pair of kinds: the rules of
// the studies (3, 5, 7 points) and the widest (8).  A configuration runs at
// the smallest count that holds both of its rules.
#define SF_SHAPES_OF(F, KD, KO) F(KD, KO, 3) F(KD, KO, 5) F(KD, KO, 7) F(KD, KO, 8)
#define SF_SHAPES(F) SF_SHAPES_OF(F, 0, 0) SF_SHAPES_OF(F, 0, 1) SF_SHAPES_OF(F, 1, 0) \
                     SF_SHAPES_OF(F, 1, 1)

// Most slots of the slot design (scalar_filter_step_general.cuh, sfs_record):
// its counts are those of the shaped form, 9, 12 and 16 (scalar_filter_slots.cu)
// and, above SF_NARROW_SLOTS, 20, 24 and SF_MAX_SLOTS
// (scalar_filter_slots_wide.cu).
#define SF_NARROW_SLOTS 16
#define SF_MAX_SLOTS 32

// The smallest slot count that holds rules of n_dyn and n_obs points; 0 above
// SF_MAX_SLOTS.
SF_HD int sf_slots(int n_dyn, int n_obs) {
  const int n = n_dyn > n_obs ? n_dyn : n_obs;
  return n <= 3 ? 3 : n <= 5 ? 5 : n <= 7 ? 7 : n <= 8 ? 8 : n <= 9 ? 9 : n <= 12 ? 12
         : n <= 16 ? 16 : n <= 20 ? 20 : n <= 24 ? 24 : n <= SF_MAX_SLOTS ? SF_MAX_SLOTS : 0;
}

// Lanes a trajectory of the shaped form (SF_LANES=1|2|4|8 sets one count for
// every shape, for tools/sf_variants.py).  Measured at 10,000 x 500 on an H100
// (tools/sf_variants.py): two lanes are the fastest split of every classical
// rule and of a 5-point BQ rule; the rows of a 7- or 8-point BQ rule pay for
// four, and a 3-point BQ rule is fastest in one thread (its two gathers a
// rule cost more than three divides side by side save).  Eight lanes lose
// everywhere: every lane repeats the sums, and four times the warps then
// queue for the f64 pipe.
SF_HD constexpr int sf_lanes(int kind_dyn, int kind_obs, int n_slots) {
#ifdef SF_LANES
  return SF_LANES;
#else
  if ((kind_dyn | kind_obs) == 0) return 2;
  return n_slots >= 7 ? 4 : n_slots <= 3 ? 1 : 2;
#endif
}

SF_HD double sf_ungm_dyn(double x, double c) {
  return 0.5 * x + 25.0 * (x / (1.0 + x * x)) + c;
}

SF_HD double sf_ungm_obs(double x) { return 0.05 * (x * x); }

// The UNGM transition at the step's constant c, and the UNGM measurement, as
// the model functors the steps take.
struct SfgDyn {
  double c;
  SF_HD double operator()(double x) const { return sf_ungm_dyn(x, c); }
};

struct SfUngmObs {
  SF_HD double operator()(double x) const { return sf_ungm_obs(x); }
};

// v of lane src of the G lanes this thread's trajectory has (G consecutive
// lanes of a warp, every lane of the warp calling).
template <int G>
SF_HD double sf_from_lane(double v, int src) {
  if constexpr (G == 1) {
    return v;
  } else {
#ifdef __CUDA_ARCH__
    const int lo = __shfl_sync(0xffffffffu, __double2loint(v), src, G);
    const int hi = __shfl_sync(0xffffffffu, __double2hiint(v), src, G);
    return __hiloint2double(hi, lo);
#else
    return v;  // the host build has one lane
#endif
  }
}

// Entry (s, j) of a rule's dense BQ weights Wc.
SF_HD double sf_wc(const SfRule& R, int s, int j) { return R.Wc[s * SF_MAX_PTS + j]; }

// What one lane keeps of a rule for the whole record: the unit points of its
// own slots and, for a BQ rule whose rows stay in registers (ROWS), its own
// rows of Wc; without ROWS a BQ rule's rows are read from the rule R where
// they are used (the slot design's rows in shared memory, zero past N).  R is
// SfRule (the shaped form's parameters) or SfSlotRule
// (scalar_filter_step_general.cuh): xi, wm, wc, wcc, emv and sf_wc.
template <int KIND, int N, int G, bool ROWS = true>
struct SfLaneRule {
  static constexpr int PPL = (N + G - 1) / G;  // slots a lane
  static constexpr bool kRows = KIND == 1 && ROWS;
  double xi[PPL];
  double row[kRows ? PPL : 1][kRows ? N : 1];
  int lane;

  template <class R>
  SF_HD void load(const R& rule, int lane_) {
    lane = lane_;
    SF_UNROLL
    for (int k = 0; k < PPL; ++k) {
      const int s = k * G + lane;
      xi[k] = s < N ? rule.xi[s] : 0.0;
      if constexpr (kRows) {
        SF_UNROLL
        for (int j = 0; j < N; ++j) row[k][j] = s < N ? sf_wc(rule, s, j) : 0.0;
      }
    }
  }

  // all[s] for every slot s from the lanes' own values
  SF_HD void gather(const double (&own)[PPL], double (&all)[N]) const {
    SF_UNROLL
    for (int s = 0; s < N; ++s) all[s] = sf_from_lane<G>(own[s / G], s % G);
  }

  // Moments of the function values at the points m + L xi_s under rule R,
  // from this lane's values f: mean mu, variance var and cross-covariance
  // cross with the input.
  template <class R>
  SF_HD void moments(const R& rule, double L, const double (&f)[PPL], double* mu, double* var,
                     double* cross) const {
    double fs[N];
    gather(f, fs);
    double m = 0.0;
    SF_UNROLL
    for (int i = 0; i < N; ++i) m += rule.wm[i] * fs[i];
    double v = 0.0, c = 0.0;
    if constexpr (KIND == 0) {
      SF_UNROLL
      for (int i = 0; i < N; ++i) {
        const double d = fs[i] - m;
        v += rule.wc[i] * (d * d);
        c += rule.wc[i] * ((L * rule.xi[i]) * d);
      }
    } else {
      double q_own[PPL], qs[N];
      SF_UNROLL
      for (int k = 0; k < PPL; ++k) {
        double r = 0.0;
        SF_UNROLL
        for (int j = 0; j < N; ++j) {
          if constexpr (kRows) {
            r += row[k][j] * fs[j];
          } else {
            r += sf_wc(rule, k * G + lane, j) * fs[j];
          }
        }
        q_own[k] = f[k] * r;
      }
      gather(q_own, qs);
      double q = 0.0, s = 0.0;
      SF_UNROLL
      for (int i = 0; i < N; ++i) {
        q += qs[i];
        s += rule.wcc[i] * fs[i];
      }
      v = q - m * m + rule.emv;
      c = s * L;
    }
    *mu = m;
    *var = v;
    *cross = c;
  }
};

// One lane's view of a filter: load() once, then step() for every
// measurement.  Every lane of a trajectory returns the same SfStep.
template <int KD, int KO, int N, int G, bool ROWS = true>
struct SfStepper {
  SfLaneRule<KD, N, G, ROWS> dyn;
  SfLaneRule<KO, N, G, ROWS> obs;
  static constexpr int PPL = SfLaneRule<KD, N, G, ROWS>::PPL;

  template <class RD, class RO>
  SF_HD void load(const RD& rd, const RO& ro, int lane) {
    dyn.load(rd, lane);
    obs.load(ro, lane);
  }

  SF_HD void load(const SfParams& p, int lane) { load(p.dyn, p.obs, lane); }

  // One filter step from the filtered state (m, P) of the previous step, with
  // measurement y, under the rules rd and ro, the transition f and the
  // measurement h, process- and measurement-noise variances gqg and r.
  template <class RD, class RO, class Dyn, class Obs>
  SF_HD SfStep step(const RD& rd, const RO& ro, double gqg, double r, double m, double P,
                    double y, const Dyn& f, const Obs& h) const {
    SfStep s;
    double x[PPL], v[PPL];
    const double L = sqrt(P);
    SF_UNROLL
    for (int k = 0; k < PPL; ++k) x[k] = m + L * dyn.xi[k];
    SF_UNROLL
    for (int k = 0; k < PPL; ++k) v[k] = f(x[k]);
    double Pf;
    dyn.moments(rd, L, v, &s.m_pr, &Pf, &s.xx);
    s.P_pr = Pf + gqg;

    const double L2 = sqrt(s.P_pr);
    SF_UNROLL
    for (int k = 0; k < PPL; ++k) x[k] = s.m_pr + L2 * obs.xi[k];
    SF_UNROLL
    for (int k = 0; k < PPL; ++k) v[k] = h(x[k]);
    double y_pr, S0, C;
    obs.moments(ro, L2, v, &y_pr, &S0, &C);
    const double S = S0 + r;
    const double K = C / S;
    s.m_fi = s.m_pr + K * (y - y_pr);
    s.P_fi = s.P_pr - (K * K) * S;
    return s;
  }

  // The shaped form's step: the UNGM models, the dynamics constant c of this
  // step.
  SF_HD SfStep step(const SfParams& p, double m, double P, double y, double c) const {
    return step(p.dyn, p.obs, p.gqg, p.r, m, P, y, SfgDyn{c}, SfUngmObs{});
  }
};
