// One step of the Gaussian sigma-point filter for small vector states with
// additive noise, in native float64, one trajectory a thread, for rules at
// the UT and CKF point counts (ND and NO, the dynamics and measurement rules'
// counts, each 2 D + 1 or 2 D), with both counts and each transform's kind
// (classical or BQ) known at compile time.
//
// Shared by the CUDA kernels (vector_filter_shaped.cu: both rules classical;
// vector_filter_shaped_bq.cu and vector_filter_shaped_bq_mixed.cu: a BQ rule
// on either transform or both, at one count and at the two mixed; the
// general and registered kernels' shaped one-thread form,
// vector_filter_general_shaped.cuh, whose model policies give the functors)
// and the host shims (vector_filter_shaped_host.cpp for the classical kernel,
// vector_filter_host.cpp for the BQ shapes at one count and
// vector_filter_shaped_bq_host.cpp for those at mixed counts), which g++
// builds, so that the CPU tests hold this exact code against the plain
// PyTorch version in ssmtoybox_torch/ops/vector_filter.py.  The step is that
// of vector_filter_step.cuh, whose models, Cholesky factor and parameter
// struct it reuses; every sum runs in the plain version's order, from 0.0
// upwards, so that both agree to the bit where their exp, sqrt and atan2
// agree.
//
// Besides the UT and CKF counts, one Gauss-Hermite count p^D of at most
// VFS_MAX_PTS points that is neither (vfs_gh_count: GH-3 on a 2-D state, 9
// points; GH-2 on a 3-D one, 8) runs here on both transforms of classical
// rules (VFS_GH; GH-2 on a 2-D state has the CKF's 4 points).
//
// What differs from the first version's step (vector_filter_step.cuh):
// - both point counts, the model pair and the rules' kinds are template
//   arguments, so each transform's point loops have a count known to the
//   compiler (ND on the time update, NO on the measurement update: the UKF
//   beside the CKF is one shape like the others), and nothing is read at run
//   time to decide the shape;
// - the rules' constants travel by value in the parameters and are read at
//   offsets the compiler knows (the constant bank), not through pointers;
// - each point's value f_j and offset dx_j = L xi_j are computed once and
//   kept on chip for the sums: in registers where the point loops are
//   unrolled, in the thread's own local memory (L1) where they stay loops;
//   nothing goes through a scratch buffer in device memory;
// - a BQ rule's quadratic form sum_i f_i (sum_j Wc_ij f_j)^T takes its row
//   sum g_i one i at a time, EO accumulators, the j loop unrolled over the
//   values kept on chip and the constant row of Wc; the first version reads
//   both from device memory (N^2 EO scratch loads and N^2 weight loads a
//   transform).
//
// Unrolled or not.  A transform through the reentry dynamics keeps its point
// loops as loops: the model (two square roots, two divides and an exp, each
// with its slow path) unrolled 10 or 11 times made a kernel of 9,000-16,000
// instructions, past what the SM's instruction cache holds, and it ran at
// 2.4-3.0 ms on the bench lane against 1.6 ms as loops (PERF.md, section 6).  The
// radar and the constant-velocity model are short and unroll.  The
// coordinated turn (a sine, a cosine and two divides) and the four bearings
// (four atan2, each with a divide) stay loops for the same reason: unrolled,
// that kernel was 13,900-15,200 instructions, as loops 4,300 (PERF.md); the
// pendulum (one sine), the falling body (one exp), its range (one square
// root) and the pendulum's sine measurement unroll at their 4-7 points.
#pragma once

#include "vector_filter_step.cuh"

// Largest state of a registered model pair (reentry, coordinated turn), and
// its UT point count.
#define VFS_MAX_DIM 5
#define VFS_MAX_PTS 11

// A classical rule by value: unit points (dim_in, n), rows VFS_MAX_PTS apart,
// mean and diagonal covariance weights.  616 bytes.
struct VfsRule {
  double xi[VFS_MAX_DIM * VFS_MAX_PTS];
  double wm[VFS_MAX_PTS];
  double wc[VFS_MAX_PTS];
};

// The kernel's parameters: the first version's (models, initial moments,
// G Q G^T, R; of its rule fields only the kinds and point counts, which the
// launcher checks) and both rules by value, 3,136 bytes of the 4 KB a
// kernel's parameters may take.
struct VfsParams {
  VfParams base;
  VfsRule dyn;
  VfsRule obs;
};

// A rule by value of either kind, for the kernel of the BQ shapes: the
// classical fields (xi and wm of both kinds, wc of a classical rule, zero in
// a BQ one), then a BQ rule's dense weights Wc (n, n) and cross weights Wcc
// (dim_in, n), rows VFS_MAX_PTS apart, and its expected model variance.  Wc
// is kept whole, not as a triangle: the port's GPQ weights (wm wm^T + K^-1
// (Q - q q^T) K^-1) are not symmetric to the bit.  2,032 bytes.
struct VfsBqRule {
  VfsRule c;
  double Wc[VFS_MAX_PTS * VFS_MAX_PTS];
  double Wcc[VFS_MAX_DIM * VFS_MAX_PTS];
  double emv;
};

// The parameters of the kernel of the BQ shapes: 5,968 bytes.  Past the 4 KB
// that a kernel's parameters could take before CUDA 12.1; from 12.1 on, sm_70
// and later take up to 32,764 bytes of them, which still live in the constant
// bank: every thread reads the same address, and the constant cache
// broadcasts it.  The launch's other arguments take 80 bytes.
struct VfsBqParams {
  VfParams base;
  VfsBqRule dyn;
  VfsBqRule obs;
};
static_assert(sizeof(VfsBqRule) == 2032 && sizeof(VfsBqParams) == 5968,
              "the layout the ctypes mirror (ops/vector_filter.py) expects");
static_assert(sizeof(VfsBqParams) + 128 <= 32764,
              "a kernel's parameters take at most 32,764 bytes (CUDA 12.1 and later)");

// Whether the point loops of the dynamics and of the measurement transform
// stay loops (above).
template <int DYN>
constexpr bool vfs_rolled = DYN == VF_DYN_REENTRY || DYN == VF_DYN_CT;
template <int OBS>
constexpr bool vfs_rolled_obs = OBS == VF_OBS_BEARING;

#define VFS_PRAGMA(x) _Pragma(#x)

// Moments of f over rule R at the Gaussian (m, L L^T): mean mu, covariance cov
// (full, mirrored from the lower triangle) and cross-covariance cross[e][d] of
// the output e with the input d.  ROLL: the point loops stay loops.
template <int D, int EO, int N, bool ROLL, class F>
VF_HD void vfs_moments(const VfsRule& R, const double (&m)[D], const double (&L)[D][D],
                       const F& f, double (&mu)[EO], double (&cov)[EO][EO],
                       double (&cross)[EO][D]) {
  static_assert(N <= VFS_MAX_PTS, "a VfsRule holds VFS_MAX_PTS points");
  [[maybe_unused]] constexpr int U = ROLL ? 1 : N;  // unroll factor of the point loops
  double v[N][EO + D];             // point j: its values, then its offset
  VFS_PRAGMA(unroll (U))
  for (int j = 0; j < N; ++j) {
    double x[D], fx[EO];
#pragma unroll
    for (int a = 0; a < D; ++a) {
      double acc = 0.0;
#pragma unroll
      for (int c = 0; c <= a; ++c) acc = acc + L[a][c] * R.xi[c * VFS_MAX_PTS + j];
      v[j][EO + a] = acc;
      x[a] = m[a] + acc;
    }
    f(x, fx);
#pragma unroll
    for (int e = 0; e < EO; ++e) v[j][e] = fx[e];
  }
#pragma unroll
  for (int e = 0; e < EO; ++e) mu[e] = 0.0;
  VFS_PRAGMA(unroll (U))
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int e = 0; e < EO; ++e) mu[e] = mu[e] + R.wm[j] * v[j][e];
  }
#pragma unroll
  for (int a = 0; a < EO; ++a) {
#pragma unroll
    for (int b = 0; b < EO; ++b) cov[a][b] = 0.0;
#pragma unroll
    for (int c = 0; c < D; ++c) cross[a][c] = 0.0;
  }
  VFS_PRAGMA(unroll (U))
  for (int j = 0; j < N; ++j) {
    double d[EO];
#pragma unroll
    for (int e = 0; e < EO; ++e) d[e] = v[j][e] - mu[e];
    const double w = R.wc[j];
#pragma unroll
    for (int a = 0; a < EO; ++a) {
#pragma unroll
      for (int b = 0; b <= a; ++b) cov[a][b] = cov[a][b] + w * (d[a] * d[b]);
#pragma unroll
      for (int c = 0; c < D; ++c) cross[a][c] = cross[a][c] + w * (d[a] * v[j][EO + c]);
    }
  }
#pragma unroll
  for (int a = 0; a < EO; ++a) {
#pragma unroll
    for (int b = a + 1; b < EO; ++b) cov[a][b] = cov[b][a];
  }
}

// Moments of f over the BQ rule R at the Gaussian (m, L L^T), every sum in
// the order of the plain version's BQ branch (ops/vector_filter.py,
// _moments_plain) and of vf_moments, from 0.0 upwards: mu = sum_j wm_j f_j;
// for each i, g_i = sum_j Wc_ij f_j, then q += f_i g_i^T on the lower
// triangle; h = sum_i Wcc[:, i] f_i; cov = q - mu mu^T + emv I (mirrored),
// cross = h L^T.  Only the values f_j stay on chip: the cross-covariance
// needs no offsets.  ROLL: the point loops stay loops; the j loop of g_i,
// which calls no model, is unrolled either way (as a loop it ran slower).
template <int D, int EO, int N, bool ROLL, class F>
VF_HD void vfs_bq_moments(const VfsBqRule& R, const double (&m)[D], const double (&L)[D][D],
                          const F& f, double (&mu)[EO], double (&cov)[EO][EO],
                          double (&cross)[EO][D]) {
  static_assert(N <= VFS_MAX_PTS, "a VfsBqRule holds VFS_MAX_PTS points");
  [[maybe_unused]] constexpr int U = ROLL ? 1 : N;  // unroll factor of the point loops
  double v[N][EO];                 // point j: its values
  VFS_PRAGMA(unroll (U))
  for (int j = 0; j < N; ++j) {
    double x[D], fx[EO];
#pragma unroll
    for (int a = 0; a < D; ++a) {
      double acc = 0.0;
#pragma unroll
      for (int c = 0; c <= a; ++c) acc = acc + L[a][c] * R.c.xi[c * VFS_MAX_PTS + j];
      x[a] = m[a] + acc;
    }
    f(x, fx);
#pragma unroll
    for (int e = 0; e < EO; ++e) v[j][e] = fx[e];
  }
#pragma unroll
  for (int e = 0; e < EO; ++e) mu[e] = 0.0;
  VFS_PRAGMA(unroll (U))
  for (int j = 0; j < N; ++j) {
#pragma unroll
    for (int e = 0; e < EO; ++e) mu[e] = mu[e] + R.c.wm[j] * v[j][e];
  }
  double h[EO][D];
#pragma unroll
  for (int a = 0; a < EO; ++a) {
#pragma unroll
    for (int b = 0; b < EO; ++b) cov[a][b] = 0.0;
#pragma unroll
    for (int c = 0; c < D; ++c) h[a][c] = 0.0;
  }
  VFS_PRAGMA(unroll (U))
  for (int i = 0; i < N; ++i) {
    double g[EO];
#pragma unroll
    for (int e = 0; e < EO; ++e) g[e] = 0.0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const double w = R.Wc[i * VFS_MAX_PTS + j];
#pragma unroll
      for (int e = 0; e < EO; ++e) g[e] = g[e] + w * v[j][e];
    }
#pragma unroll
    for (int a = 0; a < EO; ++a) {
#pragma unroll
      for (int b = 0; b <= a; ++b) cov[a][b] = cov[a][b] + v[i][a] * g[b];
    }
  }
  // h in a pass of its own: its EO x D sums beside the quadratic form's
  // overflowed the registers of the reentry transform (255, 112 bytes spilled)
  VFS_PRAGMA(unroll (U))
  for (int i = 0; i < N; ++i) {
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const double w = R.Wcc[c * VFS_MAX_PTS + i];
#pragma unroll
      for (int e = 0; e < EO; ++e) h[e][c] = h[e][c] + w * v[i][e];
    }
  }
#pragma unroll
  for (int a = 0; a < EO; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) cov[a][b] = cov[a][b] - mu[a] * mu[b];
    cov[a][a] = cov[a][a] + R.emv;
  }
  // cross = h L^T, from 0.0 upwards over the lower triangle of L
#pragma unroll
  for (int e = 0; e < EO; ++e) {
#pragma unroll
    for (int c = 0; c < D; ++c) {
      double acc = 0.0;
#pragma unroll
      for (int a = 0; a <= c; ++a) acc = acc + h[e][a] * L[c][a];
      cross[e][c] = acc;
    }
  }
#pragma unroll
  for (int a = 0; a < EO; ++a) {
#pragma unroll
    for (int b = a + 1; b < EO; ++b) cov[a][b] = cov[b][a];
  }
}

// The moments of a transform whose rule has kind KIND (0 classical, 1 BQ):
// a VfsRule holds a classical rule, a VfsBqRule either kind.
template <int KIND, int D, int EO, int N, bool ROLL, class F>
VF_HD void vfs_transform(const VfsRule& R, const double (&m)[D], const double (&L)[D][D],
                         const F& f, double (&mu)[EO], double (&cov)[EO][EO],
                         double (&cross)[EO][D]) {
  static_assert(KIND == 0, "a VfsRule holds a classical rule");
  vfs_moments<D, EO, N, ROLL>(R, m, L, f, mu, cov, cross);
}

template <int KIND, int D, int EO, int N, bool ROLL, class F>
VF_HD void vfs_transform(const VfsBqRule& R, const double (&m)[D], const double (&L)[D][D],
                         const F& f, double (&mu)[EO], double (&cov)[EO][EO],
                         double (&cross)[EO][D]) {
  static_assert(KIND == 0 || KIND == 1, "rule kind");
  if constexpr (KIND == 0) {
    vfs_moments<D, EO, N, ROLL>(R.c, m, L, f, mu, cov, cross);
  } else {
    vfs_bq_moments<D, EO, N, ROLL>(R, m, L, f, mu, cov, cross);
  }
}

// One filter step from the filtered state (m, P) of the previous step (only
// the lower triangle of P is read), measurement y; writes the five streams
// through `out` and leaves this step's filtered state in (m, P).  vf_step's
// arithmetic, with vfs_transform for vf_moments, on the functors dyn and obs
// (a model policy's, below).  ND, NO: the point counts of the dynamics and
// measurement rules; KD, KO: their kinds; RD, RO: whether their transforms'
// point loops stay loops; P: VfsParams (both classical), VfsBqParams, or the
// general kernel's VgsParams (vector_filter_general_shaped.cuh), each with
// the fields base, dyn and obs; or the slot kernel's lane view of its
// parameters (vector_filter_slots.cuh), whose rules' moments overload
// vfs_transform.
template <int D, int E, int ND, int NO, int KD, int KO, bool RD, bool RO, class Params,
          class Dyn, class Obs>
VF_HD void vfs_step_with(const Params& p, double (&m)[D], double (&P)[D][D],
                         const double (&y)[E], const Dyn& dyn, const Obs& obs,
                         const VfOut& out) {
  static_assert(D <= VFS_MAX_DIM, "rule shape");
  const VfParams& q = p.base;
  double L[D][D], m_pr[D], P_pr[D][D];
  {
    double Pf[D][D], xx[D][D];
    vf_chol(P, L);
    vfs_transform<KD, D, D, ND, RD>(p.dyn, m, L, dyn, m_pr, Pf, xx);
#pragma unroll
    for (int a = 0; a < D; ++a) {
      out.m_pr[a * out.cs] = m_pr[a];
#pragma unroll
      for (int b = 0; b < D; ++b) {
        P_pr[a][b] = Pf[a][b] + q.gqg[a * VF_MAX_DIM + b];
        out.P_pr[(a * D + b) * out.cs] = P_pr[a][b];
        out.xx[(a * D + b) * out.cs] = xx[a][b];
      }
    }
  }
  double y_pr[E], S[E][E], C[E][D];
  vf_chol(P_pr, L);
  vfs_transform<KO, D, E, NO, RO>(p.obs, m_pr, L, obs, y_pr, S, C);
#pragma unroll
  for (int a = 0; a < E; ++a) {
#pragma unroll
    for (int b = 0; b < E; ++b) S[a][b] = S[a][b] + q.r[a * VF_MAX_DIM + b];
  }
  double Ls[E][E], K[D][E];
  vf_chol(S, Ls);
  // K[d] = S^-1 C[:, d]: forward, then backward substitution
#pragma unroll
  for (int d = 0; d < D; ++d) {
    double z[E];
#pragma unroll
    for (int i = 0; i < E; ++i) {
      double s = C[i][d];
#pragma unroll
      for (int k = 0; k < i; ++k) s = s - Ls[i][k] * z[k];
      z[i] = s / Ls[i][i];
    }
#pragma unroll
    for (int i = E - 1; i >= 0; --i) {
      double s = z[i];
#pragma unroll
      for (int k = i + 1; k < E; ++k) s = s - Ls[k][i] * K[d][k];
      K[d][i] = s / Ls[i][i];
    }
  }
  double T[D][E];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    double acc = m_pr[d];
#pragma unroll
    for (int e = 0; e < E; ++e) acc = acc + K[d][e] * (y[e] - y_pr[e]);
    m[d] = acc;
    out.m_fi[d * out.cs] = acc;
#pragma unroll
    for (int e = 0; e < E; ++e) {
      double t = 0.0;
#pragma unroll
      for (int e2 = 0; e2 < E; ++e2) t = t + K[d][e2] * S[e2][e];
      T[d][e] = t;
    }
  }
#pragma unroll
  for (int a = 0; a < D; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) {
      double acc = 0.0;
#pragma unroll
      for (int e = 0; e < E; ++e) acc = acc + T[a][e] * K[b][e];
      P[a][b] = P_pr[a][b] - acc;
      P[b][a] = P[a][b];
    }
  }
#pragma unroll
  for (int a = 0; a < D; ++a) {
#pragma unroll
    for (int b = 0; b < D; ++b) out.P_fi[(a * D + b) * out.cs] = P[a][b];
  }
}

// A whole record of one trajectory: T steps from the initial moments,
// measurement e of step k at y[e * y_e + k * y_k], the streams of step k at
// out_*[k * (components) * cs], components cs apart (vf_record's layout); the
// measurement of step k + 1 is loaded before the arithmetic of step k.  The
// models of the policy Model: Model::dyn(p, s + k * n_s) for step k (a
// registered transition's n_s stream values of step k at s[k * n_s]) and
// Model::obs(p).
template <int D, int E, int ND, int NO, int KD, int KO, bool RD, bool RO, class Model,
          class Params>
VF_HD void vfs_record_as(const Params& p, const double* y, long long y_e, long long y_k, int T,
                         const double* s, int n_s, double* m_fi, double* P_fi, double* m_pr,
                         double* P_pr, double* xx, long long cs) {
  double m[D], P[D][D];
#pragma unroll
  for (int a = 0; a < D; ++a) {
    m[a] = p.base.m0[a];
#pragma unroll
    for (int b = 0; b < D; ++b) P[a][b] = p.base.P0[a * VF_MAX_DIM + b];
  }
  double y_next[E];
#pragma unroll
  for (int e = 0; e < E; ++e) y_next[e] = y[e * y_e];
#pragma unroll 1
  for (int k = 0; k < T; ++k) {
    double yk[E];
#pragma unroll
    for (int e = 0; e < E; ++e) {
      yk[e] = y_next[e];
      if (k + 1 < T) y_next[e] = y[e * y_e + (k + 1) * y_k];
    }
    const long long v = static_cast<long long>(k) * D * cs, M = v * D;
    const VfOut out = {m_fi + v, P_fi + M, m_pr + v, P_pr + M, xx + M, cs};
    vfs_step_with<D, E, ND, NO, KD, KO, RD, RO>(
        p, m, P, yk, Model::dyn(p, s + static_cast<long long>(k) * n_s), Model::obs(p), out);
  }
}

// The model policy of a pair of the table's models known when compiling:
// their functors on the parameters' base (their constants by value), and
// whether each model's point loops stay loops (vfs_rolled; what the slot
// kernel's vsl_record reads of a policy).
template <int D, int E, int DYN, int OBS>
struct VfsZoo {
  static_assert(VfDyn<DYN>::D == D && VfObs<OBS>::E == E, "model dimensions");
  static constexpr bool dyn_rolled = vfs_rolled<DYN>, obs_rolled = vfs_rolled_obs<OBS>;
  template <class Params>
  VF_HD static VfDynFn<D, DYN> dyn(const Params& p, const double*) {
    return {p.base};
  }
  template <class Params>
  VF_HD static VfObsFn<D, OBS> obs(const Params& p) {
    return {p.base};
  }
};

// The record of the shaped kernels: the model pair (DYN, OBS) of the table,
// ND and NO points on the dynamics and measurement rules, its loops rolled as
// vfs_rolled says.
template <int D, int E, int DYN, int OBS, int ND, int NO, int KD = 0, int KO = 0, class Params>
VF_HD void vfs_record(const Params& p, const double* y, long long y_e, long long y_k, int T,
                      double* m_fi, double* P_fi, double* m_pr, double* P_pr, double* xx,
                      long long cs) {
  vfs_record_as<D, E, ND, NO, KD, KO, vfs_rolled<DYN>, vfs_rolled_obs<OBS>,
                VfsZoo<D, E, DYN, OBS>>(p, y, y_e, y_k, T, nullptr, 0, m_fi, P_fi, m_pr, P_pr,
                                        xx, cs);
}

// The model pairs with a kernel form, (D, E, dynamics, measurement), each
// given to X with F.
#define VFS_PAIRS(X, F)                                     \
  X(F, 5, 2, VF_DYN_REENTRY, VF_OBS_RADAR)                  \
  X(F, 4, 2, VF_DYN_CV, VF_OBS_RADAR)                       \
  X(F, 2, 1, VF_DYN_PENDULUM, VF_OBS_PENDULUM_SIN)          \
  X(F, 3, 1, VF_DYN_REENTRY1D, VF_OBS_RANGE)                \
  X(F, 5, 4, VF_DYN_CT, VF_OBS_BEARING)

// The point counts of a model pair's rules, F(D, E, DYN, OBS, ND, NO): one
// count on both transforms, the UT's or the CKF's (VFS_SHAPES_OF), or the
// two mixed, the UT on the dynamics beside the CKF on the measurement and
// the other way round (VFS_MIXED_OF).
#define VFS_SHAPES_OF(F, D, E, DYN, OBS) \
  F(D, E, DYN, OBS, 2 * (D) + 1, 2 * (D) + 1) F(D, E, DYN, OBS, 2 * (D), 2 * (D))
#define VFS_MIXED_OF(F, D, E, DYN, OBS) \
  F(D, E, DYN, OBS, 2 * (D) + 1, 2 * (D)) F(D, E, DYN, OBS, 2 * (D), 2 * (D) + 1)

// The Gauss-Hermite point count p^D (p >= 2) of a D-dimensional state that
// the shaped steps take beside the UT and CKF counts: at most VFS_MAX_PTS
// points and neither 2 D + 1 nor 2 D.  GH-3 on 2-D states (9), GH-2 on 3-D
// ones (8); none from 4-D on (16 points and more), and GH-2 on 2-D has the
// CKF's 4.  0 where there is none.
VF_HD constexpr int vfs_gh_count(int D) {
  for (int p = 2, n = 1; p <= VFS_MAX_PTS; ++p, n = 1) {
    for (int k = 0; k < D; ++k) n *= p;
    if (n > VFS_MAX_PTS) return 0;
    if (n != 2 * D && n != 2 * D + 1) return n;
  }
  return 0;
}
static_assert(vfs_gh_count(2) == 9 && vfs_gh_count(3) == 8 && vfs_gh_count(4) == 0 &&
                  vfs_gh_count(5) == 0,
              "the Gauss-Hermite counts that ops/vector_filter.py routes (_gh_count)");

// Whether the shaped steps take ND and NO points on a D-dimensional state:
// the UT or CKF count on each transform, or the Gauss-Hermite count of
// vfs_gh_count on both.
VF_HD constexpr bool vfs_counts_ok(int D, int ND, int NO) {
  return ((ND == 2 * D || ND == 2 * D + 1) && (NO == 2 * D || NO == 2 * D + 1)) ||
         (ND == NO && ND == vfs_gh_count(D) && ND > 0);
}

// The Gauss-Hermite count of each model pair of VFS_PAIRS that has one, on
// both rules, F(D, E, DYN, OBS, N, N): the pendulum at 9 points (GH-3), the
// falling body at 8 (GH-2).
#define VFS_GH(F)                                                 \
  F(2, 1, VF_DYN_PENDULUM, VF_OBS_PENDULUM_SIN, 9, 9)             \
  F(3, 1, VF_DYN_REENTRY1D, VF_OBS_RANGE, 8, 8)

// The instantiations of the classical kernel: the four pairs of UT and CKF
// point counts of each model pair and the Gauss-Hermite counts of VFS_GH,
// F(D, E, DYN, OBS, ND, NO): 22.
#define VFS_SHAPES(F) VFS_PAIRS(VFS_SHAPES_OF, F) VFS_PAIRS(VFS_MIXED_OF, F) VFS_GH(F)

// The instantiations of the kernel of the BQ shapes: both point counts of
// each model pair, each with the kinds (BQ, BQ), (classical, BQ) and (BQ,
// classical) of the dynamics and measurement rules, F(D, E, DYN, OBS, N, KD,
// KO): 30.
#define VFS_BQ_KINDS_OF(F, D, E, DYN, OBS, N) \
  F(D, E, DYN, OBS, N, 1, 1) F(D, E, DYN, OBS, N, 0, 1) F(D, E, DYN, OBS, N, 1, 0)
#define VFS_BQ_SHAPES_OF(F, D, E, DYN, OBS) \
  VFS_BQ_KINDS_OF(F, D, E, DYN, OBS, 2 * (D) + 1) VFS_BQ_KINDS_OF(F, D, E, DYN, OBS, 2 * (D))
#define VFS_BQ_SHAPES(F) VFS_PAIRS(VFS_BQ_SHAPES_OF, F)

// The instantiations of the kernel of the BQ shapes at mixed point counts
// (vector_filter_shaped_bq_mixed.cu): the UT count on the dynamics beside the
// CKF count on the measurement and the other way round, each with the kinds
// (BQ, BQ), (classical, BQ) and (BQ, classical), F(D, E, DYN, OBS, ND, NO,
// KD, KO): 30.
#define VFS_BQ_MIXED_KINDS_OF(F, D, E, DYN, OBS, ND, NO) \
  F(D, E, DYN, OBS, ND, NO, 1, 1) F(D, E, DYN, OBS, ND, NO, 0, 1) F(D, E, DYN, OBS, ND, NO, 1, 0)
#define VFS_BQ_MIXED_OF(F, D, E, DYN, OBS)                                 \
  VFS_BQ_MIXED_KINDS_OF(F, D, E, DYN, OBS, 2 * (D) + 1, 2 * (D))           \
  VFS_BQ_MIXED_KINDS_OF(F, D, E, DYN, OBS, 2 * (D), 2 * (D) + 1)
#define VFS_BQ_MIXED(F) VFS_PAIRS(VFS_BQ_MIXED_OF, F)
