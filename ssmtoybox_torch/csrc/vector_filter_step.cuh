// One step of the Gaussian sigma-point filter for small vector states
// (2 <= D <= 8) with additive noise, in native float64, one trajectory a
// thread.  Model pairs: reentry (2-D) and constant velocity with the radar,
// the pendulum with its sine measurement, the falling body (1-D reentry)
// with its range, the coordinated turn with four bearings.  The model forms
// here are shared by every vector kernel; the general kernel
// (vector_filter_general.cuh) also takes the UNGM measurement of a state
// component (VfObs<VF_OBS_UNGM>) and bearings from any number of sensors
// (vf_bearings), with any transition of the table, and the registered
// kernel (vector_filter_registered.cu) a user's own model forms.
//
// Shared by the CUDA kernel (vector_filter.cu) and a host shim
// (vector_filter_host.cpp) that g++ builds, so that the CPU tests hold this
// exact code against the plain PyTorch version in
// ssmtoybox_torch/ops/vector_filter.py.  Every sum runs in the plain
// version's order, from 0.0 upwards, so that the two agree to the bit where
// their exp, sqrt, sin, cos and atan2 agree.
//
// Step (the JAX package's ops/ddvec.py::_prepare.step_math and the port's
// eager ssinf._gaussian_time_update / _kalman_update, in f64):
//   time update   L = chol(P), x_j = m + L xi_j, f_j = f(x_j)
//                 (m_pr, Pf, xx) = rule_dyn(f), P_pr = Pf + G Q G^T
//   measurement   L2 = chol(P_pr), h_j = h(m_pr + L2 xi_j)
//                 (y_pr, S0, C) = rule_obs(h), S = S0 + R
//   update        K = C^T S^-1 (an E x E Cholesky solve a column of C),
//                 m_fi = m_pr + K (y - y_pr), P_fi = P_pr - (K S) K^T on the
//                 lower triangle, mirrored.
// A classical rule takes centred moments with diagonal weights wc (the state
// of the reentry model is ~6.4e3 with variances of ~1e-6: uncentred sums
// would cancel ~13 of 16 digits).  A BQ rule takes the uncentred quadratic
// form of the reference, sum_i f_i (sum_j Wc_ij f_j)^T - mu mu^T + emv I, and
// the cross-covariance h L^T with h = sum_j Wcc_.j f_j.
//
// The rule's point count N is read at run time (up to 243 for Gauss-Hermite
// of degree 3 at D = 5), so the function values of the N points go through a
// scratch buffer, value (j, e) of a trajectory at scratch[(j * EO + e) * ss]:
// the kernel interleaves the trajectories (ss = B, neighbouring threads at
// neighbouring addresses), the host shim too.  The rule's constants are read
// through VF_LDG (the read-only path on the card), never kept in registers.
//
// A Cholesky factor of a matrix that is not positive definite takes the square
// root of a negative number: NaN, which then fills the trajectory's moments
// from that step on, with no trap, as utils/linalg.chol_small does in both
// packages.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define VF_HD __host__ __device__ __forceinline__
#else
#define VF_HD inline
#endif

#ifdef __CUDA_ARCH__
#define VF_LDG(p) __ldg(p)
#else
#define VF_LDG(p) (*(p))
#endif

// Largest state and measurement dimension of the parameter struct.
#define VF_MAX_DIM 8

// Models with a kernel form (ids shared with ops/vector_filter.py).
#define VF_DYN_REENTRY 0    // ReentryVehicle2DTransition: dyn_c = dt, R0, H0, Gm0, b0
#define VF_DYN_CV 1         // ConstantVelocity: dyn_c = dt
#define VF_DYN_PENDULUM 2   // Pendulum2DTransition: dyn_c = dt, g dt
#define VF_DYN_REENTRY1D 3  // ReentryVehicle1DTransition: dyn_c = dt, -Gamma
#define VF_DYN_CT 4         // CoordinatedTurnTransition: dyn_c = dt
// obs_idx: the state components the measurement reads (its state_index)
#define VF_OBS_RADAR 0         // Radar2DMeasurement: obs_c = radar x, y
#define VF_OBS_PENDULUM_SIN 1  // Pendulum2DMeasurement: no constants
#define VF_OBS_RANGE 2         // RangeMeasurement: obs_c = sx^2, sy
#define VF_OBS_BEARING 3       // BearingMeasurement, S sensors: obs_c = x, y of each
#define VF_OBS_UNGM 4          // UNGMMeasurement of component obs_idx[0]: no constants

// Largest number of measurement constants the struct holds: 8 bearing
// sensors' positions, as many sensors as R (VF_MAX_DIM x VF_MAX_DIM) has
// outputs.  The general kernels read the measurement's constants and R from
// device memory instead (VfgParams), for any number of outputs.
#define VF_MAX_OBS_C 16

// A quadrature rule, its constants in memory the step reads (device memory
// for the kernel).  kind 0: classical, diagonal covariance weights wc.  kind 1:
// BQ, dense weights Wc (n x n), cross weights Wcc (dim_in x n) and the
// expected model variance emv.  All arrays row-major.
struct VfRule {
  int kind;
  int n;
  const double* xi;   // (dim_in, n) unit sigma points
  const double* wm;   // (n,)
  const double* wc;   // (n,), kind 0
  const double* Wc;   // (n, n), kind 1
  const double* Wcc;  // (dim_in, n), kind 1
  double emv;         // kind 1
};

// Everything the kernel takes besides the data: by value, 1,904 bytes of
// the 4 KB a kernel's parameters may take.  Matrices row-major, VF_MAX_DIM
// apart.
struct VfParams {
  VfRule dyn;
  VfRule obs;
  int dyn_model;
  int obs_model;
  int dim_state;
  int dim_out;
  double dyn_c[5];
  double obs_c[VF_MAX_OBS_C];
  int obs_idx[2];
  double m0[VF_MAX_DIM];
  double P0[VF_MAX_DIM * VF_MAX_DIM];
  double gqg[VF_MAX_DIM * VF_MAX_DIM];  // G Q G^T
  double r[VF_MAX_DIM * VF_MAX_DIM];    // R
};
static_assert(sizeof(VfRule) == 56 && sizeof(VfParams) == 1904,
              "the layout the ctypes mirror (ops/vector_filter.py) expects");

// Where one step of one trajectory writes its five streams: each pointer at
// component 0 of this step and trajectory, components `cs` apart.
struct VfOut {
  double *m_fi, *P_fi, *m_pr, *P_pr, *xx;
  long long cs;
};

// x[i] of a register array without dynamic indexing (which would put x in
// local memory).
template <int D>
VF_HD double vf_pick(const double (&x)[D], int i) {
  double v = x[0];
#pragma unroll
  for (int k = 1; k < D; ++k) v = i == k ? x[k] : v;
  return v;
}

// ---------------------------------------------------------------------------
// models
// ---------------------------------------------------------------------------

template <int DYN>
struct VfDyn;

// 2-D reentry vehicle (ssmod.ReentryVehicle2DTransition.dyn_fcn at zero
// noise), the two exponentials of the drag fused as the JAX package writes
// them.
template <>
struct VfDyn<VF_DYN_REENTRY> {
  static constexpr int D = 5;
  VF_HD static void eval(const double* c, const double (&x)[5], double (&f)[5]) {
    const double dt = c[0], R0 = c[1], H0 = c[2], Gm0 = c[3], b0 = c[4];
    const double R = sqrt(x[0] * x[0] + x[1] * x[1]);
    const double V = sqrt(x[2] * x[2] + x[3] * x[3]);
    const double drag = (b0 * exp(x[4] + (R0 - R) / H0)) * V;
    const double grav = (-Gm0) / ((R * R) * R);
    f[0] = x[0] + dt * x[2];
    f[1] = x[1] + dt * x[3];
    f[2] = x[2] + dt * (drag * x[2] + grav * x[0]);
    f[3] = x[3] + dt * (drag * x[3] + grav * x[1]);
    f[4] = x[4];
  }
};

// Constant velocity in the plane, state [p_x, v_x, p_y, v_y].
template <>
struct VfDyn<VF_DYN_CV> {
  static constexpr int D = 4;
  VF_HD static void eval(const double* c, const double (&x)[4], double (&f)[4]) {
    const double dt = c[0];
    f[0] = x[0] + dt * x[1];
    f[1] = x[1];
    f[2] = x[2] + dt * x[3];
    f[3] = x[3];
  }
};

// Pendulum, state [angle, angular rate] (ssmod.Pendulum2DTransition).
template <>
struct VfDyn<VF_DYN_PENDULUM> {
  static constexpr int D = 2;
  VF_HD static void eval(const double* c, const double (&x)[2], double (&f)[2]) {
    const double dt = c[0], gdt = c[1];
    f[0] = x[0] + x[1] * dt;
    f[1] = x[1] - gdt * sin(x[0]);
  }
};

// Falling body, state [altitude, velocity, ballistic coefficient]
// (ssmod.ReentryVehicle1DTransition), the products in the model's order.
template <>
struct VfDyn<VF_DYN_REENTRY1D> {
  static constexpr int D = 3;
  VF_HD static void eval(const double* c, const double (&x)[3], double (&f)[3]) {
    const double dt = c[0], neg_gamma = c[1];
    f[0] = x[0] - dt * x[1];
    f[1] = x[1] - ((dt * exp(neg_gamma * x[0])) * (x[1] * x[1])) * x[2];
    f[2] = x[2];
  }
};

// Coordinated turn, state [p_x, v_x, p_y, v_y, turn rate]
// (ssmod.CoordinatedTurnTransition): below a turn rate of 1e-30 the
// straight-line limit is selected and the divisions see 1e-30, the select of
// both packages.  sin and cos are called apart, as the plain version calls
// torch.sin and torch.cos (a sincos() need not give their bits).
template <>
struct VfDyn<VF_DYN_CT> {
  static constexpr int D = 5;
  VF_HD static void eval(const double* c, const double (&x)[5], double (&f)[5]) {
    const double dt = c[0], om = x[4];
    const bool straight = fabs(om) < 1e-30;
    const double om_safe = straight ? 1e-30 : om;
    const double a = sin(om * dt);
    const double b = cos(om * dt);
    const double cc = straight ? dt : a / om_safe;
    const double d = straight ? 0.0 : (1.0 - b) / om_safe;
    f[0] = (x[0] + cc * x[1]) - d * x[3];
    f[1] = b * x[1] - a * x[3];
    f[2] = (x[2] + d * x[1]) + cc * x[3];
    f[3] = a * x[1] + b * x[3];
    f[4] = x[4];
  }
};

template <int OBS>
struct VfObs;

// Each measurement reads its constants through c (the parameter struct's
// obs_c, or a copy in device memory for the general kernels) and the state
// components idx (obs_idx), and writes its outputs to h[0 .. E) (a register
// array, or a strided column of the general kernels' scratch buffer).

// Range and bearing from a radar at (c[0], c[1]) of the state components
// idx[0], idx[1].
template <>
struct VfObs<VF_OBS_RADAR> {
  static constexpr int E = 2;
  template <int D, class C, class H>
  VF_HD static void eval(const C& c, const int (&idx)[2], const double (&x)[D], H&& h) {
    const double dx = vf_pick(x, idx[0]) - c[0];
    const double dy = vf_pick(x, idx[1]) - c[1];
    h[0] = sqrt(dx * dx + dy * dy);
    h[1] = atan2(dy, dx);
  }
};

// The sine of the angle (state component idx[0]).
template <>
struct VfObs<VF_OBS_PENDULUM_SIN> {
  static constexpr int E = 1;
  template <int D, class C, class H>
  VF_HD static void eval(const C&, const int (&idx)[2], const double (&x)[D], H&& h) {
    h[0] = sin(vf_pick(x, idx[0]));
  }
};

// Range to the falling body (state component idx[0]) from a radar sx away at
// height sy: sqrt(sx^2 + (x - sy)^2), c = sx^2, sy.
template <>
struct VfObs<VF_OBS_RANGE> {
  static constexpr int E = 1;
  template <int D, class C, class H>
  VF_HD static void eval(const C& c, const int (&idx)[2], const double (&x)[D], H&& h) {
    const double d = vf_pick(x, idx[0]) - c[1];
    h[0] = sqrt(c[0] + d * d);
  }
};

// Bearings of (idx[0], idx[1]) from four sensors at (c[2 s], c[2 s + 1]).
template <>
struct VfObs<VF_OBS_BEARING> {
  static constexpr int E = 4;
  template <int D, class C, class H>
  VF_HD static void eval(const C& c, const int (&idx)[2], const double (&x)[D], H&& h) {
    const double px = vf_pick(x, idx[0]), py = vf_pick(x, idx[1]);
#pragma unroll
    for (int s = 0; s < 4; ++s) h[s] = atan2(py - c[2 * s + 1], px - c[2 * s]);
  }
};

// The UNGM measurement 0.05 x^2 of the state component idx[0].
template <>
struct VfObs<VF_OBS_UNGM> {
  static constexpr int E = 1;
  template <int D, class C, class H>
  VF_HD static void eval(const C&, const int (&idx)[2], const double (&x)[D], H&& h) {
    const double v = vf_pick(x, idx[0]);
    h[0] = 0.05 * (v * v);
  }
};

// Bearings of (idx[0], idx[1]) from the first S sensors at (c[2 s],
// c[2 s + 1]), S read at run time: the bearing form of the general kernel.
// SB > 0: a register array h of SB entries, SB predicated iterations (static
// indices); SB == 0: any S (h a scratch column or shared memory), four
// sensors an iteration, their atan2 computed before any is stored so that
// the four can overlap (a store to h could alias c).  Entries of h from S on
// are not written.
template <int SB, int D, class C, class H>
VF_HD void vf_bearings(const C& c, const int (&idx)[2], const double (&x)[D], int S, H&& h) {
  const double px = vf_pick(x, idx[0]), py = vf_pick(x, idx[1]);
  if constexpr (SB > 0) {
#pragma unroll
    for (int s = 0; s < SB; ++s)
      if (s < S) h[s] = atan2(py - c[2 * s + 1], px - c[2 * s]);
  } else {
    int s = 0;
#pragma unroll 1
    for (; s + 4 <= S; s += 4) {
      double b[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) b[u] = atan2(py - c[2 * (s + u) + 1], px - c[2 * (s + u)]);
#pragma unroll
      for (int u = 0; u < 4; ++u) h[s + u] = b[u];
    }
#pragma unroll 1
    for (; s < S; ++s) h[s] = atan2(py - c[2 * s + 1], px - c[2 * s]);
  }
}

template <int D, int DYN>
struct VfDynFn {
  const VfParams& p;
  VF_HD void operator()(const double (&x)[D], double (&f)[D]) const {
    VfDyn<DYN>::eval(p.dyn_c, x, f);
  }
};

template <int D, int OBS>
struct VfObsFn {
  const VfParams& p;
  VF_HD void operator()(const double (&x)[D], double (&h)[VfObs<OBS>::E]) const {
    VfObs<OBS>::template eval<D>(p.obs_c, p.obs_idx, x, h);
  }
};

// ---------------------------------------------------------------------------
// small linear algebra, in the order of utils/linalg.py::chol_small
// ---------------------------------------------------------------------------

// Lower Cholesky factor of the lower triangle of A; zeros above the diagonal.
template <int D>
VF_HD void vf_chol(const double (&A)[D][D], double (&L)[D][D]) {
#pragma unroll
  for (int i = 0; i < D; ++i) {
#pragma unroll
    for (int j = 0; j < D; ++j) {
      if (j > i) {
        L[i][j] = 0.0;
        continue;
      }
      double s = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = i == j ? sqrt(s) : s / L[j][j];
    }
  }
}

// dx = L xi_j, the offset of point j from the mean.
template <int D>
VF_HD void vf_offset(const VfRule& R, const double (&L)[D][D], int j, double (&dx)[D]) {
  const int n = R.n;
#pragma unroll
  for (int a = 0; a < D; ++a) {
    double acc = 0.0;
#pragma unroll
    for (int k = 0; k <= a; ++k) acc = acc + L[a][k] * VF_LDG(R.xi + k * n + j);
    dx[a] = acc;
  }
}

// Moments of f over rule R at the Gaussian (m, L L^T): mean mu, covariance cov
// (full, mirrored from the lower triangle) and cross-covariance cross[e][d]
// of the output e with the input d.
template <int D, int EO, int KIND, class F>
VF_HD void vf_moments(const VfRule& R, const double (&m)[D], const double (&L)[D][D], const F& f,
                      double* scratch, long long ss, double (&mu)[EO], double (&cov)[EO][EO],
                      double (&cross)[EO][D]) {
  const int n = R.n;
#pragma unroll
  for (int e = 0; e < EO; ++e) mu[e] = 0.0;
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    double dx[D], x[D], fx[EO];
    vf_offset(R, L, j, dx);
#pragma unroll
    for (int a = 0; a < D; ++a) x[a] = m[a] + dx[a];
    f(x, fx);
    const double w = VF_LDG(R.wm + j);
#pragma unroll
    for (int e = 0; e < EO; ++e) {
      scratch[(static_cast<long long>(j) * EO + e) * ss] = fx[e];
      mu[e] = mu[e] + w * fx[e];
    }
  }
#pragma unroll
  for (int a = 0; a < EO; ++a) {
#pragma unroll
    for (int b = 0; b < EO; ++b) cov[a][b] = 0.0;
#pragma unroll
    for (int d = 0; d < D; ++d) cross[a][d] = 0.0;
  }
  if constexpr (KIND == 0) {
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      double dx[D], d[EO];
      vf_offset(R, L, j, dx);
#pragma unroll
      for (int e = 0; e < EO; ++e)
        d[e] = scratch[(static_cast<long long>(j) * EO + e) * ss] - mu[e];
      const double w = VF_LDG(R.wc + j);
#pragma unroll
      for (int a = 0; a < EO; ++a) {
#pragma unroll
        for (int b = 0; b <= a; ++b) cov[a][b] = cov[a][b] + w * (d[a] * d[b]);
#pragma unroll
        for (int c = 0; c < D; ++c) cross[a][c] = cross[a][c] + w * (d[a] * dx[c]);
      }
    }
  } else {
    double h[EO][D];
#pragma unroll
    for (int e = 0; e < EO; ++e) {
#pragma unroll
      for (int c = 0; c < D; ++c) h[e][c] = 0.0;
    }
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      double fi[EO], g[EO];
#pragma unroll
      for (int e = 0; e < EO; ++e) {
        fi[e] = scratch[(static_cast<long long>(i) * EO + e) * ss];
        g[e] = 0.0;
      }
#pragma unroll 1
      for (int j = 0; j < n; ++j) {
        const double w = VF_LDG(R.Wc + static_cast<long long>(i) * n + j);
#pragma unroll
        for (int e = 0; e < EO; ++e)
          g[e] = g[e] + w * scratch[(static_cast<long long>(j) * EO + e) * ss];
      }
#pragma unroll
      for (int a = 0; a < EO; ++a) {
#pragma unroll
        for (int b = 0; b <= a; ++b) cov[a][b] = cov[a][b] + fi[a] * g[b];
      }
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const double w = VF_LDG(R.Wcc + c * n + i);
#pragma unroll
        for (int e = 0; e < EO; ++e) h[e][c] = h[e][c] + w * fi[e];
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
  }
#pragma unroll
  for (int a = 0; a < EO; ++a) {
#pragma unroll
    for (int b = a + 1; b < EO; ++b) cov[a][b] = cov[b][a];
  }
}

// ---------------------------------------------------------------------------
// the step
// ---------------------------------------------------------------------------

// One filter step from the filtered state (m, P) of the previous step (only
// the lower triangle of P is read), measurement y; writes the five streams
// through `out` and leaves this step's filtered state in (m, P).
template <int D, int E, int DYN, int OBS, int KD, int KO>
VF_HD void vf_step(const VfParams& p, double (&m)[D], double (&P)[D][D], const double (&y)[E],
                   double* scratch, long long ss, const VfOut& out) {
  static_assert(VfDyn<DYN>::D == D && VfObs<OBS>::E == E, "model dimensions");
  double L[D][D], m_pr[D], P_pr[D][D];
  {
    double Pf[D][D], xx[D][D];
    vf_chol(P, L);
    vf_moments<D, D, KD>(p.dyn, m, L, VfDynFn<D, DYN>{p}, scratch, ss, m_pr, Pf, xx);
#pragma unroll
    for (int a = 0; a < D; ++a) {
      out.m_pr[a * out.cs] = m_pr[a];
#pragma unroll
      for (int b = 0; b < D; ++b) {
        P_pr[a][b] = Pf[a][b] + p.gqg[a * VF_MAX_DIM + b];
        out.P_pr[(a * D + b) * out.cs] = P_pr[a][b];
        out.xx[(a * D + b) * out.cs] = xx[a][b];
      }
    }
  }
  double y_pr[E], S[E][E], C[E][D];
  vf_chol(P_pr, L);
  vf_moments<D, E, KO>(p.obs, m_pr, L, VfObsFn<D, OBS>{p}, scratch, ss, y_pr, S, C);
#pragma unroll
  for (int a = 0; a < E; ++a) {
#pragma unroll
    for (int b = 0; b < E; ++b) S[a][b] = S[a][b] + p.r[a * VF_MAX_DIM + b];
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

// A whole record of one trajectory: T steps from the initial moments of p,
// measurement e of step k at y[e * y_e + k * y_k].  The streams of step k start
// at out_*[k * (components) * cs], components cs apart.
template <int D, int E, int DYN, int OBS, int KD, int KO>
VF_HD void vf_record(const VfParams& p, const double* y, long long y_e, long long y_k, int T,
                     double* scratch, long long ss, double* m_fi, double* P_fi, double* m_pr,
                     double* P_pr, double* xx, long long cs) {
  double m[D], P[D][D];
#pragma unroll
  for (int a = 0; a < D; ++a) {
    m[a] = p.m0[a];
#pragma unroll
    for (int b = 0; b < D; ++b) P[a][b] = p.P0[a * VF_MAX_DIM + b];
  }
#pragma unroll 1
  for (int k = 0; k < T; ++k) {
    double yk[E];
#pragma unroll
    for (int e = 0; e < E; ++e) yk[e] = y[e * y_e + k * y_k];
    const long long v = static_cast<long long>(k) * D * cs, M = v * D;
    const VfOut out = {m_fi + v, P_fi + M, m_pr + v, P_pr + M, xx + M, cs};
    vf_step<D, E, DYN, OBS, KD, KO>(p, m, P, yk, scratch, ss, out);
  }
}

// The instantiations: (D, E, dynamics, measurement) for each registered model
// pair, each with the four pairs of rule kinds.
#define VF_MODELS(F)                                                                    \
  F(5, 2, VF_DYN_REENTRY, VF_OBS_RADAR) F(4, 2, VF_DYN_CV, VF_OBS_RADAR)                \
  F(2, 1, VF_DYN_PENDULUM, VF_OBS_PENDULUM_SIN) F(3, 1, VF_DYN_REENTRY1D, VF_OBS_RANGE) \
  F(5, 4, VF_DYN_CT, VF_OBS_BEARING)
