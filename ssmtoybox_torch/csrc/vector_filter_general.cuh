// One step of the general vector filter (vector_filter_general.cu): every
// model pair of the table in vector_filter_step.cuh for 2 <= D <= 5, any
// measurement dimension 1 <= E <= 8 (bearings from 1-8 sensors, the UNGM
// measurement of a state component included), classical or BQ rules of any
// point count, in native float64, one trajectory a thread.
//
// Shared by the CUDA kernel and a host shim (vector_filter_host.cpp) that g++
// builds, so that the CPU tests hold this exact code against the plain
// PyTorch version in ssmtoybox_torch/ops/vector_filter.py.  Every sum runs in
// the plain version's order, from 0.0 upwards, as in vf_step.
//
// Shape.  D is a template argument (the transition fixes it: the pendulum
// 2, the falling body 3, constant velocity 4, reentry and the coordinated
// turn 5), and so is EB, a bound on E (2, 4 or 8); everything else is read
// at run time and is the same in every thread of a launch, so no branch
// diverges: the transition among those of its D, the measurement, E <= EB,
// both rule kinds and point counts.  Every loop over measurement components
// runs EB predicated iterations (e < E), so the E-sized arrays keep static
// indices and stay in registers where they fit; the first version's step
// (vf_step) instead makes E, the models and the kinds template arguments,
// which for every pair, bearing count and pair of kinds would be ~220
// instantiations.  Rules and function values go through device memory and a
// scratch buffer interleaved by trajectory, as in the first version.
#pragma once

#include "vector_filter_step.cuh"

// The transition of p among those of state dimension D.
template <int D>
struct VfgDynFn {
  static_assert(D >= 2 && D <= 5, "the transitions of the table have 2-5 states");
  const VfParams& p;
  VF_HD void operator()(const double (&x)[D], double (&f)[D]) const {
    if constexpr (D == 5) {
      if (p.dyn_model == VF_DYN_CT)
        VfDyn<VF_DYN_CT>::eval(p.dyn_c, x, f);
      else
        VfDyn<VF_DYN_REENTRY>::eval(p.dyn_c, x, f);
    } else if constexpr (D == 4) {
      VfDyn<VF_DYN_CV>::eval(p.dyn_c, x, f);
    } else if constexpr (D == 3) {
      VfDyn<VF_DYN_REENTRY1D>::eval(p.dyn_c, x, f);
    } else {
      VfDyn<VF_DYN_PENDULUM>::eval(p.dyn_c, x, f);
    }
  }
};

// The measurement of p, its model read at run time; its E = p.dim_out <= EB
// outputs go to h[0 .. E).
template <int D, int EB>
struct VfgObsFn {
  static_assert(EB >= 2, "the radar has two outputs");
  const VfParams& p;
  VF_HD void operator()(const double (&x)[D], double (&h)[EB]) const {
    double one[1], two[2];
    switch (p.obs_model) {
      case VF_OBS_RADAR:
        VfObs<VF_OBS_RADAR>::template eval<D>(p, x, two);
        h[0] = two[0];
        h[1] = two[1];
        return;
      case VF_OBS_PENDULUM_SIN:
        VfObs<VF_OBS_PENDULUM_SIN>::template eval<D>(p, x, one);
        break;
      case VF_OBS_RANGE:
        VfObs<VF_OBS_RANGE>::template eval<D>(p, x, one);
        break;
      case VF_OBS_UNGM:
        VfObs<VF_OBS_UNGM>::template eval<D>(p, x, one);
        break;
      default:
        vf_bearings<D, EB>(p, x, p.dim_out, h);
        return;
    }
    h[0] = one[0];
  }
};

// Lower Cholesky factor of the lower triangle of the leading E x E block of A
// (vf_chol's recurrence); entries outside the block are not written.
template <int EB>
VF_HD void vfg_chol(const double (&A)[EB][EB], int E, double (&L)[EB][EB]) {
#pragma unroll
  for (int i = 0; i < EB; ++i) {
#pragma unroll
    for (int j = 0; j < EB; ++j) {
      if (i >= E || j > i) continue;
      double s = A[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - L[i][k] * L[j][k];
      L[i][j] = i == j ? sqrt(s) : s / L[j][j];
    }
  }
}

// Moments of f over rule R at the Gaussian (m, L L^T), vf_moments with the
// rule's kind and the output count eo <= EO read at run time: mean mu,
// covariance cov (the leading eo x eo block, mirrored from its lower
// triangle) and cross-covariance cross[e][d]; value (j, e) of a trajectory at
// scratch[(j * eo + e) * ss].
template <int D, int EO, class F>
VF_HD void vfg_moments(const VfRule& R, int eo, const double (&m)[D], const double (&L)[D][D],
                       const F& f, double* scratch, long long ss, double (&mu)[EO],
                       double (&cov)[EO][EO], double (&cross)[EO][D]) {
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
      if (e >= eo) continue;
      scratch[(static_cast<long long>(j) * eo + e) * ss] = fx[e];
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
  if (R.kind == 0) {
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      double dx[D], d[EO];
      vf_offset(R, L, j, dx);
#pragma unroll
      for (int e = 0; e < EO; ++e)
        d[e] = e < eo ? scratch[(static_cast<long long>(j) * eo + e) * ss] - mu[e] : 0.0;
      const double w = VF_LDG(R.wc + j);
#pragma unroll
      for (int a = 0; a < EO; ++a) {
        if (a >= eo) continue;
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
        fi[e] = e < eo ? scratch[(static_cast<long long>(i) * eo + e) * ss] : 0.0;
        g[e] = 0.0;
      }
#pragma unroll 1
      for (int j = 0; j < n; ++j) {
        const double w = VF_LDG(R.Wc + static_cast<long long>(i) * n + j);
#pragma unroll
        for (int e = 0; e < EO; ++e)
          if (e < eo) g[e] = g[e] + w * scratch[(static_cast<long long>(j) * eo + e) * ss];
      }
#pragma unroll
      for (int a = 0; a < EO; ++a) {
        if (a >= eo) continue;
#pragma unroll
        for (int b = 0; b <= a; ++b) cov[a][b] = cov[a][b] + fi[a] * g[b];
      }
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const double w = VF_LDG(R.Wcc + c * n + i);
#pragma unroll
        for (int e = 0; e < EO; ++e)
          if (e < eo) h[e][c] = h[e][c] + w * fi[e];
      }
    }
#pragma unroll
    for (int a = 0; a < EO; ++a) {
      if (a >= eo) continue;
#pragma unroll
      for (int b = 0; b <= a; ++b) cov[a][b] = cov[a][b] - mu[a] * mu[b];
      cov[a][a] = cov[a][a] + R.emv;
    }
    // cross = h L^T, from 0.0 upwards over the lower triangle of L
#pragma unroll
    for (int e = 0; e < EO; ++e) {
      if (e >= eo) continue;
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

// One filter step from the filtered state (m, P) of the previous step (only
// the lower triangle of P is read), measurement y[0 .. E); writes the five
// streams through `out` and leaves this step's filtered state in (m, P):
// vf_step with E = p.dim_out <= EB read at run time.
template <int D, int EB>
VF_HD void vfg_step(const VfParams& p, double (&m)[D], double (&P)[D][D], const double (&y)[EB],
                    double* scratch, long long ss, const VfOut& out) {
  const int E = p.dim_out;
  double L[D][D], m_pr[D], P_pr[D][D];
  {
    double Pf[D][D], xx[D][D];
    vf_chol(P, L);
    vfg_moments<D, D>(p.dyn, D, m, L, VfgDynFn<D>{p}, scratch, ss, m_pr, Pf, xx);
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
  double y_pr[EB], S[EB][EB], C[EB][D];
  vf_chol(P_pr, L);
  vfg_moments<D, EB>(p.obs, E, m_pr, L, VfgObsFn<D, EB>{p}, scratch, ss, y_pr, S, C);
#pragma unroll
  for (int a = 0; a < EB; ++a) {
#pragma unroll
    for (int b = 0; b < EB; ++b)
      if (a < E && b < E) S[a][b] = S[a][b] + p.r[a * VF_MAX_DIM + b];
  }
  double Ls[EB][EB], K[D][EB];
  vfg_chol(S, E, Ls);
  // K[d] = S^-1 C[:, d]: forward, then backward substitution
#pragma unroll
  for (int d = 0; d < D; ++d) {
    double z[EB];
#pragma unroll
    for (int i = 0; i < EB; ++i) {
      if (i >= E) continue;
      double s = C[i][d];
#pragma unroll
      for (int k = 0; k < i; ++k) s = s - Ls[i][k] * z[k];
      z[i] = s / Ls[i][i];
    }
#pragma unroll
    for (int i = EB - 1; i >= 0; --i) {
      if (i >= E) continue;
      double s = z[i];
#pragma unroll
      for (int k = i + 1; k < EB; ++k)
        if (k < E) s = s - Ls[k][i] * K[d][k];
      K[d][i] = s / Ls[i][i];
    }
  }
  double T[D][EB];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    double acc = m_pr[d];
#pragma unroll
    for (int e = 0; e < EB; ++e)
      if (e < E) acc = acc + K[d][e] * (y[e] - y_pr[e]);
    m[d] = acc;
    out.m_fi[d * out.cs] = acc;
#pragma unroll
    for (int e = 0; e < EB; ++e) {
      if (e >= E) continue;
      double t = 0.0;
#pragma unroll
      for (int e2 = 0; e2 < EB; ++e2)
        if (e2 < E) t = t + K[d][e2] * S[e2][e];
      T[d][e] = t;
    }
  }
#pragma unroll
  for (int a = 0; a < D; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) {
      double acc = 0.0;
#pragma unroll
      for (int e = 0; e < EB; ++e)
        if (e < E) acc = acc + T[a][e] * K[b][e];
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

// A whole record of one trajectory (vf_record's layouts): T steps from the
// initial moments of p, measurement e of step k at y[e * y_e + k * y_k].
template <int D, int EB>
VF_HD void vfg_record(const VfParams& p, const double* y, long long y_e, long long y_k, int T,
                      double* scratch, long long ss, double* m_fi, double* P_fi, double* m_pr,
                      double* P_pr, double* xx, long long cs) {
  const int E = p.dim_out;
  double m[D], P[D][D];
#pragma unroll
  for (int a = 0; a < D; ++a) {
    m[a] = p.m0[a];
#pragma unroll
    for (int b = 0; b < D; ++b) P[a][b] = p.P0[a * VF_MAX_DIM + b];
  }
#pragma unroll 1
  for (int k = 0; k < T; ++k) {
    double yk[EB];
#pragma unroll
    for (int e = 0; e < EB; ++e) yk[e] = e < E ? y[e * y_e + k * y_k] : 0.0;
    const long long v = static_cast<long long>(k) * D * cs, M = v * D;
    const VfOut out = {m_fi + v, P_fi + M, m_pr + v, P_pr + M, xx + M, cs};
    vfg_step<D, EB>(p, m, P, yk, scratch, ss, out);
  }
}

// The instantiations: D of the transitions, EB the bound on E that holds it.
#define VFG_SHAPES(F)                                                                   \
  F(2, 2) F(2, 4) F(2, 8) F(3, 2) F(3, 4) F(3, 8) F(4, 2) F(4, 4) F(4, 8) F(5, 2) F(5, 4) \
  F(5, 8)

// The bound EB of the instantiation that runs E measurement outputs.
inline int vfg_bound(int E) { return E <= 2 ? 2 : E <= 4 ? 4 : 8; }

// Whether the general step takes p: a transition of the table (its D), a
// measurement of the table with 1 <= E <= VF_MAX_DIM outputs, rule kinds 0 or
// 1, at least one point each.
inline bool vfg_takes(const VfParams& p) {
  static const int dims[] = {5, 4, 2, 3, 5};  // by VF_DYN_* id
  if (p.dyn_model < 0 || p.dyn_model > VF_DYN_CT || dims[p.dyn_model] != p.dim_state) return false;
  if (p.obs_model < 0 || p.obs_model > VF_OBS_UNGM || p.dim_out < 1 || p.dim_out > VF_MAX_DIM)
    return false;
  const int E = p.dim_out;
  if ((p.obs_model == VF_OBS_RADAR && E != 2) ||
      (p.obs_model != VF_OBS_RADAR && p.obs_model != VF_OBS_BEARING && E != 1))
    return false;
  return p.dyn.n >= 1 && p.obs.n >= 1 && ((p.dyn.kind | p.obs.kind) >> 1) == 0;
}
