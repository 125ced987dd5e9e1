// One step of the general vector filter (vector_filter_general.cu, and the
// registered kernel vector_filter_registered.cu): any transition with any
// measurement, any measurement dimension E (bearings from any number of
// sensors, the UNGM measurement of a state component included), classical
// or BQ rules of any point count, in native float64, one trajectory a thread.
//
// Shared by the CUDA kernels and a host shim (vector_filter_host.cpp) that g++
// builds, so that the CPU tests hold this exact code against the plain
// PyTorch version in ssmtoybox_torch/ops/vector_filter.py.  Every sum runs in
// the plain version's order, from 0.0 upwards, as in vf_step.
//
// Models.  The step takes its transition and measurement as functors, made
// a step at a time by a model policy (Model::dyn(p, s), Model::obs(p)).
// VfgZoo is the table of vector_filter_step.cuh: the transition among those
// of D (2-5) and the measurement, both by the ids of the parameters.  A
// model registered at run time (ops/vector_filter.register_dyn_dd_vec and
// friends) brings its own functors, generated from its C++ statements into
// the header that vector_filter_registered.cu includes, with any D from 1 to
// 8; its constants are read from device memory (VfgParams::dyn_c, obs_c), a
// transition's per-step stream values through s.
//
// The shaped one-thread form (vector_filter_general_shaped.cuh) takes the
// shapes of at most 4 outputs whose rules have the UT or CKF point count on
// the pairs it instantiates, and every such registered configuration
// (ops/vector_filter.py, lanes_of); this step runs the rest.
//
// Shape.  D is a template argument, and so is EB, a bound on E (2, 4 or 8;
// 0 for the wide form); everything else is read at run time and is the same
// in every thread of a launch, so no branch diverges: the models among those
// of the policy, E <= EB, both rule kinds and point counts.  Every loop over
// measurement components of the EB forms runs EB predicated iterations
// (e < E), so the E-sized arrays keep static indices and stay in registers
// where they fit.  The wide form (EB = 0, any E, vfg_step_wide) keeps every
// E-sized array of a thread (the predicted measurement, S, its factor, the
// cross-covariance, the gain, K S) in the scratch buffer beside the function
// values, interleaved by trajectory like them, and loops over E at run time.
// Rules and function values go through device memory and a scratch buffer
// interleaved by trajectory, as in the first version; so do the
// measurement's constants and R, which the parameter struct has no room for
// at any E.
#pragma once

#include "vector_filter_step.cuh"

// Everything the general kernels take besides the data: the parameters of the
// other vector kernels, whose obs_c and r are not read here, and pointers to
// the measurement's constants (the zoo model's, or a registered form's), R
// (E x E, row-major, E apart) and a registered transition's constants, all
// in device memory for the kernels.  By value, 1,928 bytes.
struct VfgParams {
  VfParams base;
  const double* obs_c;
  const double* r;
  const double* dyn_c;
};
static_assert(sizeof(VfgParams) == 1928, "the layout the ctypes mirror (ops/vector_filter.py) expects");

// A column of the scratch buffer: entry i of one trajectory at p[i * ss].
struct VfgCol {
  double* p;
  long long ss;
  VF_HD double& operator[](long long i) const { return p[i * ss]; }
};

// The transition of p among those of the table of state dimension D.
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

// The measurement of the table of p, its model read at run time, its
// constants from device memory; its E = p.base.dim_out outputs go to h[0 ..
// E), a register array of EB entries or (EB = 0) a scratch column.
template <int D, int EB>
struct VfgObsFn {
  const VfgParams& p;
  template <class H>
  VF_HD void operator()(const double (&x)[D], H&& h) const {
    const VfParams& q = p.base;
    switch (q.obs_model) {
      case VF_OBS_RADAR:
        VfObs<VF_OBS_RADAR>::template eval<D>(p.obs_c, q.obs_idx, x, h);
        return;
      case VF_OBS_PENDULUM_SIN:
        VfObs<VF_OBS_PENDULUM_SIN>::template eval<D>(p.obs_c, q.obs_idx, x, h);
        return;
      case VF_OBS_RANGE:
        VfObs<VF_OBS_RANGE>::template eval<D>(p.obs_c, q.obs_idx, x, h);
        return;
      case VF_OBS_UNGM:
        VfObs<VF_OBS_UNGM>::template eval<D>(p.obs_c, q.obs_idx, x, h);
        return;
      default:
        vf_bearings<EB>(p.obs_c, q.obs_idx, x, q.dim_out, h);
    }
  }
};

// The model policy of the table: the functors of the parameters' ids.
template <int D, int EB>
struct VfgZoo {
  VF_HD static VfgDynFn<D> dyn(const VfgParams& p, const double*) { return {p.base}; }
  VF_HD static VfgObsFn<D, EB> obs(const VfgParams& p) { return {p}; }
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

// The time update from the filtered state (m, P) of the previous step (only
// the lower triangle of P is read): writes the predicted mean and covariance
// and the cross-covariance through `out` and leaves the prediction in
// (m_pr, P_pr).
template <int D, class Dyn>
VF_HD void vfg_predict(const VfgParams& p, const double (&m)[D], const double (&P)[D][D],
                       const Dyn& dyn, double* scratch, long long ss, const VfOut& out,
                       double (&m_pr)[D], double (&P_pr)[D][D]) {
  double L[D][D], Pf[D][D], xx[D][D];
  vf_chol(P, L);
  vfg_moments<D, D>(p.base.dyn, D, m, L, dyn, scratch, ss, m_pr, Pf, xx);
#pragma unroll
  for (int a = 0; a < D; ++a) {
    out.m_pr[a * out.cs] = m_pr[a];
#pragma unroll
    for (int b = 0; b < D; ++b) {
      P_pr[a][b] = Pf[a][b] + p.base.gqg[a * VF_MAX_DIM + b];
      out.P_pr[(a * D + b) * out.cs] = P_pr[a][b];
      out.xx[(a * D + b) * out.cs] = xx[a][b];
    }
  }
}

// Stores this step's filtered covariance.
template <int D>
VF_HD void vfg_store_P(const double (&P)[D][D], const VfOut& out) {
#pragma unroll
  for (int a = 0; a < D; ++a) {
#pragma unroll
    for (int b = 0; b < D; ++b) out.P_fi[(a * D + b) * out.cs] = P[a][b];
  }
}

// One filter step of an EB form from the filtered state (m, P) of the
// previous step, measurement y[0 .. E); writes the five streams through
// `out` and leaves this step's filtered state in (m, P): vf_step with
// E = p.base.dim_out <= EB read at run time.
template <int D, int EB, class Dyn, class Obs>
VF_HD void vfg_step(const VfgParams& p, double (&m)[D], double (&P)[D][D], const double (&y)[EB],
                    const Dyn& dyn, const Obs& obs, double* scratch, long long ss,
                    const VfOut& out) {
  const int E = p.base.dim_out;
  double L[D][D], m_pr[D], P_pr[D][D];
  vfg_predict(p, m, P, dyn, scratch, ss, out, m_pr, P_pr);
  double y_pr[EB], S[EB][EB], C[EB][D];
  vf_chol(P_pr, L);
  vfg_moments<D, EB>(p.base.obs, E, m_pr, L, obs, scratch, ss, y_pr, S, C);
#pragma unroll
  for (int a = 0; a < EB; ++a) {
#pragma unroll
    for (int b = 0; b < EB; ++b)
      if (a < E && b < E) S[a][b] = S[a][b] + p.r[a * E + b];
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
  vfg_store_P(P, out);
}

// Doubles a trajectory of the scratch buffer: the function values of every
// point of a transform, max(n_dyn D, n_obs E), and for the wide form the
// E-sized arrays after them (vfg_step_wide), 2 E + 2 E^2 + 4 D E more.
// ops/vector_filter.py (_scratch) sizes the buffer by the same count.
VF_HD long long vfg_values(const VfParams& q) {
  const long long a = static_cast<long long>(q.dyn.n) * q.dim_state;
  const long long b = static_cast<long long>(q.obs.n) * q.dim_out;
  return a > b ? a : b;
}

// One filter step of the wide form, any E = p.base.dim_out: vfg_step with
// every E-sized array in the scratch buffer after the nf function values
// (columns mu (E), S and Ls (E x E), C (E x D), K and T (D x E), and for a BQ
// rule g (E) and h (E x D), each entry i at scratch[(nf + offset + i) * ss]),
// loops over E at run time, every sum in the same order.  Measurement e at
// y[e * y_e].
template <int D, class Dyn, class Obs>
VF_HD void vfg_step_wide(const VfgParams& p, double (&m)[D], double (&P)[D][D], const double* y,
                         long long y_e, const Dyn& dyn, const Obs& obs, double* scratch,
                         long long ss, long long nf, const VfOut& out) {
  const int E = p.base.dim_out;
  const VfRule& R = p.base.obs;
  const int n = R.n;
  double L[D][D], m_pr[D], P_pr[D][D];
  vfg_predict(p, m, P, dyn, scratch, ss, out, m_pr, P_pr);
  vf_chol(P_pr, L);
  const long long EE = static_cast<long long>(E) * E, DE = static_cast<long long>(D) * E;
  const VfgCol F{scratch, ss}, mu{scratch + nf * ss, ss};
  const VfgCol S{mu.p + E * ss, ss}, Ls{S.p + EE * ss, ss}, C{Ls.p + EE * ss, ss};
  const VfgCol K{C.p + DE * ss, ss}, T{K.p + DE * ss, ss}, g{T.p + DE * ss, ss};
  const VfgCol h{g.p + E * ss, ss};
  // the moments of the measurement, vfg_moments' sums
#pragma unroll 1
  for (int e = 0; e < E; ++e) mu[e] = 0.0;
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    double dx[D], x[D];
    vf_offset(R, L, j, dx);
#pragma unroll
    for (int a = 0; a < D; ++a) x[a] = m_pr[a] + dx[a];
    obs(x, VfgCol{F.p + static_cast<long long>(j) * E * ss, ss});
    const double w = VF_LDG(R.wm + j);
#pragma unroll 1
    for (int e = 0; e < E; ++e) mu[e] = mu[e] + w * F[static_cast<long long>(j) * E + e];
  }
#pragma unroll 1
  for (int a = 0; a < E; ++a) {
#pragma unroll 1
    for (int b = 0; b <= a; ++b) S[a * E + b] = 0.0;
#pragma unroll
    for (int c = 0; c < D; ++c) C[a * D + c] = 0.0;
  }
  if (R.kind == 0) {
#pragma unroll 1
    for (int j = 0; j < n; ++j) {
      double dx[D];
      vf_offset(R, L, j, dx);
      const double w = VF_LDG(R.wc + j);
      const long long fj = static_cast<long long>(j) * E;
#pragma unroll 1
      for (int a = 0; a < E; ++a) {
        const double da = F[fj + a] - mu[a];
#pragma unroll 1
        for (int b = 0; b <= a; ++b) S[a * E + b] = S[a * E + b] + w * (da * (F[fj + b] - mu[b]));
#pragma unroll
        for (int c = 0; c < D; ++c) C[a * D + c] = C[a * D + c] + w * (da * dx[c]);
      }
    }
  } else {
#pragma unroll 1
    for (int e = 0; e < E; ++e) {
#pragma unroll
      for (int c = 0; c < D; ++c) h[e * D + c] = 0.0;
    }
#pragma unroll 1
    for (int i = 0; i < n; ++i) {
      const long long fi = static_cast<long long>(i) * E;
#pragma unroll 1
      for (int e = 0; e < E; ++e) g[e] = 0.0;
#pragma unroll 1
      for (int j = 0; j < n; ++j) {
        const double w = VF_LDG(R.Wc + static_cast<long long>(i) * n + j);
        const long long fj = static_cast<long long>(j) * E;
#pragma unroll 1
        for (int e = 0; e < E; ++e) g[e] = g[e] + w * F[fj + e];
      }
#pragma unroll 1
      for (int a = 0; a < E; ++a) {
        const double fa = F[fi + a];
#pragma unroll 1
        for (int b = 0; b <= a; ++b) S[a * E + b] = S[a * E + b] + fa * g[b];
      }
#pragma unroll
      for (int c = 0; c < D; ++c) {
        const double w = VF_LDG(R.Wcc + c * n + i);
#pragma unroll 1
        for (int e = 0; e < E; ++e) h[e * D + c] = h[e * D + c] + w * F[fi + e];
      }
    }
#pragma unroll 1
    for (int a = 0; a < E; ++a) {
#pragma unroll 1
      for (int b = 0; b <= a; ++b) S[a * E + b] = S[a * E + b] - mu[a] * mu[b];
      S[a * E + a] = S[a * E + a] + R.emv;
    }
    // cross = h L^T, from 0.0 upwards over the lower triangle of L
#pragma unroll 1
    for (int e = 0; e < E; ++e) {
#pragma unroll
      for (int c = 0; c < D; ++c) {
        double acc = 0.0;
#pragma unroll
        for (int a = 0; a <= c; ++a) acc = acc + h[e * D + a] * L[c][a];
        C[e * D + c] = acc;
      }
    }
  }
  // S: the covariance mirrored from its lower triangle, plus R (row a's
  // upper entries read rows below a, not yet written)
#pragma unroll 1
  for (int a = 0; a < E; ++a) {
#pragma unroll 1
    for (int b = 0; b < E; ++b)
      S[a * E + b] = (b <= a ? S[a * E + b] : S[b * E + a]) + p.r[a * E + b];
  }
  // Ls: vfg_chol's recurrence on the lower triangle
#pragma unroll 1
  for (int i = 0; i < E; ++i) {
#pragma unroll 1
    for (int j = 0; j <= i; ++j) {
      double s = S[i * E + j];
#pragma unroll 1
      for (int k = 0; k < j; ++k) s = s - Ls[i * E + k] * Ls[j * E + k];
      Ls[i * E + j] = i == j ? sqrt(s) : s / Ls[j * E + j];
    }
  }
  // K[d] = S^-1 C[:, d]: forward substitution into K[d], then backward in
  // place (entry i of the backward pass reads z[i] before it writes K[d][i])
#pragma unroll
  for (int d = 0; d < D; ++d) {
#pragma unroll 1
    for (int i = 0; i < E; ++i) {
      double s = C[i * D + d];
#pragma unroll 1
      for (int k = 0; k < i; ++k) s = s - Ls[i * E + k] * K[d * E + k];
      K[d * E + i] = s / Ls[i * E + i];
    }
#pragma unroll 1
    for (int i = E - 1; i >= 0; --i) {
      double s = K[d * E + i];
#pragma unroll 1
      for (int k = i + 1; k < E; ++k) s = s - Ls[k * E + i] * K[d * E + k];
      K[d * E + i] = s / Ls[i * E + i];
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) {
    double acc = m_pr[d];
#pragma unroll 1
    for (int e = 0; e < E; ++e) acc = acc + K[d * E + e] * (y[e * y_e] - mu[e]);
    m[d] = acc;
    out.m_fi[d * out.cs] = acc;
#pragma unroll 1
    for (int e = 0; e < E; ++e) {
      double t = 0.0;
#pragma unroll 1
      for (int e2 = 0; e2 < E; ++e2) t = t + K[d * E + e2] * S[e2 * E + e];
      T[d * E + e] = t;
    }
  }
#pragma unroll
  for (int a = 0; a < D; ++a) {
#pragma unroll
    for (int b = 0; b <= a; ++b) {
      double acc = 0.0;
#pragma unroll 1
      for (int e = 0; e < E; ++e) acc = acc + T[a * E + e] * K[b * E + e];
      P[a][b] = P_pr[a][b] - acc;
      P[b][a] = P[a][b];
    }
  }
  vfg_store_P(P, out);
}

// A whole record of one trajectory (vf_record's layouts): T steps from the
// initial moments of p, measurement e of step k at y[e * y_e + k * y_k], the
// transition's n_s stream values of step k at s[k * n_s]; the models of
// Model, the step of EB (0: the wide form).
template <int D, int EB, class Model>
VF_HD void vfg_record(const VfgParams& p, const double* y, long long y_e, long long y_k, int T,
                      const double* s, int n_s, double* scratch, long long ss, double* m_fi,
                      double* P_fi, double* m_pr, double* P_pr, double* xx, long long cs) {
  const VfParams& q = p.base;
  const long long nf = vfg_values(q);
  double m[D], P[D][D];
#pragma unroll
  for (int a = 0; a < D; ++a) {
    m[a] = q.m0[a];
#pragma unroll
    for (int b = 0; b < D; ++b) P[a][b] = q.P0[a * VF_MAX_DIM + b];
  }
#pragma unroll 1
  for (int k = 0; k < T; ++k) {
    const long long v = static_cast<long long>(k) * D * cs, M = v * D;
    const VfOut out = {m_fi + v, P_fi + M, m_pr + v, P_pr + M, xx + M, cs};
    const double* sk = s + static_cast<long long>(k) * n_s;
    if constexpr (EB == 0) {
      vfg_step_wide<D>(p, m, P, y + k * y_k, y_e, Model::dyn(p, sk), Model::obs(p), scratch, ss,
                       nf, out);
    } else {
      double yk[EB];
#pragma unroll
      for (int e = 0; e < EB; ++e) yk[e] = e < q.dim_out ? y[e * y_e + k * y_k] : 0.0;
      vfg_step<D, EB>(p, m, P, yk, Model::dyn(p, sk), Model::obs(p), scratch, ss, out);
    }
  }
}

// The bound EB of the step that runs E measurement outputs: 2, 4 or 8, and
// 0 (the wide form) above 8.
VF_HD int vfg_bound(int E) { return E <= 2 ? 2 : E <= 4 ? 4 : E <= 8 ? 8 : 0; }

// Whether the rules of p can run: kinds 0 or 1, at least one point each.
VF_HD bool vfg_rules_ok(const VfParams& q) {
  return q.dyn.n >= 1 && q.obs.n >= 1 && ((q.dyn.kind | q.obs.kind) >> 1) == 0;
}

// The instantiations of the table's models: D of the transitions, EB the
// bound on E that holds it (0: the wide form, bearings from more than 8
// sensors).
#define VFG_SHAPES(F)                                                                   \
  F(2, 2) F(2, 4) F(2, 8) F(2, 0) F(3, 2) F(3, 4) F(3, 8) F(3, 0) F(4, 2) F(4, 4) F(4, 8) \
  F(4, 0) F(5, 2) F(5, 4) F(5, 8) F(5, 0)

// Whether the step of the table's models takes p: a transition of the table
// (its D), a measurement of the table (E = 2 for the radar, any E >= 1 for
// the bearings, 1 for the others) and rules that can run.
inline bool vfg_takes(const VfParams& q) {
  static const int dims[] = {5, 4, 2, 3, 5};  // by VF_DYN_* id
  if (q.dyn_model < 0 || q.dyn_model > VF_DYN_CT || dims[q.dyn_model] != q.dim_state) return false;
  if (q.obs_model < 0 || q.obs_model > VF_OBS_UNGM || q.dim_out < 1) return false;
  const int E = q.dim_out;
  if ((q.obs_model == VF_OBS_RADAR && E != 2) ||
      (q.obs_model != VF_OBS_RADAR && q.obs_model != VF_OBS_BEARING && E != 1))
    return false;
  return vfg_rules_ok(q);
}

#ifdef __CUDACC__
// 64 threads a block, as the first version.
constexpr int kVfgThreads = 64;

struct VfgStreams {
  double *m_fi, *P_fi, *m_pr, *P_pr, *xx;
};

// The general kernel: one thread a trajectory, the models of Model.
template <int D, int EB, class Model>
__global__ void __launch_bounds__(kVfgThreads)
vector_filter_general_kernel(const __grid_constant__ VfgParams p, const double* __restrict__ y,
                             long long y_b, long long y_e, long long y_k,
                             const double* __restrict__ s, int n_s, int B, int n_steps,
                             const VfgStreams out, double* __restrict__ scratch) {
  const long long b = static_cast<long long>(blockIdx.x) * kVfgThreads + threadIdx.x;
  if (b >= B) return;
  vfg_record<D, EB, Model>(p, y + b * y_b, y_e, y_k, n_steps, s, n_s, scratch + b, B,
                           out.m_fi + b, out.P_fi + b, out.m_pr + b, out.P_pr + b, out.xx + b, B);
}

template <int D, int EB, class Model>
void vfg_launch_as(const VfgParams& p, const double* y, long long y_b, long long y_e,
                   long long y_k, const double* s, int n_s, int B, int n_steps,
                   const VfgStreams& out, double* scratch, cudaStream_t stream) {
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(B) + kVfgThreads - 1) /
                                                kVfgThreads);
  vector_filter_general_kernel<D, EB, Model><<<blocks, kVfgThreads, 0, stream>>>(
      p, y, y_b, y_e, y_k, s, n_s, B, n_steps, out, scratch);
}
#endif
