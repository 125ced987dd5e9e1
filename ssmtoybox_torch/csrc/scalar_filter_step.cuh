// One step of the scalar sigma-point filter for the univariate nonlinear
// growth model (UNGM), in native float64.
//
// Shared by the CUDA kernel (scalar_filter.cu) and a host shim
// (scalar_filter_host.cpp) that g++ builds so the CPU tests can hold this
// exact code against the PyTorch twin in ssmtoybox_torch/ops/scalar_filter.py.
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
// with the dense weights Wc (row-major n x n), cross weights wcc and the
// expected model variance emv.
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

SF_HD double sf_ungm_dyn(double x, double c) {
  return 0.5 * x + 25.0 * (x / (1.0 + x * x)) + c;
}

SF_HD double sf_ungm_obs(double x) { return 0.05 * (x * x); }

// Moments of the n function values fs at points m + L xi_i under rule R:
// mean mu, variance var and cross-covariance cross with the input.
SF_HD void sf_moments(const SfRule& R, double L, const double* fs,
                      double* mu, double* var, double* cross) {
  double m = 0.0;
  SF_UNROLL
  for (int i = 0; i < SF_MAX_PTS; ++i)
    if (i < R.n) m += R.wm[i] * fs[i];
  double v = 0.0, c = 0.0;
  if (R.kind == 0) {
    SF_UNROLL
    for (int i = 0; i < SF_MAX_PTS; ++i) {
      if (i < R.n) {
        const double d = fs[i] - m;
        v += R.wc[i] * (d * d);
        c += R.wc[i] * ((L * R.xi[i]) * d);
      }
    }
  } else {
    double q = 0.0, s = 0.0;
    SF_UNROLL
    for (int i = 0; i < SF_MAX_PTS; ++i) {
      if (i < R.n) {
        double row = 0.0;
        SF_UNROLL
        for (int j = 0; j < SF_MAX_PTS; ++j)
          if (j < R.n) row += R.Wc[i * SF_MAX_PTS + j] * fs[j];
        q += fs[i] * row;
        s += R.wcc[i] * fs[i];
      }
    }
    v = q - m * m + R.emv;
    c = s * L;
  }
  *mu = m;
  *var = v;
  *cross = c;
}

// One filter step from the filtered state (m, P) of the previous step, with
// measurement y and the dynamics constant c of this step.
SF_HD SfStep sf_step(const SfParams& p, double m, double P, double y, double c) {
  SfStep s;
  double fs[SF_MAX_PTS] = {};
  const double L = sqrt(P);
  SF_UNROLL
  for (int i = 0; i < SF_MAX_PTS; ++i)
    if (i < p.dyn.n) fs[i] = sf_ungm_dyn(m + L * p.dyn.xi[i], c);
  double Pf;
  sf_moments(p.dyn, L, fs, &s.m_pr, &Pf, &s.xx);
  s.P_pr = Pf + p.gqg;

  const double L2 = sqrt(s.P_pr);
  SF_UNROLL
  for (int i = 0; i < SF_MAX_PTS; ++i)
    if (i < p.obs.n) fs[i] = sf_ungm_obs(s.m_pr + L2 * p.obs.xi[i]);
  double y_pr, S0, C;
  sf_moments(p.obs, L2, fs, &y_pr, &S0, &C);
  const double S = S0 + p.r;
  const double K = C / S;
  s.m_fi = s.m_pr + K * (y - y_pr);
  s.P_fi = s.P_pr - (K * K) * S;
  return s;
}
