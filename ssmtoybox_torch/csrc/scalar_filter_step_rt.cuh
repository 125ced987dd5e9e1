// The scalar filter step with the rule's shape read at run time: every loop
// runs SF_MAX_PTS predicated iterations and both kinds of moments are
// compiled in.  One thread a trajectory ran this step until the shapes became
// template arguments (scalar_filter_step.cuh); it is kept, under the macro
// SF_RUNTIME_SHAPE of scalar_filter.cu, so that tools/sf_variants.py can time
// what the compile-time shapes and the lanes bought.  Same arithmetic in the
// same order: it too agrees with the twin to the bit.
#pragma once

#include "scalar_filter_step.cuh"

// Moments of the n function values fs at points m + L xi_i under rule R:
// mean mu, variance var and cross-covariance cross with the input.
SF_HD void sf_moments_rt(const SfRule& R, double L, const double* fs,
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
SF_HD SfStep sf_step_rt(const SfParams& p, double m, double P, double y, double c) {
  SfStep s;
  double fs[SF_MAX_PTS] = {};
  const double L = sqrt(P);
  SF_UNROLL
  for (int i = 0; i < SF_MAX_PTS; ++i)
    if (i < p.dyn.n) fs[i] = sf_ungm_dyn(m + L * p.dyn.xi[i], c);
  double Pf;
  sf_moments_rt(p.dyn, L, fs, &s.m_pr, &Pf, &s.xx);
  s.P_pr = Pf + p.gqg;

  const double L2 = sqrt(s.P_pr);
  SF_UNROLL
  for (int i = 0; i < SF_MAX_PTS; ++i)
    if (i < p.obs.n) fs[i] = sf_ungm_obs(s.m_pr + L2 * p.obs.xi[i]);
  double y_pr, S0, C;
  sf_moments_rt(p.obs, L2, fs, &y_pr, &S0, &C);
  const double S = S0 + p.r;
  const double K = C / S;
  s.m_fi = s.m_pr + K * (y - y_pr);
  s.P_fi = s.P_pr - (K * K) * S;
  return s;
}
