// Host build of the scalar filter step (scalar_filter_step.cuh), for testing
// the kernel's per-thread arithmetic on a machine without a GPU.  Runs the same
// loop as the CUDA kernel, one trajectory after another; same layouts.
#include "scalar_filter_step.cuh"

extern "C" void sf_host_run(const SfParams* params, const double* y, const double* c,
                            int B, int N, double* m_fi, double* P_fi, double* m_pr,
                            double* P_pr, double* xx) {
  for (int b = 0; b < B; ++b) {
    double m = params->m0, P = params->P0;
    for (int k = 0; k < N; ++k) {
      const long o = static_cast<long>(k) * B + b;
      const SfStep s = sf_step(*params, m, P, y[o], c[k]);
      m_pr[o] = s.m_pr;
      P_pr[o] = s.P_pr;
      xx[o] = s.xx;
      m_fi[o] = s.m_fi;
      P_fi[o] = s.P_fi;
      m = s.m_fi;
      P = s.P_fi;
    }
  }
}
