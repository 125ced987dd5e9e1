// Host build of the Vandermonde entry (vandermonde_cols.cuh), for testing the
// kernel's per-element arithmetic on a machine without a GPU.  Same layouts
// as the CUDA kernel: x (D, N), mul (D, Q), out (N, Q), all row-major.
#include "vandermonde_cols.cuh"

extern "C" void vdm_host_run(const double* x, const int* mul, int D, long long N, int Q,
                             double* out) {
  for (long long n = 0; n < N; ++n)
    for (int b = 0; b < Q; ++b) out[n * Q + b] = vdm_entry(x + n, N, mul + b, Q, D);
}
