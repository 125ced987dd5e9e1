// Host build of the Vandermonde point routine (vandermonde_cols.cuh), for
// testing the kernel's per-point arithmetic on a machine without a GPU.  Same
// layouts as the CUDA kernel: x (D, N), mul (D, Q), out (N, Q), all row-major;
// the same choice between coordinates in registers (D <= VDM_MAX_REG_D) and
// coordinates read again for every column.
#include "vandermonde_cols.cuh"

namespace {

template <int D>
void run(const double* x, const int* mul, int dim, long long N, int Q, double* out) {
  for (long long n = 0; n < N; ++n) {
    VdmPoint<D> pt;
    pt.load(x + n, N, dim);
    for (int b = 0; b < Q; ++b) out[n * Q + b] = vdm_entry(pt, VdmExponents{mul, Q}, b);
  }
}

}  // namespace

extern "C" void vdm_host_run(const double* x, const int* mul, int D, long long N, int Q,
                             double* out) {
  switch (D <= VDM_MAX_REG_D ? D : 0) {
#define VDM_CASE(DIM) case DIM: return run<DIM>(x, mul, D, N, Q, out);
    VDM_CASE(1) VDM_CASE(2) VDM_CASE(3) VDM_CASE(4) VDM_CASE(5) VDM_CASE(6) VDM_CASE(7)
    VDM_CASE(8)
#undef VDM_CASE
    default: return run<0>(x, mul, D, N, Q, out);
  }
}
