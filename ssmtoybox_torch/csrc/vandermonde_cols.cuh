// One entry of the Vandermonde matrix of multivariate monomials,
//   vdm[n, b] = prod_d x[d, n] ^ e[d, b],
// in float64, by repeated multiplication in a fixed order:
//   col = 1; for d: { p = 1; for i < e_d: p *= x_d; col *= p; }
//
// Shared by the CUDA kernel (vandermonde.cu) and a host shim
// (vandermonde_host.cpp) that g++ builds, so the CPU tests hold this exact
// code against the plain PyTorch version in ssmtoybox_torch/ops/vandermonde.py,
// which multiplies in the same order.  Products alone leave a compiler
// nothing to contract into multiply-adds, so all three agree to the bit.
#pragma once

#ifdef __CUDACC__
#define VDM_HD __host__ __device__ __forceinline__
#else
#define VDM_HD inline
#endif

// x: the point's D coordinates, x_stride apart.  e: the column's D
// exponents, e_stride apart.
VDM_HD double vdm_entry(const double* x, long long x_stride, const int* e, int e_stride,
                        int D) {
  double col = 1.0;
  for (int d = 0; d < D; ++d) {
    const double xd = x[d * x_stride];
    const int ed = e[d * e_stride];
    double p = 1.0;
    for (int i = 0; i < ed; ++i) p *= xd;
    col *= p;
  }
  return col;
}
