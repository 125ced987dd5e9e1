// The columns of one point of the Vandermonde matrix of multivariate
// monomials,
//   vdm[n, b] = prod_d x[d, n] ^ e[d, b],
// in float64, by repeated multiplication in a fixed order:
//   col = 1; for d: { p = 1; for i < e_d: p *= x_d; col *= p; }
//
// Shared by the CUDA kernel (vandermonde.cu) and a host shim
// (vandermonde_host.cpp) that g++ builds, so the CPU tests hold this exact
// code against the plain PyTorch version in ssmtoybox_torch/ops/vandermonde.py,
// which multiplies in the same order.  Products alone leave a compiler
// nothing to contract into multiply-adds, so all three agree to the bit.
//
// A point's D coordinates are read once (vdm_load) and stay in registers
// while its columns are walked: D is a template argument up to VDM_MAX_REG_D,
// so the array is never indexed by a run-time value.  The exponents come
// through a functor e(d, b), which lets the kernel read them from its
// parameters or from shared memory and the host from a plain array.
#pragma once

#ifdef __CUDACC__
#define VDM_HD __host__ __device__ __forceinline__
#define VDM_UNROLL _Pragma("unroll")
#else
#define VDM_HD inline
#define VDM_UNROLL
#endif

// Largest D whose coordinates are held in registers; above it (D = 0 as the
// template argument) the coordinates are read again for every column.
#define VDM_MAX_REG_D 8

// The coordinates of a point: D registers, or for D = 0 where to read them.
template <int D>
struct VdmPoint {
  double x[D];
  VDM_HD void load(const double* px, long long stride, int) {
    VDM_UNROLL
    for (int d = 0; d < D; ++d) x[d] = px[d * stride];
  }
  VDM_HD double coord(int d) const { return x[d]; }
  VDM_HD int dim() const { return D; }
};

template <>
struct VdmPoint<0> {
  const double* px;
  long long stride;
  int D;
  VDM_HD void load(const double* px_, long long stride_, int D_) {
    px = px_;
    stride = stride_;
    D = D_;
  }
  VDM_HD double coord(int d) const { return px[d * stride]; }
  VDM_HD int dim() const { return D; }
};

// Column b of the point: e(d, b) is the exponent of coordinate d.
template <int D, class Exponents>
VDM_HD double vdm_entry(const VdmPoint<D>& pt, const Exponents& e, int b) {
  double col = 1.0;
  const int dim = pt.dim();
  VDM_UNROLL
  for (int d = 0; d < dim; ++d) {
    const double xd = pt.coord(d);
    const int ed = e(d, b);
    double p = 1.0;
    for (int i = 0; i < ed; ++i) p *= xd;
    col *= p;
  }
  return col;
}

// Exponents in a (D, Q) row-major int array.
struct VdmExponents {
  const int* e;
  int Q;
  VDM_HD int operator()(int d, int b) const { return e[d * Q + b]; }
};
