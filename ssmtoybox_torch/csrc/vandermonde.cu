// Vandermonde matrix of multivariate monomials for Hopper (sm_90a), float64.
//
// Replaces the TPU kernel ssmtoybox_tpu/ops/pallas_ops.py::_vandermonde_kernel
// (via pallas_ops.vandermonde), which unrolls a static multi-index over one
// VMEM block in float32 because Mosaic has no f64 ALU; the library's BSQ code
// therefore called the exact f64 jnp version instead.  The card has native
// f64, so this one kernel computes exactly what utils/combin.py::vandermonde
// computes, and BayesSardModel runs it for every weight build and in the
// Monte-Carlo verifiers.
//
// What bounds it on this card: the bytes written.  It reads D * N * 8 B and
// writes N * Q * 8 B (168 MB at N = 1e6, Q = 21) against 3.35 TB/s, and does
// at most a few f64 multiplies an output element, far under the f64 rate.
// So the design is about full-width memory transactions and nothing else.
//
// Design: one thread a point, one block a tile of points.
// - A thread loads its point's D coordinates once, neighbouring threads
//   reading neighbouring n of each row of x, and keeps them in registers
//   (D a template argument up to 8) while it walks the Q columns.
// - Every thread of a warp is at the same column, so the exponent e[d, b] is
//   uniform over the warp: the power loop has one trip count and never
//   diverges, and no index is divided.  A small multi-index (D * Q <=
//   VDM_VALUE_INTS, every study's) travels by value in the kernel's
//   parameters and is read from the constant bank, with nothing copied to the
//   card; a larger one is staged from device memory into shared memory.
// - A thread's row of Q doubles is Q * 8 bytes from its neighbour's, so the
//   block first puts its tile (rows x Q) into shared memory, rows an odd
//   number of doubles apart (no bank is hit twice), and then writes it out as
//   what it is in `out`: one contiguous span, neighbouring threads storing
//   neighbouring doubles.  Q > kCols goes kCols columns at a time; a span is
//   then kCols doubles a row.  The position in the tile advances by a fixed
//   step with a carry, not by a division.
// - Where the tile already lies in shared memory as it will in `out` (Q odd,
//   so rows are Q doubles apart, and at most kCols), one thread hands the
//   whole span to an asynchronous bulk copy from shared to device memory
//   (cp.async.bulk: 16-byte aligned at both ends when rows * Q is even) and
//   no thread issues a store: 0.079 against 0.090 ms at 5 x 1e6, Q = 21 on an
//   H100, the same from 1e5 points down (tools/vdm_variants.py).  Even Q, a
//   ragged last tile of odd size and column tiles take the loop;
//   VDM_BULK_STORE=0 makes every tile take it, for measurement.
// - Few points leave most of the card idle and a thread with all Q columns
//   to walk alone.  Below kSplitBelow points a block therefore takes a
//   quarter of the points and its four warps a quarter of the columns each
//   (a warp still walks one column at a time, so nothing diverges);
//   VDM_COL_GROUPS=1|2|4 fixes the split for measurement.  A matrix of at
//   most kRows entries (the weight shapes: 3 x 3 to 11 x 11) is one thread an
//   entry, stored straight to `out`: no tile, no barrier.
#include <cuda_runtime.h>

#include "vandermonde_cols.cuh"

#ifndef VDM_BULK_STORE
#define VDM_BULK_STORE 1
#endif

// Most exponents that travel by value: 512 bytes of the parameters.
#define VDM_VALUE_INTS 128

struct VdmIndex {
  int e[VDM_VALUE_INTS];
};

namespace {

// Exponents in the kernel's parameters (the constant bank).
struct ByValue {
  const VdmIndex& idx;
  int Q;
  __device__ __forceinline__ int operator()(int d, int b) const { return idx.e[d * Q + b]; }
};

constexpr int kRows = 128;  // threads a block: a point each, or 32 points by 4 column groups
constexpr int kCols = 32;   // most columns of a tile
constexpr long long kSplitBelow = 2 * 132 * kRows;  // points that give every SM two blocks
// distance of two rows of a tile of `cols` columns, in doubles: odd
__host__ __device__ constexpr int row_stride(int cols) { return cols | 1; }

template <int D, bool BY_VALUE>
__global__ void __launch_bounds__(kRows)
vandermonde_kernel(const double* __restrict__ x, const __grid_constant__ VdmIndex idx,
                   const int* __restrict__ mul, int dim, long long N, int Q, int col_groups,
                   double* __restrict__ out) {
  extern __shared__ __align__(16) double tile[];
  const int cols = Q < kCols ? Q : kCols;
  const int qs = row_stride(cols);
  int* const s_mul = reinterpret_cast<int*>(tile + kRows * qs);
  if constexpr (!BY_VALUE) {
    for (int i = threadIdx.x; i < dim * Q; i += kRows) s_mul[i] = mul[i];
    __syncthreads();
  }
  if (N * Q <= kRows) {  // a thread an entry; the launcher sends one block
    const int t = threadIdx.x;
    if (t < N * Q) {
      const int n = t / Q;
      VdmPoint<D> pt;
      pt.load(x + n, N, dim);
      if constexpr (BY_VALUE) {
        out[t] = vdm_entry(pt, ByValue{idx, Q}, t - n * Q);
      } else {
        out[t] = vdm_entry(pt, VdmExponents{s_mul, Q}, t - n * Q);
      }
    }
    return;
  }
  const int tile_rows = kRows / col_groups;  // whole warps: col_groups is 1, 2 or 4
  const long long n0 = static_cast<long long>(blockIdx.x) * tile_rows;
  const int rows = N - n0 < tile_rows ? static_cast<int>(N - n0) : tile_rows;
  const int t = threadIdx.x;
  const int r = t % tile_rows, group = t / tile_rows;
  VdmPoint<D> pt;
  pt.load(x + n0 + (r < rows ? r : rows - 1), N, dim);

  for (int q0 = 0; q0 < Q; q0 += kCols) {
    const int qc = Q - q0 < kCols ? Q - q0 : kCols;
    if (r < rows) {
      for (int b = group; b < qc; b += col_groups) {
        if constexpr (BY_VALUE) {
          tile[r * qs + b] = vdm_entry(pt, ByValue{idx, Q}, q0 + b);
        } else {
          tile[r * qs + b] = vdm_entry(pt, VdmExponents{s_mul, Q}, q0 + b);
        }
      }
    }
#if VDM_BULK_STORE
    // every thread's writes to the tile must be ordered before the bulk copy
    // reads it (another proxy): fence, then meet
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
#endif
    __syncthreads();
    double* const span = out + n0 * Q + q0;
#if VDM_BULK_STORE
    // the tile is one span of rows * Q doubles here and there: 16-byte aligned
    // at both ends when rows * Q is even (n0 * Q is: n0 is a multiple of 32)
    if (qc == Q && qs == Q && ((rows * Q) & 1) == 0) {
      if (t == 0) {
        const unsigned src = static_cast<unsigned>(__cvta_generic_to_shared(tile));
        const unsigned bytes = static_cast<unsigned>(rows) * Q * 8u;
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
                     :: "l"(span), "r"(src), "r"(bytes) : "memory");
        asm volatile("cp.async.bulk.commit_group;" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      }
    } else
#endif
    {
      // element i of the tile, row-major: (ri, bi); i advances by kRows
      const int dr = kRows / qc, db = kRows - dr * qc;
      int ri = t / qc, bi = t - ri * qc;
      for (int i = t; i < rows * qc; i += kRows) {
        span[static_cast<long long>(ri) * Q + bi] = tile[ri * qs + bi];
        ri += dr;
        bi += db;
        if (bi >= qc) {
          bi -= qc;
          ++ri;
        }
      }
    }
    __syncthreads();
  }
}

template <int D>
cudaError_t launch(const double* x, const int* mul_host, const int* mul_dev, int dim,
                   long long N, int Q, double* out, cudaStream_t stream) {
#ifdef VDM_COL_GROUPS
  const int col_groups = VDM_COL_GROUPS;
#else
  const int col_groups = N < kSplitBelow ? 4 : 1;
#endif
  const int tile_rows = kRows / col_groups;
  const unsigned blocks =
      N * Q <= kRows ? 1u : static_cast<unsigned>((N + tile_rows - 1) / tile_rows);
  const int cols = Q < kCols ? Q : kCols;
  size_t smem = static_cast<size_t>(kRows) * row_stride(cols) * sizeof(double);
  if (mul_host != nullptr) {
    VdmIndex idx = {};
    for (int i = 0; i < dim * Q; ++i) idx.e[i] = mul_host[i];
    vandermonde_kernel<D, true><<<blocks, kRows, smem, stream>>>(x, idx, nullptr, dim, N, Q,
                                                                 col_groups, out);
  } else {
    smem += static_cast<size_t>(dim) * Q * sizeof(int);
    if (smem > 48 * 1024) {  // above 48 KB a kernel has to ask
      const cudaError_t err = cudaFuncSetAttribute(
          vandermonde_kernel<D, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    vandermonde_kernel<D, false><<<blocks, kRows, smem, stream>>>(x, VdmIndex{}, mul_dev, dim,
                                                                  N, Q, col_groups, out);
  }
  return cudaGetLastError();
}

}  // namespace

// Launch on `stream` of card `device` without synchronising.  x is (D, N)
// row-major f64, out (N, Q) row-major f64.  The (D, Q) row-major int32
// multi-index comes either as mul_host, a host array of at most
// VDM_VALUE_INTS entries that goes by value, or (mul_host null) as mul_dev in
// device memory, at most 48 KB.  Returns the CUDA error of selecting the
// device or, after the launch, cudaGetLastError().
extern "C" int vdm_launch(const double* x, const int* mul_host, const int* mul_dev, int D,
                          long long N, int Q, int device, double* out, void* stream) {
  if (N <= 0 || Q <= 0) return 0;
  if (mul_host != nullptr ? D * Q > VDM_VALUE_INTS : mul_dev == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: select the tensors' card explicitly
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D <= VDM_MAX_REG_D ? D : 0) {
#define VDM_CASE(DIM) \
  case DIM: return static_cast<int>(launch<DIM>(x, mul_host, mul_dev, D, N, Q, out, s));
    VDM_CASE(1) VDM_CASE(2) VDM_CASE(3) VDM_CASE(4) VDM_CASE(5) VDM_CASE(6) VDM_CASE(7)
    VDM_CASE(8)
#undef VDM_CASE
    default: return static_cast<int>(launch<0>(x, mul_host, mul_dev, D, N, Q, out, s));
  }
}

extern "C" const char* vdm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
