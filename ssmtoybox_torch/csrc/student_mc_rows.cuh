// Per-element math of the RBF-Student Monte-Carlo kernels, in float32.
//
// Shared by the CUDA kernels (student_mc.cu) and a host shim
// (student_mc_host.cpp) that g++ builds so the CPU tests can hold this exact
// code against the plain PyTorch versions in ssmtoybox_torch/ops/student_mc.py.
//
// Notation: samples x_s (raw, D-vectors), points p_n (raw), inverse
// lengthscales inv_l; scaled vectors s = x * inv_l.  The sample-point Gram of
// the q/R/Q kernels is the TPU kernels' expanded form
//     k(s, p) = exp(-0.5 (|s|^2 + |p|^2) + s . p).
// The sample-sample Gram of the pairwise kernels takes the difference form in
// base 2 (smc_kxy_pair): with u = s * sqrt(0.5 log2 e),
//     k(r, c) = exp2(-|u_r - u_c|^2),
// which has no cancellation; the diagonal (exactly 1) is never evaluated.
#pragma once

#include <math.h>

#ifdef __CUDACC__
#define SMC_HD __host__ __device__ __forceinline__
#else
#define SMC_HD inline
#endif

#define SMC_MAX_D 8            // largest input dimension the kernels take
#define SMC_MAX_N 128          // most points the q/R/Q kernels take
#define SMC_KXY_MAX_CHUNK 1024 // largest chunk of the pairwise kernels
#define SMC_TILE 64            // samples staged at once in the q/R/Q kernels
#define SMC_KXY_THREADS 256    // threads of a pairwise block, a SMC_KXY_GRID^2 grid
#define SMC_KXY_GRID 16        // side of that grid
#define SMC_KXY_MICRO 4        // side of a thread's micro-tile of the Gram
#define SMC_KXY_TILE 64        // side of a block's tile: SMC_KXY_GRID * SMC_KXY_MICRO
#define SMC_KXY_SCALE 0.84932180028801904272f  // sqrt(0.5 log2 e)
#define SMC_KXY_PLANES(D) (((D) + 3) / 4)      // planes of four components of a staged D-vector

// s = x * inv_l for one D-vector; returns |s|^2.
SMC_HD float smc_scale(const float* x, const float* inv_l, int D, float* s) {
  float s2 = 0.f;
  for (int d = 0; d < D; ++d) {
    s[d] = x[d] * inv_l[d];
    s2 += s[d] * s[d];
  }
  return s2;
}

// RBF value of two scaled vectors with squared norms s2 and p2.
SMC_HD float smc_gram(const float* s, const float* p, float s2, float p2, int D) {
  float dot = 0.f;
  for (int d = 0; d < D; ++d) dot += s[d] * p[d];
  return expf(-0.5f * (s2 + p2) + dot);
}

// Contribution of a tile of T samples to output o of (q, R, Q), laid out as
// q[n] (o < N), R[d, n] (o = N + d N + n), Q[i, j] (o = N + D N + i N + j).
// xs: T x D raw samples, k: T x N Gram tile.
SMC_HD float smc_qrq_term(int o, int T, int N, int D, const float* xs, const float* k) {
  float acc = 0.f;
  if (o < N) {
    for (int t = 0; t < T; ++t) acc += k[t * N + o];
  } else if (o < N + D * N) {
    const int d = (o - N) / N, n = (o - N) % N;
    for (int t = 0; t < T; ++t) acc += xs[t * D + d] * k[t * N + n];
  } else {
    const int i = (o - N - D * N) / N, j = (o - N - D * N) % N;
    for (int t = 0; t < T; ++t) acc += k[t * N + i] * k[t * N + j];
  }
  return acc;
}

// Weighted Gram of the q/R/Q backward pass for one sample:
//     M[n] = W[n] k[n],  W[n] = gq[n] + sum_d x[d] gR[d, n] + sum_m k[m] gQ2[m, n]
// (W is the coefficient of dk[n] in <g, d(q, R, Q)>; gQ2 = gQ + gQ^T).
SMC_HD float smc_bwd_m(int n, int N, int D, const float* x, const float* k,
                       const float* gq, const float* gR, const float* gQ2) {
  float w = gq[n];
  for (int d = 0; d < D; ++d) w += x[d] * gR[d * N + n];
  for (int m = 0; m < N; ++m) w += k[m] * gQ2[m * N + n];
  return w * k[n];
}

// Contribution of a tile of T samples to output o of the backward partials,
// laid out as cs[n] = sum_s M[s, n] (o < N), B[d, n] = sum_s x[s, d] M[s, n]
// (o = N + d N + n) and u[d] = sum_s x[s, d]^2 rowsum[s] (o = N + D N + d).
SMC_HD float smc_bwd_term(int o, int T, int N, int D, const float* xs, const float* M,
                          const float* rowsum) {
  float acc = 0.f;
  if (o < N) {
    for (int t = 0; t < T; ++t) acc += M[t * N + o];
  } else if (o < N + D * N) {
    const int d = (o - N) / N, n = (o - N) % N;
    for (int t = 0; t < T; ++t) acc += xs[t * D + d] * M[t * N + n];
  } else {
    const int d = o - N - D * N;
    for (int t = 0; t < T; ++t) acc += xs[t * D + d] * xs[t * D + d] * rowsum[t];
  }
  return acc;
}

// ---------------------------------------------------------------------------
// The pairwise kernels: one block of SMC_KXY_THREADS threads a chunk of C
// samples.  The chunk is staged once as u = x * scale (scale = inv_l *
// SMC_KXY_SCALE), in planes of four components so that a sample's vector is
// one 16-byte load a plane: u[d] of sample c lies at
// s[((d / 4) * CP + c) * 4 + d % 4], CP = smc_kxy_padded(C); the unused
// components and the samples C..CP-1 are 0 (they are masked, never summed).
//
// The threads form a 16 x 16 grid (ty = tid / 16, tx = tid % 16).  The chunk's
// Gram is cut into tiles of 64 x 64 entries, and only the tiles on or above
// the diagonal are visited, row of tiles by row of tiles, left to right.  In
// a tile, thread (ty, tx) owns the 4 x 4 entries (r0 + 16 i + ty, c0 + 16 j +
// tx): its 4 row vectors stay in registers along a row of tiles, a column
// vector is loaded once for 4 pairs.  In a tile on the diagonal the pair
// (i, j) has r < c if i < j (kept), or if i = j and ty < tx (masked), and is
// not evaluated at all if i > j: which of the three is known when the kernel
// is compiled.  Those tiles and the one at a ragged end of the chunk also
// mask c < C; all other tiles run without masks.
// ---------------------------------------------------------------------------

// Samples staged for a chunk of C: C rounded up to whole tiles.
SMC_HD int smc_kxy_padded(int C) {
  return (C + SMC_KXY_TILE - 1) / SMC_KXY_TILE * SMC_KXY_TILE;
}

// 2^e: the card's ex2.approx (2 ulp, 0 below 2^-126, never NaN for e <= 0).
SMC_HD float smc_exp2(float e) {
#ifdef __CUDA_ARCH__
  float k;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(k) : "f"(e));
  return k;
#else
  return exp2f(e);
#endif
}

// Stage the slots first, first + step, ... of a chunk's planes (see above)
// from its raw samples xc (C x D).
template <int D>
SMC_HD void smc_kxy_stage(const float* xc, const float* scale, int C, float* s, int first,
                          int step) {
  constexpr int W = 4 * SMC_KXY_PLANES(D);
  const int CP = smc_kxy_padded(C);
  for (int e = first; e < CP * W; e += step) {
    const int c = e / W, d = e % W;
    s[((d / 4) * CP + c) * 4 + d % 4] = (c < C && d < D) ? xc[c * D + d] * scale[d] : 0.f;
  }
}

// The staged vector of sample c (4 P floats).
template <int D>
SMC_HD void smc_kxy_load(const float* s, int CP, int c, float* v) {
#pragma unroll
  for (int p = 0; p < SMC_KXY_PLANES(D); ++p) {
#ifdef __CUDA_ARCH__
    const float4 t = *reinterpret_cast<const float4*>(s + (p * CP + c) * 4);
    v[4 * p] = t.x, v[4 * p + 1] = t.y, v[4 * p + 2] = t.z, v[4 * p + 3] = t.w;
#else
    for (int q = 0; q < 4; ++q) v[4 * p + q] = s[(p * CP + c) * 4 + q];
#endif
  }
}

// One pair of staged vectors: k = exp2(-sum_d (r_d - c_d)^2), 0 unless keep.
// Forward: acc[0] += k.  Backward: acc[d] += k (r_d - c_d)^2.
template <int D, bool BWD>
SMC_HD void smc_kxy_pair(const float* r, const float* c, bool keep, float* acc) {
  float sq[D];
  float e = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float delta = r[d] - c[d];
    sq[d] = delta * delta;
    e += sq[d];
  }
  const float k = keep ? smc_exp2(-e) : 0.f;
  if (BWD) {
#pragma unroll
    for (int d = 0; d < D; ++d) acc[d] += k * sq[d];
  } else {
    acc[0] += k;
  }
}

// The tile whose first column is c0, for the thread at (ty, tx); rows: the
// thread's 4 row vectors, acc: 4 x NA running sums.  DIAG for the tile on
// the diagonal (c0 = r0); RAGGED if the tile may reach past sample C - 1.
template <int D, bool BWD, bool DIAG, bool RAGGED>
SMC_HD void smc_kxy_tile(const float* s, int CP, int C, const float* rows, int c0, int ty,
                         int tx, float* acc) {
  constexpr int V = 4 * SMC_KXY_PLANES(D), NA = BWD ? D : 1;
#pragma unroll
  for (int j = 0; j < SMC_KXY_MICRO; ++j) {
    const int c = c0 + SMC_KXY_GRID * j + tx;
    float col[V];
    smc_kxy_load<D>(s, CP, c, col);
#pragma unroll
    for (int i = 0; i < SMC_KXY_MICRO; ++i) {
      if (DIAG && i > j) continue;
      const bool keep = (!DIAG || i < j || ty < tx) && (!RAGGED || c < C);
      smc_kxy_pair<D, BWD>(rows + V * i, col, keep, acc + NA * i);
    }
  }
}

// All pairs r < c of thread tid: out[0] = sum k (forward), out[d] = sum k
// (u_rd - u_cd)^2 (backward).  The order of the sums is fixed.
template <int D, bool BWD>
SMC_HD void smc_kxy_thread(const float* s, int C, int tid, float* out) {
  constexpr int V = 4 * SMC_KXY_PLANES(D), NA = BWD ? D : 1;
  const int CP = smc_kxy_padded(C);
  const int ty = tid / SMC_KXY_GRID, tx = tid % SMC_KXY_GRID;
  float acc[SMC_KXY_MICRO * NA];
#pragma unroll
  for (int a = 0; a < SMC_KXY_MICRO * NA; ++a) acc[a] = 0.f;
  for (int r0 = 0; r0 < C; r0 += SMC_KXY_TILE) {
    float rows[SMC_KXY_MICRO * V];
#pragma unroll
    for (int i = 0; i < SMC_KXY_MICRO; ++i)
      smc_kxy_load<D>(s, CP, r0 + SMC_KXY_GRID * i + ty, rows + V * i);
    smc_kxy_tile<D, BWD, true, true>(s, CP, C, rows, r0, ty, tx, acc);
    int c0 = r0 + SMC_KXY_TILE;
    for (; c0 + SMC_KXY_TILE <= C; c0 += SMC_KXY_TILE)
      smc_kxy_tile<D, BWD, false, false>(s, CP, C, rows, c0, ty, tx, acc);
    if (c0 < C) smc_kxy_tile<D, BWD, false, true>(s, CP, C, rows, c0, ty, tx, acc);
  }
#pragma unroll
  for (int a = 0; a < NA; ++a) {
    float v = acc[a];
#pragma unroll
    for (int i = 1; i < SMC_KXY_MICRO; ++i) v += acc[NA * i + a];
    out[a] = v;
  }
}

// A block's result from its sum over the pairs r < c.  Forward: the whole
// Gram, 2 half + C (the diagonal is exactly 1).  Backward: the sum over r < c
// of k (x_rd - x_cd)^2 from the sum in staged units, scale = scale[d].
template <bool BWD>
SMC_HD float smc_kxy_finish(float half, int C, float scale) {
  return BWD ? half / (scale * scale) : 2.f * half + static_cast<float>(C);
}
