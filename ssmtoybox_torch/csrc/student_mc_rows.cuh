// Per-element math of the RBF-Student Monte-Carlo kernels, in float32.
//
// Shared by the CUDA kernels (student_mc.cu) and a host shim
// (student_mc_host.cpp) that g++ builds so the CPU tests can hold this exact
// code against the plain PyTorch versions in ssmtoybox_torch/ops/student_mc.py.
//
// Notation: samples x_s (raw, D-vectors), points p_n (raw), inverse
// lengthscales inv_l; scaled vectors s = x * inv_l.  The Gram value is the
// TPU kernels' expanded form
//     k(s, p) = exp(-0.5 (|s|^2 + |p|^2) + s . p)
// so that the sample-sample diagonal is exp(0) = 1 exactly.
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
#define SMC_ROWS 128           // rows of a pairwise block (a power of two)

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

// Row r of a chunk's sample-sample Gram: returns sum_c k(r, c) over the C
// samples of the chunk (s: C x D scaled, s2: C squared norms).  With kx not
// null it also sums kx[d] = sum_c k(r, c) x[c, d] over the raw samples x.
SMC_HD float smc_kxy_row(int r, int C, int D, const float* s, const float* s2,
                         const float* x, float* kx) {
  float rs = 0.f;
  if (kx)
    for (int d = 0; d < D; ++d) kx[d] = 0.f;
  for (int c = 0; c < C; ++c) {
    const float k = smc_gram(s + r * D, s + c * D, s2[r], s2[c], D);
    rs += k;
    if (kx)
      for (int d = 0; d < D; ++d) kx[d] += k * x[c * D + d];
  }
  return rs;
}
