// Per-element math of the RBF-Student Monte-Carlo kernels, in float32.
//
// Shared by the CUDA kernels (student_mc.cu) and a host shim
// (student_mc_host.cpp) that g++ builds so the CPU tests can hold this exact
// code against the plain PyTorch versions in ssmtoybox_torch/ops/student_mc.py.
//
// Notation: samples x_s (raw, D-vectors), points p_n (raw), inverse
// lengthscales inv_l; scaled vectors s = x * inv_l.  The sample-point Gram of
// the q/R/Q kernels is the TPU kernels' expanded form
//     k(s, p) = exp(-0.5 (|s|^2 + |p|^2) + s . p),
// evaluated in base 2 (smc_qrq_row).
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
#define SMC_KXY_THREADS 256    // threads of a pairwise block, a SMC_KXY_GRID^2 grid
#define SMC_KXY_GRID 16        // side of that grid
#define SMC_KXY_MICRO 4        // side of a thread's micro-tile of the Gram
#define SMC_KXY_TILE 64        // side of a block's tile: SMC_KXY_GRID * SMC_KXY_MICRO
#define SMC_KXY_SCALE 0.84932180028801904272f  // sqrt(0.5 log2 e)
#define SMC_KXY_PLANES(D) (((D) + 3) / 4)      // planes of four components of a staged D-vector

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

// ---------------------------------------------------------------------------
// The q/R/Q kernels and their backward.  One block a chunk of C samples
// writes the chunk's float32 partials, forward (q, R, Q) as q[n] (n < N),
// R[d, n] at N + d N + n and Q[i, j] at N + D N + i N + j; backward (cs, B,
// u) as cs[n], B[d, n] at N + d N + n and u[d] at N + D N + d.
//
// Both paths evaluate the Gram in the expanded form in base 2: with u = x *
// inv_l * sqrt(log2 e) and v_n likewise, k = ex2(u . v_n - |u|^2 / 2 -
// |v_n|^2 / 2), one ex2.approx a point.
//
// Small path (N <= smc_qrq_bucket(D)): D and the bucket NB are template
// arguments, the points past N are masked (k = 0), and a thread takes the
// samples tid, tid + 128, ... of the chunk, the next one loaded ahead.  Its
// Gram row (NB values) and its sample stay in registers, and it keeps
// private sums of every result it adds to: forward q (NB), R (D NB) and the
// upper triangle of Q (NB (NB + 1) / 2), backward cs (NB), B (D NB) and u
// (D), the row sum of M a register.  The scaled points (and the cotangents)
// are read from shared memory, the same word for every thread.  The block
// then sums each result by a shuffle tree in each warp and over the four
// warps in turn.
//
// Large path (every other N up to SMC_MAX_N): D is a template argument, N a
// run-time one.  The chunk goes in tiles of TILE samples (as many as
// SMC_QRQ_TILE_FLOATS of shared memory hold, a multiple of 64), whose raw
// samples are copied ahead by cp.async, one tile in flight while the
// previous one is used.  A tile is staged as rows of VW = NP + XW floats a
// sample: the Gram row k[0..NP) (NP = N rounded up to 4; the padded points
// masked to 0), then x[0..D), 1 and zeros up to XW; a sample past the
// chunk's end is a row of zeros.  Forward, the results are the 4 x 4
// micro-tiles of the product V[:, a] V[:, c] (a over all VW columns, c over
// the NP Gram columns) on or above the diagonal of Q, and the q/R rows below
// it; a thread keeps up to SMC_QRQ_MT_MAX micro-tiles in registers, and when
// there are fewer micro-tiles than threads, G groups of threads split a
// tile's samples and are summed in group order at the end.  Backward, a
// thread owns a slice of 4 points and takes two samples at a time: W = gq +
// x gR + k gQ2 for both (the rows of gQ2 staged with NP columns), M = W k,
// and its slice's cs, B and u.
// ---------------------------------------------------------------------------

#ifdef __CUDACC__
#define SMC_CE constexpr __host__ __device__
#define SMC_CALL static __host__ __device__ __noinline__  // compiled once, called from many places
#else
#define SMC_CE constexpr
#define SMC_CALL static inline
#endif

#define SMC_QRQ_THREADS 128        // threads of a small-path block (96 or 64: slower)
#define SMC_QRQ_LARGE_THREADS 256  // threads of a large-path block
#define SMC_QRQ_MT_MAX 3           // micro-tiles a large-path thread keeps (624 at N = 128, D = 8)
#define SMC_QRQ_SCALE 1.20112240878644983f  // sqrt(log2 e)
// most private sums a small-path thread keeps in the forward kernel: the
// bucket of D is the largest N <= 2 D + 1 (the UT and degree-3 FS rules)
// within it; 0 sends every shape to the large path
#ifndef SMC_QRQ_SMALL_ACC
#define SMC_QRQ_SMALL_ACC 132
#endif
#define SMC_QRQ_TILE_FLOATS 8192   // shared memory a large-path tile may take (16,384: within 5%)

SMC_CE int smc_qrq_fwd_sums(int D, int N) { return N + D * N + N * (N + 1) / 2; }
// the small path's point bucket at D (0: none)
SMC_CE int smc_qrq_bucket(int D) {
  int nb = 2 * D + 1;
  while (nb > 0 && smc_qrq_fwd_sums(D, nb) > SMC_QRQ_SMALL_ACC) --nb;
  return nb;
}
SMC_CE bool smc_qrq_small(int D, int N) { return N <= smc_qrq_bucket(D); }
// private sums of a small-path thread
SMC_CE int smc_qrq_sums(int D, int N, bool bwd) { return bwd ? N + D * N + D : smc_qrq_fwd_sums(D, N); }

// The scaled inverse lengthscales il = inv_l * sqrt(log2 e) of every Gram.
template <int D>
SMC_HD void smc_qrq_il(const float* inv_l, float* il) {
#pragma unroll
  for (int d = 0; d < D; ++d) il[d] = inv_l[d] * SMC_QRQ_SCALE;
}

// Scaled point v = xp * il (D floats, il from smc_qrq_il); returns
// -|v|^2 / 2.
template <int D>
SMC_HD float smc_qrq_point(const float* xp, const float* il, float* v) {
  float v2 = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    v[d] = xp[d] * il[d];
    v2 += v[d] * v[d];
  }
  return -0.5f * v2;
}

// The four floats at p (16-byte aligned).
SMC_HD void smc_load4(const float* p, float* a) {
#ifdef __CUDA_ARCH__
  const float4 t = *reinterpret_cast<const float4*>(p);
  a[0] = t.x, a[1] = t.y, a[2] = t.z, a[3] = t.w;
#else
  for (int i = 0; i < 4; ++i) a[i] = p[i];
#endif
}

// 0, read anew on every call on the card: an offset that keeps the compiler
// from hoisting the shared-memory constants of the small path out of its
// sample loop (into registers it does not have).
SMC_HD int smc_opaque_zero() {
#ifdef __CUDA_ARCH__
  int z;
  asm volatile("mov.u32 %0, 0;" : "=r"(z));
  return z;
#else
  return 0;
#endif
}

// Shared-memory layout of a small-path block (float offsets, 16-byte
// aligned): the points v (NB rows of DP = D rounded up to 4), their
// -|v|^2 / 2 in c (NBP = NB rounded up to 4), and for the backward gq (NBP),
// gR (D rows of NBP) and gQ2 (NB rows of NBP), all zero past N.
template <int D, int NB, bool BWD>
struct SmcQrqSmall {
  static constexpr int DP = (D + 3) / 4 * 4, NBP = (NB + 3) / 4 * 4;
  static constexpr int v = 0, c = NB * DP, gq = c + NBP, gR = gq + NBP, gQ2 = gR + D * NBP;
  static constexpr int total = BWD ? gQ2 + NB * NBP : gq;
};

// Stage a small-path block's constants (items first, first + step, ...).
template <int D, int NB, bool BWD>
SMC_HD void smc_qrq_small_stage(const float* xp, const float* il, const float* gq,
                                const float* gR, const float* gQ2, int N, float* sm, int first,
                                int step) {
  using L = SmcQrqSmall<D, NB, BWD>;
  for (int e = first; e < L::total; e += step) {
    float w = 0.f;
    if (e < L::c) {
      const int n = e / L::DP, d = e % L::DP;
      if (n < N && d < D) w = xp[n * D + d] * il[d];
    } else if (e < L::gq) {
      const int n = e - L::c;
      float v[D];
      if (n < N) w = smc_qrq_point<D>(xp + n * D, il, v);
    } else {
      const int r = (e - L::gq) / L::NBP, n = (e - L::gq) % L::NBP;
      if (n < N && (r <= D || r - 1 - D < N))
        w = r == 0 ? gq[n] : r <= D ? gR[(r - 1) * N + n] : gQ2[(r - 1 - D) * N + n];
    }
    sm[e] = w;
  }
}

// Gram row of the raw sample x against the NB staged points of sm:
// k[n] = ex2(-|u|^2 / 2 + c[n] + u . v_n), u = x * il; 0 for n >= N.
template <int D, int NB, bool BWD>
SMC_HD void smc_qrq_row(const float* x, const float* il, const float* sm, int N, float* k) {
  using L = SmcQrqSmall<D, NB, BWD>;
  float u[L::DP];
  float h = 0.f;
#pragma unroll
  for (int d = 0; d < L::DP; ++d) {
    u[d] = d < D ? x[d] * il[d] : 0.f;
    if (d < D) h += u[d] * u[d];
  }
  h *= -0.5f;
#pragma unroll
  for (int nq = 0; nq < L::NBP / 4; ++nq) {
    float c[4];
    smc_load4(sm + L::c + 4 * nq, c);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 4 * nq + j;
      if (n >= NB) continue;
      float e = h + c[j];
#pragma unroll
      for (int dq = 0; dq < L::DP / 4; ++dq) {
        float v[4];
        smc_load4(sm + L::v + n * L::DP + 4 * dq, v);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          if (4 * dq + i < D) e += u[4 * dq + i] * v[i];
      }
      k[n] = n < N ? smc_exp2(e) : 0.f;
    }
  }
}

// One sample's terms of the forward sums: q, R, then Q's upper triangle row
// by row.
template <int D, int N>
SMC_HD void smc_qrq_add(const float* x, const float* k, float* acc) {
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n] += k[n];
#pragma unroll
  for (int d = 0; d < D; ++d)
#pragma unroll
    for (int n = 0; n < N; ++n) acc[N + d * N + n] += x[d] * k[n];
  int o = N + D * N;
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = i; j < N; ++j) acc[o++] += k[i] * k[j];
}

// One sample's terms of the backward sums: with W[n] = gq[n] + sum_d x[d]
// gR[d, n] + sum_m k[m] gQ2[m, n] (the coefficient of dk[n]; gQ2 = gQ + gQ^T)
// and M = W k: cs += M, B[d] += x[d] M, u[d] += x[d]^2 sum_n M[n].  The
// cotangents are read from sm four points at a time.
template <int D, int NB>
SMC_HD void smc_qrq_bwd_add(const float* x, const float* k, const float* sm, float* acc) {
  using L = SmcQrqSmall<D, NB, true>;
  float r = 0.f;
#pragma unroll
  for (int nq = 0; nq < L::NBP / 4; ++nq) {
    const int J = NB - 4 * nq;   // the block's points: 4 j < J (known once unrolled)
    float w[4], g4[4];
    smc_load4(sm + L::gq + 4 * nq, w);
#pragma unroll
    for (int d = 0; d < D; ++d) {
      smc_load4(sm + L::gR + d * L::NBP + 4 * nq, g4);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < J) w[j] += x[d] * g4[j];
    }
#pragma unroll
    for (int m = 0; m < NB; ++m) {
      smc_load4(sm + L::gQ2 + m * L::NBP + 4 * nq, g4);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < J) w[j] += k[m] * g4[j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = 4 * nq + j;
      if (j >= J) continue;
      const float M = w[j] * k[n];
      r += M;
      acc[n] += M;
#pragma unroll
      for (int d = 0; d < D; ++d) acc[NB + d * NB + n] += x[d] * M;
    }
  }
#pragma unroll
  for (int d = 0; d < D; ++d) acc[NB + D * NB + d] += x[d] * x[d] * r;
}

// The private sums of the small-path thread that takes the samples first,
// first + step, ... of the chunk xc (C x D), N of the NB points real, the
// block's constants in sm (SmcQrqSmall).
template <int D, int NB, bool BWD>
SMC_HD void smc_qrq_small_thread(const float* xc, int C, int first, int step, const float* il,
                                 const float* sm, int N, float* acc) {
  constexpr int NA = smc_qrq_sums(D, NB, BWD);
#pragma unroll
  for (int a = 0; a < NA; ++a) acc[a] = 0.f;
  float next[D];
#pragma unroll
  for (int d = 0; d < D; ++d) next[d] = first < C ? xc[static_cast<long>(first) * D + d] : 0.f;
  for (int t = first; t < C; t += step) {
    float x[D], k[NB];
#pragma unroll
    for (int d = 0; d < D; ++d) {
      x[d] = next[d];
      if (t + step < C) next[d] = xc[static_cast<long>(t + step) * D + d];
    }
    const float* s = sm + smc_opaque_zero();   // the constants read anew every sample
    smc_qrq_row<D, NB, BWD>(x, il, s, N, k);
    if constexpr (BWD)
      smc_qrq_bwd_add<D, NB>(x, k, s, acc);
    else
      smc_qrq_add<D, NB>(x, k, acc);
  }
}

// Sum each of the NA private sums of a warp's 32 lanes with few shuffles:
// the sums are padded to P = 32 q, and at each of five steps (lanes off =
// 16, 8, 4, 2, 1 apart) a lane hands the half of its sums that its partner
// keeps to the partner and adds the partner's half to the half it keeps
// (the lane with bit `off` set keeps the upper half).  Lane l ends with the
// sums of private sums q l .. q l + q - 1 in acc[0..q); 31 q shuffles
// instead of 5 NA.  `swap(v, off)` is __shfl_xor_sync on the card.
template <int LEN, typename Swap>
SMC_HD void smc_qrq_swap_step(float* v, int lane, int off, Swap swap) {
  const bool upper = lane & off;
#pragma unroll
  for (int i = 0; i < LEN / 2; ++i) {
    const float give = upper ? v[i] : v[i + LEN / 2];
    const float keep = upper ? v[i + LEN / 2] : v[i];
    v[i] = keep + swap(give, off);
  }
}

template <int NA, typename Swap>
SMC_HD void smc_qrq_warp_sums(float* acc, int lane, Swap swap) {
  constexpr int P = (NA + 31) / 32 * 32;
  float v[P];
#pragma unroll
  for (int a = 0; a < P; ++a) v[a] = a < NA ? acc[a] : 0.f;
  smc_qrq_swap_step<P>(v, lane, 16, swap);
  smc_qrq_swap_step<P / 2>(v, lane, 8, swap);
  smc_qrq_swap_step<P / 4>(v, lane, 4, swap);
  smc_qrq_swap_step<P / 8>(v, lane, 2, swap);
  smc_qrq_swap_step<P / 16>(v, lane, 1, swap);
#pragma unroll
  for (int i = 0; i < P / 32; ++i) acc[i] = v[i];
}

// Write the block's sum s of private sum a (bucket NB, N points real) to
// the chunk's partials oc; sums of padded points are dropped, a forward sum
// of Q's triangle is written to Q[i, j] and Q[j, i].
template <int D, int NB, bool BWD>
SMC_HD void smc_qrq_small_put(int a, float s, int N, float* oc) {
  if (a < NB + D * NB) {
    const int n = a % NB, d = a / NB - 1;
    if (n < N) oc[a < NB ? n : N + d * N + n] = s;
    return;
  }
  if (BWD) {
    oc[N + D * N + a - NB - D * NB] = s;
    return;
  }
  int r = a - NB - D * NB, i = 0;
  while (r >= NB - i) r -= NB - i++;
  const int j = i + r;
  if (j >= N) return;
  oc[N + D * N + i * N + j] = s;
  oc[N + D * N + j * N + i] = s;
}

// Shared-memory layout (float offsets) and thread roles of a large-path block.
struct SmcQrqLarge {
  int NP, VW, tile, nb, MT, K, G, ew, v, raw, p, c, gq, gR, gQ2, total;
  SMC_HD SmcQrqLarge(int D, int N, bool bwd) {
    NP = (N + 3) / 4 * 4;
    const int XW = (D + 4) / 4 * 4;                // x, 1 and zeros
    VW = NP + XW;
    tile = SMC_QRQ_TILE_FLOATS / VW / 64 * 64;
    if (tile < 64) tile = 64;
    nb = NP / 4;
    ew = 4 + 5 * D;                                // backward sums of a thread
    int red;
    if (bwd) {
      MT = K = 0;
      G = SMC_QRQ_LARGE_THREADS / nb < tile / 2 ? SMC_QRQ_LARGE_THREADS / nb : tile / 2;
      red = G * nb * ew;
    } else {
      MT = nb * (nb + 1) / 2 + (XW / 4) * nb;
      K = (MT + SMC_QRQ_LARGE_THREADS - 1) / SMC_QRQ_LARGE_THREADS;
      G = K == 1 ? SMC_QRQ_LARGE_THREADS / MT : 1;
      red = G > 1 ? G * MT * 16 : 0;
    }
    v = 0;                                          // the tile, then the groups' sums
    raw = ((tile * VW > red ? tile * VW : red) + 3) / 4 * 4;   // two tiles of raw samples
    p = raw + (2 * tile * D + 3) / 4 * 4;
    c = p + NP * D;
    gq = c + NP;
    gR = gq + (bwd ? NP : 0);
    gQ2 = gR + (bwd ? D * NP : 0);
    total = gQ2 + (bwd ? N * NP : 0);
  }
};

// Micro-tile m of a forward large-path block: its first A column ai and Gram
// column jj, in units of 4.  The nb (nb + 1) / 2 tiles of Q's upper triangle
// come first, row by row, then the q/R rows.
SMC_CALL void smc_qrq_mtile(int m, int nb, int* ai, int* jj) {
  const int tri = nb * (nb + 1) / 2;
  if (m < tri) {
    int i = 0;
    while (m >= nb - i) m -= nb - i++;
    *ai = i;
    *jj = i + m;
  } else {
    *ai = nb + (m - tri) / nb;
    *jj = (m - tri) % nb;
  }
}

// Stage the points (scaled, and -|v|^2 / 2; zero past N) of a large-path block.
template <int D>
SMC_HD void smc_qrq_stage_points(const float* xp, const float* il, int N, int NP, float* v,
                                 float* c, int first, int step) {
  for (int n = first; n < NP; n += step) {
    if (n < N) {
      c[n] = smc_qrq_point<D>(xp + n * D, il, v + n * D);
    } else {
      c[n] = 0.f;
      for (int d = 0; d < D; ++d) v[n * D + d] = 0.f;
    }
  }
}

// Copy the raw samples (T x D floats) of a tile to dst in shared memory:
// cp.async on the card, one float a copy, the next tile in flight while one
// is used; a plain copy on the host.
SMC_HD void smc_qrq_fetch(const float* src, int count, float* dst, int first, int step) {
  for (int e = first; e < count; e += step) {
#ifdef __CUDA_ARCH__
    const unsigned to = static_cast<unsigned>(__cvta_generic_to_shared(dst + e));
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(to), "l"(src + e));
#else
    dst[e] = src[e];
#endif
  }
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;");
#endif
}

// Wait for this thread's copies in flight.
SMC_HD void smc_qrq_fetched() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group 0;");
#endif
}

// Stage the rows of a tile of T (<= L.tile) raw samples xt (T x D, shared
// memory): items e = first, first + step, ... of L.tile x 4, item e filling
// the columns e % 4, e % 4 + 4, ... of row e / 4.
template <int D>
SMC_HD void smc_qrq_stage(const float* xt, int T, const float* il, const float* v,
                          const float* c, int N, const SmcQrqLarge& L, float* V, int first,
                          int step) {
  for (int e = first; e < L.tile * 4; e += step) {
    const int t = e / 4, sub = e % 4;
    float* row = V + t * L.VW;
    float x[D], u[D];
    float h = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      x[d] = t < T ? xt[t * D + d] : 0.f;
      u[d] = x[d] * il[d];
      h += u[d] * u[d];
    }
    h *= -0.5f;
    for (int n = sub; n < L.NP; n += 4) {
      float e = h + c[n];
#pragma unroll
      for (int d = 0; d < D; ++d) e += u[d] * v[n * D + d];
      row[n] = (t < T && n < N) ? smc_exp2(e) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < (D + 4) / 4 * 4; ++j)
      if (j % 4 == sub) row[L.NP + j] = t >= T ? 0.f : j < D ? x[j] : j == D ? 1.f : 0.f;
  }
}


// Forward large-path roles of thread tid: its group g (G or more if it
// idles) and micro-tiles (ai, jj); returns how many it keeps.
SMC_HD int smc_qrq_roles(const SmcQrqLarge& L, int tid, int* g, int* ai, int* jj) {
  int cnt = 0;
  *g = L.K == 1 ? tid / L.MT : 0;
  if (*g >= L.G) return 0;
#pragma unroll
  for (int u = 0; u < SMC_QRQ_MT_MAX; ++u) {
    const int m = L.K == 1 ? (u == 0 ? tid % L.MT : L.MT) : tid + u * SMC_QRQ_LARGE_THREADS;
    if (m < L.MT) {
      smc_qrq_mtile(m, L.nb, ai + u, jj + u);
      cnt = u + 1;
    }
  }
  return cnt;
}

// Micro-tile u of a forward large-path thread.
SMC_HD int smc_qrq_mt_of(const SmcQrqLarge& L, int tid, int u) {
  return L.K == 1 ? tid % L.MT : tid + u * SMC_QRQ_LARGE_THREADS;
}

// Forward: the thread's cnt micro-tiles add the tile's samples g, g + G, ...
SMC_HD void smc_qrq_large_fwd_tile(const float* V, const SmcQrqLarge& L, int g, int cnt,
                                   const int* ai, const int* jj, float* acc) {
  for (int t = g; t < L.tile; t += L.G) {
    const float* row = V + t * L.VW;
#pragma unroll
    for (int u = 0; u < SMC_QRQ_MT_MAX; ++u) {
      if (u < cnt) {
        float a[4], b[4];
        smc_load4(row + 4 * ai[u], a);
        smc_load4(row + 4 * jj[u], b);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[u * 16 + i * 4 + j] += a[i] * b[j];
      }
    }
  }
}

// Write entry e of forward micro-tile m, summed over the block, to the
// chunk's partials oc: a Q entry on or above the diagonal to Q[a, c] and
// Q[c, a], an R or q entry once; padded rows and columns are dropped.
SMC_CALL void smc_qrq_large_put(const SmcQrqLarge& L, int D, int N, int m, int e, float s,
                              float* oc) {
  int ai, jj;
  smc_qrq_mtile(m, L.nb, &ai, &jj);
  const int i = e / 4, j = e % 4, c = 4 * jj + j;
  int a = 4 * ai + i;
  if (c >= N) return;
  if (ai < L.nb) {
    if (a >= N || (ai == jj && i > j)) return;
    oc[N + D * N + a * N + c] = s;
    oc[N + D * N + c * N + a] = s;
  } else if ((a -= L.NP) < D) {
    oc[N + a * N + c] = s;
  } else if (a == D) {
    oc[c] = s;
  }
}

// Stage the backward cotangents with NP columns (zero past N): gq, gR (D
// rows), gQ2 (N rows).
SMC_HD void smc_qrq_stage_cot(const float* gq, const float* gR, const float* gQ2, int D, int N,
                              int NP, float* sq, float* sR, float* sQ, int first, int step) {
  for (int e = first; e < (1 + D + N) * NP; e += step) {
    const int r = e / NP, n = e % NP;
    const float w = n >= N ? 0.f : r == 0 ? gq[n] : r <= D ? gR[(r - 1) * N + n]
                                                            : gQ2[(r - 1 - D) * N + n];
    (r == 0 ? sq : r <= D ? sR + (r - 1) * NP : sQ + (r - 1 - D) * NP)[n] = w;
  }
}

// Backward: the thread of point slice `slice` (points 4 slice .. + 3) and
// group g adds the tile's sample pairs (2 g, 2 g + 1), (2 g + 2 G, ...) to acc:
// cs (4), B (D x 4), u (D).
template <int D>
SMC_HD void smc_qrq_large_bwd_tile(const float* V, const SmcQrqLarge& L, int N, const float* sq,
                                   const float* sR, const float* sQ, int g, int slice,
                                   float* acc) {
  const int n0 = 4 * slice;
  for (int t0 = 2 * g; t0 < L.tile; t0 += 2 * L.G) {
    const float* rows[2] = {V + t0 * L.VW, V + (t0 + 1) * L.VW};
    float w[2][4], x[2][D];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      smc_load4(sq + n0, w[s]);
#pragma unroll
      for (int d = 0; d < D; ++d) x[s][d] = rows[s][L.NP + d];
    }
#pragma unroll
    for (int d = 0; d < D; ++d) {
      float gr[4];
      smc_load4(sR + d * L.NP + n0, gr);
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int j = 0; j < 4; ++j) w[s][j] += x[s][d] * gr[j];
    }
    for (int m = 0; m < N; ++m) {
      float gQ[4];
      smc_load4(sQ + m * L.NP + n0, gQ);
      const float k0 = rows[0][m], k1 = rows[1][m];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        w[0][j] += k0 * gQ[j];
        w[1][j] += k1 * gQ[j];
      }
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      float k[4], M[4];
      smc_load4(rows[s] + n0, k);
      float r = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        M[j] = w[s][j] * k[j];
        r += M[j];
        acc[j] += M[j];
      }
#pragma unroll
      for (int d = 0; d < D; ++d) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[4 + 4 * d + j] += x[s][d] * M[j];
        acc[4 + 4 * D + d] += x[s][d] * x[s][d] * r;
      }
    }
  }
}

// Backward partial o of the chunk from the groups' sums red[(g nb + slice)
// ew + ...]: cs and B over the groups of their slice, u over the slices and,
// inside each, the groups.
SMC_CALL float smc_qrq_large_bwd_sum(const SmcQrqLarge& L, int D, int N, int o, const float* red) {
  float s = 0.f;
  if (o < N + D * N) {
    const int n = o < N ? o : (o - N) % N, at = o < N ? n % 4 : 4 + 4 * ((o - N) / N) + n % 4;
    for (int g = 0; g < L.G; ++g) s += red[(g * L.nb + n / 4) * L.ew + at];
  } else {
    for (int sl = 0; sl < L.nb; ++sl)
      for (int g = 0; g < L.G; ++g) s += red[(g * L.nb + sl) * L.ew + 4 + 4 * D + (o - N - D * N)];
  }
  return s;
}

// Every large-path block: fetch tile 0, then for each tile, wait for its raw
// samples, fetch the next one, stage the Gram rows, and hand the tile to
// use(V); `sync` is __syncthreads on the card.  raw holds two tiles of raw
// samples.
template <int D, typename Sync, typename Use>
SMC_HD void smc_qrq_tiles(const float* xc, int C, const float* il, const float* v,
                          const float* c, int N, const SmcQrqLarge& L, float* V, float* raw,
                          int first, int step, Sync sync, Use use) {
  smc_qrq_fetch(xc, (C < L.tile ? C : L.tile) * D, raw, first, step);
  for (int t0 = 0, k = 0; t0 < C; t0 += L.tile, ++k) {
    const int T = C - t0 < L.tile ? C - t0 : L.tile;
    const int t1 = t0 + L.tile, T1 = C - t1 < L.tile ? C - t1 : L.tile;
    float* here = raw + (k % 2) * L.tile * D;
    smc_qrq_fetched();
    sync();  // this tile's samples have arrived, the previous tile is used
    smc_qrq_fetch(xc + static_cast<long>(t1) * D, T1 > 0 ? T1 * D : 0,
                  raw + ((k + 1) % 2) * L.tile * D, first, step);
    smc_qrq_stage<D>(here, T, il, v, c, N, L, V, first, step);
    sync();
    use(V);
  }
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
