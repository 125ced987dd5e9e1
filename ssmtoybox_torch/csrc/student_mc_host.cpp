// Host build of the RBF-Student Monte-Carlo math (student_mc_rows.cuh), for
// testing the kernels' arithmetic on a machine without a GPU.  Each function
// runs a kernel's threads one after another through the header's code and
// adds their sums in the kernel's order (the shuffles inside each warp, then
// the warps in turn; the large q/R/Q path's groups in turn), writing the same
// per-block partials in the same layouts.
#include <vector>

#include "student_mc_rows.cuh"

namespace {

// smc_qrq_warp_sums on the 32 lanes' sums (lane l's NA sums at acc[l NA
// ...]), every lane's shuffles of a step at once; the warp's NA sums to out.
template <int NA>
void warp_sums(const float* acc, float* out) {
  constexpr int P = (NA + 31) / 32 * 32;
  std::vector<float> v(32 * P, 0.f), give(32 * P);
  for (int l = 0; l < 32; ++l)
    for (int a = 0; a < NA; ++a) v[l * P + a] = acc[l * NA + a];
  for (int off = 16, len = P; off > 0; off >>= 1, len >>= 1) {
    for (int l = 0; l < 32; ++l)
      for (int i = 0; i < len / 2; ++i) give[l * P + i] = v[l * P + i + ((l & off) ? 0 : len / 2)];
    for (int l = 0; l < 32; ++l)
      for (int i = 0; i < len / 2; ++i)
        v[l * P + i] = v[l * P + i + ((l & off) ? len / 2 : 0)] + give[(l ^ off) * P + i];
  }
  for (int l = 0; l < 32; ++l)
    for (int i = 0; i < P / 32; ++i)
      if ((P / 32) * l + i < NA) out[(P / 32) * l + i] = v[l * P + i];
}

// The small q/R/Q path: the blocks of student_qrq_kernel<D, NB> (BWD false)
// or student_qrq_bwd_kernel<D, NB>, N <= NB points real.
template <int D, int NB, bool BWD>
void host_qrq_small(const float* inv_l, const float* xs, const float* xp, const float* gq,
                    const float* gR, const float* gQ2, int num_chunks, int chunk, int N,
                    float* out) {
  constexpr int NA = smc_qrq_sums(D, NB, BWD), T = SMC_QRQ_THREADS;
  const int n_out = BWD ? N + D * N + D : N + D * N + N * N;
  float il[D];
  smc_qrq_il<D>(inv_l, il);
  std::vector<float> sm(SmcQrqSmall<D, NB, BWD>::total);
  smc_qrq_small_stage<D, NB, BWD>(xp, il, gq, gR, gQ2, N, sm.data(), 0, 1);
  std::vector<float> acc(T * NA);
  for (int ch = 0; ch < num_chunks; ++ch) {
    for (int tid = 0; tid < T; ++tid)
      smc_qrq_small_thread<D, NB, BWD>(xs + static_cast<long>(ch) * chunk * D, chunk, tid, T, il,
                                       sm.data(), N, acc.data() + tid * NA);
    std::vector<float> red(T / 32 * NA);
    for (int w = 0; w < T / 32; ++w) warp_sums<NA>(acc.data() + w * 32 * NA, red.data() + w * NA);
    for (int a = 0; a < NA; ++a) {
      float s = red[a];
      for (int w = 1; w < T / 32; ++w) s += red[w * NA + a];
      smc_qrq_small_put<D, NB, BWD>(a, s, N, out + static_cast<long>(ch) * n_out);
    }
  }
}

// The large q/R/Q path: the blocks of student_qrq_large_kernel<D> or
// student_qrq_bwd_large_kernel<D>.
template <int D>
void host_qrq_large(bool bwd, const float* inv_l, const float* xs, const float* xp,
                    const float* gq, const float* gR, const float* gQ2, int num_chunks,
                    int chunk, int N, float* out) {
  constexpr int T = SMC_QRQ_LARGE_THREADS, NA = SMC_QRQ_MT_MAX * 16 > 4 + 5 * D
                                                      ? SMC_QRQ_MT_MAX * 16 : 4 + 5 * D;
  const SmcQrqLarge L(D, N, bwd);
  const int n_out = bwd ? N + D * N + D : N + D * N + N * N;
  std::vector<float> sm(L.total);
  float il[D];
  smc_qrq_il<D>(inv_l, il);
  smc_qrq_stage_points<D>(xp, il, N, L.NP, sm.data() + L.p, sm.data() + L.c, 0, 1);
  if (bwd)
    smc_qrq_stage_cot(gq, gR, gQ2, D, N, L.NP, sm.data() + L.gq, sm.data() + L.gR,
                      sm.data() + L.gQ2, 0, 1);
  std::vector<int> grp(T), cnt(T), ai(T * SMC_QRQ_MT_MAX), jj(T * SMC_QRQ_MT_MAX);
  for (int tid = 0; tid < T && !bwd; ++tid)
    cnt[tid] = smc_qrq_roles(L, tid, &grp[tid], &ai[tid * SMC_QRQ_MT_MAX],
                             &jj[tid * SMC_QRQ_MT_MAX]);
  std::vector<float> acc(T * NA);
  float* V = sm.data() + L.v;
  for (int ch = 0; ch < num_chunks; ++ch) {
    float* oc = out + static_cast<long>(ch) * n_out;
    acc.assign(acc.size(), 0.f);
    smc_qrq_tiles<D>(xs + static_cast<long>(ch) * chunk * D, chunk, il, sm.data() + L.p,
                     sm.data() + L.c, N, L, V, sm.data() + L.raw, 0, 1, [] {},
                     [&](const float* tile) {
                       for (int tid = 0; tid < T; ++tid) {
                         if (bwd && tid / L.nb < L.G)
                           smc_qrq_large_bwd_tile<D>(tile, L, N, sm.data() + L.gq,
                                                     sm.data() + L.gR, sm.data() + L.gQ2,
                                                     tid / L.nb, tid % L.nb,
                                                     acc.data() + tid * NA);
                         else if (!bwd && cnt[tid])
                           smc_qrq_large_fwd_tile(tile, L, grp[tid], cnt[tid],
                                                  &ai[tid * SMC_QRQ_MT_MAX],
                                                  &jj[tid * SMC_QRQ_MT_MAX],
                                                  acc.data() + tid * NA);
                       }
                     });
    if (bwd) {
      for (int tid = 0; tid < L.G * L.nb; ++tid)
        for (int a = 0; a < L.ew; ++a) V[tid * L.ew + a] = acc[tid * NA + a];
      for (int o = 0; o < n_out; ++o) oc[o] = smc_qrq_large_bwd_sum(L, D, N, o, V);
    } else if (L.G == 1) {
      for (int tid = 0; tid < T; ++tid)
        for (int u = 0; u < cnt[tid]; ++u)
          for (int e = 0; e < 16; ++e)
            smc_qrq_large_put(L, D, N, smc_qrq_mt_of(L, tid, u), e, acc[tid * NA + u * 16 + e],
                              oc);
    } else {
      for (int tid = 0; tid < T; ++tid)
        if (cnt[tid])
          for (int e = 0; e < 16; ++e)
            V[(grp[tid] * L.MT + tid % L.MT) * 16 + e] = acc[tid * NA + e];
      for (int o = 0; o < L.MT * 16; ++o) {
        float s = V[o];
        for (int gg = 1; gg < L.G; ++gg) s += V[gg * L.MT * 16 + o];
        smc_qrq_large_put(L, D, N, o / 16, o % 16, s, oc);
      }
    }
  }
}

template <int D>
void host_qrq(bool bwd, const float* inv_l, const float* xs, const float* xp, const float* gq,
              const float* gR, const float* gQ2, int num_chunks, int chunk, int N, float* out) {
  constexpr int NB = smc_qrq_bucket(D);
  if constexpr (NB > 0) {
    if (N <= NB) {
      if (bwd)
        host_qrq_small<D, NB, true>(inv_l, xs, xp, gq, gR, gQ2, num_chunks, chunk, N, out);
      else
        host_qrq_small<D, NB, false>(inv_l, xs, xp, gq, gR, gQ2, num_chunks, chunk, N, out);
      return;
    }
  }
  host_qrq_large<D>(bwd, inv_l, xs, xp, gq, gR, gQ2, num_chunks, chunk, N, out);
}

void host_qrq_d(int D, bool bwd, const float* inv_l, const float* xs, const float* xp,
                const float* gq, const float* gR, const float* gQ2, int num_chunks, int chunk,
                int N, float* out) {
  switch (D) {
    case 1: return host_qrq<1>(bwd, inv_l, xs, xp, gq, gR, gQ2, num_chunks, chunk, N, out);
    case 2: return host_qrq<2>(bwd, inv_l, xs, xp, gq, gR, gQ2, num_chunks, chunk, N, out);
    case 3: return host_qrq<3>(bwd, inv_l, xs, xp, gq, gR, gQ2, num_chunks, chunk, N, out);
    case 4: return host_qrq<4>(bwd, inv_l, xs, xp, gq, gR, gQ2, num_chunks, chunk, N, out);
    case 5: return host_qrq<5>(bwd, inv_l, xs, xp, gq, gR, gQ2, num_chunks, chunk, N, out);
    case 6: return host_qrq<6>(bwd, inv_l, xs, xp, gq, gR, gQ2, num_chunks, chunk, N, out);
    case 7: return host_qrq<7>(bwd, inv_l, xs, xp, gq, gR, gQ2, num_chunks, chunk, N, out);
    case 8: return host_qrq<8>(bwd, inv_l, xs, xp, gq, gR, gQ2, num_chunks, chunk, N, out);
  }
}

}  // namespace

// out: the launchers' per-chunk partials, (num_chunks, N + D N + N N).
extern "C" void smc_host_qrq(const float* inv_l, const float* xs, const float* xp,
                             int num_chunks, int chunk, int N, int D, float* out) {
  host_qrq_d(D, false, inv_l, xs, xp, nullptr, nullptr, nullptr, num_chunks, chunk, N, out);
}

// out: (num_chunks, N + D N + D).
extern "C" void smc_host_qrq_bwd(const float* inv_l, const float* xs, const float* xp,
                                 const float* gq, const float* gR, const float* gQ2,
                                 int num_chunks, int chunk, int N, int D, float* out) {
  host_qrq_d(D, true, inv_l, xs, xp, gq, gR, gQ2, num_chunks, chunk, N, out);
}

// The small path's point bucket at D: it takes N <= this (0: none).
extern "C" int smc_host_qrq_bucket(int D) {
  switch (D) {
    case 1: return smc_qrq_bucket(1);
    case 2: return smc_qrq_bucket(2);
    case 3: return smc_qrq_bucket(3);
    case 4: return smc_qrq_bucket(4);
    case 5: return smc_qrq_bucket(5);
    case 6: return smc_qrq_bucket(6);
    case 7: return smc_qrq_bucket(7);
    case 8: return smc_qrq_bucket(8);
  }
  return 0;
}

namespace {

template <int D, bool BWD>
void host_kxy(const float* inv_l, const float* xs, int num_chunks, int chunk, float* out) {
  constexpr int NA = BWD ? D : 1;
  constexpr int kWarps = SMC_KXY_THREADS / 32;
  float scale[D];
  for (int d = 0; d < D; ++d) scale[d] = inv_l[d] * SMC_KXY_SCALE;
  std::vector<float> s(smc_kxy_padded(chunk) * 4 * SMC_KXY_PLANES(D));
  std::vector<float> part(SMC_KXY_THREADS * NA);
  for (int c = 0; c < num_chunks; ++c) {
    smc_kxy_stage<D>(xs + static_cast<long>(c) * chunk * D, scale, chunk, s.data(), 0, 1);
    for (int tid = 0; tid < SMC_KXY_THREADS; ++tid)
      smc_kxy_thread<D, BWD>(s.data(), chunk, tid, part.data() + tid * NA);
    for (int a = 0; a < NA; ++a) {
      float half = 0.f;
      for (int w = 0; w < kWarps; ++w) {
        float lane[32];
        for (int l = 0; l < 32; ++l) lane[l] = part[(w * 32 + l) * NA + a];
        for (int off = 16; off > 0; off >>= 1)
          for (int l = 0; l < off; ++l) lane[l] += lane[l + off];
        half += lane[0];
      }
      out[static_cast<long>(c) * NA + a] = smc_kxy_finish<BWD>(half, chunk, scale[a]);
    }
  }
}

template <int D>
void host_kxy_d(const float* inv_l, const float* xs, int num_chunks, int chunk, int bwd,
                float* out) {
  if (bwd)
    host_kxy<D, true>(inv_l, xs, num_chunks, chunk, out);
  else
    host_kxy<D, false>(inv_l, xs, num_chunks, chunk, out);
}

}  // namespace

// out: (num_chunks,) for the forward, (num_chunks, D) with bwd != 0.
extern "C" void smc_host_kxy(const float* inv_l, const float* xs, int num_chunks, int chunk,
                             int D, int bwd, float* out) {
  switch (D) {
    case 1: return host_kxy_d<1>(inv_l, xs, num_chunks, chunk, bwd, out);
    case 2: return host_kxy_d<2>(inv_l, xs, num_chunks, chunk, bwd, out);
    case 3: return host_kxy_d<3>(inv_l, xs, num_chunks, chunk, bwd, out);
    case 4: return host_kxy_d<4>(inv_l, xs, num_chunks, chunk, bwd, out);
    case 5: return host_kxy_d<5>(inv_l, xs, num_chunks, chunk, bwd, out);
    case 6: return host_kxy_d<6>(inv_l, xs, num_chunks, chunk, bwd, out);
    case 7: return host_kxy_d<7>(inv_l, xs, num_chunks, chunk, bwd, out);
    case 8: return host_kxy_d<8>(inv_l, xs, num_chunks, chunk, bwd, out);
  }
}
