// Host build of the RBF-Student Monte-Carlo math (student_mc_rows.cuh), for
// testing the kernels' per-element arithmetic on a machine without a GPU.
// Each function walks the chunks and tiles in the kernels' order, one after
// another, and writes the same per-block partials in the same layouts.  The
// pairwise functions run the kernels' threads one after another through the
// header's tile walk and add their sums in the kernels' order (a shuffle tree
// inside each warp, then the warps in turn).
#include <vector>

#include "student_mc_rows.cuh"

namespace {

// Scaled points and their squared norms.
void scale_points(const float* xp, const float* inv_l, int N, int D, std::vector<float>& p,
                  std::vector<float>& p2) {
  p.assign(N * D, 0.f);
  p2.assign(N, 0.f);
  for (int n = 0; n < N; ++n) p2[n] = smc_scale(xp + n * D, inv_l, D, p.data() + n * D);
}

// Gram tile of T samples xt against the scaled points; scaled samples in s.
void gram_tile(const float* xt, const float* inv_l, int T, int N, int D,
               const std::vector<float>& p, const std::vector<float>& p2, float* k) {
  float s[SMC_MAX_D];
  for (int t = 0; t < T; ++t) {
    const float s2 = smc_scale(xt + t * D, inv_l, D, s);
    for (int n = 0; n < N; ++n) k[t * N + n] = smc_gram(s, p.data() + n * D, s2, p2[n], D);
  }
}

}  // namespace

extern "C" void smc_host_qrq(const float* inv_l, const float* xs, const float* xp,
                             int num_chunks, int chunk, int N, int D, float* out) {
  const int n_out = N + D * N + N * N;
  std::vector<float> p, p2, k(SMC_TILE * N);
  scale_points(xp, inv_l, N, D, p, p2);
  for (int c = 0; c < num_chunks; ++c) {
    float* acc = out + static_cast<long>(c) * n_out;
    for (int o = 0; o < n_out; ++o) acc[o] = 0.f;
    for (int t0 = 0; t0 < chunk; t0 += SMC_TILE) {
      const int T = chunk - t0 < SMC_TILE ? chunk - t0 : SMC_TILE;
      const float* xt = xs + (static_cast<long>(c) * chunk + t0) * D;
      gram_tile(xt, inv_l, T, N, D, p, p2, k.data());
      for (int o = 0; o < n_out; ++o) acc[o] += smc_qrq_term(o, T, N, D, xt, k.data());
    }
  }
}

extern "C" void smc_host_qrq_bwd(const float* inv_l, const float* xs, const float* xp,
                                 const float* gq, const float* gR, const float* gQ2,
                                 int num_chunks, int chunk, int N, int D, float* out) {
  const int n_out = N + D * N + D;
  std::vector<float> p, p2, k(SMC_TILE * N), M(SMC_TILE * N), rowsum(SMC_TILE);
  scale_points(xp, inv_l, N, D, p, p2);
  for (int c = 0; c < num_chunks; ++c) {
    float* acc = out + static_cast<long>(c) * n_out;
    for (int o = 0; o < n_out; ++o) acc[o] = 0.f;
    for (int t0 = 0; t0 < chunk; t0 += SMC_TILE) {
      const int T = chunk - t0 < SMC_TILE ? chunk - t0 : SMC_TILE;
      const float* xt = xs + (static_cast<long>(c) * chunk + t0) * D;
      gram_tile(xt, inv_l, T, N, D, p, p2, k.data());
      for (int t = 0; t < T; ++t) {
        float r = 0.f;
        for (int n = 0; n < N; ++n) {
          M[t * N + n] = smc_bwd_m(n, N, D, xt + t * D, k.data() + t * N, gq, gR, gQ2);
          r += M[t * N + n];
        }
        rowsum[t] = r;
      }
      for (int o = 0; o < n_out; ++o)
        acc[o] += smc_bwd_term(o, T, N, D, xt, M.data(), rowsum.data());
    }
  }
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
