// Host build of the RBF-Student Monte-Carlo math (student_mc_rows.cuh), for
// testing the kernels' per-element arithmetic on a machine without a GPU.
// Each function walks the chunks, tiles and rows in the kernels' order, one
// after another, and writes the same per-block partials in the same layouts
// (the pairwise kernels sum a tile's rows as a tree; here they are summed in
// order).
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

// out: (num_chunks, tiles) for the forward, (num_chunks, tiles, D) with bwd != 0.
extern "C" void smc_host_kxy(const float* inv_l, const float* xs, int num_chunks, int chunk,
                             int D, int bwd, float* out) {
  const int tiles = (chunk + SMC_ROWS - 1) / SMC_ROWS;
  std::vector<float> s(chunk * D), s2(chunk);
  float kx[SMC_MAX_D];
  for (int c = 0; c < num_chunks; ++c) {
    const float* xc = xs + static_cast<long>(c) * chunk * D;
    for (int r = 0; r < chunk; ++r) s2[r] = smc_scale(xc + r * D, inv_l, D, s.data() + r * D);
    for (int tile = 0; tile < tiles; ++tile) {
      float* oc = out + (static_cast<long>(c) * tiles + tile) * (bwd ? D : 1);
      for (int d = 0; d < (bwd ? D : 1); ++d) oc[d] = 0.f;
      for (int r = tile * SMC_ROWS; r < chunk && r < (tile + 1) * SMC_ROWS; ++r) {
        const float rs = smc_kxy_row(r, chunk, D, s.data(), s2.data(), xc, bwd ? kx : nullptr);
        if (!bwd) {
          oc[0] += rs;
          continue;
        }
        for (int d = 0; d < D; ++d) {
          const float x = xc[r * D + d];
          oc[d] += x * x * rs - x * kx[d];
        }
      }
    }
  }
}
