// The lane-group form of the general vector filter step (vfg_step and
// vfg_step_wide of vector_filter_general.cuh), for the shapes where the
// E x E and D x D algebra dominates: more than 4 measurement outputs, or a
// registered state of more than 5 dimensions.  Used by the general kernel
// (vector_filter_general.cu) and the registered kernel
// (vector_filter_registered.cu), on the same model policies.
//
// What held the one-thread forms back on the card: at a bound of 8 outputs
// every E-sized array of a thread sits in registers and spills; the wide form
// keeps them in the global scratch buffer at 226 registers a thread, so about
// 2.4 warps an SM hide none of its round trips; the registered D = 8 step
// holds about five 8 x 8 matrices a thread and spills.  What bounds this
// form: the dependency chain of a step (the factors' square roots and
// divisions, the gain's substitutions, a lane's transcendentals), a few
// warps an SM deep, as many as the trajectories' shared memory allows.
//
// Design:
// - a trajectory runs on G consecutive lanes of a warp (a template
//   argument; the library's instantiations take VFL_G, 8, which beat 4 on
//   every lane the card timed but one: tools/lane_variants.py builds and
//   times 4), and every array it carries from one phase to the
//   next lives in dynamic shared memory (VflLayout): the state and its
//   prediction, the factor, the offsets and function values of every point,
//   the mean, the covariance's lower triangle, the cross-covariance, the
//   innovation covariance's factor as a lower triangle, the gain; rows of
//   the arrays that lanes read side by side have an odd stride (no bank
//   conflicts);
// - a block stages both rules' constants and R in its shared memory once
//   (VflRules), where they fit, so that no phase waits on a global load;
// - the work is split by entry, never by partial sum, so each entry is
//   computed by one lane with vfg_step's operations in vfg_step's order and
//   the form gives its bits: a transform's points are split over the lanes
//   (lane l evaluates points l, l + G, ... whole); each entry of a mean, a
//   covariance, a cross-covariance and a BQ rule's row sums is summed by one
//   lane over all points; a Cholesky factor goes a column at a time, the
//   column's rows over the lanes (each lane computes the column's diagonal
//   entry itself); one lane solves for a column of the gain; the updates of
//   the mean and the covariance are split by entry;
// - the phases are separated by __syncwarp on the whole warp (every group of
//   a warp runs the same phases; a group past the batch's last trajectory
//   repeats it); nothing is summed across lanes, no atomics, no shuffles.
//
// Host build (vector_filter_host.cpp): the same code, the lanes of a phase
// run one after another (VFL_LANES) and a trajectory's shared memory a host
// buffer.  No phase reads what another lane writes in the same phase, so the
// order of the lanes within a phase does not change a bit.
#pragma once

#include "vector_filter_general.cuh"

// A thread's lane in its trajectory's group.
struct VflLane {
  int l;
};

// The lanes a thread runs a phase for: on the card its own; on the host all G
// in turn.
#ifdef __CUDA_ARCH__
#define VFL_LANES(l, G, ln) for (int l = (ln).l, l##_end = (ln).l + 1; l < l##_end; ++l)
#else
#define VFL_LANES(l, G, ln) for (int l = 0; l < (G); ++l)
#endif

// The end of a phase: the group's lanes see each other's shared-memory
// writes.  Every lane of the warp takes every sync (the kernel keeps all 32
// busy), so the mask is the whole warp's, known when compiling.
VF_HD void vfl_sync(const VflLane& ln) {
  (void)ln;
#ifdef __CUDA_ARCH__
  __syncwarp();
#endif
}

// Entry (i, j), j <= i, of a lower triangle stored row after row.
VF_HD int vfl_tri(int i, int j) { return i * (i + 1) / 2 + j; }

// Steps (a, b) from an entry of a lower triangle to the one `by` entries on,
// row after row.
VF_HD void vfl_tri_step(int by, int& a, int& b) {
  b += by;
  while (b > a) {
    b -= a + 1;
    ++a;
  }
}

// The odd row stride of an array whose rows lanes read side by side: rows of
// an even number of doubles would start in one bank and serialize them.
VF_HD int vfl_stride(int n) { return n | 1; }

// Where a trajectory's arrays lie in its shared memory, in doubles from its
// start: the state m and P (D x D, rows dp apart), the prediction m_pr and
// P_pr, the factor L of either, the predicted measurement y_pr (E), the
// points' offsets X (point j's at j * D) and function values F (point j's eo
// outputs at j * eo), a BQ rule's row sums Gq (as F), the covariance's lower
// triangle Cv (vfl_tri) and the cross-covariance C (entry (e, c) at e * dp +
// c) of either transform, the innovation covariance's factor Ls (vfl_tri), the
// gain K (row d at d * ep; then K S in C's room, as K); `size` doubles in
// all.
struct VflLayout {
  int dp, ep;
  int m, m_pr, y_pr, P, P_pr, L, X, F, Gq, Cv, C, Ls, K, size;
};

VF_HD VflLayout vfl_layout(const VfParams& q) {
  const int D = q.dim_state, E = q.dim_out, nd = q.dyn.n, no = q.obs.n;
  const int n = nd > no ? nd : no, wide = E > D ? E : D;
  const int nf = nd * D > no * E ? nd * D : no * E;
  VflLayout s;
  s.dp = vfl_stride(D);
  s.ep = vfl_stride(E);
  const int sq = D * s.dp;
  s.m = 0;
  s.m_pr = s.m + D;
  s.y_pr = s.m_pr + D;
  s.P = s.y_pr + E;
  s.P_pr = s.P + sq;
  s.L = s.P_pr + sq;
  s.X = s.L + sq;
  s.F = s.X + n * D;
  s.Gq = s.F + nf;
  s.Cv = s.Gq + ((q.dyn.kind | q.obs.kind) != 0 ? nf : 0);
  s.C = s.Cv + wide * (wide + 1) / 2;
  s.Ls = s.C + (wide * s.dp > D * s.ep ? wide * s.dp : D * s.ep);
  s.K = s.Ls + E * (E + 1) / 2;
  s.size = s.K + D * s.ep;
  return s;
}

// Both rules and R as a step reads them: in a block's shared memory where
// they fit (vfl_stage), else in device memory.
struct VflRules {
  VfRule dyn, obs;
  const double* r;
};

// The doubles of a rule's constants on D inputs: xi, wm, then wc, or Wc and
// Wcc.
VF_HD long long vfl_rule_doubles(const VfRule& R, int D) {
  const long long n = R.n;
  return R.kind == 0 ? (D + 2) * n : (2 * D + 1 + n) * n;
}

// The most doubles a block stages (64 KB).
#define VFL_STAGE_MAX 8192

// The doubles a block stages: both rules and R, none where they exceed
// VFL_STAGE_MAX.
VF_HD int vfl_stage_doubles(const VfParams& q) {
  const long long n = vfl_rule_doubles(q.dyn, q.dim_state) +
                      vfl_rule_doubles(q.obs, q.dim_state) +
                      static_cast<long long>(q.dim_out) * q.dim_out;
  return n <= VFL_STAGE_MAX ? static_cast<int>(n) : 0;
}

// count doubles from `from` to `to`, thread t of nt; returns `to`.
VF_HD const double* vfl_copy(const double* from, long long count, double* to, int t, int nt) {
  for (long long i = t; i < count; i += nt) to[i] = VF_LDG(from + i);
  return to;
}

// Stages rule R (D inputs) at `to`, thread t of nt: the copy's pointers.
VF_HD VfRule vfl_stage_rule(VfRule R, int D, double*& to, int t, int nt) {
  const long long n = R.n;
  R.xi = vfl_copy(R.xi, D * n, to, t, nt);
  to += D * n;
  R.wm = vfl_copy(R.wm, n, to, t, nt);
  to += n;
  if (R.kind == 0) {
    R.wc = vfl_copy(R.wc, n, to, t, nt);
    to += n;
  } else {
    R.Wc = vfl_copy(R.Wc, n * n, to, t, nt);
    to += n * n;
    R.Wcc = vfl_copy(R.Wcc, D * n, to, t, nt);
    to += D * n;
  }
  return R;
}

// The rules and R a step reads: copied to `to` (vfl_stage_doubles of them,
// thread t of nt copying its share) where they fit, else p's own.
VF_HD VflRules vfl_stage(const VfgParams& p, double* to, int t, int nt) {
  const VfParams& q = p.base;
  VflRules s = {q.dyn, q.obs, p.r};
  if (vfl_stage_doubles(q) == 0) return s;
  s.dyn = vfl_stage_rule(q.dyn, q.dim_state, to, t, nt);
  s.obs = vfl_stage_rule(q.obs, q.dim_state, to, t, nt);
  s.r = vfl_copy(p.r, static_cast<long long>(q.dim_out) * q.dim_out, to, t, nt);
  return s;
}

// Row-major matrix entries, rows `stride` apart (the lower triangle of P or
// P_pr for a factor).
struct VflSquare {
  const double* a;
  int stride;
  VF_HD double operator()(int i, int j) const { return a[i * stride + j]; }
  VF_HD int at(int i, int j) const { return i * stride + j; }
};

// The innovation covariance S = (covariance, mirrored from its lower
// triangle) + R (E x E, row-major).
struct VflInnov {
  const double* cv;
  const double* r;
  int E;
  VF_HD double operator()(int i, int j) const {
    return (j <= i ? cv[vfl_tri(i, j)] : cv[vfl_tri(j, i)]) + r[i * E + j];
  }
};

struct VflTriAt {
  VF_HD int at(int i, int j) const { return vfl_tri(i, j); }
};

// Lower Cholesky factor of the lower triangle of the n x n matrix a(i, j)
// into Lo (entry (i, j) at Lo[at.at(i, j)]), vf_chol's recurrence: a column
// at a time, row i on lane i mod G, each lane computing the column's diagonal
// entry itself; n phases.  The dot products run 4 terms to an unrolled
// iteration, which lets their loads run ahead of the chain of subtractions
// without changing its order.
template <int G, class A, class At>
VF_HD void vfl_chol(int n, const A& a, double* Lo, const At& at, const VflLane& ln) {
#pragma unroll 1
  for (int j = 0; j < n; ++j) {
    VFL_LANES(l, G, ln) {
      int i = j + ((l - j) & (G - 1));  // the lane's first row from j on
      if (i < n) {
        double s = a(j, j);
#pragma unroll 4
        for (int k = 0; k < j; ++k) s = s - Lo[at.at(j, k)] * Lo[at.at(j, k)];
        const double d = sqrt(s);
        const bool diagonal = i == j;
        if (diagonal) i += G;
#pragma unroll 1
        for (; i < n; i += G) {
          double t = a(i, j);
#pragma unroll 4
          for (int k = 0; k < j; ++k) t = t - Lo[at.at(i, k)] * Lo[at.at(j, k)];
          Lo[at.at(i, j)] = t / d;
        }
        // stored last, so that the rows' loads need not wait for it
        if (diagonal) Lo[at.at(j, j)] = d;
      }
    }
    vfl_sync(ln);
  }
}

// A transition as the moments take it: its D values written to h.
template <int D, class Dyn>
struct VflDynAt {
  const Dyn& dyn;
  VF_HD void operator()(const double (&x)[D], double* h) const {
    double f[D];
    dyn(x, f);
#pragma unroll
    for (int a = 0; a < D; ++a) h[a] = f[a];
  }
};

// A measurement as the moments take it: its outputs written to h.
template <int D, class Obs>
struct VflObsAt {
  const Obs& obs;
  VF_HD void operator()(const double (&x)[D], double* h) const { obs(x, h); }
};

// Where the moments of a transform go, in the trajectory's shared memory;
// dp: the row stride of L and C.
struct VflMoments {
  double *X, *F, *Gq, *mu, *Cv, *C;
  int dp;
};

// The moments of f over rule R (eo outputs) at the Gaussian (m, L L^T) of a
// trajectory, m and L in shared memory: vfg_moments' sums, each entry by one
// lane in vfg_moments' order.  Writes the mean to o.mu, the covariance's
// lower triangle to o.Cv and the cross-covariance to o.C; three phases.  A
// classical rule's values are centred in place (f_j - mu, the difference its
// sums take) by the lane that summed their mean; a BQ rule's row sums g_i =
// sum_j Wc_ij f_j go to o.Gq.  The sums over points run 4 terms to an
// unrolled iteration (see vfl_chol).
template <int D, int G, class Eval>
VF_HD void vfl_moments(const VfRule& R, int eo, const double* m, const double* L, const Eval& f,
                       const VflMoments& o, const VflLane& ln) {
  const int n = R.n, dp = o.dp;
  // the points, split over the lanes: offsets L xi_j (vf_offset) and values
  VFL_LANES(l, G, ln) {
#pragma unroll 1
    for (int j = l; j < n; j += G) {
      double dx[D], x[D];
#pragma unroll
      for (int a = 0; a < D; ++a) {
        double acc = 0.0;
#pragma unroll
        for (int k = 0; k <= a; ++k) acc = acc + L[a * dp + k] * R.xi[k * n + j];
        dx[a] = acc;
      }
#pragma unroll
      for (int a = 0; a < D; ++a) {
        x[a] = m[a] + dx[a];
        o.X[j * D + a] = dx[a];
      }
      f(x, o.F + j * eo);
    }
  }
  vfl_sync(ln);
  // the mean, an entry a lane, then (classical) the values of that output
  // centred; or (BQ) the row sums g_i[e], an entry a lane
  VFL_LANES(l, G, ln) {
#pragma unroll 1
    for (int e = l; e < eo; e += G) {
      double acc = 0.0;
#pragma unroll 4
      for (int j = 0; j < n; ++j) acc = acc + R.wm[j] * o.F[j * eo + e];
      o.mu[e] = acc;
      if (R.kind == 0) {
#pragma unroll 4
        for (int j = 0; j < n; ++j) o.F[j * eo + e] = o.F[j * eo + e] - acc;
      }
    }
    if (R.kind != 0) {
#pragma unroll 1
      for (int t = l; t < n * eo; t += G) {
        const int i = t / eo, e = t - i * eo;
        const double* w = R.Wc + static_cast<long long>(i) * n;
        double acc = 0.0;
#pragma unroll 4
        for (int j = 0; j < n; ++j) acc = acc + w[j] * o.F[j * eo + e];
        o.Gq[t] = acc;
      }
    }
  }
  vfl_sync(ln);
  VFL_LANES(l, G, ln) {
    // the covariance's lower triangle, entry t of it on lane t mod G
    int a = 0, b = 0;
    vfl_tri_step(l, a, b);
#pragma unroll 1
    for (; a < eo; vfl_tri_step(G, a, b)) {
      double acc = 0.0;
      if (R.kind == 0) {
#pragma unroll 4
        for (int j = 0; j < n; ++j) acc = acc + R.wc[j] * (o.F[j * eo + a] * o.F[j * eo + b]);
      } else {
#pragma unroll 4
        for (int i = 0; i < n; ++i) acc = acc + o.F[i * eo + a] * o.Gq[i * eo + b];
        acc = acc - o.mu[a] * o.mu[b];
        if (a == b) acc = acc + R.emv;
      }
      o.Cv[vfl_tri(a, b)] = acc;
    }
    // the cross-covariance, row e on lane e mod G
#pragma unroll 1
    for (int e = l; e < eo; e += G) {
      double acc[D];
#pragma unroll
      for (int c = 0; c < D; ++c) acc[c] = 0.0;
      if (R.kind == 0) {
#pragma unroll 2
        for (int j = 0; j < n; ++j) {
          const double de = o.F[j * eo + e], w = R.wc[j];
#pragma unroll
          for (int c = 0; c < D; ++c) acc[c] = acc[c] + w * (de * o.X[j * D + c]);
        }
      } else {
        // h[e][c] = sum_i Wcc_ci f_i[e] into acc, then the row of h L^T
#pragma unroll 2
        for (int i = 0; i < n; ++i) {
          const double fe = o.F[i * eo + e];
#pragma unroll
          for (int c = 0; c < D; ++c) acc[c] = acc[c] + R.Wcc[c * n + i] * fe;
        }
#pragma unroll
        for (int c = D - 1; c >= 0; --c) {
          double x = 0.0;
#pragma unroll
          for (int a2 = 0; a2 <= c; ++a2) x = x + acc[a2] * L[c * dp + a2];
          acc[c] = x;
        }
      }
#pragma unroll
      for (int c = 0; c < D; ++c) o.C[e * dp + c] = acc[c];
    }
  }
  vfl_sync(ln);
}

// One filter step of a trajectory on G lanes, its arrays at sm (layout s),
// from the filtered state (m, P) there, the rules and R of `rules`:
// vfg_step / vfg_step_wide's computation and bits, the five streams written
// through `out`, this step's filtered state left in (m, P).  Measurement e at
// y[e * y_e].
template <int D, int G, class Dyn, class Obs>
VF_HD void vfl_step(const VfgParams& p, const VflRules& rules, const VflLayout& s, double* sm,
                    const double* y, long long y_e, const Dyn& dyn, const Obs& obs,
                    const VfOut& out, const VflLane& ln) {
  const VfParams& q = p.base;
  const int E = q.dim_out, dp = s.dp, ep = s.ep;
  double *m = sm + s.m, *m_pr = sm + s.m_pr, *y_pr = sm + s.y_pr, *P = sm + s.P;
  double *P_pr = sm + s.P_pr, *L = sm + s.L, *Cv = sm + s.Cv, *C = sm + s.C, *Ls = sm + s.Ls;
  double* K = sm + s.K;
  const long long cs = out.cs;
  // the time update: L = chol(P), the transition's moments, P_pr = Pf + G Q G^T
  vfl_chol<G>(D, VflSquare{P, dp}, L, VflSquare{L, dp}, ln);
  vfl_moments<D, G>(rules.dyn, D, m, L, VflDynAt<D, Dyn>{dyn},
                    VflMoments{sm + s.X, sm + s.F, sm + s.Gq, m_pr, Cv, C, dp}, ln);
  VFL_LANES(l, G, ln) {
#pragma unroll 1
    for (int t = l; t < D * D; t += G) {
      const int a = t / D, b = t - a * D;
      const double v = (b <= a ? Cv[vfl_tri(a, b)] : Cv[vfl_tri(b, a)]) +
                       q.gqg[a * VF_MAX_DIM + b];
      P_pr[a * dp + b] = v;
      out.P_pr[t * cs] = v;
      out.xx[t * cs] = C[a * dp + b];
    }
#pragma unroll 1
    for (int d = l; d < D; d += G) out.m_pr[d * cs] = m_pr[d];
  }
  vfl_sync(ln);
  // the measurement: L = chol(P_pr), its moments, Ls = chol(S + R)
  vfl_chol<G>(D, VflSquare{P_pr, dp}, L, VflSquare{L, dp}, ln);
  vfl_moments<D, G>(rules.obs, E, m_pr, L, VflObsAt<D, Obs>{obs},
                    VflMoments{sm + s.X, sm + s.F, sm + s.Gq, y_pr, Cv, C, dp}, ln);
  const VflInnov S{Cv, rules.r, E};
  vfl_chol<G>(E, S, Ls, VflTriAt{}, ln);
  // the gain, a column of K a lane: K[d] = S^-1 C[:, d], forward substitution
  // into K[d], then backward in place
  VFL_LANES(l, G, ln) {
#pragma unroll 1
    for (int d = l; d < D; d += G) {
      double* Kd = K + d * ep;
#pragma unroll 1
      for (int i = 0; i < E; ++i) {
        double acc = C[i * dp + d];
#pragma unroll 4
        for (int k = 0; k < i; ++k) acc = acc - Ls[vfl_tri(i, k)] * Kd[k];
        Kd[i] = acc / Ls[vfl_tri(i, i)];
      }
#pragma unroll 1
      for (int i = E - 1; i >= 0; --i) {
        double acc = Kd[i];
#pragma unroll 4
        for (int k = i + 1; k < E; ++k) acc = acc - Ls[vfl_tri(k, i)] * Kd[k];
        Kd[i] = acc / Ls[vfl_tri(i, i)];
      }
    }
  }
  vfl_sync(ln);
  // the filtered mean, an entry a lane, and T = K S (in C's room, rows as K's),
  // an entry a lane
  double* T = C;
  VFL_LANES(l, G, ln) {
#pragma unroll 1
    for (int d = l; d < D; d += G) {
      double acc = m_pr[d];
#pragma unroll 4
      for (int e = 0; e < E; ++e) acc = acc + K[d * ep + e] * (y[e * y_e] - y_pr[e]);
      m[d] = acc;
      out.m_fi[d * cs] = acc;
    }
#pragma unroll 1
    for (int t = l; t < D * E; t += G) {
      const int d = t / E, e = t - d * E;
      double acc = 0.0;
#pragma unroll 4
      for (int e2 = 0; e2 < E; ++e2) acc = acc + K[d * ep + e2] * S(e2, e);
      T[d * ep + e] = acc;
    }
  }
  vfl_sync(ln);
  // the filtered covariance P_pr - (K S) K^T on the lower triangle, mirrored
  VFL_LANES(l, G, ln) {
    int a = 0, b = 0;
    vfl_tri_step(l, a, b);
#pragma unroll 1
    for (; a < D; vfl_tri_step(G, a, b)) {
      double acc = 0.0;
#pragma unroll 4
      for (int e = 0; e < E; ++e) acc = acc + T[a * ep + e] * K[b * ep + e];
      const double v = P_pr[a * dp + b] - acc;
      P[a * dp + b] = v;
      P[b * dp + a] = v;
      out.P_fi[(a * D + b) * cs] = v;
      out.P_fi[(b * D + a) * cs] = v;
    }
  }
  vfl_sync(ln);
}

// A whole record of one trajectory on G lanes, its arrays at sm: vfg_record's
// layouts and streams, the models of Model, the rules and R of `rules`.
template <int D, int G, class Model>
VF_HD void vfl_record(const VfgParams& p, const VflRules& rules, double* sm, const double* y,
                      long long y_e, long long y_k, int T, const double* s, int n_s,
                      double* m_fi, double* P_fi, double* m_pr, double* P_pr, double* xx,
                      long long cs, const VflLane& ln) {
  const VfParams& q = p.base;
  const VflLayout lay = vfl_layout(q);
  VFL_LANES(l, G, ln) {
#pragma unroll 1
    for (int t = l; t < D * D; t += G)
      sm[lay.P + (t / D) * lay.dp + t % D] = q.P0[(t / D) * VF_MAX_DIM + t % D];
#pragma unroll 1
    for (int d = l; d < D; d += G) sm[lay.m + d] = q.m0[d];
  }
  vfl_sync(ln);
#pragma unroll 1
  for (int k = 0; k < T; ++k) {
    const long long v = static_cast<long long>(k) * D * cs, M = v * D;
    const VfOut out = {m_fi + v, P_fi + M, m_pr + v, P_pr + M, xx + M, cs};
    vfl_step<D, G>(p, rules, lay, sm, y + k * y_k, y_e,
                   Model::dyn(p, s + static_cast<long long>(k) * n_s), Model::obs(p), out, ln);
  }
}

// The lanes a trajectory runs on in the library's instantiations.
#ifndef VFL_G
#define VFL_G 8
#endif

// The lane-group instantiations of the table's models: D of the transitions.
#define VFL_SHAPES(F) F(2) F(3) F(4) F(5)

// The shared memory a block can take on sm_90, in doubles.
#define VFL_MAX_SHARED 29056

// The trajectories a block of the lane-group form holds: two warps' worth,
// one warp's where two do not fit in a block's shared memory beside the
// staged rules, 0 where one does not either (the launcher then runs the
// one-thread form).  ops/vector_filter.py (lanes_of) asks the same through
// vector_filter_fit.cpp.
VF_HD int vfl_block_trajectories(int G, int size, int stage) {
  for (int warps = 2; warps >= 1; --warps)
    if (stage + static_cast<long long>(warps) * (32 / G) * size <= VFL_MAX_SHARED)
      return warps * (32 / G);
  return 0;
}

// vfl_block_trajectories of p's configuration on VFL_G lanes.
VF_HD int vfl_block_of(const VfParams& q) {
  return vfl_block_trajectories(VFL_G, vfl_layout(q).size, vfl_stage_doubles(q));
}

// An sm_90 SM's shared memory and what it reserves for each block, in bytes,
// and the blocks of the lane-group kernel its registers hold (the launch
// bounds below).
#define VFL_SM_SHARED 233472
#define VFL_BLOCK_RESERVED 1024
#define VFL_SM_BLOCKS 10

// The warps of the lane-group form an SM holds on p's configuration: blocks
// of vfl_block_of trajectories beside the staged rules, as many as the SM's
// shared memory and registers allow; 0 where the launcher refuses the shape.
VF_HD int vfl_sm_warps(const VfParams& q) {
  const long long per_block = vfl_block_of(q);
  if (per_block == 0) return 0;
  const long long bytes =
      (vfl_stage_doubles(q) + per_block * vfl_layout(q).size) * 8 + VFL_BLOCK_RESERVED;
  const long long blocks = VFL_SM_SHARED / bytes;
  return static_cast<int>((blocks < VFL_SM_BLOCKS ? blocks : VFL_SM_BLOCKS) * per_block *
                          VFL_G / 32);
}

#ifdef __CUDACC__
// Two warps a block, 10 blocks an SM: at most 96 registers a thread, so that
// the 2,500 warps of 10,000 trajectories on 8 lanes fit on the card in one
// wave where shared memory allows.
constexpr int kVflThreads = 64;
constexpr int kVflMinBlocks = VFL_SM_BLOCKS;

// The lane-group kernel: the block stages the rules, then trajectory b runs
// on lanes G b .. G b + G - 1 of the grid, its arrays in the block's dynamic
// shared memory after the rules, `size` doubles apart.  A warp past the
// batch's end returns; in the last warp, a group past the last trajectory
// runs that trajectory again, writing the same bits to the same places, so
// that all 32 lanes take each sync.
template <int D, int G, class Model>
__global__ void __launch_bounds__(kVflThreads, kVflMinBlocks)
vector_filter_lanes_kernel(const __grid_constant__ VfgParams p, const double* __restrict__ y,
                           long long y_b, long long y_e, long long y_k,
                           const double* __restrict__ s, int n_s, int B, int n_steps,
                           const VfgStreams out, int size) {
  extern __shared__ double vfl_shared[];
  const VflRules rules = vfl_stage(p, vfl_shared, threadIdx.x, blockDim.x);
  __syncthreads();
  const int g = threadIdx.x / G;
  long long b = static_cast<long long>(blockIdx.x) * (blockDim.x / G) + g;
  if (b - (threadIdx.x & 31) / G >= B) return;  // the warp's first trajectory
  if (b >= B) b = B - 1;
  const VflLane ln = {static_cast<int>(threadIdx.x % G)};
  double* sm = vfl_shared + vfl_stage_doubles(p.base) + static_cast<long long>(g) * size;
  vfl_record<D, G, Model>(p, rules, sm, y + b * y_b, y_e, y_k, n_steps, s, n_s, out.m_fi + b,
                          out.P_fi + b, out.m_pr + b, out.P_pr + b, out.xx + b, B, ln);
}

// Launch the lane-group form; the CUDA error of the attributes or of the
// launch, cudaErrorInvalidValue where a warp's trajectories do not fit in a
// block's shared memory.
template <int D, int G, class Model>
int vfl_launch_as(const VfgParams& p, const double* y, long long y_b, long long y_e,
                  long long y_k, const double* s, int n_s, int B, int n_steps,
                  const VfgStreams& out, cudaStream_t stream) {
  const int size = vfl_layout(p.base).size, stage = vfl_stage_doubles(p.base);
  const int per_block = vfl_block_trajectories(G, size, stage);
  if (per_block == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = (stage + per_block * size) * 8;
  const auto kernel = vector_filter_lanes_kernel<D, G, Model>;
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        bytes);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(B) + per_block - 1) /
                                                per_block);
  kernel<<<blocks, per_block * G, bytes, stream>>>(p, y, y_b, y_e, y_k, s, n_s, B, n_steps, out,
                                                   size);
  return static_cast<int>(cudaGetLastError());
}
#endif
