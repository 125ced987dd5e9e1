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
// The warp form (G = VFL_WARP, 32: a trajectory on a whole warp), for rules of
// many points (Gauss-Hermite: 243 points on a 5-D state).  There the lane-group
// form's offsets and values of every point took 21-29 KB a trajectory, so an
// SM held 1-2 warps of it, and the first version (one thread a trajectory)
// holds 2.4; neither hides the latencies of a 243-deep sum.  The warp form:
// - lane l evaluates points l, l + 32, ... whole (the offsets L xi_j from the
//   factor in registers), their values to shared memory output-major (rows
//   of an odd stride), so that a lane summing an entry reads a point after
//   another and the lanes reading side by side hit different banks;
// - no offset is kept: the sums that need them (a classical rule's
//   cross-covariance) take a tile of 32 points at a time, whose offsets the
//   lanes recompute with the same operations into shared memory (lane l its
//   point), so a trajectory holds its values and one tile (12 KB on reentry
//   under GH-3, not 21);
// - a classical rule's covariance and cross-covariance are one list of
//   entries, up to VFL_SLOTS a lane at once over the tile, every entry summed
//   by one lane with the same code (w_j (d_a v), v a centred value or an
//   offset), so no lane waits on another's branch; the lanes centre the
//   tile's values; a running sum waits in its entry between tiles;
// - a block of up to 16 warps stages the rules unless that costs an SM more
//   than a quarter of its warps, else they are read from device memory
//   (vfl_fit); at most 128 registers a thread, 16 warps an SM.
// What bounds it (tools/lane_variants.py --clocks, reentry GH-3): the sums,
// half a step's clocks, a few lanes busy in the means (5 or 2 of 32), the
// transcendentals of the models; not the bytes (PERF.md, PR 22).
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

// Where a warp's time goes, phase by phase, in a build with -DVFL_CLOCKS
// (tools/lane_variants.py --clocks): lane 0 of each warp adds the clocks
// since its last mark to the next slot of its warp's row of vfl_clocks;
// vfl_mark_step starts a step's row of slots again.  Nothing in other builds.
#if defined(VFL_CLOCKS) && defined(__CUDACC__)
#define VFL_CLOCK_WARPS 16384
__device__ long long vfl_clocks[VFL_CLOCK_WARPS][16];

VF_HD void vfl_mark() {
#ifdef __CUDA_ARCH__
  if ((threadIdx.x & 31) != 0) return;
  long long* row = vfl_clocks[((blockIdx.x * blockDim.x + threadIdx.x) / 32) % VFL_CLOCK_WARPS];
  const long long t = clock64();
  row[row[15]++] += t - row[14];
  row[14] = t;
#endif
}

VF_HD void vfl_mark_step() {
#ifdef __CUDA_ARCH__
  if ((threadIdx.x & 31) != 0) return;
  long long* row = vfl_clocks[((blockIdx.x * blockDim.x + threadIdx.x) / 32) % VFL_CLOCK_WARPS];
  row[14] = clock64();
  row[15] = 0;
#endif
}
#else
VF_HD void vfl_mark() {}
VF_HD void vfl_mark_step() {}
#endif

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

// The lanes of a warp: the warp form runs a trajectory on all of them (a
// build may set 16, two trajectories a warp: tools/lane_variants.py times it).
#ifndef VFL_WARP
#define VFL_WARP 32
#endif

// Where a trajectory's arrays lie in its shared memory on G lanes, in doubles
// from its start: the state m and P (D x D, rows dp apart), the prediction
// m_pr and P_pr, the factor L of either, the predicted measurement y_pr (E),
// the points' offsets X (point j's at j * D; in the warp form a tile of 32
// points, offset c of point j0 + i at c * 33 + i, or a BQ rule's h, row e at
// e * dp) and function values F (point j's eo outputs at j * eo; in the warp
// form output e of point j at e * (n | 1) + j), a BQ rule's row sums Gq (as
// F), the covariance's lower triangle Cv (vfl_tri) and the cross-covariance
// C (entry (e, c) at e * dp + c) of either transform, the innovation
// covariance's factor Ls (vfl_tri), the gain K (row d at d * ep; then K S in
// C's room, as K); `size` doubles in all.
struct VflLayout {
  int dp, ep;
  int m, m_pr, y_pr, P, P_pr, L, X, F, Gq, Cv, C, Ls, K, size;
};

VF_HD VflLayout vfl_layout(const VfParams& q, int G) {
  const int D = q.dim_state, E = q.dim_out, nd = q.dyn.n, no = q.obs.n;
  const int n = nd > no ? nd : no, wide = E > D ? E : D;
  const int nf = G == VFL_WARP ? (vfl_stride(nd) * D > vfl_stride(no) * E ? vfl_stride(nd) * D
                                                                          : vfl_stride(no) * E)
                               : (nd * D > no * E ? nd * D : no * E);
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
  s.F = s.X + (G == VFL_WARP ? ((VFL_WARP + 1) * D > wide * s.dp ? (VFL_WARP + 1) * D
                                                                 : wide * s.dp)
                              : n * D);
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

// The most doubles a block of the lane-group form on VFL_G lanes stages (64
// KB).
#define VFL_STAGE_MAX 8192

// The doubles of both rules and R.
VF_HD long long vfl_rules_doubles(const VfParams& q) {
  return vfl_rule_doubles(q.dyn, q.dim_state) + vfl_rule_doubles(q.obs, q.dim_state) +
         static_cast<long long>(q.dim_out) * q.dim_out;
}

// The doubles a block of the lane-group form on VFL_G lanes stages: both
// rules and R, none where they exceed VFL_STAGE_MAX.
VF_HD int vfl_stage_doubles(const VfParams& q) {
  const long long n = vfl_rules_doubles(q);
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

// The rules and R a step reads: copied to `to` (thread t of nt copying its
// share) where the block stages them (`stage`, their doubles, nonzero), else
// p's own.
VF_HD VflRules vfl_stage(const VfgParams& p, double* to, int stage, int t, int nt) {
  const VfParams& q = p.base;
  VflRules s = {q.dyn, q.obs, p.r};
  if (stage == 0) return s;
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
  template <class H>
  VF_HD void operator()(const double (&x)[D], H&& h) const {
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
  template <class H>
  VF_HD void operator()(const double (&x)[D], H&& h) const {
    obs(x, h);
  }
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

// The lower triangle of the D x D factor L (rows dp apart) in registers.
template <int D>
VF_HD void vfl_factor(const double* L, int dp, double (&Lr)[D][D]) {
#pragma unroll
  for (int a = 0; a < D; ++a) {
#pragma unroll
    for (int k = 0; k < D; ++k) Lr[a][k] = k <= a ? L[a * dp + k] : 0.0;
  }
}

// The offsets L xi_j of point j: vf_offset's sums, the rule read as staged.
template <int D>
VF_HD void vfl_offset(const VfRule& R, const double (&L)[D][D], int j, double (&dx)[D]) {
  const int n = R.n;
#pragma unroll
  for (int a = 0; a < D; ++a) {
    double acc = 0.0;
#pragma unroll
    for (int k = 0; k <= a; ++k) acc = acc + L[a][k] * R.xi[k * n + j];
    dx[a] = acc;
  }
}

// The most entries a lane of the warp form sums at once over a tile of points
// (a classical rule's covariance and cross-covariance).
#define VFL_SLOTS 4

// One round of a classical rule's covariance and cross-covariance sums in the
// warp form: entries t0 + s 32 + l (s < NS) on lane l, where entry t < ntri
// is the covariance's (a, b) = vfl_tri's t-th and entry ntri + e D + c the
// cross-covariance's (e, c).  The values lie output-major (output e of point
// j at o.F[e fs + j], fs the odd stride of n).  For each tile of 32 points
// the lanes recompute the points' offsets into o.X, offset c of point j0 + i
// at o.X[c 33 + i] (lane i its point; an odd stride, so that the columns the
// lanes read side by side lie in different banks), and, in the first round
// (`centre`), centre the points' values
// in place (f - mu, vfg_moments' d); then every lane adds the tile's terms
// w_j (u_j v_j) to each of its entries in point order, u v being d_a d_b or
// d_e dx_c: vfg_moments' terms, one code for both kinds, both factors read
// a point after another.  An entry's running sum waits in its place in o.Cv
// or o.C between tiles.
template <int D, int NS>
VF_HD void vfl_tile_round(const VfRule& R, int eo, int t0, int ntask, bool centre,
                          const double* L, const VflMoments& o, const VflLane& ln) {
  constexpr int G = VFL_WARP, xs = G + 1;
  const int n = R.n, fs = vfl_stride(n), dp = o.dp, ntri = eo * (eo + 1) / 2;
#pragma unroll 1
  for (int j0 = 0; j0 < n; j0 += G) {
    const int nt = n - j0 < G ? n - j0 : G;
    VFL_LANES(l, G, ln) {
      if (l < nt) {
        double Lr[D][D], dx[D];
        vfl_factor(L, dp, Lr);
        vfl_offset(R, Lr, j0 + l, dx);
#pragma unroll
        for (int c = 0; c < D; ++c) o.X[c * xs + l] = dx[c];
        if (centre) {
#pragma unroll 1
          for (int e = 0; e < eo; ++e) o.F[e * fs + j0 + l] = o.F[e * fs + j0 + l] - o.mu[e];
        }
      }
    }
    vfl_sync(ln);
    VFL_LANES(l, G, ln) {
      const double *u[NS], *v[NS];
      double *to[NS], acc[NS];
      bool live[NS];
#pragma unroll
      for (int s = 0; s < NS; ++s) {
        int t = t0 + s * G + l;
        live[s] = t < ntask;
        if (!live[s]) t = 0;  // any entry: its sum is not stored
        int a = 0, b = 0;
        if (t < ntri) {
          vfl_tri_step(t, a, b);
          v[s] = o.F + b * fs + j0;
          to[s] = o.Cv + t;
        } else {
          a = (t - ntri) / D;
          b = t - ntri - a * D;
          v[s] = o.X + b * xs;
          to[s] = o.C + a * dp + b;
        }
        u[s] = o.F + a * fs + j0;
        acc[s] = j0 > 0 && live[s] ? *to[s] : 0.0;
      }
      const double* w = R.wc + j0;
#pragma unroll 4
      for (int i = 0; i < nt; ++i) {
        const double wi = w[i];
#pragma unroll
        for (int s = 0; s < NS; ++s) acc[s] = acc[s] + wi * (u[s][i] * v[s][i]);
      }
#pragma unroll
      for (int s = 0; s < NS; ++s)
        if (live[s]) *to[s] = acc[s];
    }
    vfl_sync(ln);
  }
}

// The moments of f over rule R (eo outputs) at the Gaussian (m, L L^T) of a
// trajectory on a whole warp: vfl_moments' results and bits, the values kept
// output-major (output e of point j at o.F[e fs + j], fs the odd stride of
// n; a BQ rule's row sums likewise in o.Gq) so that a lane summing an entry
// reads a point after
// another, a tile of offsets (vfl_tile_round) in o.X instead of every
// point's, a classical rule's values centred a tile at a time.  A BQ rule's
// sums go an entry a lane as in vfl_moments, its h (eo x D, rows dp apart) to
// o.X before h L^T.
template <int D, class Eval>
VF_HD void vfl_moments_warp(const VfRule& R, int eo, const double* m, const double* L,
                            const Eval& f, const VflMoments& o, const VflLane& ln) {
  constexpr int G = VFL_WARP;
  const int n = R.n, fs = vfl_stride(n), dp = o.dp, ntri = eo * (eo + 1) / 2;
  VFL_LANES(l, G, ln) {
    double Lr[D][D], mr[D];
    vfl_factor(L, dp, Lr);
#pragma unroll
    for (int a = 0; a < D; ++a) mr[a] = m[a];
#pragma unroll 1
    for (int j = l; j < n; j += G) {
      double dx[D], x[D];
      vfl_offset(R, Lr, j, dx);
#pragma unroll
      for (int a = 0; a < D; ++a) x[a] = mr[a] + dx[a];
      f(x, VfgCol{o.F + j, fs});
    }
  }
  vfl_sync(ln);
  vfl_mark();
  // the mean, an entry a lane; (BQ) the row sums g_i[e], an entry a lane
  VFL_LANES(l, G, ln) {
#pragma unroll 1
    for (int e = l; e < eo; e += G) {
      const double* fe = o.F + e * fs;
      double acc = 0.0;
#pragma unroll 4
      for (int j = 0; j < n; ++j) acc = acc + R.wm[j] * fe[j];
      o.mu[e] = acc;
    }
    if (R.kind != 0) {
#pragma unroll 1
      for (int t = l; t < n * eo; t += G) {
        const int e = t / n, i = t - e * n;
        const double *w = R.Wc + static_cast<long long>(i) * n, *fe = o.F + e * fs;
        double acc = 0.0;
#pragma unroll 4
        for (int j = 0; j < n; ++j) acc = acc + w[j] * fe[j];
        o.Gq[e * fs + i] = acc;
      }
    }
  }
  vfl_sync(ln);
  vfl_mark();
  if (R.kind == 0) {
    const int ntask = ntri + eo * D;
#pragma unroll 1
    for (int t0 = 0; t0 < ntask; t0 += G * VFL_SLOTS) {
      const int rows = (ntask - t0 + G - 1) / G;
      const bool centre = t0 == 0;
      if (rows >= 4)
        vfl_tile_round<D, 4>(R, eo, t0, ntask, centre, L, o, ln);
      else if (rows == 3)
        vfl_tile_round<D, 3>(R, eo, t0, ntask, centre, L, o, ln);
      else if (rows == 2)
        vfl_tile_round<D, 2>(R, eo, t0, ntask, centre, L, o, ln);
      else
        vfl_tile_round<D, 1>(R, eo, t0, ntask, centre, L, o, ln);
    }
    vfl_mark();
    return;
  }
  // BQ: the covariance's lower triangle, then h[e][c] = sum_i Wcc_ci f_i[e]
  // into o.X, an entry a lane
  VFL_LANES(l, G, ln) {
#pragma unroll 1
    for (int t = l; t < ntri + eo * D; t += G) {
      double acc = 0.0;
      if (t < ntri) {
        int a = 0, b = 0;
        vfl_tri_step(t, a, b);
        const double *fa = o.F + a * fs, *gb = o.Gq + b * fs;
#pragma unroll 4
        for (int i = 0; i < n; ++i) acc = acc + fa[i] * gb[i];
        acc = acc - o.mu[a] * o.mu[b];
        if (a == b) acc = acc + R.emv;
        o.Cv[t] = acc;
      } else {
        const int e = (t - ntri) / D, c = t - ntri - e * D;
        const double *w = R.Wcc + c * n, *fe = o.F + e * fs;
#pragma unroll 4
        for (int i = 0; i < n; ++i) acc = acc + w[i] * fe[i];
        o.X[e * dp + c] = acc;
      }
    }
  }
  vfl_sync(ln);
  // the cross-covariance h L^T, an entry a lane
  VFL_LANES(l, G, ln) {
#pragma unroll 1
    for (int t = l; t < eo * D; t += G) {
      const int e = t / D, c = t - e * D;
      double x = 0.0;
#pragma unroll 1
      for (int a = 0; a <= c; ++a) x = x + o.X[e * dp + a] * L[c * dp + a];
      o.C[e * dp + c] = x;
    }
  }
  vfl_sync(ln);
  vfl_mark();
}

// The moments of a transform on G lanes: the warp form's or vfl_moments.
template <int D, int G, class Eval>
VF_HD void vfl_transform(const VfRule& R, int eo, const double* m, const double* L,
                         const Eval& f, const VflMoments& o, const VflLane& ln) {
  if constexpr (G == VFL_WARP)
    vfl_moments_warp<D>(R, eo, m, L, f, o, ln);
  else
    vfl_moments<D, G>(R, eo, m, L, f, o, ln);
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
  vfl_mark_step();
  vfl_chol<G>(D, VflSquare{P, dp}, L, VflSquare{L, dp}, ln);
  vfl_mark();
  vfl_transform<D, G>(rules.dyn, D, m, L, VflDynAt<D, Dyn>{dyn},
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
  vfl_mark();
  vfl_transform<D, G>(rules.obs, E, m_pr, L, VflObsAt<D, Obs>{obs},
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
  vfl_mark();
}

// A whole record of one trajectory on G lanes, its arrays at sm: vfg_record's
// layouts and streams, the models of Model, the rules and R of `rules`.
template <int D, int G, class Model>
VF_HD void vfl_record(const VfgParams& p, const VflRules& rules, double* sm, const double* y,
                      long long y_e, long long y_k, int T, const double* s, int n_s,
                      double* m_fi, double* P_fi, double* m_pr, double* P_pr, double* xx,
                      long long cs, const VflLane& ln) {
  const VfParams& q = p.base;
  const VflLayout lay = vfl_layout(q, G);
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

// An sm_90 SM's shared memory and what it reserves for each block, in bytes,
// and the blocks of the lane-group kernel its registers hold (the launch
// bounds below); for the warp form, the warps a block holds at most and the
// warps of an SM its registers hold.
#define VFL_SM_SHARED 233472
#define VFL_BLOCK_RESERVED 1024
#define VFL_SM_BLOCKS 10
#define VFL_WARP_BLOCK_WARPS 16
#define VFL_WARP_SM_WARPS 16

// How a configuration runs in the lane-group form on G lanes: the
// trajectories a block holds (0 where the launcher refuses it), the doubles a
// block stages (both rules and R; 0: read from device memory), the doubles
// of a trajectory's shared memory and the warps an SM holds.  ops/vector_
// filter.py (lanes_of, kernel_of) asks the same through vector_filter_fit.cpp.
struct VflFit {
  int per_block, stage, size, warps;
};

// The warp form with `stage` doubles staged: of 16 down to 1 warps a block,
// the count that lets an SM hold the most warps (the larger on a tie).
VF_HD VflFit vfl_warp_fit(int size, int stage) {
  constexpr int per_warp = 32 / VFL_WARP;
  VflFit best = {0, stage, size, 0};
  for (int warps = VFL_WARP_BLOCK_WARPS; warps >= 1; --warps) {
    const long long doubles = stage + static_cast<long long>(warps) * per_warp * size;
    if (doubles > VFL_MAX_SHARED) continue;
    long long blocks = VFL_SM_SHARED / (doubles * 8 + VFL_BLOCK_RESERVED);
    if (blocks > VFL_WARP_SM_WARPS / warps) blocks = VFL_WARP_SM_WARPS / warps;
    if (blocks * warps > best.warps)
      best = {warps * per_warp, stage, size, static_cast<int>(blocks * warps)};
  }
  return best;
}

// How q runs on G lanes.  On VFL_G lanes: blocks of vfl_block_trajectories
// trajectories beside the rules staged up to VFL_STAGE_MAX, as many as the
// SM's shared memory and registers allow.  In the warp form (vfl_warp_fit):
// the rules staged unless that leaves an SM fewer than three quarters of the
// warps it holds with them in device memory (every sum reads a weight a
// point, and a load from device memory waits some hundred clocks where
// shared memory answers in some tens).
VF_HD VflFit vfl_fit(const VfParams& q, int G) {
  const int size = vfl_layout(q, G).size;
  if (G == VFL_WARP) {
    const long long rules = vfl_rules_doubles(q);
    const VflFit bare = vfl_warp_fit(size, 0);
    if (rules > VFL_MAX_SHARED) return bare;
    const VflFit staged = vfl_warp_fit(size, static_cast<int>(rules));
    return staged.warps > 0 && 4 * staged.warps >= 3 * bare.warps ? staged : bare;
  }
  const int stage = vfl_stage_doubles(q), per_block = vfl_block_trajectories(G, size, stage);
  if (per_block == 0) return {0, stage, size, 0};
  const long long blocks =
      VFL_SM_SHARED / ((stage + static_cast<long long>(per_block) * size) * 8 + VFL_BLOCK_RESERVED);
  return {per_block, stage, size,
          static_cast<int>((blocks < VFL_SM_BLOCKS ? blocks : VFL_SM_BLOCKS) * per_block * G / 32)};
}

#ifdef __CUDACC__
// On VFL_G lanes two warps a block, 10 blocks an SM: at most 96 registers a
// thread, so that the 2,500 warps of 10,000 trajectories on 8 lanes fit on
// the card in one wave where shared memory allows.  The warp form: up to 16
// warps a block, so that up to 16 trajectories share the staged rules, one
// block an SM: at most 128 registers a thread.
#define VFL_THREADS(G) ((G) == VFL_WARP ? 32 * VFL_WARP_BLOCK_WARPS : 64)
#define VFL_MIN_BLOCKS(G) ((G) == VFL_WARP ? VFL_WARP_SM_WARPS / VFL_WARP_BLOCK_WARPS : VFL_SM_BLOCKS)

// The lane-group kernel: the block stages the rules (`stage` doubles of
// them, none if 0), then trajectory b runs on lanes G b .. G b + G - 1 of the
// grid, its arrays in the block's dynamic shared memory after the rules,
// `size` doubles apart.  A warp past the batch's end returns; in the last
// warp, a group past the last trajectory runs that trajectory again, writing
// the same bits to the same places, so that all 32 lanes take each sync.
template <int D, int G, class Model>
__global__ void __launch_bounds__(VFL_THREADS(G), VFL_MIN_BLOCKS(G))
vector_filter_lanes_kernel(const __grid_constant__ VfgParams p, const double* __restrict__ y,
                           long long y_b, long long y_e, long long y_k,
                           const double* __restrict__ s, int n_s, int B, int n_steps,
                           const VfgStreams out, int size, int stage) {
  extern __shared__ double vfl_shared[];
  const VflRules rules = vfl_stage(p, vfl_shared, stage, threadIdx.x, blockDim.x);
  __syncthreads();
  const int g = threadIdx.x / G;
  long long b = static_cast<long long>(blockIdx.x) * (blockDim.x / G) + g;
  if (b - (threadIdx.x & 31) / G >= B) return;  // the warp's first trajectory
  if (b >= B) b = B - 1;
  const VflLane ln = {static_cast<int>(threadIdx.x % G)};
  double* sm = vfl_shared + stage + static_cast<long long>(g) * size;
  vfl_record<D, G, Model>(p, rules, sm, y + b * y_b, y_e, y_k, n_steps, s, n_s, out.m_fi + b,
                          out.P_fi + b, out.m_pr + b, out.P_pr + b, out.xx + b, B, ln);
}

// Launch the lane-group form on G lanes (VFL_G, or VFL_WARP: the warp form);
// the CUDA error of the attributes or of the launch, cudaErrorInvalidValue
// where a warp's trajectories do not fit in a block's shared memory.
template <int D, int G, class Model>
int vfl_launch_as(const VfgParams& p, const double* y, long long y_b, long long y_e,
                  long long y_k, const double* s, int n_s, int B, int n_steps,
                  const VfgStreams& out, cudaStream_t stream) {
  const VflFit fit = vfl_fit(p.base, G);
  if (fit.per_block == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = (fit.stage + fit.per_block * fit.size) * 8;
  const auto kernel = vector_filter_lanes_kernel<D, G, Model>;
  cudaError_t rc = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                        bytes);
  if (rc == cudaSuccess)
    rc = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const unsigned blocks = static_cast<unsigned>(
      (static_cast<long long>(B) + fit.per_block - 1) / fit.per_block);
  kernel<<<blocks, fit.per_block * G, bytes, stream>>>(p, y, y_b, y_e, y_k, s, n_s, B, n_steps,
                                                       out, fit.size, fit.stage);
  return static_cast<int>(cudaGetLastError());
}
#endif
