// Host build of the scalar filter steps (scalar_filter_step.cuh and the general
// form's scalar_filter_step_general.cuh, which includes it), for testing
// the kernel's arithmetic on a machine without a GPU.  It picks the template
// instantiation as the CUDA launchers do (kinds of both rules, the smallest
// slot count that holds them; the general and registered forms' slot design
// up to SF_MAX_SLOTS points, one thread a trajectory above) and runs it with
// one lane a trajectory, one trajectory after another; same layouts and the
// same order of every sum.  The slot design's rules are staged as the kernel
// stages them in shared memory.
//
// Built with -DSFR_REGISTERED beside a generated sfr_forms.cuh
// (ops/scalar_filter.py, build_registered), it holds only sfr_host_run, the
// general form's designs on the registered models, as
// scalar_filter_registered.cu launches them.
#include "scalar_filter_step_general.cuh"

namespace {

// The slot design <KD, KO, N> on Model's functors made from p, one lane a
// trajectory, the trajectories one after another, with the kernel's layouts.
template <int KD, int KO, int N, class Model, class P>
void run_slots(const P& p, const SfsRules& v, const double* y, long long y_step,
               long long y_traj, const double* s, int n_s, int B, int n_steps, double* m_fi,
               double* P_fi, double* m_pr, double* P_pr, double* xx) {
  SfSlotWc<KD, N> wd;
  SfSlotWc<KO, N> wo;
  sfs_stage(wd, sf_base(p).dyn, 0, 1);
  sfs_stage(wo, sf_base(p).obs, 0, 1);
  const SfSlotRule<KD, N> rd = sfs_rule(v.dyn, wd, sf_base(p).dyn);
  const SfSlotRule<KO, N> ro = sfs_rule(v.obs, wo, sf_base(p).obs);
  for (int b = 0; b < B; ++b)
    sfs_record<KD, KO, N, 1, Model>(p, rd, ro, 0, y + b * y_traj, y_step, s, n_s, n_steps, B,
                                    true, m_fi + b, P_fi + b, m_pr + b, P_pr + b, xx + b);
}

}  // namespace

#ifdef SFR_REGISTERED
#include "sfr_forms.cuh"

namespace {

// Configuration <Model, KD, KO, N> in its design; returns N, or 1 for the
// one-thread form (N = 0).
template <class Model, int KD, int KO, int N>
int run_pair(const SfrParams& p, const SfsRules* v, const double* y, long long y_step,
             long long y_traj, const double* s, int n_s, int B, int n_steps, double* m_fi,
             double* P_fi, double* m_pr, double* P_pr, double* xx, double* scratch) {
  if constexpr (N > 0) {
    run_slots<KD, KO, N, Model>(p, *v, y, y_step, y_traj, s, n_s, B, n_steps, m_fi, P_fi,
                                m_pr, P_pr, xx);
    return N;
  } else {
    for (int b = 0; b < B; ++b)
      sfg_record<Model>(p, p.base, y + b * y_traj, y_step, s, n_s, n_steps, scratch + b, B,
                        m_fi + b, P_fi + b, m_pr + b, P_pr + b, xx + b);
    return 1;
  }
}

}  // namespace

// Configuration `pair` of SFR_PAIRS on the trajectories one after another,
// with sfr_launch's layouts.  Returns its slot count (1 for the one-thread
// form), or 0 if `pair` is not one of the library's or the rules cannot run
// or are not of its kinds and slots.
extern "C" int sfr_host_run(int pair, const SfrParams* params, const SfsRules* vecs,
                            const double* y, long long y_step, long long y_traj, const double* s,
                            int n_s, int B, int n_steps, double* m_fi, double* P_fi,
                            double* m_pr, double* P_pr, double* xx, double* scratch) {
  const SfrParams& p = *params;
  if (!sfg_rules_ok(p.base)) return 0;
  const int slots = sf_slots(p.base.dyn.n, p.base.obs.n);
#define SFR_RUN_IF(I, MODEL, KD, KO, N)                                                    \
  if (pair == I && p.base.dyn.kind == KD && p.base.obs.kind == KO && slots == N)          \
    return run_pair<MODEL, KD, KO, N>(p, vecs, y, y_step, y_traj, s, n_s, B, n_steps, m_fi, \
                                      P_fi, m_pr, P_pr, xx, scratch);
  SFR_PAIRS(SFR_RUN_IF)
#undef SFR_RUN_IF
  return 0;
}

#else

namespace {

template <int KD, int KO, int N>
void run(const SfParams& p, const double* y, long long y_step, long long y_traj,
         const double* c, int B, int n_steps, double* m_fi, double* P_fi, double* m_pr,
         double* P_pr, double* xx) {
  SfStepper<KD, KO, N, 1> filter;
  filter.load(p, 0);
  for (int b = 0; b < B; ++b) {
    double m = p.m0, P = p.P0;
    for (int k = 0; k < n_steps; ++k) {
      const long long o = static_cast<long long>(k) * B + b;
      const SfStep s = filter.step(p, m, P, y[k * y_step + b * y_traj], c[k]);
      m_pr[o] = s.m_pr;
      P_pr[o] = s.P_pr;
      xx[o] = s.xx;
      m_fi[o] = s.m_fi;
      P_fi[o] = s.P_fi;
      m = s.m_fi;
      P = s.P_fi;
    }
  }
}

}  // namespace

// Returns the slot count of the instantiation that ran, 0 if none takes the
// shape.
extern "C" int sf_host_run(const SfParams* params, const double* y, long long y_step,
                           long long y_traj, const double* c, int B, int n_steps,
                           double* m_fi, double* P_fi, double* m_pr, double* P_pr,
                           double* xx) {
  const SfRule &d = params->dyn, &o = params->obs;
  if (d.n < 1 || d.n > SF_MAX_PTS || o.n < 1 || o.n > SF_MAX_PTS || (d.kind | o.kind) >> 1)
    return 0;
  const int slots = sf_slots(d.n, o.n);
#define SF_RUN_IF(KD, KO, N)                                                             \
  if (d.kind == KD && o.kind == KO && slots == N)                                        \
    run<KD, KO, N>(*params, y, y_step, y_traj, c, B, n_steps, m_fi, P_fi, m_pr, P_pr, xx);
  SF_SHAPES(SF_RUN_IF)
#undef SF_RUN_IF
  return slots;
}

// The general form (scalar_filter_step_general.cuh): any rule, any 1-D
// measurement, the trajectories one after another with the kernel's layouts;
// up to SF_MAX_SLOTS points the slot design (the rules' vectors in *vecs),
// above it one thread a trajectory (scratch of max(n_dyn, n_obs) * B doubles,
// interleaved by trajectory).
// Returns the slot count that ran (1 for the one-thread form), or 0 for a
// configuration the form does not take.
extern "C" int sfg_host_run(const SfgParams* params, const SfsRules* vecs, const double* y,
                            long long y_step, long long y_traj, const double* c, int B,
                            int n_steps, double* m_fi, double* P_fi, double* m_pr,
                            double* P_pr, double* xx, double* scratch) {
  const SfgParams& p = *params;
  if (!sfg_rules_ok(p) || p.obs_model < 0 || p.obs_model > SF_OBS_RANGE) return 0;
  const int slots = sf_slots(p.dyn.n, p.obs.n);
  if (slots) {
#define SFS_RUN_IF(KD, KO, N)                                                              \
    if (p.dyn.kind == KD && p.obs.kind == KO && slots == N) {                              \
      run_slots<KD, KO, N, SfgZoo>(p, *vecs, y, y_step, y_traj, c, 1, B, n_steps, m_fi,     \
                                   P_fi, m_pr, P_pr, xx);                                  \
      return N;                                                                            \
    }
    SFS_SHAPES(SFS_RUN_IF)
    SFS_WIDE_SHAPES(SFS_RUN_IF)
#undef SFS_RUN_IF
    return 0;
  }
  for (int b = 0; b < B; ++b)
    sfg_record<SfgZoo>(p, p, y + b * y_traj, y_step, c, 1, n_steps, scratch + b, B, m_fi + b,
                       P_fi + b, m_pr + b, P_pr + b, xx + b);
  return 1;
}

// The design of a launch on the card (sf_design_of in
// scalar_filter_step_general.cuh), as the CUDA library's sf_design reports it.
extern "C" void sf_design(int shaped, int kind_dyn, int kind_obs, int n_dyn, int n_obs,
                          int* slots, int* lanes) {
  sf_design_of(shaped, kind_dyn, kind_obs, n_dyn, n_obs, slots, lanes);
}
#endif
