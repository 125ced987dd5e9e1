// The room the lane-group and warp forms of the general and registered vector
// filter kernels (vector_filter_lanes.cuh) take for a configuration, and
// whether the general kernel's shaped one-thread form has an instantiation of
// it (vector_filter_general_shaped.cuh), reckoned on the host by the headers'
// own functions, so that ops/vector_filter.py (lanes_of, kernel_of) routes a
// shape to a form only where its launcher takes it; the lanes of the slot
// kernel's instantiation of it and the slot design of a registered
// configuration (vector_filter_slots.cuh).  Built with g++: it
// instantiates no step, so it builds in a second or two.
#include "vector_filter_general_shaped.cuh"
#include "vector_filter_lanes.cuh"
#include "vector_filter_slots.cuh"

// vfl_fit on `lanes` lanes (VFL_G, or VFL_WARP: the warp form) into out: the
// trajectories a block holds (0 where the launcher refuses the shape), the
// doubles a block stages (0: the rules read from device memory), the
// doubles of a trajectory's shared memory, the warps an SM holds.
extern "C" void vfl_fit_on(const VfParams* params, int lanes, int* out) {
  const VflFit fit = vfl_fit(*params, lanes);
  out[0] = fit.per_block;
  out[1] = fit.stage;
  out[2] = fit.size;
  out[3] = fit.warps;
}

// vgs_takes: 1 if the general kernel's shaped form has an instantiation of
// the configuration (a pair of VGS_PAIRS, both rules classical, each at
// 2 D + 1 or 2 D points, or both at the Gauss-Hermite count of VGS_GH),
// else 0.
extern "C" int vgs_takes_on(const VfParams* params) { return vgs_takes(*params) ? 1 : 0; }

// vsl_lanes_of: the lanes a trajectory of the slot kernel's instantiation of
// the configuration runs on (VSL_SHAPES, VSL_GENERAL), 0 if none takes it.
extern "C" int vsl_lanes_on(const VfParams* params) { return vsl_lanes_of(*params); }

// vsr_design into out: the lanes (0: none), split and keep of the slot
// design of a registered configuration of D states, E outputs and N points.
extern "C" void vsr_design_on(int D, int E, int N, int* out) {
  const VslDesignOf d = vsr_design(D, E, N);
  out[0] = d.G;
  out[1] = d.split;
  out[2] = d.keep;
}
