// The room the lane-group form of the general and registered vector filter
// kernels (vector_filter_lanes.cuh) takes for a configuration, reckoned on the
// host by the header's own functions, so that ops/vector_filter.py (lanes_of)
// routes a shape to that form only where its launcher takes it.  Built with
// g++: it instantiates no step, so it builds in a second or two.
#include "vector_filter_lanes.cuh"

// The trajectories a block holds on VFL_G lanes a trajectory
// (vfl_block_trajectories); 0 where one warp's trajectories do not fit in a
// block's shared memory, and the launcher refuses the shape.
extern "C" int vfl_fit_block(const VfParams* params) { return vfl_block_of(*params); }

// The warps of the lane-group form an SM holds (vfl_sm_warps).
extern "C" int vfl_fit_warps(const VfParams* params) { return vfl_sm_warps(*params); }

// The doubles of a trajectory's shared memory (vfl_layout) and of the rules
// and R a block stages (vfl_stage_doubles, 0 where they are read from device
// memory).
extern "C" int vfl_fit_doubles(const VfParams* params) { return vfl_layout(*params).size; }
extern "C" int vfl_fit_stage(const VfParams* params) { return vfl_stage_doubles(*params); }
