#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ssmtoybox_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc`` (PATH, $CUDA_HOME or /usr/local/cuda); it
fails at once without them.  Phases, each fatal on failure:

1. set-up: print the card's name and power limit, build the CUDA sources
   ``ssmtoybox_torch/csrc/scalar_filter.cu``, ``scalar_filter_slots.cu``,
   ``scalar_filter_slots_wide.cu``, ``student_mc.cu``, ``student_qrq.cu``,
   ``vandermonde.cu``, ``vector_filter.cu``, ``vector_filter_shaped.cu``,
   ``vector_filter_shaped_bq.cu``, ``vector_filter_general.cu``,
   ``vector_filter_general_shaped.cu``,
   ``vector_filter_general_shaped_mixed.cu`` and
   ``vector_filter_shaped_bq_mixed.cu`` for sm_90a (one nvcc each, at once;
   the three scalar filter sources make one library, the two Student-MC
   sources another, the seven vector filter sources a third), print each library's build time and
   their ptxas lines; the UNGM UKF lane is built with no device argument and
   must lie on the card, the port's default device;
2. the scalar filter kernel vs its plain PyTorch twin, both on the card, for
   the UKF and the GPQ rule: one step at B=4096 (pointwise 1e-13), 20 steps
   at B=4096 (pointwise 1e-9), and study RMSE at B=10,000 x 500 steps
   (relative 1e-3; the UNGM map decorrelates single trajectories); then the
   kernel against its twin to the bit through every instantiation its
   launcher can pick (classical and BQ rules of 3, 5 and 7 points, a mixed
   pair, 4- and 8-point rules that run padded; the general form's GH-9,
   GH-15, GPQ-GH15 and mixed rules) at B = 1, 7, 4,097 and 10,000, two
   launches on one input, and trajectory-major measurements read through
   their strides;
3. the port against the repo's golden references (tests/goldens) on the card;
4. the Gaussian main path at the study sizes: 10,000 trajectories in
   float64, UNGM UKF and GPQKF through the scalar filter kernel and reentry
   UKF through the shaped vector filter kernel (``engine="dd"``, one launch of
   ``vector_filter_shaped``, none of the first version), then the RTS
   smoother and RMSE;
5. timings with CUDA events after a warm-up;
6. the four RBF-Student Monte-Carlo kernels vs their plain versions on the
   same samples, at the CV radar glint study's shapes (D = 4, the 9 points of
   the TPQSF dynamics rule, 2e6 samples): q, R, Q and E[k(x, y)] within 1e-5
   relative, the backward kernels' gradients against autograd through the
   plain versions at rtol 1e-4 / atol 1e-5; all four kernels twice on one
   input, equal to the bit; their timings, the host time of one
   ``kxy_chunk_sums`` call part by part, the SM clock before and after the
   profiled launches, and raw launches of each (behind ``torch.cuda._sleep``);
   the q/R/Q kernels also at N = 33 (D = 4) and N = 128 (D = 8), against
   their plain versions and timed beside their bounds;
7. Student goldens on the card: FSQ on ``ungm_student.npz`` (1e-8) and the
   TP weights at 2e6 samples on ``tpq_cv_weights.npz`` (the tolerances and
   eigenvalue check of ``tests/test_parity.py``);
8. the Student-t BQ path at full width: the CV radar glint study, 10,000
   trajectories x 100 steps simulated on the card, TPQSF, GPQSF and FSQ built
   on the card (weights from 2e6 samples), filter and smoother of each, RMSE,
   INC and the diverged share, with the launch counts of the four kernels;
   then the timings of the weights, filters and smoothers;
9. the Vandermonde kernel (``csrc/vandermonde.cu``) against its plain
   version on the card, bit-equal, at the BSQ weight shapes (D = 1 with N =
   3, 5, 7; D = 5 with N = Q = 11), the verifiers' batch (D = 5, 100,000
   samples) and a wide shape (D = 5, 1,000,000 samples, Q = 21), at N = 1,
   N one short of, equal to and one over a tile of 128 points, 40 columns
   (two column tiles), D = 9 (coordinates not held in registers) and two
   multi-indices too large to travel by value (staged in shared memory); the
   scalar filter kernel at 7 points (GH-7, BSQ-GH7) against its twin,
   bit-equal;
10. BSQ goldens on the card: ``ungm.npz`` ``bsqkf`` (f64 and dd, filter and
    smoother) and ``ghkf5`` (dd) at 1e-8, ``reentry.npz`` ``bsqkf`` at
    1e-7 / 1e-6, ``transforms.npz`` ``bs_gh_*`` and ``bs_uni_*`` at 1e-8;
11. the BSQ UNGM study (``experiments/bsq_ungm.py``) on the main path's
    10,000 x 500 data: the nine lanes (UT, GH-5, GH-7, each classical, GPQ
    and BSQ) through the kernel, the smoother, RMSE / NCI / NLL and the
    diverged share; the BSQ lanes also through eager f64 (study RMSE within
    1e-3); it fails on fewer than 6 Vandermonde launches while the filters
    are built or 9 scalar filter launches, more than 1% non-finite runs, or
    a BSQ-GH NCI not below the classical GH one;
12. the BSQ reentry tracking study (``experiments/bsq_tracking.py``): truth
    by Euler-Maruyama at dt 0.05 for 100 s (the study's 200 s cut for time),
    10,000 trajectories, 1,000 filter steps; BSQKF with three EMV
    overrides and the UKF, each through
    ``engine="auto"`` (the UKF runs in the shaped vector filter kernel, the BSQ
    lanes' matrix overrides send them to the eager path) and the UKF also
    eagerly; fails unless the engines are those, the UKF lane's kernel
    result equals the plain version run on the same 10,000 x 1,000 input to
    the bit (all five streams), the UKF's RMSE is the eager lane's to the
    digits printed and RMSE orders bsqkf < bsqkf_2e-6 < ukf;
13. the Monte-Carlo verifiers (10 x 100,000 samples) on the tracking
    dynamics rule: ``mc_exp_x_kxpx`` against the closed form at atol 5e-3,
    10 and 11 Vandermonde launches;
14. timings: the Vandermonde kernel and its plain version at each shape, the
    BSQ transform builds, every UNGM lane (dd, eager f64, smoother), the
    tracking UKF lane through the kernel once more, the scalar filter kernel
    at 3 and 7 points; for the
    scalar filter and Vandermonde kernels also raw launches through the
    libraries' C entry points between CUDA events, which do not depend on
    what the profiler records; the host time of a ``scalar_filter`` call, of
    a UNGM lane and of a ``vandermonde`` call part by part, each wrapper
    call and lane beside its raw launch, the transposed copy the lane no
    longer makes, the two verifiers' 21 calls, and the chain floor of the
    scalar filter kernel (the dependent-issue latencies of the card times the
    operations on the critical path of a step) beside its bound; the shaped
    vector filter kernel on the tracking UKF lane (raw launches, the first
    version's on the same input, bound, chain floor);
15. the vector filter kernels against their plain version, both on
    the card, to the bit, 20 steps, all five streams, at every instantiation
    of the eleven sources: the five model pairs (reentry and CV with the
    radar, the pendulum, the falling body with its range, CT with four
    bearings) under UKF, CKF, a BQ rule at the UT count (GPQ-UT; BSQ-UT too
    on reentry, on CV instead) and GPQ with spherical-radial points, every
    rule on both transforms, the mixed kinds of both counts, the UKF beside
    the CKF and a BQ rule beside the other count either way round (on CV
    every pair of its four rules), GH-3 on reentry, and the Gauss-Hermite
    rules of ``VF_GH_RULES`` (GH-3 on the pendulum, GH-2 and GH-3 on the
    falling body and CV, GH-2 on reentry and CT): the classical shaped
    kernel (``csrc/vector_filter_shaped.cu``, 22 instantiations: 4 pairs of
    point counts of each model pair, and 9 points on the pendulum, 8 on the
    falling body), the slot kernel (``csrc/vector_filter_slots.cu``, 5:
    Gauss-Hermite rules of 16-81 points on 2 or 4 lanes a trajectory; 16
    more of the general pairs, ``VSL_GENERAL``, below), the
    kernel of the BQ shapes
    (``csrc/vector_filter_shaped_bq.cu`` and ``_mixed.cu``, 60: one count on
    both transforms or the two mixed, three pairs of kinds) and, at every pair
    (sent there by force where another kernel takes it), the first version
    (``csrc/vector_filter.cu``, 20), at B = 1, 7, 31, 4,097 and 10,000, each
    wrapper launch counted on the kernel ``kernel_of`` names, each batch
    against the plain version's run on all 10,000 (elementwise across
    trajectories: the same bits for a prefix); the general kernel
    (``csrc/vector_filter_general.cu``, 16 one-thread instantiations: D = 2-5
    x a bound of 2, 4 or 8 on E, or the wide form of bearings from 9-12
    sensors; 4 of its lane-group form, ``csrc/vector_filter_lanes.cuh``: D
    on 8 lanes; 4 of its warp form, D on 32 lanes; 53 of its shaped
    one-thread form, ``csrc/vector_filter_general_shaped.cu``,
    ``csrc/vector_filter_general_shaped_mixed.cu`` and
    ``csrc/vector_filter_general_shaped_gh.cu``: 12 pairs at the UT and
    CKF counts, on both transforms or mixed, and 5 at the Gauss-Hermite
    count of 8 or 9 points) on ``VF_GENERAL_CASES``,
    the pairs only it takes, every pair of rule kinds, at the same batch
    sizes through the wrapper (the shaped form under the UKF and the CKF,
    alone or beside each other, and GH-3 on 2-D or GH-2 on 3-D states, up
    to 4 outputs, the lane-group form above, the warp form under GH-3 on
    5-D states; the slot kernel, ``csrc/vector_filter_general_slots.cu`` and
    ``_hi.cu``, under GH-2 to GH-4 of 16-81 points, its 16 instantiations of
    ``VSL_GENERAL``), the
    general one-thread form of those by force on all 10,000,
    and by force, one thread and warp form, on the UKF of the five other
    pairs (GH-3 on reentry runs in the warp form through the wrapper); it
    fails if an instantiation ran no configuration; two launches on one input
    equal to the bit;
16. the reentry bench lane (10,000 x 100, the main path's run) through the
    shaped kernel against the eager f64 lane: each stream's max |diff| within
    the JAX package's dd-vs-f64 tolerances (1e-6 on means, 1e-7 on
    covariances), filter and smoother RMSE within 1e-6 relative, one launch a
    call; then the other kernels' paths, their launches counted from 0: the
    same data under BSQ-UT (the kernel of the BQ shapes), under GH-3 (the
    general kernel's warp form), under the UKF beside the CKF (the classical
    shaped kernel at mixed counts; these two with their filter RMSE within
    1e-6 relative of the eager f64 lane's, every run finite), under GPQ-UT
    beside the CKF (the kernel of the BQ shapes at mixed counts; the first
    version by force on the same input, to the bit too) and under GH-2 (32
    points: the slot kernel, the first version by force on the same input,
    to the bit too; its filter RMSE within 1e-6 relative of the eager f64
    lane's), and the pendulum under GH-4 (16 points, 10,000 x 50: the first
    version, which keeps the Gauss-Hermite counts no other kernel takes)
    through ``engine="dd"``, each against its plain version at the full
    shape to the bit, RMSE finite; the two mixed lanes' and the GH-2 lane's
    raw launches in turns with the first version's on the same input;
17. ``tests/goldens/reentry.npz`` ``ukf`` (the shaped kernel) and ``bsqkf``
    (the BQ shapes) through ``engine="dd"`` on the card (1e-7 / 1e-6);
18. the main path's kernel result on the bench lane against the plain
    version at its full 10,000 x 100, to the bit, all five streams; then
    timings: raw launches on the bench lane under each rule beside its bound
    and chain floor (the card's dependent-issue latencies, exp and atan2
    included), for every rule that another kernel takes the first-version
    kernel on the same input in turns with it, for GPQ-UT, BSQ-UT and GPQ-SR
    the registers, local memory and f64 issue floor (from the SASS) of both
    kernels' instantiations; the wrapper calls of the three kernels beside
    their plain versions, and the lane through both engines;
19. "zoo": the rest of the model zoo at 10,000 trajectories simulated on the
    card from the seed: the pendulum under UKF (shaped kernel) and GPQKF
    (BQ shapes), the falling body under UKF and the coordinated turn
    with four bearings under CKF (shaped kernel), 100 steps, each through
    ``engine="dd"`` (one launch of the kernel ``kernel_of`` names), every
    stream of its first 200 trajectories equal to the plain version's to
    the bit, its filter RMSE the eager lane's within 1e-6 relative, at most
    1% of its runs not finite, filter and smoother RMSE printed and raw
    launches of its instantiation beside its bound and chain floor; UNGM
    with non-additive noise (500 steps) and the constant turn-rate model
    with the radar under UKF through ``engine="auto"``, which runs them
    eagerly (no kernel may launch), timed with CUDA events, filter and
    smoother RMSE printed;
20. "classical": the filters that no kernel takes, eagerly, 10,000 x 100:
    the hybrid demo's UNGM system (the main path's data) under the EKF, the
    EKF-GPQD and the GPQ+D Kalman filter; the reentry bench lane's data
    under the EKF and the truncated UKF and CKF; the truncated GHKF-3 on
    non-additive UNGM dynamics; the extended Student filter on phase 8's CV
    glint data.  Each ``engine="dd"`` must raise, ``"auto"`` must give the
    bits of ``"f64"``, at most 1% of the runs may be non-finite, and the
    first 200 trajectories must match the same filter on the CPU within
    1e-9 of each stream's largest entry; filter and smoother times (CUDA
    events), RMSE, NCI and NLL printed.  Then the two transform studies at
    10,000 input means (polar to cartesian through the linearization,
    MC-1000, UT and truncated UT at dimensions 2-8; GPQ against GPQ+D on
    ``sin(x) + x^2 / 2``): SKL from Monte-Carlo truth and each transform's
    time, the GPQ+D weights' build time.  No launch counter may move;
21. "bq_rest": GPQKF with the RQ kernel under ``engine="auto"`` on the
    main path's UNGM (scalar filter kernel) and reentry (the vector filter
    kernel of the BQ shapes) data, one launch each, bit-equal to the plain
    versions and held to ``"f64"``; per-call kernel parameters (theta) of
    the GPQKF and the BSQKF on UNGM (10,000 x 100): the construction
    parameters' bits, a filter built at another theta's bits, the gradient
    of the batch-mean NLL with respect to log theta against the CPU, the
    BSQ lane's Vandermonde launches; the IPLF on CV + precise radar
    (10,000 x 60: one iteration is the UKF, five have a lower RMSE); the
    MO-GPQKF on UNGM against the GPQKF, the MO-TP Student filter on the
    Student UNGM system (at most 1% non-finite) and on phase 8's CV glint
    data (non-finite share reported), each against the CPU, no launch
    counter moving; ``GaussianProcessModel.optimize`` on the card against
    the CPU;
22. "marginal_online": the marginalized GPQ Kalman filter's damped-Newton
    batch path on the main path's UNGM data (10,000 runs, cut to
    ``MARGINAL_STEPS`` steps) with the float64 and the float32 search, its
    warm-up under ``torch.cuda.set_sync_debug_mode("error")``, RMSE / NCI /
    NLL beside the UKF and the fixed GPQKF (NCI and NLL of both searches
    below the fixed GPQKF's, at most 1% lost, step 1 of 200 runs within
    1e-7 of the CPU's);
    the SciPy-BFGS path on ``marginal_ungm.npz``; the streaming UKF on
    10,000 targets equal to the batch filter (1e-12), its per-step latency
    at batch 1 and 10,000, the fixed-lag smoother against the offline RTS,
    a checkpoint round trip and resume; no launch counter may move;
23. "sqrt": the square-root filters and smoothers on the main path's data
    (10,000 runs): SR-UKF on UNGM and reentry in float64 and float32
    against the full-covariance filter, the square-root GPQ filter and
    smoother on UNGM and SR-FSQ with the square-root Student smoother on
    the CV glint data in float32, the streaming square-root filter at batch
    1 and 10,000 and the fixed-lag smoother against the offline ones, 200
    runs of each float64 lane against the CPU, a step of each SR-UKF lane
    under the profiler; no launch counter may move (``sqrt_slice``);
24. "parallel": the time-parallel filters and smoothers on one long
    pendulum record (``tools/bench_iplf.py``'s widths, simulated on the card,
    50,000 steps): IPLS(2) with the observer init against the sequential
    UKF + RTS smoother at 2,000 steps, the float32 square-root IPLS(2)
    against float64 at 2,500 and 5,000 steps, the block observer at
    50,000 steps, the card against the CPU on a 500-step prefix; the linear
    and square-root affine scans at 10^4-10^6 steps (blocked and
    unblocked); the batched NLML fit of the UNGM GP model; no launch counter
    may move (``parallel_slice``);
25. "mesh": the multi-rank half of ``parallel/`` on the one card, through
    an NCCL world of one rank and 2-4 ranks as threads with gloo groups:
    ``filter_mc_sharded`` and ``mc_metrics_sharded`` on the main path's UNGM
    UKF data, ``filter_bank_sharded`` of four GPQ-UT transforms, the sharded
    affine filters and smoothers at 10^6 and 10^6 + 3 steps, the iterated
    smoother on a mesh, the fit on a mesh, each against its unsharded call;
    the iterated extended smoother (``LinearizationTransform``) on a UNGM
    record against the EKF + RTS smoother; no launch counter may move
    (``mesh_slice``);
26. "studies": eight of the nine study modules of
    ``ssmtoybox_torch/experiments`` through their ``main([...])`` on the card
    (``STUDY_RUNS``): the UNGM classical-vs-GPQ study at 10,000 x 500
    through the scalar filter kernel (every lane ``dd``) and at 100 x 250 in
    float64, the BSQ UNGM filter and smoother study (100 x 250), reentry GPQ
    tracking through ``engine="auto"`` (both shaped vector filter kernels),
    BSQ tracking (50 s), the two Student-t glint studies (2e6-sample
    weights), the GPQ+D demo (200 runs, raised from 50 for its gate) and the
    transform studies (the marginalized study's filter and gate run in phase
    22, at 10,000 runs); each study's tables,
    wall time and launches, at most 1% lost runs a row, and the conclusion
    ``experiments/RESULTS.md`` draws from it (``STUDY_GATES``), its margin
    in standard errors (``studies_slice``);
27. "dd pairs": what only the general forms take, at full width
    (``dd_pairs_slice``): CT + radar under UKF and CKF and CT with 2, 3, 5
    and 8 bearings under CKF and 8 under GH-3, CT + radar under the UKF
    beside the CKF, the pendulum with the radar under GH-3 (9 points),
    10,000 x 100 simulated on the card, and under GH-4 (16 points) and GH-5
    (25) on its first 50 steps, through the general vector kernel
    (radar and 2-3 bearings in its shaped one-thread form, the mixed counts
    and the pendulum's GH-3 too, 5 and 8 bearings under CKF in its
    lane-group form, GH-3 on CT in its warp form, the pendulum's GH-5 in its
    general one-thread form) and the slot kernel (the pendulum's GH-4);
    UNGM under GH-9, GH-15, GPQ on GH-15 points and GH-17 (the slot design,
    GH-17 at 20 slots) on the main path's 10,000 x 500 data and under GH-33
    (one thread a trajectory) on its first 100 steps, through the scalar
    kernel's general form; each lane once with the counts from 0 (6 shaped,
    1 one-thread, 2 lane-group, 1 warp-form, 1 slot-kernel and 5 scalar
    launches, nothing else), its first 200 trajectories (all 10,000 on CT + radar UKF and on
    UNGM GH-17 and GH-33, which also match at B = 1, 7 and 4,097 through the
    wrapper) equal to the plain version to the bit, its filter RMSE within
    1e-6 (vector) or 1e-3 (UNGM) relative of the eager f64 lane's, at most
    1% non-finite; raw launches, wrapper, plain and bound, the libraries'
    build times; on every lane off the general one-thread form its route
    (the slot kernel's GH-4 too) and that form (at 3 bearings the lane-group
    form too) to the bit and in turns with their ptxas counts;
    the general form's range and sine measurements of the UNGM state against
    the plain version to the bit at B = 1, 7, 4,097 and 10,000; raw launches
    of the general kernel by force beside the first version and the shaped
    kernel on the reentry bench lane's UKF, in turns.  To run the general
    forms' checks alone: ``chip_smoke.dd_pairs_alone()``;
28. "registry": models of a user's own registered in the port's fused
    kernels, and bearings from more than 8 sensors (``registry_slice``):
    the libraries of the registered forms built from generated headers
    (``vector_filter_registered.cu``, ``scalar_filter_registered.cu``, at
    once, their times and ptxas registers and spills printed); a 1-D
    transition with a per-step stream and a 1-D measurement (the scalar
    kernel's registered form, 10,000 x 500), a 2-D one with a stream and a
    2-output measurement and with the radar, an 8-D one with the radar and a
    copy of the table's pendulum with the radar (the registered vector
    kernel: the 2-D ones under the UKF in its shaped one-thread form, the 2-D
    one with the radar under GH-3 in that form too, under GH-4 (10,000 x
    50) in its slot form (also at B = 1, 7 and 4,097 through the wrapper)
    and under GH-5 (the same data) in its general one-thread form, the 8-D
    one in its lane-group form), CT with 9 and 16 bearings under CKF (the
    general kernel's lane-group form), reentry with a copy of the table's
    radar under GH-3 (the registered kernel's warp form), 10,000 x 100; each
    lane once with the counts from 0 (3 registered shaped, 1 registered
    slot-form, 1 registered one-thread, 1 registered lane-group, 1
    registered warp-form, 2 general lane-group, 1 scalar launch, nothing
    else), equal to its plain version
    to the bit (all 10,000 trajectories on the 2-D lane, the first 200
    elsewhere), its filter RMSE within 1e-6 (1e-3 on the 1-D lane) relative
    of the eager lane's; raw launches, wrapper, plain and bound; on the
    shaped, slot, lane-group and warp lanes that form and the general one-thread
    form of the kernel to the bit and in turns (the wide form on the
    bearings); the pendulum copy
    equal to the table's pendulum in the general kernel to the bit and timed
    in turns with it, and the radar copy the table's radar in the general
    kernel's warp form.  Then the 1-D registered lanes under GH-17 (at 20
    slots, 500 steps) and GH-33 (one thread a trajectory, 100 steps), each
    on its own path from counts of 0, equal to its plain version to the bit
    at B = 1, 7, 4,097 and 10,000, timed.  Alone:
    ``chip_smoke.registry_alone()``; every form
    of the lane-group lanes, and two trees, in turns:
    ``tools/lane_variants.py``.

Every kernel's entry in the ``kernels`` line carries its launches on the
paths driven above (each path run with the counts set to 0 first), its
error against its plain version, its time, its plain version's, and its
bound: the larger of the bytes it must move over 3.35 TB/s and its
operations over the card's peak rate for their type.  The line before the last two is a JSON object describing each kernel; the
line before the last is the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""
import ctypes
import json
import math
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.abspath(__file__))
#: every ``log`` line starts with the seconds since the script started
T_START = time.perf_counter()

MC = 10_000
UNGM_STEPS = 500
REENTRY_STEPS = 100
COMPARE_B = 4096
SEED = 0


def log(*a):
    print(f"[{time.perf_counter() - T_START:7.1f} s]", *a, flush=True)


def fail(msg):
    log(f"FAILED: {msg}")
    sys.exit(1)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps=5):
    """Median and min wall time of ``fn`` on the card in ms, CUDA events,
    after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    times.sort()
    return times[len(times) // 2], times[0]


#: the CV radar glint study (experiments/tpq_constant_velocity.py)
CV_STEPS = 100
STUDENT_MC = 2_000_000
DT = 0.5
P0 = [100.0 ** 2, 10.0 ** 2, 100.0 ** 2, 10.0 ** 2]
Q = [50.0, 5.0]
R0, R1 = [50.0, 0.4e-6], [5000.0, 1.6e-5]
SIDX = [0, 2, 1, 3]
M0_TRUE = [10000.0, 300.0, 1000.0, -40.0]
M0_MIS = [10175.0, 295.0, 980.0, -35.0]
X0_DOF, R_DOF = 1000.0, 4.0
PAR_DYN = [[0.05, 100.0, 100.0, 100.0, 100.0]]
PAR_OBS = [[0.005, 10.0, 100.0, 10.0, 100.0]]
#: the seed of the golden TP-weight check (the MC spread is seed-dependent, PERF.md)
GOLDEN_SEED = 0


#: the card's peak rates, for each kernel's bound (NVIDIA H100 SXM data sheet:
#: 3.35 TB/s HBM3, 67 TFLOP/s float32 and 33.5 TFLOP/s float64 outside the
#: tensor cores; exp and the other special functions at 16 results a clock on
#: each of the 132 SMs, at the 1.98 GHz boost clock)
HBM_BYTES_S = 3.35e12
F32_OPS_S = 67e12
F64_OPS_S = 33.5e12
SFU_OPS_S = 132 * 16 * 1.98e9


def bound(n_bytes, *ops):
    """``(bound_ms, bound_by)``: the larger of the bytes over the memory rate
    and the operations over their peak rate, ``ops`` as ``(count, rate)``
    pairs of operation types that run on separate units (the slowest type
    bounds them)."""
    t_bytes = n_bytes / HBM_BYTES_S
    t_ops = max((count / rate for count, rate in ops), default=0.0)
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def qrq_bounds(tot, d, n):
    """``bound`` of ``qrq`` and ``qrq_bwd`` at ``tot`` f32 samples of D = d
    and n points: the samples are read once; per sample, a Gram row of n exps
    (special-function unit) and the f32 flops of the row, q, R and the
    symmetric half of Q (the backward adds W = gq + x gR + k (gQ + gQ^T) and
    its three reductions)."""
    row = n * (3 * d + 1)
    return (bound(tot * d * 4, (tot * n, SFU_OPS_S),
                  (tot * (row + n + 2 * d * n + n * (n + 1)), F32_OPS_S)),
            bound(tot * d * 4, (tot * n, SFU_OPS_S),
                  (tot * (row + n * (2 * d + 2 * n) + n + 2 * d * n), F32_OPS_S)))


def device_ms(torch, fn, kernel, reps=10):
    """Mean device time, in ms, of the device activities whose name contains
    ``kernel``, from ``torch.profiler`` over ``reps`` calls of ``fn`` (one
    launch each) after one warm-up, profiled again, up to three times, if no
    such activity was recorded; ``(ms, profile)``, ms None (and the names of
    the device activities seen logged) if none matched.  The profiler drops
    records of short kernels (1 to 5 of 10 were kept where raw launches
    between CUDA events gave the same time a record), so the mean is over
    the records found, and a profile that lost some says so."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):      # a profile now and then comes back without device records
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        found = [e.time_range.elapsed_us() for e in on_card if kernel in e.name]
        if found:
            break
    if not found:
        log(f"  (profile of {kernel}: device activities seen: "
            f"{sorted({e.name[:80] for e in on_card}) or 'none'})")
    elif len(found) != reps:
        log(f"  (profile of {kernel}: {len(found)} device records for {reps} launches)")
    return (sum(found) / len(found) / 1e3 if found else None), prof


def raw_ms(torch, launch, reps=20) -> float:
    """Time of one kernel launch in ms: ``reps`` calls of ``launch``, which
    goes straight to a library's C entry point (no wrapper, 10-30 us of host
    time a call) and returns its CUDA error code, between two CUDA events
    after one warm-up.  ``torch.cuda._sleep`` is queued ahead of the first
    event, long enough for the host to queue every launch before the card
    reaches it, so the time is the card's even for kernels shorter than the
    host's launch, whatever the profiler records."""
    def checked():
        rc = launch()
        if rc != 0:
            fail(f"a raw kernel launch returned cudaError {rc}")
    checked()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000 * reps)          # ~50 us of the card's time a launch
    start.record()
    for _ in range(reps):
        checked()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def clocks_line() -> str:
    """The card's current and maximum SM clock, as nvidia-smi gives them."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"


def host_us(torch, fn, reps=200) -> float:
    """Host time of one call of ``fn`` in microseconds: ``reps`` calls on the
    host clock between two synchronisations (the enqueue, not the kernel)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / reps * 1e6


def fmt_ms(ms) -> str:
    return "not measured (no device time in the profile)" if ms is None else f"{ms:.4f} ms"


def rel_err(a, b) -> float:
    """``max |a - b| / max |b|``."""
    return float((a - b).abs().max() / b.abs().max())


def study_scores(torch, x_true, fi_mean, fi_cov, chunk=1000):
    """Per-run RMSE, INC, NLL and NCI of the port's study harness
    (``ssmtoybox_torch.experiments.common.study_scores``: the per-step MSE
    matrix over the runs whose RMSE is finite, the credibility scores
    ``chunk`` runs at a time).  ``x_true`` / ``fi_mean`` (M, D, N), ``fi_cov``
    (M, D, D, N)."""
    from ssmtoybox_torch.experiments.common import study_scores as scores
    s = scores(x_true.permute(1, 2, 0), fi_mean, fi_cov, chunk)
    return s["rmse"], s["inc"], s["nll"], s["nci"]


def student_slice(torch, np, dev):
    """Phases 6-8: the Student-t BQ path and its four kernels.  Returns the
    kernels' entries of the ``kernels`` line, and the CV glint study's
    Student models and data ``(dyn, obs, x, y)``, (M, D, N) each."""
    import ssmtoybox_torch as stt
    from ssmtoybox_torch.bq import StudentTProcessTransform
    from ssmtoybox_torch.ops import student_mc as smc
    from ssmtoybox_torch.points import fs_points
    from ssmtoybox_torch.ssmod import (ConstantVelocity, Radar2DMeasurement, UNGMMeasurement,
                                       UNGMTransition)
    from ssmtoybox_torch.utils import GaussianMixtureRV, GaussRV, StudentRV, rand

    f64 = dict(dtype=torch.float64, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)

    # ---- 6. the four kernels vs their plain versions, study shapes --------
    par = torch.tensor(PAR_DYN, **f64)
    x = torch.as_tensor(fs_points(4, 3, 0.0, X0_DOF), **f64)      # TPQSF dynamics rule
    gen = torch.Generator(device=dev).manual_seed(SEED)
    c_q, _, tot_q = smc.chunking(STUDENT_MC, smc.QRQ_CHUNK)
    c_k, _, tot_k = smc.chunking(STUDENT_MC, smc.KXY_CHUNK)
    s_q = rand.multivariate_t(gen, torch.zeros(4, **f32), torch.eye(4, **f32), 4.0, (tot_q,))
    s_k = rand.multivariate_t(gen, torch.zeros(4, **f32), torch.eye(4, **f32), 4.0, (tot_k,))
    d, n = x.shape
    err = {}
    got, ref = smc.student_qrq(par, x, s_q, c_q), smc.student_qrq_plain(par, x, s_q, c_q)
    torch.cuda.synchronize()
    rels = [rel_err(a, b) for a, b in zip(got, ref)]
    err["qrq"] = max(float((a - b).abs().max()) for a, b in zip(got, ref))
    log(f"qrq kernel vs plain ({tot_q} samples, chunk {c_q}, D={d}, N={n}): relative "
        f"q {rels[0]:.2e}, R {rels[1]:.2e}, Q {rels[2]:.2e} (limit 1e-5)")
    if not max(rels) < 1e-5:
        fail(f"qrq kernel vs plain: relative {max(rels):.3e} exceeds 1e-5")
    v, vr = smc.student_kxy(par, s_k, c_k), smc.student_kxy_plain(par, s_k, c_k)
    err["kxy"] = abs(float(v) - float(vr))
    log(f"kxy kernel vs plain ({tot_k} samples, chunk {c_k}): {float(v):.12f} vs "
        f"{float(vr):.12f}, relative {err['kxy'] / abs(float(vr)):.2e} (limit 1e-5)")
    if not err["kxy"] / abs(float(vr)) < 1e-5:
        fail("kxy kernel vs plain exceeds 1e-5 relative")

    wgen = torch.Generator(device=dev).manual_seed(SEED + 1)
    w = [torch.randn(s, generator=wgen, **f64) for s in ((n,), (d, n), (n, n))]

    def grads(fn):
        p, xx = par.clone().requires_grad_(True), x.clone().requires_grad_(True)
        loss = sum(torch.sum(wi * oi) for wi, oi in zip(w, fn(p, xx, s_q, c_q)))
        return torch.autograd.grad(loss, (p, xx))

    for tag, g_k, g_p in (("qrq_bwd", grads(smc.student_qrq), grads(smc.student_qrq_plain)),):
        err[tag] = max(float((a - b).abs().max()) for a, b in zip(g_k, g_p))
        ok = all(torch.allclose(a, b, rtol=1e-4, atol=1e-5) for a, b in zip(g_k, g_p))
        log(f"{tag} gradient vs autograd through the plain version: max |diff| "
            f"{err[tag]:.2e}, relative {max(rel_err(a, b) for a, b in zip(g_k, g_p)):.2e} "
            f"(rtol 1e-4, atol 1e-5)")
        if not ok:
            fail(f"{tag} gradient disagrees with autograd through the plain version")
    p_k, p_p = par.clone().requires_grad_(True), par.clone().requires_grad_(True)
    (g_k,) = torch.autograd.grad(smc.student_kxy(p_k, s_k, c_k), p_k)
    (g_p,) = torch.autograd.grad(smc.student_kxy_plain(p_p, s_k, c_k), p_p)
    err["kxy_bwd"] = float((g_k - g_p).abs().max())
    log(f"kxy_bwd gradient vs autograd through the plain version: max |diff| "
        f"{err['kxy_bwd']:.2e}, relative {rel_err(g_k, g_p):.2e} (rtol 1e-4, atol 1e-5)")
    if not torch.allclose(g_k, g_p, rtol=1e-4, atol=1e-5):
        fail("kxy_bwd gradient disagrees with autograd through the plain version")

    _, inv_l, xp = smc._kernel_args(par, x)
    gq, gR, gQ = (t.to(torch.float32).contiguous() for t in w)
    gQ2 = (gQ + gQ.T).contiguous()
    timed = {
        "qrq": (lambda: smc.qrq_sums(inv_l, s_q, xp, c_q),
                lambda: smc._qrq_partials_plain(inv_l, s_q, xp, c_q).double().sum(0)),
        "qrq_bwd": (lambda: smc.qrq_bwd_sums(inv_l, s_q, xp, gq, gR, gQ2, c_q),
                    lambda: smc._qrq_bwd_partials_plain(inv_l, s_q, xp, gq, gR, gQ2,
                                                        c_q).double().sum(0)),
        "kxy": (lambda: smc.kxy_chunk_sums(inv_l, s_k, c_k),
                lambda: smc._kxy_partials_plain(inv_l, s_k, c_k).double()),
        "kxy_bwd": (lambda: smc.kxy_bwd_sums(inv_l, s_k, c_k),
                    lambda: smc._kxy_bwd_partials_plain(inv_l, s_k, c_k).double().sum(0)),
    }
    for name in timed:
        a, b = timed[name][0](), timed[name][0]()
        torch.cuda.synchronize()
        if not (torch.equal(a, b) and bool(torch.isfinite(a).all())):
            fail(f"{name}: two launches on the same input differ by "
                 f"{float((a - b).abs().max()):.3e}; expected equal bits")
    log(f"qrq, qrq_bwd, kxy and kxy_bwd: two launches on the same input give equal bits "
        f"({tot_q // c_q} chunks of {c_q}, N={n}; {tot_k // c_k} chunks of {c_k}; D={d})")
    ms = {}
    for name, (kern, plain) in timed.items():
        a, b = kern(), plain()
        ms[name] = cuda_ms(torch, kern)[0], cuda_ms(torch, plain)[0]
        log(f"{name}: kernel {ms[name][0]:.3f} ms, plain {ms[name][1]:.3f} ms "
            f"(wrapper sums, f64; kernel vs plain relative {rel_err(a, b):.2e})")
    n_chunks = tot_k // c_k
    out_k = torch.empty((n_chunks,), **f32)
    lib = smc.build()
    kxy_args = (inv_l.data_ptr(), s_k.data_ptr(), n_chunks, c_k, d, out_k.data_ptr())
    parts = {
        "_check": lambda: smc._check(inv_l, s_k, c_k, pairwise=True),
        "build() (the bound library)": smc.build,
        "torch.empty": lambda: torch.empty((n_chunks,), **f32),
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "_run (stream, ctypes, cudaSetDevice, launch)": lambda: smc._run(
            lib, "smc_kxy_launch", "kxy", dev, kxy_args),
        "out.double()": out_k.double,
        "the whole call": timed["kxy"][0],
    }
    log("host time of one kxy_chunk_sums call, part by part (host clock, 200 calls each, "
        "no synchronisation inside): "
        + ", ".join(f"{k_} {host_us(torch, fn):.1f} us" for k_, fn in parts.items()))
    log(f"SM clock before the profiled launches (current, max): {clocks_line()}")
    for name, (kern, _) in timed.items():
        dev_ms, _ = device_ms(torch, kern, f"student_{name}_kernel")
        log(f"{name}: device time {fmt_ms(dev_ms)} a launch (torch.profiler, 10 launches)")
    log(f"SM clock after the profiled launches (current, max): {clocks_line()}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_q = tot_q // c_q
    out_q, out_b = torch.empty((n_q, n + d * n + n * n), **f32), torch.empty((n_q, n + d * n + d),
                                                                              **f32)
    out_kb = torch.empty((n_chunks, d), **f32)
    raw = {
        "qrq": lambda: lib.smc_qrq_launch(inv_l.data_ptr(), s_q.data_ptr(), xp.data_ptr(), n_q,
                                          c_q, n, d, dev.index or 0, out_q.data_ptr(), stream),
        "qrq_bwd": lambda: lib.smc_qrq_bwd_launch(
            inv_l.data_ptr(), s_q.data_ptr(), xp.data_ptr(), gq.data_ptr(), gR.data_ptr(),
            gQ2.data_ptr(), n_q, c_q, n, d, dev.index or 0, out_b.data_ptr(), stream),
        "kxy": lambda: lib.smc_kxy_launch(*kxy_args[:-1], dev.index or 0, kxy_args[-1], stream),
        "kxy_bwd": lambda: lib.smc_kxy_bwd_launch(*kxy_args[:-1], dev.index or 0,
                                                  out_kb.data_ptr(), stream),
    }
    b_q = dict(zip(("qrq", "qrq_bwd"), qrq_bounds(tot_q, d, n)))
    goal = {"qrq": 0.030, "qrq_bwd": 0.040}
    for name, launch in raw.items():
        log(f"{name}: raw launches {raw_ms(torch, launch):.4f} ms a launch (CUDA events around "
            f"20 calls of the C entry point behind torch.cuda._sleep)"
            + (f", bound {b_q[name][0]:.4f} ms ({b_q[name][1]}), goal {goal[name]} ms"
               if name in b_q else ""))
    # the q/R/Q kernels at the FS degree-5 rule (N = 33) and on the large
    # path's widest shape (D = 8, N = 128), each beside its bound
    for dd, nn in ((4, 33), (8, 128)):
        s_w = rand.multivariate_t(gen, torch.zeros(dd, **f32), torch.eye(dd, **f32), 4.0,
                                  (tot_q,))
        il_w = torch.linspace(0.5, 1.4, dd, **f32)
        xp_w = torch.randn((nn, dd), generator=wgen, **f32)
        g_w = [torch.randn(sh, generator=wgen, **f32) for sh in ((nn,), (dd, nn), (nn, nn))]
        g_w[2] = (g_w[2] + g_w[2].T).contiguous()
        o_f = torch.empty((n_q, nn + dd * nn + nn * nn), **f32)
        o_b = torch.empty((n_q, nn + dd * nn + dd), **f32)
        for tag, out_w, launch, ref in (
                ("qrq", o_f, lambda: lib.smc_qrq_launch(
                    il_w.data_ptr(), s_w.data_ptr(), xp_w.data_ptr(), n_q, c_q, nn, dd,
                    dev.index or 0, o_f.data_ptr(), stream),
                 lambda: smc._qrq_partials_plain(il_w, s_w, xp_w, c_q)),
                ("qrq_bwd", o_b, lambda: lib.smc_qrq_bwd_launch(
                    il_w.data_ptr(), s_w.data_ptr(), xp_w.data_ptr(), *(t.data_ptr() for t in g_w),
                    n_q, c_q, nn, dd, dev.index or 0, o_b.data_ptr(), stream),
                 lambda: smc._qrq_bwd_partials_plain(il_w, s_w, xp_w, *g_w, c_q))):
            if launch() != 0:
                fail(f"{tag} at D={dd}, N={nn}: the launch failed")
            rel = rel_err(out_w.double(), ref().double())
            if not rel < 1e-5:
                fail(f"{tag} at D={dd}, N={nn}: kernel vs plain relative {rel:.3e} exceeds 1e-5")
            b_w = qrq_bounds(tot_q, dd, nn)[tag == "qrq_bwd"]
            log(f"{tag} at D={dd}, N={nn} ({n_q} x {c_q}): raw launches {raw_ms(torch, launch):.4f} "
                f"ms a launch, bound {b_w[0]:.4f} ms ({b_w[1]}), kernel vs plain relative "
                f"{rel:.2e} (limit 1e-5)")
        del s_w
    del s_q, s_k

    # ---- 7. Student goldens on the card ----------------------------------
    g = np.load(os.path.join(HERE, "tests", "goldens", "ungm_student.npz"))
    dyn_u = UNGMTransition(StudentRV(1, scale=1.0, dof=4.0, device=dev),
                           StudentRV(1, scale=10.0, dof=4.0, device=dev))
    obs_u = UNGMMeasurement(StudentRV(1, scale=0.01, dof=4.0, device=dev), dim_state=1)
    for name, fixed in (("fsq3", True), ("fsq3_inc", False)):
        fm, fP = stt.FullySymmetricStudent(dyn_u, obs_u, degree=3, dof=4.0,
                                           fixed_dof=fixed).forward_pass(
            torch.as_tensor(g["y"][..., 0], device=dev))
        for got_, key in ((fm, "fm"), (fP, "fP")):
            if not np.allclose(got_.cpu().numpy(), g[f"{name}_{key}"], atol=1e-8, rtol=1e-8):
                fail(f"golden ungm_student {name}_{key} off by "
                     f"{np.abs(got_.cpu().numpy() - g[f'{name}_{key}']).max():.3e}")
    g = np.load(os.path.join(HERE, "tests", "goldens", "tpq_cv_weights.npz"))
    for tag in ("dyn", "obs"):
        for seed in range(4):
            t = StudentTProcessTransform(4, 1, g[f"{tag}_par"], "rbf-student", "fs",
                                         point_par={"dof": 4.0}, nu=4.0, device=dev,
                                         mc_opts={"num_samples": STUDENT_MC, "seed": seed})
            lam = np.linalg.eigvalsh(t.Wc.cpu().numpy())
            lam_ref = np.linalg.eigvalsh(g[f"{tag}_Wc"])
            e = {"wm": (np.abs(t.wm.cpu().numpy() - g[f"{tag}_wm"]).max(), 5e-3),
                 "Wc": (np.abs(t.Wc.cpu().numpy() - g[f"{tag}_Wc"]).max(), 0.5),
                 "Wcc": (np.abs(t.Wcc.cpu().numpy() - g[f"{tag}_Wcc"]).max(), 0.25),
                 "emv": (abs(float(t.model_var) / float(g[f"{tag}_emv"][0]) - 1.0), 0.3)}
            ok = all(v_ <= lim for v_, lim in e.values())
            ok = ok and lam[0] > -1e-10 and lam[-1] < 2.0 * lam_ref[-1]
            log(f"TP weights on the card vs golden, {tag}, seed {seed}: "
                + ", ".join(f"{k_} {v_:.3g} (limit {lim})" for k_, (v_, lim) in e.items())
                + f", eig [{lam[0]:.3g}, {lam[-1]:.3g}] (ref max {lam_ref[-1]:.3g}): "
                + ("ok" if ok else "OUTSIDE"))
            if seed == GOLDEN_SEED and not ok:
                fail(f"TP weights ({tag}, seed {seed}) outside the golden's tolerances")
    log("Student goldens on the card: FSQ (1e-8) and TP weights ok")

    # ---- 8. the Student-t BQ path: CV radar glint, 10,000 x 100 ------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    dyn_t = ConstantVelocity(GaussRV(4, mean=M0_TRUE, cov=np.diag(P0), device=dev),
                             GaussRV(2, cov=np.diag(Q), device=dev), dt=DT)
    glint = GaussianMixtureRV(2, means=(np.zeros(2), np.zeros(2)),
                              covs=(np.diag(R0), np.diag(R1)), alphas=(0.85, 0.15), device=dev)
    obs_t = Radar2DMeasurement(glint, dim_state=4, state_index=SIDX)
    x_cv = dyn_t.simulate_discrete(gen, steps=CV_STEPS, mc_sims=MC)
    y_cv = obs_t.simulate_measurements(gen, x_cv)
    xs, ys = x_cv.permute(2, 0, 1), y_cv.permute(2, 0, 1)
    sc = (X0_DOF - 2.0) / X0_DOF
    dyn_s = ConstantVelocity(StudentRV(4, mean=M0_MIS, scale=sc * np.diag(P0), dof=X0_DOF,
                                       device=dev),
                             StudentRV(2, scale=sc * np.diag(Q), dof=X0_DOF, device=dev), dt=DT)
    obs_s = Radar2DMeasurement(StudentRV(2, scale=(R_DOF - 2.0) / R_DOF * np.diag(R0),
                                         dof=R_DOF, device=dev), dim_state=4, state_index=SIDX)
    makers = {
        "TPQSF": lambda: stt.StudentProcessStudent(
            dyn_s, obs_s, np.array(PAR_DYN), np.array(PAR_OBS), point_par={"kappa": 0.0},
            dof=4.0, dof_tp=4.0, mc_opts={"num_samples": STUDENT_MC}),
        "GPQSF": lambda: stt.GPQStudent(
            dyn_s, obs_s, np.array(PAR_DYN), np.array(PAR_OBS), point_hyp={"kappa": 0.0},
            dof=4.0, mc_opts={"num_samples": STUDENT_MC}),
        "FSQ": lambda: stt.FullySymmetricStudent(dyn_s, obs_s, degree=3, kappa=0.0, dof=4.0),
    }
    torch.cuda.synchronize()
    for name in smc.LAUNCHES:
        smc.LAUNCHES[name] = 0
    algs, build_s = {}, {}
    for name, make in makers.items():
        t0 = time.perf_counter()
        algs[name] = make()
        torch.cuda.synchronize()
        build_s[name] = time.perf_counter() - t0
    kxy_builds = smc.LAUNCHES["kxy"]
    results = {}
    for name, alg in algs.items():
        res = alg.forward_pass_batch(ys)
        results[name] = (res, stt.studentian_smoother(res))
    # the fused expectations and their gradients on the TPQSF dynamics kernel
    model = algs["TPQSF"].tf_dyn.model
    par_k = model.kernel.par.clone().requires_grad_(True)
    q, R, Qm = model.kernel.exp_x_qRQ(par_k, model.points)
    (g_qrq,) = torch.autograd.grad(q.sum() + R.sum() + Qm.sum(), par_k)
    (g_kxy,) = torch.autograd.grad(model.kernel.exp_xy_kxy(par_k), par_k)
    torch.cuda.synchronize()
    counts = dict(smc.LAUNCHES)
    log(f"Student path launches: {counts} (kxy {kxy_builds} while the transforms were built)")
    if kxy_builds < 4:
        fail(f"the kxy kernel ran {kxy_builds} times while the 4 BQ transforms were built")
    for name in ("qrq", "qrq_bwd", "kxy_bwd"):
        if counts[name] < 1:
            fail(f"the {name} kernel was not launched on the Student path")
    if not (bool(torch.isfinite(g_qrq).all()) and bool(torch.isfinite(g_kxy).all())):
        fail("the fused expectations' gradients are not finite")
    inc = {}
    for name, (res, (sm, sS)) in results.items():
        if tuple(res.fi_mean.shape) != tuple(xs.shape) or tuple(sS.shape) != (MC, 4, 4, CV_STEPS):
            fail(f"{name}: shapes {tuple(res.fi_mean.shape)}, {tuple(sS.shape)}")
        rmse_r, inc_r, nll_r, _ = study_scores(torch, xs, res.fi_mean, res.fi_cov)
        ok = torch.isfinite(rmse_r) & torch.isfinite(inc_r) & torch.isfinite(nll_r)
        bad = 1.0 - float(ok.double().mean())
        inc[name] = float(inc_r[ok].mean())
        # the scale-matrix RTS pass of the JAX package grows without bound on
        # Monte-Carlo BQ cross-weights (PERF.md, open questions): reported only
        r_sm = torch.sqrt(torch.mean(torch.sum((sm - xs) ** 2, 1), -1))[ok]
        blown = float((r_sm > 10.0 * rmse_r[ok]).double().mean())
        log(f"CV glint {name} ({MC}x{CV_STEPS}): RMSE {float(rmse_r[ok].mean()):.4f}, "
            f"INC {inc[name]:.4f}, NLL {float(nll_r[ok].mean()):.4f}, diverged {bad:.4%}, "
            f"smoother RMSE median {float(r_sm.median()):.4g} ({blown:.2%} of runs above 10x "
            f"their filter RMSE), weights built in {build_s[name] * 1e3:.1f} ms")
        if bad > 0.01:
            fail(f"{name}: {bad:.2%} of the trajectories are not finite (limit 1%)")
    for name in ("TPQSF", "GPQSF"):
        if not inc[name] < inc["FSQ"]:
            fail(f"INC of {name} ({inc[name]:.3f}) is not below FSQ's ({inc['FSQ']:.3f})")
    for name, alg in algs.items():
        res = results[name][0]
        f_ms = cuda_ms(torch, lambda: alg.forward_pass_batch(ys), reps=3)
        s_ms = cuda_ms(torch, lambda: stt.studentian_smoother(res), reps=3)
        log(f"{name}: filter {f_ms[0]:.1f} ms (min {f_ms[1]:.1f}), smoother {s_ms[0]:.1f} ms "
            f"(min {s_ms[1]:.1f})")

    # bounds at these shapes (qrq_bounds); kxy needs the exps of the
    # distinct pairs of each chunk, 3D flops each (5D with the gradient)
    pairs = (tot_k // c_k) * c_k * (c_k - 1) / 2
    b_qrq, b_qrq_bwd = qrq_bounds(tot_q, d, n)
    bounds = {
        "qrq": b_qrq,
        "qrq_bwd": b_qrq_bwd,
        "kxy": bound(tot_k * d * 4, (pairs, SFU_OPS_S), (pairs * 3 * d, F32_OPS_S)),
        "kxy_bwd": bound(tot_k * d * 4, (pairs, SFU_OPS_S), (pairs * 5 * d, F32_OPS_S)),
    }
    replaces = {"qrq": 73, "qrq_bwd": 199, "kxy": 325, "kxy_bwd": 406}
    return ([{"name": f"student_{name}", "route": "cuda",
             "source": "ssmtoybox_torch/csrc/" + ("student_qrq.cu" if "qrq" in name
                                                   else "student_mc.cu"),
             "replaces": f"ssmtoybox_tpu/ops/pallas_ops.py:{line}", "launches": counts[name],
             "max_abs_err": err[name], "ms": ms[name][0], "plain_ms": ms[name][1],
             "bound_ms": bounds[name][0], "bound_by": bounds[name][1], "library_ms": None}
             for name, line in replaces.items()], (dyn_s, obs_s, xs, ys))


#: the BSQ UNGM study (experiments/bsq_ungm.py:42-65): kernel parameters and
#: multi-indices of the UT, GH-5 and GH-7 rules
PAR_UT, PAR_GH5, PAR_GH7 = [[3.0, 0.3]], [[5.0, 0.6]], [[3.0, 0.4]]
#: the GPQ kernel parameters of the UNGM lanes (the main path's GPQKF's)
UNGM_GPQ_PAR = [[1.0, 3.0]]
#: GPQ kernel parameters of UNGM rules of 17-32 Gauss-Hermite points: a
#: length-scale of 1 keeps the step's variances positive there, where the
#: studies' [[1, 3]] loses most runs (tests/test_torch_sf_wide_slots.py)
UNGM_GPQ_WIDE_PAR = [[1.0, 1.0]]
#: the BSQ reentry tracking study (experiments/bsq_tracking.py:40-84), cut
#: from its 200 s to TRACK_DUR for the script's time limit (the eager lanes
#: are host-bound, ~3.5 ms a step on the card); the RMSE order it gates on
#: holds by a wide margin there (0.49 < 4.3 < 15.7 at mc 10 on the CPU)
TRACK_DUR, TRACK_TAU, TRACK_DT = 100.0, 0.05, 0.1
TRACK_M0_TRUE = [6500.0, 350.0, -1.8, -6.8, 0.7]
TRACK_M0_MIS = [6500.0, 350.0, -1.1, -6.1, 0.7]
TRACK_PAR_DYN = [[1.0, 1, 1, 1, 1, 1]]
TRACK_PAR_OBS = [[1.0, 0.9, 0.9, 1e4, 1e4, 1e4]]
#: the Vandermonde kernel's Monte-Carlo verifier batch, and a wide shape
VDM_VERIFY_N, VDM_WIDE_N = 100_000, 1_000_000


def event_ms(torch, fn):
    """Time of one call of ``fn`` on the card in ms, CUDA events, no warm-up
    (the caller has run it once); returns ``(ms, result)``."""
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop), out


def scalar_filter_shapes(torch, np, dev, dyn, obs, y_tm, c, n_steps=40):
    """Phase 2, second part: the scalar filter kernel against its twin, to the
    bit, through every instantiation of the shaped form, every slot count and
    kind pair of the general form's slot design, and its one-thread design
    (GH-17), at batch sizes that leave warps and blocks ragged."""
    import ssmtoybox_torch as stt
    from ssmtoybox_torch.ops import scalar_filter as sf

    def gpq(par, deg):
        return stt.GaussianProcessKalman(dyn, obs, np.array(par), np.array(par), points="gh",
                                         point_hyp={"degree": deg})

    def bsq(par, deg):
        mi = np.atleast_2d(np.arange(deg))
        return stt.BayesSardKalman(dyn, obs, np.array(par), np.array(par), mulind_dyn=mi,
                                   mulind_obs=mi, points="gh", point_hyp={"degree": deg})

    algs = {"ut": stt.UnscentedKalman(dyn, obs), "gh5": stt.GaussHermiteKalman(dyn, obs, deg=5),
            "gh7": stt.GaussHermiteKalman(dyn, obs, deg=7),
            "gpq_ut": stt.GaussianProcessKalman(dyn, obs, np.array(PAR_UT), np.array(PAR_UT),
                                                points="ut"),
            "bsq_gh5": bsq(PAR_GH5, 5), "bsq_gh7": bsq(PAR_GH7, 7),
            "gh4": stt.GaussHermiteKalman(dyn, obs, deg=4),
            "gh8": stt.GaussHermiteKalman(dyn, obs, deg=8), "gpq_gh8": gpq(PAR_GH7, 8),
            "gh9": stt.GaussHermiteKalman(dyn, obs, deg=9),
            "gh12": stt.GaussHermiteKalman(dyn, obs, deg=12),
            "gh15": stt.GaussHermiteKalman(dyn, obs, deg=15),
            "gh16": stt.GaussHermiteKalman(dyn, obs, deg=16),
            "gh17": stt.GaussHermiteKalman(dyn, obs, deg=17), "gpq_gh9": gpq(UNGM_GPQ_PAR, 9),
            "gpq_gh15": gpq(UNGM_GPQ_PAR, 15), "bsq_gh9": bsq(PAR_GH7, 9)}
    # (dynamics rule of, measurement rule of): the six study shapes, a mixed
    # pair each way, rules outside the table (4 points padded to 5 slots, 5
    # with 8, 8 points of either kind), and the general form's rules (9, 12,
    # 15, 16 and 17 points, GPQ on 9 and 15, BSQ on 9, mixed with 3- and
    # 9-point rules of either kind)
    pairs = [(a, a) for a in algs] + [("bsq_gh5", "ut"), ("gh7", "gpq_ut"), ("gh5", "gh8"),
                                      ("gh15", "gpq_ut"), ("gpq_gh15", "ut"), ("gh15", "gh9"),
                                      ("gh9", "gpq_gh15")]
    seen = set()
    for a, b in pairs:
        params = sf.prepare(dyn, obs, algs[a].tf_dyn, algs[b].tf_obs)
        seen.add((sf.form_of(params), *sf.geometry(params), params.dyn.kind, params.obs.kind))
        for batch in (1, 7, 4097, y_tm.shape[1]):
            yy, cc = y_tm[:n_steps, :batch].contiguous(), c[:n_steps].contiguous()
            got, ref = sf.scalar_filter(params, yy, cc), sf._scalar_filter_plain(params, yy, cc)
            torch.cuda.synchronize()
            if not all(torch.equal(g_, r_) and bool(torch.isfinite(g_).all())
                       for g_, r_ in zip(got, ref)):
                fail(f"scalar filter kernel vs twin, rules {a}/{b}, B={batch}, N={n_steps}: max "
                     f"|diff| {max(float((g_ - r_).abs().max()) for g_, r_ in zip(got, ref)):.3e}"
                     f", expected equal bits")
        again = sf.scalar_filter(params, yy, cc)
        by_traj = sf.scalar_filter(params, yy.T.contiguous().T, cc)
        torch.cuda.synchronize()
        for what, other in (("a second launch", again), ("trajectory-major y", by_traj)):
            if not all(torch.equal(g_, o_) for g_, o_ in zip(got, other)):
                fail(f"scalar filter kernel, rules {a}/{b}: {what} differs from the first")
    log(f"scalar filter kernel == twin to the bit at {len(pairs)} rule pairs "
        f"({len(seen)} instantiations (form, design, slots, lanes, kinds)): "
        f"{sorted(seen, key=str)}), B = 1, 7, 4097, "
        f"{y_tm.shape[1]}, N = {n_steps}; two launches and trajectory-major y equal to the bit")


def sf_bound(params, n_steps, batch):
    """Bound of the scalar filter kernel on ``n_steps`` x ``batch``: it reads
    y and c (a registered transition's n_s streams) and writes five streams;
    a step costs ~10 f64 operations a point for the dynamics, 4 for the
    measurement (a registered form's ``form_ops`` and 2 for its point), 10 a
    point for a classical rule's moments or 2 n^2 + 6 n for a BQ rule's, and
    ~12 for the update."""
    def moments(rule):
        return 10 * rule.n if rule.kind == 0 else 2 * rule.n ** 2 + 6 * rule.n
    dyn = 10 if params.dyn_form is None else form_ops(params.dyn_form) + 2
    obs = 4 if params.obs_form is None else form_ops(params.obs_form) + 2
    per_step = dyn * params.dyn.n + obs * params.obs.n + moments(params.dyn) + moments(params.obs) + 12
    return bound(6 * n_steps * batch * 8 + n_steps * params.n_s * 8,
                 (n_steps * batch * per_step, F64_OPS_S))


def vdm_bound(mul, n):
    """Bound of the Vandermonde kernel: x in, the (N, Q) matrix out, and the
    kernel's f64 multiplies (the exponents, plus one a dimension a column)."""
    d, q = mul.shape
    return bound(d * n * 8 + d * q * 4 + n * q * 8, (n * (int(mul.sum()) + d * q), F64_OPS_S))


def bsq_slice(torch, np, dev, xs, ys):
    """Phases 9-14: the Bayes-Sard quadrature path and the Vandermonde
    kernel.  ``xs``/``ys`` are the main path's UNGM study data (10,000 x 500,
    the set-up of ``experiments/bsq_ungm.py``).  Returns the Vandermonde
    kernel's entry of the ``kernels`` line, the scalar filter kernel's
    launches on this path, and the vector filter kernel's launches and max
    |diff| from its plain version on the tracking UKF lane."""
    import ssmtoybox_torch as stt
    from ssmtoybox_torch.bq.models import BayesSardModel, _exp_x_kxpx
    from ssmtoybox_torch.ops import scalar_filter as sf, vandermonde as vdm, vector_filter as vf
    from ssmtoybox_torch.ssmod import (Radar2DMeasurement, ReentryVehicle2DTransition,
                                       UNGMMeasurement, UNGMTransition)
    from ssmtoybox_torch.utils import GaussRV
    from ssmtoybox_torch.utils.combin import total_degree_multi_index

    f64 = dict(dtype=torch.float64, device=dev)
    mul_ut5 = np.hstack((np.zeros((5, 1), int), np.eye(5, dtype=int), 2 * np.eye(5, dtype=int)))

    # ---- 9. the Vandermonde kernel vs its plain version; kernel 1 at 7 points
    shapes = {"D1_N3": (np.array([[0, 1, 2]]), 3), "D1_N5": (np.atleast_2d(np.arange(5)), 5),
              "D1_N7": (np.atleast_2d(np.arange(7)), 7), "D5_N11": (mul_ut5, 11),
              "D5_verifier": (mul_ut5, VDM_VERIFY_N),
              "D5_wide": (total_degree_multi_index(5, 2), VDM_WIDE_N)}
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    vdm_err, vdm_ms, vdm_in = 0.0, {}, {}
    for tag, (mul, n) in shapes.items():
        x = torch.randn((mul.shape[0], n), generator=gen, **f64)
        got, ref = vdm.vandermonde(mul, x), vdm.vandermonde_plain(mul, x)
        torch.cuda.synchronize()
        err = float((got - ref).abs().max())
        vdm_err = max(vdm_err, err)
        if not torch.equal(got, ref):
            fail(f"Vandermonde kernel vs plain at {tag} (D={mul.shape[0]}, N={n}, "
                 f"Q={mul.shape[1]}): max |diff| {err:.3e}, expected bit-equality")
        vdm_in[tag] = (mul, x)
        log(f"Vandermonde kernel == plain to the bit at {tag} (D={mul.shape[0]}, N={n}, "
            f"Q={mul.shape[1]}, {n * mul.shape[1] * 8 / 1e6:.1f} MB out)")
    edges = {"N1": (mul_ut5, 1), "one short of a tile": (mul_ut5, 127),
             "a tile": (mul_ut5, 128), "one over a tile": (mul_ut5, 129),
             "Q40 (two column tiles)": (np.atleast_2d(np.arange(40) % 6), 1000),
             "Q33 (a column tile and one column)": (np.atleast_2d(np.arange(33) % 4), 257),
             "even Q": (total_degree_multi_index(3, 2)[:, :8], 5000),
             "D9": (np.vstack((np.eye(9, dtype=int), [[2, 0, 1, 0, 3, 0, 0, 1, 2]])).T, 777),
             "staged 5x56": (total_degree_multi_index(5, 3), 10_001),
             "staged 2x6000": (np.ones((2, 6000), int), 300)}
    routes = set()
    for tag, (mul, n) in edges.items():
        x = torch.randn((mul.shape[0], n), generator=gen, **f64)
        before = vdm.LAUNCHES
        got, ref = vdm.vandermonde(mul, x), vdm.vandermonde_plain(mul, x)
        torch.cuda.synchronize()
        routes.add("by value" if mul.size <= vdm.VALUE_INTS else "staged")
        if not torch.equal(got, ref) or vdm.LAUNCHES != before + 1:
            fail(f"Vandermonde kernel vs plain at {tag} (D={mul.shape[0]}, N={n}, "
                 f"Q={mul.shape[1]}): max |diff| {float((got - ref).abs().max()):.3e}, "
                 f"{vdm.LAUNCHES - before} launches; expected equal bits from 1 launch")
    if routes != {"by value", "staged"}:
        fail(f"the Vandermonde edge shapes took the routes {routes}; expected both")
    log(f"Vandermonde kernel == plain to the bit at {len(edges)} edge shapes "
        f"({', '.join(edges)}); multi-index by value and staged in shared memory")
    dyn_g7 = UNGMTransition(GaussRV(1, cov=5.0, device=dev), GaussRV(1, cov=10.0, device=dev))
    obs_g7 = UNGMMeasurement(GaussRV(1, cov=1.0, device=dev), dim_state=1)
    y_tm = ys[:, 0, :].T.contiguous()
    c = torch.as_tensor(sf.ungm_consts(y_tm.shape[0]), device=dev)
    rules7 = {"GH-7": stt.GaussHermiteKalman(dyn_g7, obs_g7, deg=7),
              "BSQ-GH7": stt.BayesSardKalman(dyn_g7, obs_g7, np.array(PAR_GH7),
                                             np.array(PAR_GH7),
                                             mulind_dyn=np.atleast_2d(np.arange(7)),
                                             mulind_obs=np.atleast_2d(np.arange(7)),
                                             points="gh", point_hyp={"degree": 7})}
    for name, alg in rules7.items():
        params = sf.prepare(dyn_g7, obs_g7, alg.tf_dyn, alg.tf_obs)
        for n_steps in (1, 20):
            yy = y_tm[:n_steps, :COMPARE_B].contiguous()
            cc = c[:n_steps].contiguous()
            got, ref = sf.scalar_filter(params, yy, cc), sf._scalar_filter_plain(params, yy, cc)
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(got, ref)):
                fail(f"scalar filter kernel vs twin at 7 points ({name}, N={n_steps}): "
                     f"max |diff| {max(float((a - b).abs().max()) for a, b in zip(got, ref)):.3e}")
        log(f"scalar filter kernel == twin to the bit at 7 points ({name}, N=1 and 20, "
            f"B={COMPARE_B})")

    # ---- 10. BSQ goldens on the card --------------------------------------
    g = np.load(os.path.join(HERE, "tests", "goldens", "ungm.npz"))
    dyn_g = UNGMTransition(GaussRV(1, cov=1.0, device=dev), GaussRV(1, cov=10.0, device=dev))
    obs_g = UNGMMeasurement(GaussRV(1, cov=1.0, device=dev), dim_state=1)
    batch_g = torch.as_tensor(np.moveaxis(g["y"], -1, 0), device=dev)
    mi = np.array([[0, 1, 2]])
    bsq_g = stt.BayesSardKalman(dyn_g, obs_g, np.array(PAR_UT), np.array(PAR_UT),
                                mulind_dyn=mi, mulind_obs=mi)
    checks = [("bsqkf", bsq_g, engine, ("fm", "fP", "sm", "sP")) for engine in ("f64", "dd")]
    checks.append(("ghkf5", stt.GaussHermiteKalman(dyn_g, obs_g, deg=5), "dd", ("fm", "fP")))
    for name, alg, engine, keys in checks:
        res = alg.forward_pass_batch(batch_g, engine=engine)
        sm, sP = stt.gaussian_smoother(res)
        got = {"fm": res.fi_mean[0], "fP": res.fi_cov[0], "sm": sm[0], "sP": sP[0]}
        for key in keys:
            if not np.allclose(got[key].cpu().numpy(), g[f"{name}_{key}"], atol=1e-8, rtol=1e-8):
                fail(f"golden ungm {name}_{key} ({engine}) off by "
                     f"{np.abs(got[key].cpu().numpy() - g[f'{name}_{key}']).max():.3e}")
    g = np.load(os.path.join(HERE, "tests", "goldens", "reentry.npz"))
    dyn_r = ReentryVehicle2DTransition(
        GaussRV(5, mean=np.array([6500.4, 349.14, -1.8093, -6.7967, 0.6932]),
                cov=np.diag([1e-6, 1e-6, 1e-6, 1e-6, 1.0]), device=dev),
        GaussRV(3, cov=np.diag([2.4064e-5, 2.4064e-5, 1e-6]), device=dev), dt=0.05)
    obs_r = Radar2DMeasurement(GaussRV(2, cov=np.diag([1e-3, 1e-5]), device=dev), dim_state=5,
                               state_index=[0, 1], radar_loc=np.array([6374.0, 0.0]))
    bsq_r = stt.BayesSardKalman(dyn_r, obs_r, np.array(TRACK_PAR_DYN), np.array(TRACK_PAR_OBS),
                                mulind_dyn=mul_ut5, mulind_obs=mul_ut5)
    fm, fP = bsq_r.forward_pass(torch.as_tensor(g["y"][..., 0], device=dev))
    for got, key in ((fm, "bsqkf_fm"), (fP, "bsqkf_fP")):
        if not np.allclose(got.cpu().numpy(), g[key], atol=1e-7, rtol=1e-6):
            fail(f"golden reentry {key} off by {np.abs(got.cpu().numpy() - g[key]).max():.3e}")
    g = np.load(os.path.join(HERE, "tests", "goldens", "transforms.npz"))
    for branch, model in (
            ("gh", BayesSardModel(2, g["kern_par"], 2, "gh", {"degree": 3}, device=dev)),
            ("uni", BayesSardModel(2, g["kern_par"], g["bs_uni_mulind"], "ut", device=dev))):
        w = model.bq_weights()
        for key, got in (("wm", w.wm), ("wc", w.Wc), ("wcc", w.Wcc), ("emv", w.model_var),
                         ("ivar", w.integral_var)):
            ref = g.get(f"bs_{branch}_{key}")
            if ref is not None and not np.allclose(np.atleast_1d(got.cpu().numpy()), ref,
                                                   atol=1e-8, rtol=1e-8):
                fail(f"golden transforms bs_{branch}_{key} off by "
                     f"{np.abs(np.atleast_1d(got.cpu().numpy()) - ref).max():.3e}")
    log("BSQ goldens on the card: ungm bsqkf (f64 and dd, filter and smoother, 1e-8), ghkf5 "
        "(dd), reentry bsqkf (1e-7/1e-6), transforms bs_gh_*/bs_uni_* (1e-8) ok")

    # ---- 11. the BSQ UNGM study, 10,000 x 500 -----------------------------
    dyn = UNGMTransition(GaussRV(1, cov=5.0, device=dev), GaussRV(1, cov=10.0, device=dev))
    obs = UNGMMeasurement(GaussRV(1, cov=1.0, device=dev), dim_state=1)
    gh = lambda deg: {"degree": deg}  # noqa: E731
    mgh = lambda deg: np.atleast_2d(np.arange(deg))  # noqa: E731
    par_ut, par_gh5, par_gh7 = np.array(PAR_UT), np.array(PAR_GH5), np.array(PAR_GH7)
    makers = {
        "UT": lambda: stt.UnscentedKalman(dyn, obs, alpha=1.0, beta=0.0),
        "GH-5": lambda: stt.GaussHermiteKalman(dyn, obs, deg=5),
        "GH-7": lambda: stt.GaussHermiteKalman(dyn, obs, deg=7),
        "GPQ-UT": lambda: stt.GaussianProcessKalman(dyn, obs, par_ut, par_ut, points="ut"),
        "GPQ-GH5": lambda: stt.GaussianProcessKalman(dyn, obs, par_gh5, par_gh5, points="gh",
                                                     point_hyp=gh(5)),
        "GPQ-GH7": lambda: stt.GaussianProcessKalman(dyn, obs, par_gh7, par_gh7, points="gh",
                                                     point_hyp=gh(7)),
        "BSQ-UT": lambda: stt.BayesSardKalman(dyn, obs, par_ut, par_ut, mulind_dyn=mi,
                                              mulind_obs=mi, points="ut"),
        "BSQ-GH5": lambda: stt.BayesSardKalman(dyn, obs, par_gh5, par_gh5, mulind_dyn=mgh(5),
                                               mulind_obs=mgh(5), points="gh", point_hyp=gh(5)),
        "BSQ-GH7": lambda: stt.BayesSardKalman(dyn, obs, par_gh7, par_gh7, mulind_dyn=mgh(7),
                                               mulind_obs=mgh(7), points="gh", point_hyp=gh(7)),
    }
    torch.cuda.synchronize()
    sf.LAUNCHES = vdm.LAUNCHES = 0
    algs = {name: make() for name, make in makers.items()}
    torch.cuda.synchronize()
    vdm_builds = vdm.LAUNCHES
    scores, rmse_f64 = {}, {}
    for name, alg in algs.items():
        res = alg.forward_pass_batch(ys, engine="dd")
        sm, sP = stt.gaussian_smoother(res)
        scores[name] = (study_scores(torch, xs, res.fi_mean, res.fi_cov),
                        study_scores(torch, xs, sm, sP))
        if name.startswith("BSQ"):
            r64 = alg.forward_pass_batch(ys, engine="f64")
            rmse_f64[name] = study_scores(torch, xs, r64.fi_mean, r64.fi_cov)[0]
    torch.cuda.synchronize()
    ungm_launches = {"vandermonde": vdm.LAUNCHES, "scalar_filter": sf.LAUNCHES}
    log(f"BSQ UNGM path launches: {ungm_launches} (Vandermonde {vdm_builds} while the nine "
        f"filters were built)")
    if vdm_builds < 6:
        fail(f"the Vandermonde kernel ran {vdm_builds} times while the 3 BSQ filters were built")
    if sf.LAUNCHES < 9:
        fail(f"the scalar filter kernel ran {sf.LAUNCHES} times for the 9 UNGM lanes")
    nci = {}
    for name, ((rf, incf, nllf, ncif), (rs, incs, nlls, ncis)) in scores.items():
        ok = (torch.isfinite(rf) & torch.isfinite(incf) & torch.isfinite(nllf)
              & torch.isfinite(rs) & torch.isfinite(ncis) & torch.isfinite(nlls))
        bad = 1.0 - float(ok.double().mean())
        nci[name] = float(ncif[ok].mean())
        log(f"UNGM {name} ({MC}x{UNGM_STEPS}, dd): filtered RMSE {float(rf[ok].mean()):.4f}, "
            f"NCI {nci[name]:.4f}, NLL {float(nllf[ok].mean()):.4f}; smoothed RMSE "
            f"{float(rs[ok].mean()):.4f}, NCI {float(ncis[ok].mean()):.4f}, NLL "
            f"{float(nlls[ok].mean()):.4f}; diverged {bad:.4%}")
        if bad > 0.01:
            fail(f"UNGM {name}: {bad:.2%} of the runs are not finite (limit 1%)")
    for deg in ("5", "7"):
        if not nci[f"BSQ-GH{deg}"] < nci[f"GH-{deg}"]:
            fail(f"NCI of BSQ-GH{deg} ({nci[f'BSQ-GH{deg}']:.3f}) is not below GH-{deg}'s "
                 f"({nci[f'GH-{deg}']:.3f})")
    for name, r64 in rmse_f64.items():
        r_dd = scores[name][0][0]
        a, b = float(r_dd[torch.isfinite(r_dd)].mean()), float(r64[torch.isfinite(r64)].mean())
        log(f"UNGM {name}: study RMSE dd {a:.6f} vs eager f64 {b:.6f}, relative "
            f"{abs(a - b) / b:.2e} (limit 1e-3)")
        if not abs(a - b) / b < 1e-3:
            fail(f"UNGM {name}: study RMSE through dd and f64 differ by {abs(a - b) / b:.3e}")

    # ---- 12. the BSQ tracking study, 10,000 x 1,000 -----------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    sys_dyn = ReentryVehicle2DTransition(
        GaussRV(5, mean=TRACK_M0_TRUE, cov=np.diag([1e-6, 1e-6, 1e-6, 1e-6, 1e-12]), device=dev),
        GaussRV(3, cov=np.diag([2.4e-5, 2.4e-5, 1e-12]), device=dev), dt=TRACK_TAU)
    obs_t = Radar2DMeasurement(GaussRV(2, cov=np.diag([1e-6, 0.17e-6]), device=dev),
                               dim_state=5, radar_loc=np.array([6374.0, 0.0]))
    t0 = time.perf_counter()
    x_t = sys_dyn.simulate_continuous(gen, duration=TRACK_DUR, dt=TRACK_TAU, mc_sims=MC)
    y_t = obs_t.simulate_measurements(gen, x_t)
    xs_t = x_t[:, ::2].permute(2, 0, 1).contiguous()
    ys_t = y_t[:, ::2].permute(2, 0, 1).contiguous()
    del x_t, y_t
    torch.cuda.synchronize()
    log(f"tracking truth: Euler-Maruyama {int(TRACK_DUR / TRACK_TAU)} steps x {MC} on the "
        f"card, sub-sampled to {xs_t.shape[-1]} filter steps, {time.perf_counter() - t0:.1f} s")
    dyn_t = ReentryVehicle2DTransition(
        GaussRV(5, mean=TRACK_M0_MIS, cov=np.diag([1e-6, 1e-6, 1e-6, 1e-6, 1.0]), device=dev),
        GaussRV(3, cov=np.diag([2.4e-5, 2.4e-5, 1e-6]), device=dev), dt=TRACK_DT)
    overrides = {"bsqkf": np.diag([2e-4] * 5), "bsqkf_2e-6": 2e-6 * np.eye(5),
                 "bsqkf_2e-7": 2e-7 * np.eye(5)}
    sf.LAUNCHES = vdm.LAUNCHES = 0
    vf_zero(vf)
    t_algs, t_build = {}, {}
    for name, mv in overrides.items():
        t0 = time.perf_counter()
        alg = stt.BayesSardKalman(dyn_t, obs_t, np.array(TRACK_PAR_DYN), np.array(TRACK_PAR_OBS),
                                  mulind_dyn=mul_ut5, mulind_obs=mul_ut5, points="ut")
        alg.tf_dyn = alg.tf_dyn.replace(model_var=mv)
        alg.tf_obs = alg.tf_obs.replace(model_var=np.zeros((2, 2)))
        torch.cuda.synchronize()
        t_build[name] = time.perf_counter() - t0
        t_algs[name] = alg
    t_algs["ukf"] = stt.UnscentedKalman(dyn_t, obs_t, beta=0.0)
    # every lane through engine="auto": the UKF runs in the vector filter
    # kernel; the BSQ lanes' matrix EMV overrides send them to the eager path,
    # as the JAX package's engine="auto" does; the UKF also eagerly
    track_ms, track, engine_of, track_err = {}, {}, {}, 0.0
    lanes_t = [(name, "auto") for name in t_algs] + [("ukf", "f64")]
    for name, engine in lanes_t:
        alg, before = t_algs[name], vf.LAUNCHES
        ms, res = event_ms(torch, lambda: alg.forward_pass_batch(ys_t, engine=engine))
        ran = "dd" if vf.LAUNCHES > before else "f64"
        key = name if engine == "auto" else f"{name}_f64"
        engine_of[key], track_ms[key] = ran, ms
        rmse_r, inc_r, nll_r, _ = study_scores(torch, xs_t, res.fi_mean, res.fi_cov)
        if ran == "dd":
            # the kernel's result on this path against its plain version, at full shape
            t0 = time.perf_counter()
            plain = vf._vector_filter_plain(vf.prepare(dyn_t, obs_t, alg.tf_dyn, alg.tf_obs),
                                            ys_t)
            torch.cuda.synchronize()
            t_plain = time.perf_counter() - t0
            track_err = vf_against_plain(torch, res, plain, f"tracking {name} {tuple(ys_t.shape)}")
            del plain
            log(f"tracking {name} {MC}x{ys_t.shape[-1]}: the kernel's result == plain version to "
                f"the bit, all five streams (plain version {t_plain:.1f} s)")
        del res
        ok = torch.isfinite(rmse_r) & torch.isfinite(inc_r) & torch.isfinite(nll_r)
        bad = 1.0 - float(ok.double().mean())
        track[key] = float(rmse_r[ok].mean())
        log(f"tracking {name} ({MC}x{xs_t.shape[-1]}, engine={engine!r} ran {ran}): RMSE "
            f"{track[key]:.4f}, INC {float(inc_r[ok].mean()):.4f}, diverged {bad:.4%}, first "
            f"filter {ms:.1f} ms")
        if bad > 0.01:
            fail(f"tracking {name}: {bad:.2%} of the runs are not finite (limit 1%)")
    torch.cuda.synchronize()
    track_launches, track_vf, track_vfs = vdm.LAUNCHES, vf.LAUNCHES, vf.SHAPED_LAUNCHES
    log(f"BSQ tracking path launches: Vandermonde {track_launches}, vector filter {track_vf} "
        f"({track_vfs} of them the shaped kernel); engines {engine_of}")
    if track_launches < 6:
        fail(f"the Vandermonde kernel ran {track_launches} times for the 3 BSQ tracking filters")
    if engine_of != {"bsqkf": "f64", "bsqkf_2e-6": "f64", "bsqkf_2e-7": "f64", "ukf": "dd",
                     "ukf_f64": "f64"} or (track_vf, track_vfs) != (1, 1):
        fail(f"tracking lanes ran on the engines {engine_of} with {track_vf} vector filter "
             f"launches ({track_vfs} of the shaped kernel); expected the UKF alone through the "
             "shaped kernel, once")
    if f"{track['ukf']:.4f}" != f"{track['ukf_f64']:.4f}":
        fail(f"tracking UKF RMSE through the kernel {track['ukf']:.4f} differs from the eager "
             f"lane's {track['ukf_f64']:.4f}")
    if not track["bsqkf"] < track["bsqkf_2e-6"] < track["ukf"]:
        fail(f"tracking RMSE does not order bsqkf < bsqkf_2e-6 < ukf: {track}")

    # ---- 13. the Monte-Carlo verifiers on the tracking dynamics rule ------
    model = BayesSardModel(5, np.array(TRACK_PAR_DYN), mul_ut5, "ut",
                           compat_kxpx_ell_squared=False, device=dev)
    vdm.LAUNCHES = 0
    vgen = torch.Generator(device=dev).manual_seed(SEED)
    mc = model.mc_exp_x_kxpx(vgen)
    closed = _exp_x_kxpx(model._ell(model.kernel.par), model.mulind, model.points)
    n_kxpx = vdm.LAUNCHES
    cov = model.mc_exp_x_cov(vgen)
    torch.cuda.synchronize()
    n_cov = vdm.LAUNCHES - n_kxpx
    err_mc = float((mc - closed).abs().max())
    log(f"mc_exp_x_kxpx (10 x 100,000) vs closed form: max |diff| {err_mc:.2e} (atol 5e-3); "
        f"mc_exp_x_cov diagonal {[round(float(v), 6) for v in torch.diagonal(cov)]}; "
        f"Vandermonde launches {n_kxpx} and {n_cov}")
    if not err_mc < 5e-3:
        fail(f"mc_exp_x_kxpx differs from the closed form by {err_mc:.3e}")
    if (n_kxpx, n_cov) != (10, 11):
        fail(f"the verifiers launched the Vandermonde kernel {n_kxpx} and {n_cov} times; "
             "expected 10 and 11")
    t0 = time.perf_counter()
    model.mc_exp_x_kxpx(vgen)
    model.mc_exp_x_cov(vgen)
    torch.cuda.synchronize()
    log(f"the two verifiers again (21 Vandermonde calls and all around them): "
        f"{(time.perf_counter() - t0) * 1e3:.2f} ms")

    # ---- 14. timings (after the counts were read) -------------------------
    for tag, (mul, x) in vdm_in.items():
        k_ms = cuda_ms(torch, lambda: vdm.vandermonde(mul, x))
        p_ms = cuda_ms(torch, lambda: vdm.vandermonde_plain(mul, x))
        b_ms, b_by = vdm_bound(mul, x.shape[1])
        vdm_ms[tag] = (k_ms[0], p_ms[0], b_ms, b_by)
        log(f"vandermonde {tag}: kernel {k_ms[0]:.4f} ms (min {k_ms[1]:.4f}), plain "
            f"{p_ms[0]:.4f} ms (min {p_ms[1]:.4f}), bound {b_ms:.4f} ms ({b_by})")
    for name in ("BSQ-UT", "BSQ-GH5", "BSQ-GH7"):
        t0 = time.perf_counter()
        makers[name]()
        torch.cuda.synchronize()
        log(f"{name}: both BSQ transforms built in {(time.perf_counter() - t0) * 1e3:.1f} ms")
    for name, ms in t_build.items():
        log(f"tracking {name}: both 5-D BSQ transforms built (and the EMV replaced) in "
            f"{ms * 1e3:.1f} ms (timed once, in the study's set-up)")
    for name, alg in algs.items():
        # the eager lane and the smoother once after the warm-up: nine lanes of
        # ~1.4 s and ~0.5 s a call
        t = {"dd": cuda_ms(torch, lambda: alg.forward_pass_batch(ys, engine="dd")),
             "f64": cuda_ms(torch, lambda: alg.forward_pass_batch(ys, engine="f64"), reps=1)}
        res = alg.forward_pass_batch(ys, engine="dd")
        t["smoother"] = cuda_ms(torch, lambda: stt.gaussian_smoother(res), reps=1)
        log(f"UNGM {name}: " + ", ".join(f"{k} {v[0]:.2f} ms (min {v[1]:.2f})"
                                        for k, v in t.items()))
    # the kernel's lane a second time; the eager lanes' first runs (phase 12)
    # stand, each ~4-5 s
    ms, res = event_ms(torch, lambda: t_algs["ukf"].forward_pass_batch(ys_t, engine="auto"))
    del res
    log(f"tracking ukf ({engine_of['ukf']}): filter {ms:.1f} ms (second run; first "
        f"{track_ms['ukf']:.1f} ms)")
    p_t = vf.prepare(dyn_t, obs_t, t_algs["ukf"].tf_dyn, t_algs["ukf"].tf_obs)
    raw_t = raw_ms(torch, vf_raw(torch, vf, p_t, ys_t, dev), reps=5)
    raw_first = raw_ms(torch, vf_raw(torch, vf, p_t, ys_t, dev, "vector_filter"), reps=5)
    b_t = vf_bound(p_t, ys_t.shape[-1], MC)
    floor_t = vf.chain_floor_clocks(sf.dependent_latencies(dev), p_t)
    log(f"vector_filter_shaped tracking UKF {MC}x{ys_t.shape[-1]}: raw launches {raw_t:.3f} ms "
        f"a launch (CUDA events around 5 behind torch.cuda._sleep; the first-version kernel on the "
        f"same input {raw_first:.3f} ms), bound {b_t[0]:.3f} ms "
        f"({b_t[1]}), chain floor {floor_t:.0f} clocks a step = "
        f"{floor_t * ys_t.shape[-1] / (float(clocks_line().split()[0]) * 1e3):.3f} ms")
    lib_sf, lib_vdm = sf.build(), vdm.build()
    out_sf = torch.empty((5,) + tuple(y_tm.shape), **f64)
    stream = torch.cuda.current_stream(dev).cuda_stream
    n_steps, batch = y_tm.shape
    by_traj = ys[:, 0, :].T                      # the lane's view: (N, B), strides (1, N)
    lat = sf.dependent_latencies(dev)
    mhz = float(clocks_line().split()[0])
    log("dependent-issue latency of the card in clocks (one warp, 8,192 operations each): "
        + ", ".join(f"{op} {clocks:.1f}" for op, clocks in lat.items()))
    copy_ms = cuda_ms(torch, lambda: ys[:, 0, :].T.contiguous())
    log(f"the transposed copy of y ({batch} x {n_steps}, 40 MB) that a lane no longer makes: "
        f"{copy_ms[0]:.4f} ms (min {copy_ms[1]:.4f})")
    log(f"SM clock before the scalar filter's profiled launches (current, max): {clocks_line()}")
    for name, alg in (("UT (3 points)", algs["UT"]), ("GH-7 (7 points)", algs["GH-7"]),
                      ("BSQ-GH7 (7 points)", algs["BSQ-GH7"])):
        params = sf.prepare(dyn, obs, alg.tf_dyn, alg.tf_obs)
        k = cuda_ms(torch, lambda: sf.scalar_filter(params, y_tm, c))
        lane = cuda_ms(torch, lambda: alg.forward_pass_batch(ys, engine="dd"))
        b_ms, b_by = sf_bound(params, n_steps, batch)
        dev_ms, _ = device_ms(torch, lambda: sf.scalar_filter(params, y_tm, c),
                              "scalar_filter_kernel")
        p_c = sf._c_params(params)

        def raw_launch(y_in):
            return lib_sf.sf_launch(ctypes.byref(p_c), y_in.data_ptr(), y_in.stride(0),
                                    y_in.stride(1), c.data_ptr(), batch, n_steps, dev.index or 0,
                                    *(o.data_ptr() for o in out_sf), stream)

        raw = raw_ms(torch, lambda: raw_launch(y_tm))
        raw_bt = raw_ms(torch, lambda: raw_launch(by_traj))
        # one launch between two events after a synchronise, as the wrapper
        # call and the lane are timed: a launch on an idle card takes longer
        # than one of 20 in a row
        alone = cuda_ms(torch, lambda: raw_launch(y_tm))[0]
        alone_bt = cuda_ms(torch, lambda: raw_launch(by_traj))[0]
        floor = sf.chain_floor_clocks(lat, params)
        log(f"scalar_filter {name} {MC}x{UNGM_STEPS}: wrapper call {k[0]:.3f} ms (min {k[1]:.3f}), "
            f"device {fmt_ms(dev_ms)}, raw launches {raw:.4f} ms a launch (CUDA events around "
            f"20; {raw_bt:.4f} ms reading trajectory-major y), bound {b_ms:.4f} ms ({b_by}), "
            f"chain floor {floor:.0f} clocks a step = {floor * n_steps / (mhz * 1e3):.4f} ms at "
            f"{mhz:.0f} MHz")
        log(f"scalar_filter {name}: one raw launch alone {alone:.3f} ms ({alone_bt:.3f} "
            f"trajectory-major); wrapper call - raw launch {k[0] - alone:+.3f} ms alone, "
            f"{k[0] - raw:+.3f} in a row (goal within 0.10: "
            f"{'met' if k[0] - alone <= 0.10 else 'missed'}); lane forward_pass_batch("
            f"engine='dd') {lane[0]:.3f} ms (min {lane[1]:.3f}), lane - raw launch "
            f"{lane[0] - alone_bt:+.3f} ms alone, {lane[0] - raw_bt:+.3f} in a row (goal within "
            f"0.30: {'met' if lane[0] - alone_bt <= 0.30 else 'missed'})")
    log(f"SM clock after the scalar filter's profiled launches (current, max): {clocks_line()}")
    params = sf.prepare(dyn, obs, algs["UT"].tf_dyn, algs["UT"].tf_obs)
    p_c = sf._c_params(params)
    parts = {
        "_check_streams": lambda: sf._check_streams(y_tm, c),
        "build() (the bound library)": sf.build,
        "_c_params (cached struct)": lambda: sf._c_params(params),
        "torch.empty": lambda: torch.empty((5, n_steps, batch), **f64),
        "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
        "sf_launch through ctypes": lambda: lib_sf.sf_launch(
            ctypes.byref(p_c), y_tm.data_ptr(), batch, 1, c.data_ptr(), batch, n_steps,
            dev.index or 0, *(o.data_ptr() for o in out_sf), stream),
        "tuple(out)": lambda: tuple(out_sf),
        "the whole scalar_filter call": lambda: sf.scalar_filter(params, y_tm, c),
        "prepare (transforms and models seen)": lambda: sf.prepare(
            dyn, obs, algs["UT"].tf_dyn, algs["UT"].tf_obs),
        "the whole lane forward_pass_batch(engine='dd')": lambda: algs["UT"].forward_pass_batch(
            ys, engine="dd"),
    }
    log("host time of one scalar_filter call and one UNGM lane, part by part (host clock, 200 "
        "calls each, no synchronisation inside): "
        + ", ".join(f"{k_} {host_us(torch, fn):.1f} us" for k_, fn in parts.items()))
    for tag, (mul, x) in vdm_in.items():
        dev_ms, prof = device_ms(torch, lambda: vdm.vandermonde(mul, x), "vandermonde_kernel")
        vdm_ms[tag] += (dev_ms,)
        index = vdm._index(mul, x.shape[0])
        out_v = torch.empty((x.shape[1], mul.shape[1]), **f64)
        raw = raw_ms(torch, lambda: lib_vdm.vdm_launch(
            x.data_ptr(), index.e32.ctypes.data, None, x.shape[0], x.shape[1], mul.shape[1],
            dev.index or 0, out_v.data_ptr(), stream))
        log(f"vandermonde {tag}: device {fmt_ms(dev_ms)} a launch, raw launches {raw:.4f} ms "
            f"a launch (CUDA events around 20; the host needs ~0.01 ms to make one)")
        if tag == "D5_verifier":
            call = vdm_ms[tag][0]
            log(f"vandermonde {tag}: wrapper call {call:.4f} ms, - raw launch {call - raw:+.4f} "
                f"ms (goal at most 0.08 ms a call: {'met' if call <= 0.08 else 'missed'})")
            parts = {
                "_check_points": lambda: vdm._check_points(x),
                "_index (a multi-index seen)": lambda: vdm._index(mul, x.shape[0]),
                "build() (the bound library)": vdm.build,
                "torch.empty": lambda: torch.empty((x.shape[1], mul.shape[1]), **f64),
                "current_stream": lambda: torch.cuda.current_stream(dev).cuda_stream,
                "vdm_launch through ctypes": lambda: lib_vdm.vdm_launch(
                    x.data_ptr(), index.e32.ctypes.data, None, x.shape[0], x.shape[1],
                    mul.shape[1], dev.index or 0, out_v.data_ptr(), stream),
                "the whole call": lambda: vdm.vandermonde(mul, x),
            }
            log("host time of one vandermonde call at the verifiers' shape, part by part (host "
                "clock, 200 calls each, no synchronisation inside): "
                + ", ".join(f"{k_} {host_us(torch, fn):.1f} us" for k_, fn in parts.items()))

    k_ms, p_ms, b_ms, b_by, _ = vdm_ms["D5_verifier"]
    entry = {"name": "vandermonde", "route": "cuda", "source": "ssmtoybox_torch/csrc/vandermonde.cu",
             "replaces": "ssmtoybox_tpu/ops/pallas_ops.py:470",
             "launches": ungm_launches["vandermonde"] + track_launches, "max_abs_err": vdm_err,
             "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    return entry, ungm_launches["scalar_filter"], track_vfs, track_err


#: the vector filter kernel's checks: 20 steps at these batch sizes; GPQ
#: lengthscales long enough that the reentry filter stays positive definite,
#: and a BSQ rule for the CV radar system (its BQ instantiations)
VF_STEPS = 20
VF_BATCHES = (1, 7, 31, 4097, MC)
#: steps of phase 16b's pendulum GH-4 lane, the first version's path
VF_GH4_STEPS = 50
VF_GPQ_DYN, VF_GPQ_OBS = [[1.0, 10, 10, 10, 10, 10]], [[1.0, 10, 10, 1e4, 1e4, 1e4]]
VF_CV_BSQ = [[1.0, 100.0, 100.0, 100.0, 100.0]]
#: the ceilings of the reentry lane's dd-vs-f64 comparison: the JAX package's
#: own (tests/test_ddvec.py:109-134), means and covariances
VF_MEAN_ATOL, VF_COV_ATOL = 1e-6, 1e-7


#: f64 operations of each model's function, by model id (a square root, exp,
#: sine, cosine, atan2 or divide as one): reentry ~30, CV 4, the pendulum 5,
#: the falling body 9, the coordinated turn ~24 (its selects included); the
#: radar 8, the sine measurement 1, the range 4, four bearings 12
VF_DYN_OPS = {0: 30, 1: 4, 2: 5, 3: 9, 4: 24}
VF_OBS_OPS = {0: 8, 1: 1, 2: 4, 4: 3}
#: f64 operations of a bearing, a sensor (the measurement's E)
VF_BEARING_OPS = 3


def form_ops(form) -> int:
    """f64 operations of a registered model's statements: each arithmetic
    operator and each call of a math function once."""
    return (len(re.findall(r"[-+*/]", form.source))
            + len(re.findall(r"\b(?:sqrt|exp|log|sin|cos|tan|atan2|pow)\s*\(", form.source)))


def vf_bound(params, n_steps, batch):
    """Bound of the vector filter kernel on ``n_steps`` x ``batch``: it reads y
    (and a registered transition's streams) and writes the five streams (2 D
    + 3 D^2 doubles a step); its f64 operations counted a point (``L xi``
    once, though the kernel makes it again for a classical rule's second
    pass; the mean, the model (:data:`VF_DYN_OPS`, :data:`VF_OBS_OPS`, a
    registered form's ``form_ops``), the moment sums) and a step (the three
    Cholesky factors, the gain and the update)."""
    D, E = params.dim_state, params.dim_out

    def per_point(rule, eo, model):
        ops = D * (D + 1) + D + model + 2 * eo
        if rule.kind == 0:
            return ops + eo + 3 * eo * (eo + 1) // 2 + 3 * eo * D
        return ops + 2 * rule.n * eo + eo * (eo + 1) + 2 * eo * D

    def chol(n):
        return n * (n + 1) * (n + 2) // 3

    if params.obs_form is not None:
        obs_ops = form_ops(params.obs_form)
    else:
        obs_ops = VF_BEARING_OPS * E if params.obs_model == 3 else VF_OBS_OPS[params.obs_model]
    dyn_ops = (form_ops(params.dyn_form) if params.dyn_form is not None
               else VF_DYN_OPS[params.dyn_model])
    per_step = (2 * chol(D) + chol(E) + 2 * D * D + 4 * D * E * E + 2 * D * D * E
                + params.dyn.n * per_point(params.dyn, D, dyn_ops)
                + params.obs.n * per_point(params.obs, E, obs_ops))
    n_bytes = (batch * n_steps * (E + 2 * D + 3 * D * D) + n_steps * params.n_s) * 8
    return bound(n_bytes, (batch * n_steps * per_step, F64_OPS_S))


def same_bits(torch, a, b) -> bool:
    """Equal values, NaN where the other has NaN."""
    return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())


def vf_against_plain(torch, res, plain, what, chunk=200):
    """Hold a ``FilterResult`` of the vector filter kernel against the plain
    version's five time-major streams of the same input: equal bits, NaN
    where the plain version has NaN, compared ``chunk`` steps at a time to
    keep the temporaries small.  Fails otherwise; returns the max |diff|."""
    err = 0.0
    for f, ref in zip(("fi_mean", "fi_cov", "pr_mean", "pr_cov", "pr_xx_cov"), plain):
        got = getattr(res, f)
        got = got.permute(2, 1, 0) if got.ndim == 3 else got.permute(3, 1, 2, 0)  # time-major
        for k in range(0, ref.shape[0], chunk):
            g_, r_ = got[k:k + chunk], ref[k:k + chunk]
            diff = float((g_ - r_).nan_to_num().abs().max())
            err = max(err, diff)
            if not same_bits(torch, g_, r_):
                fail(f"{what}: {f} of the kernel differs from the plain version from step {k} "
                     f"on, max |diff| {diff:.3e}; expected equal bits")
    return err


def vf_raw(torch, vf, params, y, dev, kernel=None, lanes=None):
    """A launch of a vector filter kernel straight through its C entry point,
    into buffers made once (``launch.out``, the five streams); for
    ``raw_ms``.  ``kernel``: ``"vector_filter"`` (the first version, which
    takes every configuration of its five model pairs),
    ``"vector_filter_shaped"``, ``"vector_filter_shaped_bq"``,
    ``"vector_filter_slots"``,
    ``"vector_filter_general"`` (every configuration of the table's models)
    or ``"vector_filter_registered"`` (a registered model); by default the
    one the wrapper picks.  ``lanes``: the general and registered kernels'
    form (0 one thread a trajectory, ``vf._SHAPED`` the shaped one-thread
    form, ``vf._SLOTS`` the registered kernel's slot form, ``vf._LANES`` the
    lane-group form, ``vf._WARP`` the warp form), by default the wrapper's
    (``lanes_of``)."""
    lib = vf.build()
    B, _, T = y.shape
    kernel = kernel or vf.kernel_of(params)
    lanes = vf.lanes_of(params) if lanes is None else lanes
    out = vf._empty_streams(params.dim_state, T, B, dev)
    c = vf._c_struct(kernel, params, dev, lanes)
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (ctypes.byref(c), y.data_ptr(), *y.stride(), B, T, dev.index or 0,
            *(o.data_ptr() for o in out))
    if kernel == "vector_filter_registered":
        lib_r, pair = vf._registered(params, host=False, lanes=lanes)
        s, scratch = vf._streams_on(params, T, dev), vf._scratch(params, B, dev, lanes)
        outs = [o.data_ptr() for o in out]

        def launch():
            if lanes in (vf._SHAPED, vf._SLOTS):
                run = lib_r.vfr_shaped_launch if lanes == vf._SHAPED else lib_r.vfr_slots_launch
                return run(pair, ctypes.byref(c), y.data_ptr(), *y.stride(), s.data_ptr(),
                           params.n_s, B, T, dev.index or 0, *outs, stream)
            return lib_r.vfr_launch(pair, ctypes.byref(c), y.data_ptr(), *y.stride(),
                                    s.data_ptr(), params.n_s, B, T, dev.index or 0, *outs,
                                    scratch.data_ptr(), stream)
    elif kernel == "vector_filter_general" and lanes == vf._SHAPED:
        def launch():
            return lib.vgs_launch(*args, stream)
    elif kernel == "vector_filter_shaped":
        def launch():
            return lib.vfs_launch(*args, stream)
    elif kernel == "vector_filter_shaped_bq":
        def launch():
            return lib.vfs_bq_launch(*args, stream)
    elif kernel == "vector_filter_slots":
        def launch():
            return lib.vsl_launch(*args, stream)
    elif kernel == "vector_filter_general":
        scratch = vf._scratch(params, B, dev, lanes)

        def launch():
            return lib.vfg_launch(*args, scratch.data_ptr(), lanes, stream)
    else:
        scratch = vf._scratch(params, B, dev)

        def launch():
            return lib.vf_launch(*args, scratch.data_ptr(), stream)
    launch.out = out
    return launch


#: the vector filter kernels' entries of the ``kernels`` line, by name: the
#: general and registered kernels' one-thread forms, their lane-group forms
#: and their warp forms (``csrc/vector_filter_lanes.cuh``), their shaped
#: one-thread forms (``csrc/vector_filter_general_shaped.cuh``) and the
#: registered kernel's slot form (``csrc/vector_filter_general_slots.cuh``;
#: the general kernel's pairs in the slot design count on the slot kernel,
#: which launches them) apart
VF_KERNELS = ("vector_filter", "vector_filter_shaped", "vector_filter_shaped_bq",
              "vector_filter_slots", "vector_filter_general", "vector_filter_registered",
              "vector_filter_general_lanes",
              "vector_filter_registered_lanes", "vector_filter_general_warp",
              "vector_filter_registered_warp", "vector_filter_general_shaped",
              "vector_filter_registered_shaped", "vector_filter_registered_slots")


def vf_counts(vf):
    """The launches of each vector filter kernel since the counts were last
    set to 0."""
    return {"vector_filter": (vf.LAUNCHES - vf.SHAPED_LAUNCHES - vf.BQ_SHAPED_LAUNCHES
                              - vf.SLOT_LAUNCHES - vf.GENERAL_LAUNCHES
                              - vf.REGISTERED_LAUNCHES),
            "vector_filter_shaped": vf.SHAPED_LAUNCHES,
            "vector_filter_shaped_bq": vf.BQ_SHAPED_LAUNCHES,
            "vector_filter_slots": vf.SLOT_LAUNCHES,
            "vector_filter_general": (vf.GENERAL_LAUNCHES - vf.GENERAL_LANE_LAUNCHES
                                      - vf.GENERAL_WARP_LAUNCHES - vf.GENERAL_SHAPED_LAUNCHES),
            "vector_filter_registered": (vf.REGISTERED_LAUNCHES - vf.REGISTERED_LANE_LAUNCHES
                                         - vf.REGISTERED_WARP_LAUNCHES
                                         - vf.REGISTERED_SHAPED_LAUNCHES
                                         - vf.REGISTERED_SLOT_LAUNCHES),
            "vector_filter_general_lanes": vf.GENERAL_LANE_LAUNCHES,
            "vector_filter_registered_lanes": vf.REGISTERED_LANE_LAUNCHES,
            "vector_filter_general_warp": vf.GENERAL_WARP_LAUNCHES,
            "vector_filter_registered_warp": vf.REGISTERED_WARP_LAUNCHES,
            "vector_filter_general_shaped": vf.GENERAL_SHAPED_LAUNCHES,
            "vector_filter_registered_shaped": vf.REGISTERED_SHAPED_LAUNCHES,
            "vector_filter_registered_slots": vf.REGISTERED_SLOT_LAUNCHES}


def vf_source(name):
    """The source of the ``kernels`` line's entry ``name``: the lane-group
    and warp forms are instantiated in their kernel's source, and so are the
    registered kernel's shaped and slot forms."""
    base = name.removesuffix("_lanes").removesuffix("_warp")
    for form in ("registered_shaped", "registered_slots"):
        base = base.replace(form, "registered")
    return f"ssmtoybox_torch/csrc/{base}.cu"


def shaped_entry(kernel, p) -> str:
    """The mangled-name part of the instantiation of the shaped kernel
    ``kernel`` (``vector_filter_shaped``, ``vector_filter_shaped_bq`` or
    ``vector_filter_slots``) that runs ``p``: its template arguments, both
    point counts among them (the BQ shapes' mixed counts in a kernel of their
    own; the slot kernel's design, a type, left out; the general kernel's
    pairs in the slot kernel's instantiations on their model policy)."""
    from ssmtoybox_torch.ops import vector_filter as vf
    targs = [p.dim_state, p.dim_out, p.dyn_model, p.obs_model]
    if kernel == "vector_filter_slots" and not vf._instantiated(p):
        return (f"vector_filter_general_slots_kernelILi{p.dim_state}ELi{p.dim_out}ELi{p.dyn.n}E"
                "6VgsZooI" + "".join(f"Li{t}E" for t in targs) + "E")
    if kernel == "vector_filter_slots":
        return f"{kernel}_kernelI" + "".join(f"Li{t}E" for t in targs + [p.dyn.n])
    if kernel == "vector_filter_shaped":
        targs += [p.dyn.n, p.obs.n]
    elif p.dyn.n == p.obs.n:
        targs += [p.dyn.n, p.dyn.kind, p.obs.kind]
    else:
        kernel += "_mixed"
        targs += [p.dyn.n, p.obs.n, p.dyn.kind, p.obs.kind]
    return f"{kernel}_kernelI" + "".join(f"Li{t}E" for t in targs) + "E"


def vf_kernel(vf, params):
    """The entry of ``VF_KERNELS`` that the wrapper's launch for ``params``
    counts on."""
    return vf_form(vf, vf.kernel_of(params), vf.lanes_of(params))


def vf_form(vf, kernel, lanes):
    """The entry of ``VF_KERNELS`` of ``kernel``'s form on ``lanes`` lanes (0
    one thread a trajectory, ``vf._SHAPED`` the shaped one-thread form,
    ``vf._SLOTS`` the slot form, ``vf._LANES`` the lane-group form,
    ``vf._WARP`` the warp form)."""
    return kernel + {0: "", vf._SHAPED: "_shaped", vf._SLOTS: "_slots", vf._LANES: "_lanes",
                     vf._WARP: "_warp"}[lanes]


def vf_zero(vf):
    vf.LAUNCHES = vf.SHAPED_LAUNCHES = vf.BQ_SHAPED_LAUNCHES = vf.GENERAL_LAUNCHES = 0
    vf.SLOT_LAUNCHES = 0
    vf.REGISTERED_LAUNCHES = vf.GENERAL_LANE_LAUNCHES = vf.REGISTERED_LANE_LAUNCHES = 0
    vf.GENERAL_WARP_LAUNCHES = vf.REGISTERED_WARP_LAUNCHES = 0
    vf.GENERAL_SHAPED_LAUNCHES = vf.REGISTERED_SHAPED_LAUNCHES = vf.REGISTERED_SLOT_LAUNCHES = 0


def only(kernel, n=1):
    """The launch counts of ``vf_counts`` where ``kernel`` ran ``n`` times and
    no other vector filter kernel ran."""
    return {k: n * int(k == kernel) for k in VF_KERNELS}


#: phase 15's GPQ kernel parameters of the zoo's pairs and of the CV radar
#: system (length-scales of a well-conditioned Gram matrix on the unit points)
VF_GPQ_ZOO = {"pendulum": [[1.0, 2.0, 2.0]], "falling body": [[1.0, 3.0, 3.0, 3.0]],
              "CT + 4 bearings": [[1.0, 3.0, 3.0, 3.0, 3.0, 3.0]],
              "CV": [[1.0, 3.0, 3.0, 3.0, 3.0]]}


#: phase 15's Gauss-Hermite rules of the five pairs that the shaped kernel
#: (``VFS_GH``: 9 points on the pendulum, 8 on the falling body) and the slot
#: kernel (``VSL_SHAPES``: 16-81 points) take, on both transforms
VF_GH_RULES = {"pendulum": (3,), "falling body": (2, 3), "reentry": (2,), "CV": (2, 3),
               "CT + 4 bearings": (2,)}


def vf_rule_pairs(stt, np, systems):
    """Phase 15's filters and rule pairs.  ``systems``: name -> (dynamics,
    measurement) of the five model pairs with a kernel form.  Each system
    gets the UKF, the CKF, a BQ rule at N = 2 D + 1 (GPQ-UT; on reentry
    also BSQ-UT, the tracking study's, and GH-3; BSQ-UT on CV) and GPQ with
    spherical-radial points (N = 2 D), and the Gauss-Hermite rules of
    ``VF_GH_RULES``.  Returns ``{system: {rule: filter}}`` and the pairs
    ``(system, dynamics rule of, measurement rule of)``: every rule on both
    transforms, the mixed kinds of both counts and the UKF beside the CKF
    either way round, and a BQ rule beside a rule of the other count with
    the three pairs of kinds either way round (on CV every pair of its four
    rules, mixed counts too), so that every instantiation of the five pairs'
    sources runs."""
    def mul(d):
        return np.hstack((np.zeros((d, 1), int), np.eye(d, dtype=int), 2 * np.eye(d, dtype=int)))

    algs = {}
    for name, (dyn, obs) in systems.items():
        a = {"UKF": stt.UnscentedKalman(dyn, obs), "CKF": stt.CubatureKalman(dyn, obs)}
        if name == "reentry":
            gpq = (np.array(VF_GPQ_DYN), np.array(VF_GPQ_OBS))
            a["GH-3"] = stt.GaussHermiteKalman(dyn, obs, deg=3)
            a["GPQ-UT"] = stt.GaussianProcessKalman(dyn, obs, *gpq)
            a["BSQ-UT"] = stt.BayesSardKalman(dyn, obs, np.array(TRACK_PAR_DYN),
                                              np.array(TRACK_PAR_OBS), mul(5), mul(5))
        else:
            gpq = (np.array(VF_GPQ_ZOO[name]),) * 2
            if name == "CV":
                a["BSQ-UT"] = stt.BayesSardKalman(dyn, obs, np.array(VF_CV_BSQ),
                                                  np.array(VF_CV_BSQ), mul(4), mul(4))
            else:
                a["GPQ-UT"] = stt.GaussianProcessKalman(dyn, obs, *gpq)
        a["GPQ-SR"] = stt.GaussianProcessKalman(dyn, obs, *gpq, points="sr")
        algs[name] = a
    pairs = []
    for name, a in algs.items():
        if name == "CV":
            pairs += [(name, r, s) for r in a for s in a]
            continue
        bq_ut = "BSQ-UT" if "BSQ-UT" in a else "GPQ-UT"
        pairs += [(name, r, r) for r in a]
        pairs += [(name, "UKF", bq_ut), (name, bq_ut, "UKF"), (name, "CKF", "GPQ-SR"),
                  (name, "GPQ-SR", "CKF"), (name, "UKF", "CKF"), (name, "CKF", "UKF")]
        # a BQ rule beside the other count: both orders of the counts, three pairs of kinds
        # (GPQ-UT: reentry's GPQ-SR dynamics beside its BSQ-UT measurement loses every run,
        # in the plain version too)
        pairs += [(name, "GPQ-UT", "GPQ-SR"), (name, "UKF", "GPQ-SR"), (name, "GPQ-UT", "CKF"),
                  (name, "GPQ-SR", "GPQ-UT"), (name, "CKF", "GPQ-UT"), (name, "GPQ-SR", "UKF")]
    for name, degrees in VF_GH_RULES.items():
        dyn, obs = systems[name]
        for deg in degrees:
            algs[name][f"GH-{deg}"] = stt.GaussHermiteKalman(dyn, obs, deg=deg)
            pairs.append((name, f"GH-{deg}", f"GH-{deg}"))
    return algs, pairs


def vf_instantiation(kernel, params, lanes=0):
    """The template arguments of the instantiation of ``kernel`` that runs
    ``params``: (D, dynamics, kinds of both rules, the point counts of both;
    "any" for the first version; for the slot kernel D, E, both models, the
    point counts and its lanes); for the general kernel (D, the bound on E,
    0 for the wide form), in the shaped one-thread form (D, E, both models,
    both point counts), or in the lane-group or warp form on ``lanes`` lanes
    (D, the lanes)."""
    from ssmtoybox_torch.ops import vector_filter as vf
    counts = (params.dyn.n, params.obs.n)
    if kernel == "vector_filter_general":
        E = params.dim_out
        if lanes == vf._SHAPED:
            return (vf_form(vf, kernel, lanes), params.dim_state, E, params.dyn_model,
                    params.obs_model, counts)
        if lanes:
            return (vf_form(vf, kernel, lanes), params.dim_state, lanes)
        return (kernel, params.dim_state, 2 if E <= 2 else 4 if E <= 4 else 8 if E <= 8 else 0)
    if kernel == "vector_filter_slots":
        return (kernel, params.dim_state, params.dim_out, params.dyn_model, params.obs_model,
                counts, vf.slot_lanes(params))
    return (kernel, params.dim_state, params.dyn_model, params.dyn.kind, params.obs.kind,
            "any" if kernel == "vector_filter" else counts)


#: the step header's model ids, by macro name
VF_IDS = {**{f"VF_DYN_{k}": i for i, k in enumerate(("REENTRY", "CV", "PENDULUM", "REENTRY1D",
                                                    "CT"))},
          **{f"VF_OBS_{k}": i for i, k in enumerate(("RADAR", "PENDULUM_SIN", "RANGE", "BEARING",
                                                    "UNGM"))}}


def header_list(vf, header, macro, fields):
    """The entries ``F(D, E, DYN, OBS, ...)`` (``X(F, D, E, DYN, OBS)`` where
    ``fields`` is ``"X"``) of ``macro`` in ``header`` of ``csrc``: ``(D, E,
    dynamics id, measurement id, the first further integer fields)``, as many
    further fields as ``fields`` counts beyond 4 (``"X"``: none)."""
    src = open(os.path.join(vf._build.CSRC, header)).read()
    body = src.split(f"#define {macro}(")[1].split("\n\n")[0]
    head = r"X\(F, " if fields == "X" else r"F\("
    out = []
    for m in re.finditer(head + r"(\d), (\d), (\w+), (\w+)((?:, \w+)*)\)", body):
        rest = [int(v) for v in m.group(5).split(", ")[1:] if v.isdigit()]
        out.append((int(m.group(1)), int(m.group(2)), VF_IDS[m.group(3)], VF_IDS[m.group(4)],
                    *rest[:0 if fields == "X" else fields - 4]))
    return out


def vgs_pairs(vf):
    """The table's pairs of the general kernel's shaped form, ``(D, E,
    dynamics id, measurement id)`` of ``VGS_PAIRS`` in
    ``csrc/vector_filter_general_shaped.cuh``."""
    return header_list(vf, "vector_filter_general_shaped.cuh", "VGS_PAIRS", "X")


def vf_all_instantiations(vf):
    """Every instantiation of the eleven sources, as ``vf_instantiation``
    names them: the first version's 4 kinds of each model pair (20), the
    classical shaped kernel's 4 pairs of point counts (20: the UT or CKF
    count on both transforms, or the two mixed) and its Gauss-Hermite counts
    (2, ``VFS_GH``), the BQ shapes' 3 kinds x 4 pairs of counts (60: one
    count on both, or the two mixed), the slot kernel's shapes (5,
    ``VSL_SHAPES``; the general kernel's pairs, 16, ``VSL_GENERAL_LO`` and
    ``_HI``), the general kernel's state dimensions x bounds on E (16,
    the wide form's four among them), its lane-group form's state dimensions
    (4) and its shaped form's pairs x 4 pairs of point counts (48) and
    Gauss-Hermite counts (5, ``VGS_GH``)."""
    dims = {0: 5, 1: 4, 2: 2, 3: 3, 4: 5}

    def count_pairs(D):
        return [(a, b) for a in (2 * D + 1, 2 * D) for b in (2 * D + 1, 2 * D)]

    out = {("vector_filter_general", D, eb) for D in (2, 3, 4, 5) for eb in (2, 4, 8, 0)}
    out |= {("vector_filter_general_lanes", D, vf._LANES) for D in (2, 3, 4, 5)}
    out |= {("vector_filter_general_shaped", D, E, dyn, obs, counts)
            for D, E, dyn, obs in vgs_pairs(vf) for counts in count_pairs(D)}
    out |= {("vector_filter_general_shaped", D, E, dyn, obs, (nd, no)) for D, E, dyn, obs, nd, no
            in header_list(vf, "vector_filter_general_shaped.cuh", "VGS_GH", 6)}
    out |= {("vector_filter_shaped", D, dyn, 0, 0, (nd, no)) for D, _, dyn, _, nd, no
            in header_list(vf, "vector_filter_shaped.cuh", "VFS_GH", 6)}
    out |= {("vector_filter_slots", D, E, dyn, obs, (n, n), g) for macro in (
        "VSL_SHAPES", "VSL_GENERAL_LO", "VSL_GENERAL_HI") for D, E, dyn, obs, n, g
        in header_list(vf, "vector_filter_slots.cuh", macro, 6)}
    for dyn, D in dims.items():
        for kd in (0, 1):
            for ko in (0, 1):
                out.add(("vector_filter", D, dyn, kd, ko, "any"))
                if kd == ko == 0:
                    out |= {("vector_filter_shaped", D, dyn, 0, 0, c) for c in count_pairs(D)}
                else:
                    out |= {("vector_filter_shaped_bq", D, dyn, kd, ko, c)
                            for c in count_pairs(D)}
    return out


def ptxas_of(log_text, kernel_fn):
    """``(registers, stack frame bytes, spill store bytes)`` that ptxas
    reported for the entry function whose mangled name contains
    ``kernel_fn``; Nones if it is not in the log."""
    lines = log_text.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and kernel_fn in line:
            # its lines, up to the next entry function's
            near = []
            for nxt in lines[i + 1:i + 9]:
                if "Compiling entry function" in nxt:
                    break
                near.append(nxt)
            near = " ".join(near)
            regs = re.search(r"Used (\d+) registers", near)
            frame = re.search(r"(\d+) bytes stack frame", near)
            spill = re.search(r"(\d+) bytes spill stores", near)
            return tuple(int(m.group(1)) if m else None for m in (regs, frame, spill))
    return None, None, None


#: f64 opcodes of Hopper's SASS (the double-precision pipe and its MUFU seeds),
#: and the f64 warp instructions each SM issues a clock
SASS_F64 = ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "MUFU.RCP64H", "MUFU.RSQ64H")
SASS_F64_A_CLOCK = 2


_SASS = {}


def sass_listing(lib_path, kernel_fn):
    """``(address, opcode, branch target or None)`` of every instruction of
    the kernel whose mangled name contains ``kernel_fn``, from ``cuobjdump
    -sass`` of the library (run once a library); None where cuobjdump is
    missing."""
    from ssmtoybox_torch.ops import _build
    tool = os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    if lib_path not in _SASS:
        _SASS[lib_path] = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                                         text=True, timeout=300).stdout
    listing, inside = [], False
    for line in _SASS[lib_path].splitlines():
        if "Function :" in line:
            inside = kernel_fn in line
        elif inside:
            m = re.match(r"\s+/\*([0-9a-f]{4,6})\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_.]+)([^;]*);", line)
            if m:
                tgt = re.search(r"0x([0-9a-f]+)\s*$", m.group(3)) if "BRA" in m.group(2) else None
                listing.append((int(m.group(1), 16), m.group(2),
                                int(tgt.group(1), 16) if tgt else None))
    return listing


def sass_f64_a_step(listing, n_points):
    """The f64 instructions one filter step issues, from the SASS: those
    inside the widest backward branch (the step loop), each counted
    ``n_points`` times for every loop nested in the step loop that holds it
    (the point loops, and the first version's N x N quadratic form, nested
    twice); the slow paths of divide and square root, outside the step
    loop, are not counted."""
    loops = sorted(((tgt, addr) for addr, _, tgt in listing if tgt is not None and tgt < addr),
                   key=lambda r: r[0] - r[1])
    if not loops:
        return 0
    (lo, hi), inner = loops[0], loops[1:]
    count = 0
    for addr, op, _ in listing:
        if lo <= addr <= hi and op.startswith(SASS_F64):
            count += n_points ** sum(a <= addr <= b for a, b in inner)
    return count


def vector_slice(torch, np, dev, ukf_re, xs_re, ys_re, fused_re):
    """Phases 15-18: the four vector filter kernels against their plain
    version at every instantiation (the general kernel through
    ``vf_general_checks``), the reentry bench lane through the
    shaped kernel (``fused_re``, the main path's result) against the eager
    lane, the same data under BSQ-UT through the kernel of the BQ shapes,
    under GH-3 through the general kernel's warp form (against the eager
    lane too), under the UKF beside the CKF and GPQ-UT beside the CKF
    through the shaped kernels at mixed counts (the first lane against the
    eager lane; the second's first version by force, to the bit) and under
    GH-2 (32 points) through the first version (their paths), the reentry
    goldens through ``engine="dd"``, and the timings: the two mixed lanes in
    turns with the first version by force.  Returns the figures of the
    kernels for the ``kernels`` line, by name."""
    import ssmtoybox_torch as stt
    from ssmtoybox_torch.ops import _build, scalar_filter as sf, vector_filter as vf
    from ssmtoybox_torch.utils.metrics import rmse

    dyn_re, obs_re = ukf_re.mod_dyn, ukf_re.mod_obs
    dyn_cv, obs_cv = cv_radar_system(np, dev)
    zoo = zoo_systems(np, dev)
    systems = {"reentry": (dyn_re, obs_re), "CV": (dyn_cv, obs_cv),
               **{k: zoo[k] for k in ("pendulum", "falling body", "CT + 4 bearings")}}
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)
    ys_of = {"reentry": ys_re}
    for name, (dyn, obs) in systems.items():
        if name != "reentry":
            ys_of[name] = obs.simulate_measurements(
                gen, dyn.simulate_discrete(gen, steps=VF_STEPS, mc_sims=MC)).permute(2, 0, 1)
    algs, pairs = vf_rule_pairs(stt, np, systems)
    re = algs["reentry"]

    # ---- 15. the kernels vs their plain version, both on the card -----------
    err = dict.fromkeys(VF_KERNELS, 0.0)
    seen, params_of = set(), {}
    t15 = time.perf_counter()
    for system, a, b in pairs:
        params = vf.prepare(algs[system][a].mod_dyn, algs[system][a].mod_obs,
                            algs[system][a].tf_dyn, algs[system][b].tf_obs)
        params_of[system, a, b] = params
        kernel, form = vf.kernel_of(params), vf_kernel(vf, params)
        seen.add(vf_instantiation(kernel, params, vf.lanes_of(params)))
        if kernel != "vector_filter":
            seen.add(vf_instantiation("vector_filter", params))
        # the plain version once, on the whole batch: on the card its operations
        # are elementwise across trajectories, one code for every element, so a
        # batch's first b trajectories have the bits it gives for b alone (not
        # on the CPU, whose vectorised transcendentals differ from their scalar
        # tails)
        ref_all = vf._vector_filter_plain(params, ys_of[system][:, :, :VF_STEPS])
        for batch in VF_BATCHES:
            yy = ys_of[system][:batch, :, :VF_STEPS]
            ref = tuple(r[..., :batch] for r in ref_all)
            before = vf_counts(vf)
            got = vf.vector_filter(params, yy)
            first = None
            if kernel != "vector_filter":     # the first version on the same input, by force
                launch = vf_raw(torch, vf, params, yy, dev, "vector_filter")
                if launch() != 0:
                    fail(f"{system} {a}/{b}: the first version's launch failed")
                first = launch.out
            torch.cuda.synchronize()
            moved = {k: v - before[k] for k, v in vf_counts(vf).items()}
            if moved != only(form):
                fail(f"{system} {a}/{b}: the wrapper's launches {moved}; {form} was to run once")
            for k, out in ((form, got), ("vector_filter", first)):
                if out is None:
                    continue
                diff = max(float((g_ - r_).nan_to_num().abs().max()) for g_, r_ in zip(out, ref))
                err[k] = max(err[k], diff)
                lost = 1.0 - float(torch.isfinite(out[1]).flatten(0, 2).all(0).double().mean())
                if not (all(same_bits(torch, g_, r_) for g_, r_ in zip(out, ref))
                        and lost <= 0.01):
                    fail(f"{k} kernel vs plain, {system} {a}/{b}, B={batch}, N={VF_STEPS}: max "
                         f"|diff| {diff:.3e}, {lost:.2%} of the trajectories not finite; "
                         "expected equal bits (NaN where the plain version has NaN) and at most "
                         "1% not finite")
        again = vf.vector_filter(params, yy)
        torch.cuda.synchronize()
        if not all(same_bits(torch, g_, o_) for g_, o_ in zip(got, again)):
            fail(f"{form} kernel, {system} {a}/{b}: a second launch differs from the first")
    g_seen, g_err, g_cases = vf_general_checks(torch, np, dev, [
        (f"{system} {a}", params_of[system, a, a], ys_of[system][:, :, :VF_STEPS])
        for system, a in (("reentry", "UKF"), ("CV", "UKF"), ("pendulum", "UKF"),
                          ("falling body", "UKF"), ("CT + 4 bearings", "UKF"))])
    seen |= g_seen
    for k, v in g_err.items():
        err[k] = max(err[k], v)
    missing = vf_all_instantiations(vf) - seen
    if missing:
        fail(f"phase 15 ran no configuration of these instantiations: {sorted(missing, key=str)}")
    split = {k: sum(s[0] == k for s in seen) for k in VF_KERNELS}
    log(f"vector filter kernels == plain to the bit at {len(pairs)} rule pairs of 5 model pairs "
        f"and {g_cases} configurations of other pairs: every instantiation of the "
        f"{len(vf.SOURCES)} sources "
        f"({split}; the first version at every pair of its five, the general kernel at the five "
        f"by force, where other kernels take them), B = {VF_BATCHES}, N = {VF_STEPS}, all five "
        f"streams; two launches equal to the bit; {time.perf_counter() - t15:.1f} s")

    # ---- 16. the reentry bench lane: dd against f64 --------------------------
    before = vf_counts(vf)
    fused = ukf_re.forward_pass_batch(ys_re, engine="dd")
    torch.cuda.synchronize()
    moved = {k: v - before[k] for k, v in vf_counts(vf).items()}
    if moved != only("vector_filter_shaped"):
        fail(f"a reentry UKF filter call launched {moved}; expected the shaped kernel once")
    if not all(torch.equal(getattr(fused, f), getattr(fused_re, f))
               for f in ("fi_mean", "fi_cov", "pr_mean", "pr_cov", "pr_xx_cov")):
        fail("the reentry lane through the kernel differs from the main path's run of it")
    eager = ukf_re.forward_pass_batch(ys_re, engine="f64")
    M, D, N = xs_re.shape
    diffs = {f: float((getattr(fused, f) - getattr(eager, f)).abs().max())
             for f in ("fi_mean", "fi_cov", "pr_mean", "pr_cov", "pr_xx_cov")}
    log(f"reentry lane ({M}x{N}) dd vs eager f64, max |diff| (the tightest atol that holds): "
        + ", ".join(f"{f} {v:.3e}" for f, v in diffs.items())
        + f" (ceilings {VF_MEAN_ATOL} on means, {VF_COV_ATOL} on covariances)")
    for f, v in diffs.items():
        if not v <= (VF_MEAN_ATOL if f.endswith("mean") else VF_COV_ATOL):
            fail(f"reentry lane dd vs f64: {f} differs by {v:.3e}")
    x_t = xs_re.permute(1, 2, 0)
    scores = {}
    for tag, res in (("dd", fused), ("f64", eager)):
        sm, sP = stt.gaussian_smoother(res)
        if not (bool(torch.isfinite(sm).all()) and bool(torch.isfinite(sP).all())):
            fail(f"reentry lane: the smoother on the {tag} result is not finite")
        scores[tag] = (float(rmse(x_t, res.fi_mean.permute(1, 2, 0))),
                       float(rmse(x_t, sm.permute(1, 2, 0))))
    for i, what in enumerate(("filter", "smoother")):
        a, b = scores["dd"][i], scores["f64"][i]
        log(f"reentry lane {what} RMSE: dd {a:.9f}, f64 {b:.9f}, relative {abs(a - b) / b:.2e} "
            f"(limit 1e-6)")
        if not abs(a - b) / b <= 1e-6:
            fail(f"reentry lane {what} RMSE of dd and f64 differ by {abs(a - b) / b:.3e}")
    del eager

    # ---- 16b. the other kernels' paths: the bench lane under BSQ-UT, GH-3, ---------
    # ---- the UKF beside the CKF, GPQ-UT beside the CKF and GH-2; the pendulum -------
    # ---- under GH-4 -----------------------------------------------------------------
    launches, plain_ms = {}, {}
    p16 = {"UKF": params_of["reentry", "UKF", "UKF"]}
    lanes16 = {"BSQ-UT": (re["BSQ-UT"], "vector_filter_shaped_bq"),
               "GH-3": (re["GH-3"], "vector_filter_general_warp"),
               "UKF/CKF": (stt.GaussianInference(dyn_re, obs_re, re["UKF"].tf_dyn,
                                                 re["CKF"].tf_obs), "vector_filter_shaped"),
               "GPQ-UT/CKF": (stt.GaussianInference(dyn_re, obs_re, re["GPQ-UT"].tf_dyn,
                                                    re["CKF"].tf_obs), "vector_filter_shaped_bq"),
               "GH-2": (re["GH-2"], "vector_filter_slots"),
               "pendulum GH-4": (stt.GaussHermiteKalman(*systems["pendulum"], deg=4),
                                 "vector_filter")}
    # the first version's lane: the pendulum under GH-4 (16 points, a count that no
    # other kernel takes) on its own data, VF_GH4_STEPS steps
    x_pend = systems["pendulum"][0].simulate_discrete(gen, steps=VF_GH4_STEPS, mc_sims=MC)
    data16 = {rule: (xs_re, ys_re) for rule in lanes16}
    y_pend = systems["pendulum"][1].simulate_measurements(gen, x_pend)
    data16["pendulum GH-4"] = (x_pend.permute(2, 0, 1), y_pend.permute(2, 0, 1))
    for rule, (alg, kernel) in lanes16.items():
        x16, y16 = data16[rule]
        M16, _, N16 = y16.shape
        vf_zero(vf)
        res = alg.forward_pass_batch(y16, engine="dd")
        torch.cuda.synchronize()
        moved = vf_counts(vf)
        if moved != only(kernel):
            fail(f"the {rule} lane launched {moved}; expected {kernel} once")
        launches[kernel] = launches.get(kernel, 0) + 1
        p_rule = p16[rule] = vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
        plain_ms[rule], plain = event_ms(torch, lambda: vf._vector_filter_plain(p_rule, y16))
        err[kernel] = max(err[kernel], vf_against_plain(
            torch, res, plain, f"{rule} lane {M16}x{N16}"))
        if rule in ("GPQ-UT/CKF", "GH-2"):
            # the first version by force on the same input: it ran this lane until the
            # kernel of the BQ shapes took the two counts (the slot kernel GH-2)
            first = vf_raw(torch, vf, p_rule, y16, dev, "vector_filter")
            if first() != 0:
                fail(f"reentry {rule}: the first version's launch failed")
            torch.cuda.synchronize()
            for f, got, want in zip(("m_fi", "P_fi", "m_pr", "P_pr", "xx"), first.out, plain):
                diff = float((got - want).nan_to_num().abs().max())
                err["vector_filter"] = max(err["vector_filter"], diff)
                if not same_bits(torch, got, want):
                    fail(f"reentry {rule}: the first version by force differs from the plain "
                         f"version in {f}, max |diff| {diff:.3e}; expected equal bits")
            del first
        del plain
        sm, _ = stt.gaussian_smoother(res)
        x16_t = x16.permute(1, 2, 0)
        r_rule = (float(rmse(x16_t, res.fi_mean.permute(1, 2, 0))),
                  float(rmse(x16_t, sm.permute(1, 2, 0))))
        if not all(map(np.isfinite, r_rule)):
            fail(f"{rule} lane: RMSE {r_rule} not finite")
        against = ""
        if rule in ("GH-3", "UKF/CKF", "GH-2"):
            # the warp form's, the mixed counts' and the slot kernel's lanes against the eager
            # f64 lane, as phase 16 holds the UKF's
            (r_fi, lost), (e_fi, e_lost) = (finite_rmse(torch, x16, res.fi_mean), finite_rmse(
                torch, x16, alg.forward_pass_batch(y16, engine="f64").fi_mean))
            rel = abs(r_fi - e_fi) / e_fi
            against = (f"; over the finite runs, filter RMSE {r_fi:.9f} against the eager f64 "
                       f"lane's {e_fi:.9f}, relative {rel:.2e} (limit 1e-6), not finite "
                       f"{lost:.2%} (eager {e_lost:.2%}, limit 0)")
            if not (rel <= 1e-6 and lost == 0.0):
                fail(f"reentry {rule} lane: filter RMSE of dd and f64 differ by {rel:.3e} "
                     f"relative, or {lost:.2%} of the runs are not finite")
        forced = "; the first version by force too" if rule in ("GPQ-UT/CKF", "GH-2") else ""
        log(f"{rule} lane ({M16}x{N16}, N={p_rule.dyn.n}/{p_rule.obs.n}) through {kernel} "
            f"(1 launch): == plain version to the bit, all five streams (plain version "
            f"{plain_ms[rule]:.1f} ms, one call){forced}; RMSE filter {r_rule[0]:.9f}, smoother "
            f"{r_rule[1]:.9f}{against}")
        del res, sm

    # ---- 17. reentry goldens through engine="dd" on the card -----------------
    g = np.load(os.path.join(HERE, "tests", "goldens", "reentry.npz"))
    y_g = torch.as_tensor(np.moveaxis(g["y"], -1, 0), device=dev)
    for name, alg, kernel in (("ukf", ukf_re, "vector_filter_shaped"),
                              ("bsqkf", re["BSQ-UT"], "vector_filter_shaped_bq")):
        before = vf_counts(vf)
        res = alg.forward_pass_batch(y_g, engine="dd")
        for got, key in ((res.fi_mean[0], f"{name}_fm"), (res.fi_cov[0], f"{name}_fP")):
            if not np.allclose(got.cpu().numpy(), g[key], atol=1e-7, rtol=1e-6):
                fail(f"golden reentry {key} through engine='dd' off by "
                     f"{np.abs(got.cpu().numpy() - g[key]).max():.3e}")
        if vf_counts(vf)[kernel] != before[kernel] + 1:
            fail(f"golden reentry {name}: the {kernel} kernel did not run")
    log("reentry goldens through engine='dd' on the card: ukf (shaped kernel), bsqkf (BQ "
        "shapes) (1e-7/1e-6) ok")

    # ---- 18. the plain version on the main path's input; timings --------------
    params = params_of["reentry", "UKF", "UKF"]
    plain_ms["UKF"], plain = event_ms(
        torch, lambda: vf._vector_filter_plain(params, ys_re))
    torch.cuda.synchronize()
    err["vector_filter_shaped"] = max(err["vector_filter_shaped"], vf_against_plain(
        torch, fused_re, plain, f"reentry lane {M}x{N}"))
    del plain
    log(f"reentry lane {M}x{N}: the main path's kernel result == plain version to the bit, "
        "all five streams")
    lane = {e: cuda_ms(torch, lambda: ukf_re.forward_pass_batch(ys_re, engine=e), reps=3)
            for e in ("dd", "f64")}
    lat = sf.dependent_latencies(dev)
    mhz = float(clocks_line().split()[0])
    log("dependent-issue latency of the card in clocks (one warp): "
        + ", ".join(f"{op} {clocks:.1f}" for op, clocks in lat.items()))
    lib_path, build_log = vf.build()._name, _build.BUILD_LOGS.get("vector_filter", "")

    def code_of(kernel, p):
        """ptxas registers / local memory and the f64 issue floor from the SASS
        of ``kernel``'s instantiation for ``p``, as one line."""
        if kernel == "vector_filter":
            fn = "vector_filter_kernelI" + "".join(f"Li{t}E" for t in (
                p.dim_state, p.dim_out, p.dyn_model, p.obs_model, p.dyn.kind, p.obs.kind)) + "E"
        else:
            fn = shaped_entry(kernel, p)
        regs, frame, spill = ptxas_of(build_log, fn)
        listing = sass_listing(lib_path, fn)
        if not listing:
            return f"{regs} registers, {frame} bytes of local memory (stack frame); SASS not read"
        per_step = sass_f64_a_step(listing, p.dyn.n)
        floor_ms = per_step * M / 32 / (132 * SASS_F64_A_CLOCK) * N / (mhz * 1e3)
        return (f"{regs} registers, {frame} bytes of local memory (stack frame), {spill} bytes "
                f"spilled; SASS {len(listing)} instructions, {per_step} f64 a step, f64 issue "
                f"floor {floor_ms:.4f} ms")

    for name in re:
        p_n = params_of["reentry", name, name]
        kernel = vf.kernel_of(p_n)
        raw = raw_ms(torch, vf_raw(torch, vf, p_n, ys_re, dev))
        b_ms, b_by = vf_bound(p_n, N, M)
        floor = vf.chain_floor_clocks(lat, p_n)
        log(f"{kernel} reentry {name} ({p_n.dyn.n} points) {M}x{N}: raw launches "
            f"{raw:.4f} ms a launch (CUDA events around 20 behind torch.cuda._sleep), bound "
            f"{b_ms:.4f} ms ({b_by}), chain floor {floor:.0f} clocks a step = "
            f"{floor * N / (mhz * 1e3):.4f} ms at {mhz:.0f} MHz")
        if kernel != "vector_filter":
            # the first version on the same input, in turns with the shaped kernel
            first = [raw_ms(torch, vf_raw(torch, vf, p_n, ys_re, dev, "vector_filter"))]
            again = raw_ms(torch, vf_raw(torch, vf, p_n, ys_re, dev))
            first.append(raw_ms(torch, vf_raw(torch, vf, p_n, ys_re, dev, "vector_filter")))
            log(f"  the first-version kernel on the same input: raw launches "
                f"{first[0]:.4f} / {first[1]:.4f} ms ({kernel} again {again:.4f} ms; "
                f"first / {kernel} {min(first) / min(raw, again):.2f}x)")
        if kernel == "vector_filter_shaped_bq":
            log(f"  {kernel}: {code_of(kernel, p_n)}")
            log(f"  vector_filter: {code_of('vector_filter', p_n)}")
    log(f"vector_filter_shaped reentry UKF {M}x{N}: plain version "
        f"{plain_ms['UKF']:.1f} ms (one call); lane forward_pass_batch "
        f"engine='dd' {lane['dd'][0]:.3f} ms (min {lane['dd'][1]:.3f}), engine='f64' "
        f"{lane['f64'][0]:.1f} ms (min {lane['f64'][1]:.1f})")
    entries = {}
    # the UKF beside the CKF and GPQ-UT beside the CKF: the shaped kernels at mixed counts in
    # turns with the first version, which ran these lanes until the shaped kernels took two
    # counts
    for rule, kernel in (("UKF/CKF", "vector_filter_shaped"), ("GPQ-UT/CKF", "vector_filter_shaped_bq"),
                         ("GH-2", "vector_filter_slots")):
        p_mix = p16[rule]
        turns = {}
        for k in ("vector_filter", kernel, kernel, "vector_filter"):
            turns.setdefault(k, []).append(raw_ms(torch, vf_raw(torch, vf, p_mix, ys_re, dev, k)))
        b_ms, b_by = vf_bound(p_mix, N, M)
        fl = vf.chain_floor_clocks(lat, p_mix)
        log(f"reentry {rule} (N={p_mix.dyn.n}/{p_mix.obs.n}) {M}x{N}, raw launches in turns: "
            + ", ".join(f"{k} " + " / ".join(f"{t:.4f}" for t in v) + " ms"
                        for k, v in turns.items())
            + f"; bound {b_ms:.4f} ms ({b_by}), chain floor {fl:.0f} clocks a step = "
            f"{fl * N / (mhz * 1e3):.4f} ms at {mhz:.0f} MHz; {kernel}: {code_of(kernel, p_mix)}; "
            f"vector_filter: {code_of('vector_filter', p_mix)}")
    for kernel, rule in (("vector_filter_shaped", "UKF"), ("vector_filter_shaped_bq", "BSQ-UT"),
                         ("vector_filter_general_warp", "GH-3"), ("vector_filter_slots", "GH-2"),
                         ("vector_filter", "pendulum GH-4")):
        p_k, y_k = p16[rule], data16.get(rule, (xs_re, ys_re))[1]
        k_ms = cuda_ms(torch, lambda: vf.vector_filter(p_k, y_k))
        raw = raw_ms(torch, vf_raw(torch, vf, p_k, y_k, dev))
        b_ms, b_by = vf_bound(p_k, y_k.shape[-1], y_k.shape[0])
        log(f"{kernel} {rule} {y_k.shape[0]}x{y_k.shape[-1]}: wrapper call {k_ms[0]:.4f} ms (min "
            f"{k_ms[1]:.4f}), raw launches {raw:.4f} ms, plain version {plain_ms[rule]:.1f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")
        entries[kernel] = {"launches": launches.get(kernel, 0), "max_abs_err": err[kernel],
                           "ms": k_ms[0], "plain_ms": plain_ms[rule], "bound_ms": b_ms,
                           "bound_by": b_by, "library_ms": None}
    # the general kernel's phase-15 figures; phases 27 and 28 time it on their paths
    for kernel in ("vector_filter_general", "vector_filter_general_lanes",
                   "vector_filter_general_shaped"):
        entries[kernel] = {"launches": 0, "max_abs_err": err[kernel]}
    return entries


#: twelve bearing sensors: the zoo's four (``ZOO_SENSORS``), four more between
#: them and four beyond them
GEN_SENSORS = [[0.0, 0.0], [200.0, 0.0], [0.0, 200.0], [200.0, 200.0], [100.0, 0.0],
               [0.0, 100.0], [200.0, 100.0], [100.0, 200.0], [300.0, 0.0], [0.0, 300.0],
               [300.0, 300.0], [300.0, 100.0]]


def general_systems(np, dev):
    """(dynamics, measurement) of the model pairs that only the general vector
    filter kernel takes, by name: the zoo's and ``bench.py``'s transitions
    (``zoo_systems``, ``reentry_system``; constant velocity of the CV glint
    study) with the radar (noise diag(1, 1e-4), the CT radar of
    ``tests/test_torch_vector_filter.py:146-180``), the sine, the range, the
    UNGM measurement of state component 0, and bearings from 1-12 sensors
    (``GEN_SENSORS``; on the pendulum scaled to its angle and rate)."""
    from ssmtoybox_torch import ssmod
    from ssmtoybox_torch.utils import GaussRV
    zoo = zoo_systems(np, dev)
    dyns = {"pendulum": zoo["pendulum"][0], "falling body": zoo["falling body"][0],
            "CT": zoo["CT + 4 bearings"][0], "reentry": reentry_system(np, dev)[0],
            "CV": ssmod.ConstantVelocity(GaussRV(4, mean=M0_TRUE, cov=np.diag(P0), device=dev),
                                         GaussRV(2, cov=np.diag(Q), device=dev), dt=DT)}

    def pos(D):
        return [0, 2] if D >= 4 else [0, 1]

    def sensors(name):
        grid = np.array(GEN_SENSORS)
        return grid / 100.0 - 1.0 if name == "pendulum" else grid

    def obs(name, kind):
        D = dyns[name].dim_state
        if kind == "radar":
            return ssmod.Radar2DMeasurement(GaussRV(2, cov=np.diag([1.0, 1e-4]), device=dev),
                                            dim_state=D, state_index=pos(D),
                                            radar_loc=np.array([-5.0, -5.0]))
        if kind == "sine":
            return ssmod.Pendulum2DMeasurement(GaussRV(1, cov=0.1, device=dev), dim_state=D)
        if kind == "range":
            return ssmod.RangeMeasurement(GaussRV(1, cov=0.03, device=dev), dim_state=D)
        if kind == "UNGM":
            return ssmod.UNGMMeasurement(GaussRV(1, cov=1.0, device=dev), dim_state=D,
                                         state_index=[0])
        S = int(kind.split()[0])
        return ssmod.BearingMeasurement(GaussRV(S, cov=1e-3 * np.eye(S), device=dev),
                                        dim_state=D, state_index=pos(D),
                                        sensor_pos=sensors(name)[:S])

    pairs = [("pendulum", "radar"), ("pendulum", "UNGM"), ("pendulum", "3 bearings"),
             ("pendulum", "8 bearings"), ("falling body", "sine"), ("falling body", "4 bearings"),
             ("falling body", "6 bearings"), ("CV", "2 bearings"), ("CV", "3 bearings"),
             ("CV", "8 bearings"), ("CT", "radar"), ("CT", "2 bearings"), ("CT", "3 bearings"),
             ("CT", "5 bearings"), ("CT", "6 bearings"), ("CT", "7 bearings"), ("CT", "8 bearings"),
             ("reentry", "range"), ("reentry", "UNGM"),
             ("pendulum", "9 bearings"), ("falling body", "10 bearings"), ("CV", "12 bearings"),
             ("CT", "9 bearings")]
    return {f"{d} + {o}": (dyns[d], obs(d, o)) for d, o in pairs}


#: phase 15's rules on the pairs of the general kernel: (pair, dynamics rule,
#: measurement rule), every instantiation (D, bound on E, the wide form of
#: more than 8 outputs; each pair of the shaped form at both point counts,
#: mixed, and at its Gauss-Hermite count) and every pair of rule kinds
VF_GENERAL_CASES = [
    ("pendulum + radar", "UKF", "UKF"), ("pendulum + radar", "GPQ-UT", "GPQ-UT"),
    ("pendulum + UNGM", "CKF", "CKF"), ("pendulum + 3 bearings", "UKF", "UKF"),
    ("pendulum + 8 bearings", "CKF", "CKF"), ("falling body + sine", "UKF", "UKF"),
    ("falling body + sine", "GPQ-UT", "UKF"), ("falling body + 4 bearings", "CKF", "CKF"),
    ("falling body + 6 bearings", "UKF", "UKF"), ("CV + 2 bearings", "UKF", "UKF"),
    ("CV + 3 bearings", "CKF", "CKF"), ("CV + 8 bearings", "CKF", "CKF"),
    ("CT + radar", "UKF", "UKF"), ("CT + radar", "GH-3", "GH-3"),
    ("CT + 3 bearings", "CKF", "CKF"), ("CT + 8 bearings", "CKF", "CKF"),
    ("CT + 8 bearings", "UKF", "GPQ-UT"), ("reentry + range", "UKF", "UKF"),
    ("reentry + UNGM", "CKF", "CKF"), ("pendulum + 9 bearings", "UKF", "UKF"),
    ("falling body + 10 bearings", "CKF", "GPQ-UT"), ("CV + 12 bearings", "GPQ-UT", "GPQ-UT"),
    ("CT + 9 bearings", "CKF", "CKF"),
    ("pendulum + radar", "CKF", "CKF"), ("pendulum + UNGM", "UKF", "UKF"),
    ("pendulum + 3 bearings", "CKF", "CKF"), ("falling body + sine", "CKF", "CKF"),
    ("falling body + 4 bearings", "UKF", "UKF"), ("CV + 2 bearings", "CKF", "CKF"),
    ("CV + 3 bearings", "UKF", "UKF"), ("CT + radar", "CKF", "CKF"),
    ("CT + 2 bearings", "UKF", "UKF"), ("CT + 2 bearings", "CKF", "CKF"),
    ("CT + 3 bearings", "UKF", "UKF"), ("reentry + range", "CKF", "CKF"),
    ("reentry + UNGM", "UKF", "UKF"),
    # the Gauss-Hermite counts of the shaped form (VGS_GH): GH-3 on the 2-D pairs, GH-2 on
    # the 3-D ones
    ("pendulum + radar", "GH-3", "GH-3"), ("pendulum + UNGM", "GH-3", "GH-3"),
    ("pendulum + 3 bearings", "GH-3", "GH-3"), ("falling body + sine", "GH-2", "GH-2"),
    ("falling body + 4 bearings", "GH-2", "GH-2")] + [
    # the UKF beside the CKF, either way round, on every pair of the shaped form
    (name, a, b) for name in ("CT + radar", "CT + 2 bearings", "CT + 3 bearings",
                              "pendulum + radar", "pendulum + UNGM", "pendulum + 3 bearings",
                              "falling body + sine", "falling body + 4 bearings",
                              "CV + 2 bearings", "CV + 3 bearings", "reentry + range",
                              "reentry + UNGM")
    for a, b in (("UKF", "CKF"), ("CKF", "UKF"))] + [
    # the general pairs' Gauss-Hermite shapes of the slot kernel (VSL_GENERAL): GH-4 on the
    # 2-D pairs, GH-3 and GH-4 on the 3-D ones, GH-2 and GH-3 on the 4-D ones, GH-2 on the 5-D
    (name, rule, rule) for name, rules in (
        ("pendulum + radar", ("GH-4",)), ("pendulum + UNGM", ("GH-4",)),
        ("pendulum + 3 bearings", ("GH-4",)), ("falling body + sine", ("GH-3", "GH-4")),
        ("falling body + 4 bearings", ("GH-3", "GH-4")), ("CV + 2 bearings", ("GH-2", "GH-3")),
        ("CV + 3 bearings", ("GH-2", "GH-3")), ("CT + radar", ("GH-2",)),
        ("CT + 2 bearings", ("GH-2",)), ("CT + 3 bearings", ("GH-2",)),
        ("reentry + range", ("GH-2",)), ("reentry + UNGM", ("GH-2",)))
    for rule in rules]


def cv_radar_system(np, dev):
    """Constant velocity with the radar of the CV glint study's truth
    (``M0_TRUE``, ``P0``, ``Q``, ``R0``, ``SIDX``) on ``dev``: (dynamics,
    measurement)."""
    from ssmtoybox_torch.ssmod import ConstantVelocity, Radar2DMeasurement
    from ssmtoybox_torch.utils import GaussRV
    return (ConstantVelocity(GaussRV(4, mean=M0_TRUE, cov=np.diag(P0), device=dev),
                             GaussRV(2, cov=np.diag(Q), device=dev), dt=DT),
            Radar2DMeasurement(GaussRV(2, cov=np.diag(R0), device=dev), dim_state=4,
                               state_index=SIDX))


def vf_probe_systems(np, dev):
    """The reentry bench lane's system and three pairs of the five the first
    version instantiates, by name, as the warp form's probes of the point
    count under GH-3 (``tools/lane_variants.py``): the falling body with its
    range (27 points), constant velocity with the radar (``cv_radar_system``,
    81) and the coordinated turn with four bearings (243)."""
    zoo = zoo_systems(np, dev)
    return {"reentry + radar": reentry_system(np, dev),
            "falling body + range": zoo["falling body"], "CV + radar": cv_radar_system(np, dev),
            "CT + 4 bearings": zoo["CT + 4 bearings"]}


def general_filter(stt, np, dyn, obs, dyn_rule, obs_rule=None):
    """A Gaussian filter of ``dyn`` and ``obs`` with the named rules (UKF,
    CKF, GH-2, GH-3, GH-4 or GPQ-UT with the length-scales of ``VF_GPQ_ZOO``'s kind:
    3 on every input; GH-5 too); ``dyn_rule`` "A/B" with no ``obs_rule``: A on
    the dynamics, B on the measurement; one name alone: that rule on both."""
    if obs_rule is None:
        dyn_rule, obs_rule = (dyn_rule.split("/") * 2)[:2]
    D = dyn.dim_state
    par = np.array([[1.0] + [3.0] * D])

    def rule(name, model):
        alg = {"UKF": lambda: stt.UnscentedKalman(dyn, obs),
               "CKF": lambda: stt.CubatureKalman(dyn, obs),
               **{f"GH-{g}": (lambda g=g: stt.GaussHermiteKalman(dyn, obs, deg=g))
                  for g in (2, 3, 4, 5)},
               "GPQ-UT": lambda: stt.GaussianProcessKalman(dyn, obs, par, par)}[name]()
        return alg.tf_dyn if model == "dyn" else alg.tf_obs

    return stt.GaussianInference(dyn, obs, rule(dyn_rule, "dyn"), rule(obs_rule, "obs"))


def vf_general_checks(torch, np, dev, forced):
    """Phase 15, the general vector filter kernel: ``VF_GENERAL_CASES``
    simulated on the card from the seed (MC trajectories, ``VF_STEPS``
    steps), each through the wrapper (one launch of the general kernel in the
    form ``lanes_of`` names, or of the slot kernel where ``kernel_of`` names
    it, and no other) at B = ``VF_BATCHES`` against the
    plain version's run on all MC (its prefix), to the bit, NaN where it has
    NaN, at most 1% not finite; two launches equal to the bit; where that
    form is another than the general one-thread form, that form by force on
    the same MC trajectories, to the bit, and so the shaped one-thread form
    where it takes a shape routed elsewhere; then the general kernel by force, one
    thread a trajectory and in the warp form, on ``forced``, ``(name,
    params, y)`` of the pairs the other kernels take, at MC.  Returns the
    instantiations seen, the largest |diff| of each form (``VF_KERNELS``'
    names) and the count of configurations."""
    import ssmtoybox_torch as stt
    from ssmtoybox_torch.ops import vector_filter as vf

    systems = general_systems(np, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    seen, data = set(), {}
    err = dict.fromkeys(("vector_filter_general", "vector_filter_general_lanes",
                         "vector_filter_general_warp", "vector_filter_general_shaped",
                         "vector_filter_slots"), 0.0)
    for name, dyn_rule, obs_rule in VF_GENERAL_CASES:
        dyn, obs = systems[name]
        if name not in data:
            x = dyn.simulate_discrete(gen, steps=VF_STEPS, mc_sims=MC)
            data[name] = obs.simulate_measurements(gen, x).permute(2, 0, 1)
        alg = general_filter(stt, np, dyn, obs, dyn_rule, obs_rule)
        params = vf.prepare(dyn, obs, alg.tf_dyn, alg.tf_obs)
        what = f"{name} {dyn_rule}/{obs_rule}"
        slots = vf.kernel_of(params) == "vector_filter_slots"
        if vf.kernel_of(params) != "vector_filter_general" and not slots:
            fail(f"{what}: kernel_of names {vf.kernel_of(params)}, not the general kernel or "
                 "the slot kernel")
        lanes, kernel = vf.lanes_of(params), vf_kernel(vf, params)
        seen.add(vf_instantiation(vf.kernel_of(params), params, lanes))
        ref_all = vf._vector_filter_plain(params, data[name])
        for batch in VF_BATCHES:
            yy = data[name][:batch]
            before = vf_counts(vf)
            got = vf.vector_filter(params, yy)
            torch.cuda.synchronize()
            moved = {k: v - before[k] for k, v in vf_counts(vf).items()}
            if moved != only(kernel):
                fail(f"{what}: the wrapper's launches {moved}; {kernel} was to run once")
            ref = tuple(r[..., :batch] for r in ref_all)
            diff = max(float((g_ - r_).nan_to_num().abs().max()) for g_, r_ in zip(got, ref))
            err[kernel] = max(err[kernel], diff)
            lost = 1.0 - float(torch.isfinite(got[1]).flatten(0, 2).all(0).double().mean())
            if not (all(same_bits(torch, g_, r_) for g_, r_ in zip(got, ref)) and lost <= 0.01):
                fail(f"{kernel} kernel vs plain, {what}, B={batch}, N={VF_STEPS}: "
                     f"max |diff| {diff:.3e}, {lost:.2%} of the trajectories not finite; "
                     "expected equal bits and at most 1% not finite")
        again = vf.vector_filter(params, yy)
        torch.cuda.synchronize()
        if not all(same_bits(torch, g_, o_) for g_, o_ in zip(got, again)):
            fail(f"{kernel} kernel, {what}: a second launch differs from the first")
        for other in (g for g in (0, vf._SHAPED) if (slots or g != lanes) and (
                g == 0 or vf._shaped_takes(params))):
            launch = vf_raw(torch, vf, params, data[name], dev, "vector_filter_general", other)
            if launch() != 0:
                fail(f"{what}: the general kernel's launch by force on {other} lanes failed")
            torch.cuda.synchronize()
            diff = max(float((g_ - r_).nan_to_num().abs().max())
                       for g_, r_ in zip(launch.out, ref_all))
            form = vf_form(vf, "vector_filter_general", other)
            err[form] = max(err[form], diff)
            if not all(same_bits(torch, g_, r_) for g_, r_ in zip(launch.out, ref_all)):
                fail(f"{form} kernel by force on {other} lanes, {what} (B={MC}): max |diff| "
                     f"{diff:.3e}; expected equal bits")
            seen.add(vf_instantiation("vector_filter_general", params, other))
    for name, params, y in forced:
        ref = vf._vector_filter_plain(params, y)
        for lanes in (0, vf._WARP):
            launch = vf_raw(torch, vf, params, y, dev, "vector_filter_general", lanes)
            if launch() != 0:
                fail(f"{name}: the general kernel's launch by force on {lanes} lanes failed")
            torch.cuda.synchronize()
            diff = max(float((g_ - r_).nan_to_num().abs().max())
                       for g_, r_ in zip(launch.out, ref))
            form = vf_form(vf, "vector_filter_general", lanes)
            err[form] = max(err[form], diff)
            if not all(same_bits(torch, g_, r_) for g_, r_ in zip(launch.out, ref)):
                fail(f"{form} kernel by force on {name} (B={y.shape[0]}): max |diff| "
                     f"{diff:.3e}; expected equal bits")
            seen.add(vf_instantiation("vector_filter_general", params, lanes))
    return seen, err, len(VF_GENERAL_CASES) + len(forced)


#: the "zoo" phase: the rest of the model zoo on the card, at MC trajectories
ZOO_STEPS, ZOO_UNGM_STEPS = 100, 500
#: the fused lanes' comparison with the plain version: the first trajectories
ZOO_PLAIN_B = 200
#: the sensors of the CT + bearings configuration (tests/test_ddvec.py:280-289)
ZOO_SENSORS = [[0.0, 0.0], [200.0, 0.0], [0.0, 200.0], [200.0, 200.0]]


def zoo_systems(np, dev):
    """(dynamics, measurement) of the zoo phase's five systems: the pendulum,
    the falling body with its range and the coordinated turn with four
    bearings of ``tests/test_ddvec.py:262-289``; UNGM with non-additive noise
    and the constant turn-rate model with the radar of the goldens
    (``tests/test_parity.py:92-96``, ``:166-185``)."""
    from ssmtoybox_torch import ssmod
    from ssmtoybox_torch.utils import GaussRV
    dt = 0.01
    q_pend = 0.1 * np.array([[dt ** 3 / 3, dt ** 2 / 2], [dt ** 2 / 2, dt]])
    return {
        "pendulum": (ssmod.Pendulum2DTransition(
                         GaussRV(2, mean=[1.5, 0.0], cov=0.01 * np.eye(2), device=dev),
                         GaussRV(2, cov=q_pend, device=dev), dt=dt),
                     ssmod.Pendulum2DMeasurement(GaussRV(1, cov=0.1, device=dev), dim_state=2)),
        "falling body": (ssmod.ReentryVehicle1DTransition(
                             GaussRV(3, mean=[90.0, 6.0, 1.5], cov=0.09 * np.eye(3), device=dev),
                             GaussRV(3, cov=1e-8 * np.eye(3), device=dev), dt=0.1),
                         ssmod.RangeMeasurement(GaussRV(1, cov=0.03, device=dev), dim_state=3)),
        "CT + 4 bearings": (ssmod.CoordinatedTurnTransition(
                                GaussRV(5, mean=[100.0, 10.0, 100.0, 5.0, 0.06],
                                        cov=np.diag([10.0, 1.0, 10.0, 1.0, 1e-3]), device=dev),
                                GaussRV(5, cov=np.diag([0.1, 0.1, 0.1, 0.1, 1e-5]), device=dev),
                                dt=0.1),
                            ssmod.BearingMeasurement(GaussRV(4, cov=1e-3 * np.eye(4), device=dev),
                                                     dim_state=5, state_index=[0, 2],
                                                     sensor_pos=ZOO_SENSORS)),
        "UNGM-NA": (ssmod.UNGMNATransition(GaussRV(1, mean=1.0, cov=1.0, device=dev),
                                           GaussRV(1, cov=10.0, device=dev)),
                    ssmod.UNGMNAMeasurement(GaussRV(1, cov=0.01, device=dev), dim_state=1)),
        "CTRS + radar": (ssmod.ConstantTurnRateSpeed(
                             GaussRV(5, mean=[10.0, 0.0, 5.0, 0.5, 0.1], cov=0.1 * np.eye(5),
                                     device=dev),
                             GaussRV(2, cov=np.diag([0.1, 0.1 * np.pi]), device=dev), dt=0.05,
                             compat_heading=True),
                         ssmod.Radar2DMeasurement(GaussRV(2, cov=np.diag([0.3, 0.03]), device=dev),
                                                  dim_state=5, state_index=[0, 1])),
    }


def zoo_slice(torch, np, dev):
    """Phase 19, "zoo": the rest of the model zoo at MC trajectories simulated
    on the card from the seed.  Fused lanes (``engine="dd"``): the pendulum
    under UKF (the shaped kernel) and GPQKF (RBF ``[[1, 2, 2]]``,
    spherical-radial points: the kernel of the BQ shapes), the falling body
    under UKF and the CT + 4 bearings system under CKF (both the shaped
    kernel).  Each launches the kernel ``kernel_of`` names, once; every
    stream of its first
    ``ZOO_PLAIN_B`` trajectories equals the plain version's to the bit; its
    filter RMSE is the eager f64 lane's within 1e-6 relative; at most 1% of
    its runs are not finite; filter and smoother RMSE are printed, and raw
    launches of its instantiation beside ``vf_bound`` and the chain floor.
    Eager lanes (``engine="auto"``, non-additive noise, so no kernel):
    UKF on UNGM-NA (500 steps) and on CTRS + radar, launching no kernel,
    timed with CUDA events, filter and smoother RMSE printed.  Returns the
    launches of each vector filter kernel on this path (the counts set to 0
    before it) and the largest |diff| of each against its plain version."""
    import ssmtoybox_torch as stt
    from ssmtoybox_torch.ops import scalar_filter as sf, vector_filter as vf
    from ssmtoybox_torch.utils.metrics import rmse

    systems = zoo_systems(np, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    data = {}
    for name, (dyn, obs) in systems.items():
        steps = ZOO_UNGM_STEPS if name == "UNGM-NA" else ZOO_STEPS
        x = dyn.simulate_discrete(gen, steps=steps, mc_sims=MC)
        data[name] = (x.permute(2, 0, 1), obs.simulate_measurements(gen, x).permute(2, 0, 1))
    pend = systems["pendulum"]
    gpq_par = np.array([[1.0, 2.0, 2.0]])
    fused = [("pendulum", "UKF", stt.UnscentedKalman(*pend)),
             ("pendulum", "GPQKF", stt.GaussianProcessKalman(*pend, gpq_par, gpq_par, points="sr")),
             ("falling body", "UKF", stt.UnscentedKalman(*systems["falling body"])),
             ("CT + 4 bearings", "CKF", stt.CubatureKalman(*systems["CT + 4 bearings"]))]
    eager = [("UNGM-NA", "UKF", stt.UnscentedKalman(*systems["UNGM-NA"])),
             ("CTRS + radar", "UKF", stt.UnscentedKalman(*systems["CTRS + radar"]))]
    torch.cuda.synchronize()

    def scores(x_true, res):
        sm, _ = stt.gaussian_smoother(res)
        x_t = x_true.permute(1, 2, 0)
        ok = torch.isfinite(res.fi_mean).flatten(1).all(1)
        return (float(rmse(x_t, res.fi_mean.permute(1, 2, 0))),
                float(rmse(x_t, sm.permute(1, 2, 0))), 1.0 - float(ok.double().mean()))

    # ---- the path: every lane once, the counts from 0 -------------------------
    vf_zero(vf)
    sf_before = sf.LAUNCHES
    results = {}
    for system, rule, alg in fused:
        before = vf_counts(vf)
        results[system, rule] = alg.forward_pass_batch(data[system][1], engine="dd")
        params = vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
        moved = {k: v - before[k] for k, v in vf_counts(vf).items()}
        if moved != {k: int(k == vf.kernel_of(params)) for k in VF_KERNELS}:
            fail(f"zoo {system} {rule}: vector filter launches {moved}; expected one of "
                 f"{vf.kernel_of(params)}")
    launches = vf_counts(vf)
    eager_ms = {}
    for system, rule, alg in eager:
        before = (sf.LAUNCHES, vf.LAUNCHES)
        eager_ms[system], results[system, rule] = event_ms(
            torch, lambda: alg.forward_pass_batch(data[system][1], engine="auto"))
        if (sf.LAUNCHES, vf.LAUNCHES) != before:
            fail(f"zoo {system} {rule} (non-additive, engine='auto'): a kernel was launched")
    torch.cuda.synchronize()
    if sf.LAUNCHES != sf_before:
        fail("the zoo phase launched the scalar filter kernel")
    log(f"zoo path ({MC} trajectories): vector filter launches {launches}; the non-additive "
        "lanes launched none")

    # ---- the fused lanes: plain version, eager lane, scores, times ------------
    err = dict.fromkeys(VF_KERNELS, 0.0)
    lat, mhz = sf.dependent_latencies(dev), float(clocks_line().split()[0])
    for system, rule, alg in fused:
        x_true, ys = data[system]
        res = results[system, rule]
        params = vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
        kernel = vf.kernel_of(params)
        plain = vf._vector_filter_plain(params, ys[:ZOO_PLAIN_B])
        head = stt.FilterResult(*(getattr(res, f)[:ZOO_PLAIN_B] for f in
                                  ("fi_mean", "fi_cov", "pr_mean", "pr_cov", "pr_xx_cov")))
        err[kernel] = max(err[kernel], vf_against_plain(
            torch, head, plain, f"zoo {system} {rule}, first {ZOO_PLAIN_B} trajectories"))
        del plain, head
        ref = alg.forward_pass_batch(ys, engine="f64")
        (r_fi, r_sm, lost), (e_fi, e_sm, e_lost) = scores(x_true, res), scores(x_true, ref)
        rel = abs(r_fi - e_fi) / e_fi
        log(f"zoo {system} {rule} ({MC}x{ys.shape[-1]}, {kernel}): == plain version to the bit "
            f"on {ZOO_PLAIN_B} trajectories, all five streams; RMSE filter {r_fi:.9f}, smoother "
            f"{r_sm:.9f} (eager f64: {e_fi:.9f}, {e_sm:.9f}; filter relative {rel:.2e}, limit "
            f"1e-6); not finite {lost:.2%} (eager {e_lost:.2%}, limit 1%)")
        if not (rel <= 1e-6 and lost <= 0.01):
            fail(f"zoo {system} {rule}: filter RMSE of dd and f64 differ by {rel:.3e} relative, "
                 f"or {lost:.2%} of the runs are not finite")
        del ref
        raw = raw_ms(torch, vf_raw(torch, vf, params, ys, dev))
        b_ms, b_by = vf_bound(params, ys.shape[-1], MC)
        floor = vf.chain_floor_clocks(lat, params)
        log(f"  {kernel} <D={params.dim_state}, E={params.dim_out}, N={params.dyn.n}> raw "
            f"launches {raw:.4f} ms a launch (CUDA events around 20 behind torch.cuda._sleep), "
            f"bound {b_ms:.4f} ms ({b_by}), chain floor {floor:.0f} clocks a step = "
            f"{floor * ys.shape[-1] / (mhz * 1e3):.4f} ms at {mhz:.0f} MHz")

    # ---- the eager lanes ---------------------------------------------------------
    for system, rule, alg in eager:
        x_true, ys = data[system]
        r_fi, r_sm, lost = scores(x_true, results[system, rule])
        log(f"zoo {system} {rule} ({MC}x{ys.shape[-1]}, engine='auto' -> eager f64, no kernel): "
            f"{eager_ms[system]:.1f} ms (CUDA events, one call); RMSE filter {r_fi:.6f}, "
            f"smoother {r_sm:.6f}; not finite {lost:.2%}")
    return launches, err


#: phase 27: the trajectories each lane holds against its plain version (all
#: of them on the lane the ``kernels`` line times, and on the UNGM lanes
#: around the slot design's ceiling), the steps of the measurement-kind
#: checks of the scalar kernel's general form, and those of the UNGM lane
#: above ``MAX_SLOTS`` points (GH-33, one thread a trajectory: a depth cut
#: from 500 to hold the phase's time)
DD_PLAIN_B, DD_SHAPE_STEPS, DD_WIDE_STEPS = 200, 40, 100
#: the rules of the scalar lanes held to the plain version on every trajectory
#: and at B = 1, 7 and 4,097 through the wrapper (phases 27 and 28): the first
#: past 16 points, in the slot design since it reaches 32, and one past 32
SF_CEILING_RULES = ("GH-17", "GH-33")


def sf_held_at_batches(torch, sf, params, y_tm, c, plain, what) -> float:
    """Wrapper launches of the scalar filter kernel for ``params`` on the
    first 1, 7 and 4,097 trajectories of ``y_tm`` (time-major, steps x B),
    each stream equal to the plain version's ``plain`` (on all B) to the bit;
    fails otherwise, returns the largest |diff|."""
    err = 0.0
    for batch in (1, 7, 4097):
        got = sf.scalar_filter(params, y_tm[:, :batch].contiguous(), c)
        torch.cuda.synchronize()
        ref = tuple(t[:, :batch] for t in plain)
        diff = max(float((a - b).nan_to_num().abs().max()) for a, b in zip(got, ref))
        err = max(err, diff)
        if not all(same_bits(torch, a, b) for a, b in zip(got, ref)):
            fail(f"{what}, B={batch}: the kernel's streams differ from the plain version's, "
                 f"max |diff| {diff:.3e}; expected equal bits")
    return err


def sf_raw(torch, sf, params, y, c, dev):
    """A launch of the scalar filter kernel's general form (or its
    registered form, for a registered model) straight through its C entry
    point, into buffers made once (``launch.out``); for ``raw_ms``."""
    N, B = y.shape
    out = torch.empty((5, N, B), dtype=torch.float64, device=dev)
    scratch = sf._scratch(params, B, dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs = [out[i].data_ptr() for i in range(5)]
    vecs = ctypes.byref(sf._c_slot_rules(params))
    if sf.form_of(params) == "registered":
        lib, pair = sf._registered(params, host=False)
        cr = sf._c_registered_params(params, dev)

        def launch():
            return lib.sfr_launch(pair, ctypes.byref(cr), vecs, y.data_ptr(), y.stride(0),
                                  y.stride(1), c.data_ptr(), params.n_s, B, N, dev.index or 0,
                                  *outs, scratch.data_ptr(), stream)
    else:
        lib, cg = sf.build(), sf._c_general_params(params, dev)

        def launch():
            return lib.sfg_launch(ctypes.byref(cg), vecs, y.data_ptr(), y.stride(0), y.stride(1),
                                  c.data_ptr(), B, N, dev.index or 0, *outs, scratch.data_ptr(),
                                  stream)
    launch.out = out
    return launch


def sf_entry(sf, params, pair=None) -> str:
    """A part of the mangled name of the scalar filter kernel's instantiation
    that runs ``params`` (``sf.geometry``), for ``ptxas_of``: the shaped
    form's, the slot design's on the kernel's own models or on a registered
    library's configuration ``pair`` (its index there; by default the one
    the package built), or the one-thread design's."""
    design, n, _ = sf.geometry(params)
    kinds = f"ILi{params.dyn.kind}ELi{params.obs.kind}ELi{n}E"
    if design == "shaped":
        return f"scalar_filter_kernel{kinds}"
    if sf.form_of(params) == "registered":
        name = f"SfrPair{sf._registered(params, False)[1] if pair is None else pair}"
        return (f"scalar_filter_slots_kernel{kinds}{len(name)}{name}" if n else
                f"scalar_filter_registered_kernelI{len(name)}{name}E")
    return f"scalar_filter_slots_kernel{kinds}6SfgZoo" if n else "scalar_filter_general_kernel"


def form_ptxas(vf, params, kernel, lanes, logs):
    """``(registers, stack frame, spill stores, entry)`` that ptxas reported
    for the instantiation of the general (``logs``: the vector filter
    library's compiler output) or registered kernel (the registered
    library's) that runs ``params`` in the form of ``lanes`` (the shaped
    one-thread, slot, lane-group or warp form; 0 the general one-thread form;
    ``"slots"`` the slot kernel, which runs the general kernel's
    Gauss-Hermite shapes of 16-81 points)."""
    D, E = params.dim_state, params.dim_out
    if lanes == "slots":
        fn = shaped_entry("vector_filter_slots", params)
    elif kernel == "vector_filter_registered":
        policy = f"VfrPair{vf._registered(params, False, lanes)[1]}"
        # the policy is the slot form's fourth template argument, the design's type after it
        fn = f"{len(policy)}{policy}9VslDesign" if lanes == vf._SLOTS else f"{policy}E"
    elif lanes == vf._SHAPED:
        fn = (f"vector_filter_general_shaped_kernelILi{D}ELi{E}ELi{params.dyn.n}ELi"
              f"{params.obs.n}ELi0ELi0E6VgsZooILi{D}ELi{E}ELi{params.dyn_model}ELi"
              f"{params.obs_model}E")
    elif lanes:
        fn = f"vector_filter_lanes_kernelILi{D}ELi{lanes}E"
    else:
        fn = f"vector_filter_general_kernelILi{D}ELi{vf._bound_of(E)}E"
    return (*ptxas_of(logs, fn), fn)


#: raw launches a turn in ``lane_turns`` (the one-thread form takes up to
#: 0.11 s a launch)
LANE_TURN_REPS = 5


def lane_turns(torch, vf, params, ys, dev, kernel, logs, plain, what):
    """The general or registered kernel's forms on one lane ``ys``: the
    route (the shaped one-thread, slot, lane-group or warp form; the slot
    kernel, ``"slots"``, for the general kernel's Gauss-Hermite shapes that
    it takes), the general one-thread form and, where the shaped form takes
    a shape of 3 or 4 outputs, the lane-group form, each launched by force, its streams on
    the first trajectories equal to ``plain`` (the plain version's) to the
    bit, then raw launches in turns (the forms, then the same in reverse),
    each with its ptxas counts and, for the lane-group and warp forms, the
    warps an SM holds (``vf._form_fit``) beside the warps the lane gives an
    SM at all.  Logs one line a form and returns the route's raw times."""
    route = "slots" if vf.kernel_of(params) == "vector_filter_slots" else vf.lanes_of(params)
    order = (route, 0) + tuple(g for g in (vf._SHAPED, vf._LANES) if g != route and (
        3 <= params.dim_out <= 4 and vf._shaped_takes(params)))
    runs = {g: vf_raw(torch, vf, params, ys, dev, *(() if g == "slots" else (kernel, g)))
            for g in order}
    head = plain[0].shape[-1]
    for g, run in runs.items():
        if run() != 0:
            fail(f"{what}: the launch on {g} lanes failed")
        torch.cuda.synchronize()
        got = tuple(o[..., :head] for o in run.out)
        if not all(same_bits(torch, a, b) for a, b in zip(got, plain)):
            diff = max(float((a - b).nan_to_num().abs().max()) for a, b in zip(got, plain))
            fail(f"{what} on {g} lanes: the streams differ from the plain version's on {head} "
                 f"trajectories, max |diff| {diff:.3e}; expected equal bits")
    turns = {}
    for g in order + order[::-1]:
        turns.setdefault(g, []).append(raw_ms(torch, runs[g], reps=LANE_TURN_REPS))
    for g, ms in turns.items():
        regs, frame, spill, fn = form_ptxas(vf, params, kernel, g, logs)
        form, occupancy = {0: "general one-thread form", vf._SHAPED: "shaped one-thread form",
                           vf._WARP: "warp form", "slots": "slot kernel",
                           vf._SLOTS: f"slot form on {vf.slot_lanes(params)} lanes"}.get(
                               g, f"lane-group form on {g} lanes"), ""
        if g in (vf._LANES, vf._WARP):
            _, _, size, warps = vf._form_fit(params, g)
            occupancy = (f"; {warps} warps an SM resident, {ys.shape[0] * g / 32 / 132:.1f} "
                         f"warps an SM in the lane; {size * 8} bytes of shared memory a "
                         "trajectory")
        log(f"  {what}: {form}{' (routed)' if g == route else ''}: raw launches "
            + " / ".join(f"{t:.4f}" for t in ms)
            + f" ms in turns; == plain to the bit on {head} trajectories; {regs} registers, "
            f"{frame} bytes stack frame, {spill} bytes spilled ({fn}){occupancy}")
    return turns[route]


def finite_rmse(torch, x_true, m):
    """RMSE over the runs whose filtered means are all finite, and the share
    of runs that are not; ``x_true`` and ``m`` (M, D, N)."""
    ok = torch.isfinite(m).flatten(1).all(1)
    return float(((m[ok] - x_true[ok]) ** 2).mean().sqrt()), 1.0 - float(ok.double().mean())


def dd_pairs_slice(torch, np, dev, ungm, built, bench=None):
    """Phase 27, "dd pairs": the configurations that only the general forms
    take, at full width on the card.  The vector lanes (the general vector
    filter kernel): CT + radar under UKF and CKF, CT with 2, 3, 5 and 8
    bearings under CKF and with 8 under GH-3, CT + radar under the UKF
    beside the CKF, and the pendulum with the radar under GH-3
    (``general_systems``), 10,000 trajectories x 100 steps simulated from
    the seed; the UKF and CKF lanes of up to 3 bearings, and the UKF beside
    the CKF, and the pendulum's GH-3 (9 points), run in its shaped one-thread
    form (``lanes_of``), the CKF lanes of more than 4 bearings in its
    lane-group form, the CT GH-3 lane in its warp form; the pendulum's GH-4
    (16 points, ``DD_GH4_STEPS`` steps) in the slot kernel (``VSL_GENERAL``),
    its GH-5 (25 points, no slot shape; the same data) in the general
    one-thread form.  The UNGM lanes (the scalar filter kernel's general
    form): GH-9, GH-15, GPQ on GH-15 points (``UNGM_GPQ_PAR``) and GH-17 (20
    slots) in its slot design on phase 4's data, 10,000 x 500, and GH-33
    one thread a trajectory on its first ``DD_WIDE_STEPS`` steps.  Each lane
    once through ``engine="dd"`` with the counts set to 0 (one launch of the
    general kernel or form, none of another); every stream of its first
    ``DD_PLAIN_B`` trajectories (all of them on CT + radar UKF and on the
    UNGM GH-17 and GH-33 lanes, which wrapper launches at B = 1, 7 and 4,097
    also match) equal to its plain version's to the bit; filter
    RMSE against the eager f64 lane within 1e-6 relative (vector) or 1e-3
    (UNGM), at most 1% of the runs not finite; filter and smoother RMSE; raw
    launches behind ``_sleep``, the wrapper's and the plain version's time,
    the bound (``vf_bound`` / ``sf_bound``) and, for the vector lanes, the
    chain floor; on every lane that leaves the general one-thread form (the
    GH-4 lane's slot kernel too), its route and that form (and at 3 bearings
    the lane-group form and the shaped form) to the bit and in turns
    (``lane_turns``).  Then the general form's range
    and sine measurements of the UNGM state against the plain version to the
    bit at B = 1, 7, 4,097 and 10,000, in the slot design.  ``built``: the
    libraries' build times.  ``bench``: ``(dynamics, measurement, ys)`` of the reentry bench
    lane: its UKF, on which the general kernel by force, the first version by
    force and the shaped kernel are timed in turns (raw launches).  Returns the entries of ``vector_filter_general`` and
    its lane-group, warp and shaped forms and of the slot kernel (its GH-4
    lane) for the ``kernels`` line, the scalar
    general form's launches and its largest |diff| against the plain
    version, the ``kernels`` entry of the scalar slot design (its launches
    on the path, the GH-9 lane's times and bound) and that of the general
    form's one-thread design (the GH-33 lane's)."""
    import ssmtoybox_torch as stt
    from ssmtoybox_torch.ops import _build, scalar_filter as sf, vector_filter as vf
    from ssmtoybox_torch.ssmod import Pendulum2DMeasurement, RangeMeasurement
    from ssmtoybox_torch.utils import GaussRV

    t27 = time.perf_counter()
    dyn_u, obs_u, xs_u, ys_u = ungm
    systems = general_systems(np, dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 27)
    data = {}
    gh4 = f"pendulum + radar, {DD_GH4_STEPS} steps"
    vec_lanes = [("CT + radar", "UKF"), ("CT + radar", "CKF"), ("CT + 2 bearings", "CKF"),
                 ("CT + 3 bearings", "CKF"), ("CT + 5 bearings", "CKF"), ("CT + 8 bearings", "CKF"),
                 ("CT + 8 bearings", "GH-3"), ("CT + radar", "UKF/CKF"),
                 ("pendulum + radar", "GH-3"), (gh4, "GH-4"), (gh4, "GH-5")]
    systems[gh4] = systems["pendulum + radar"]
    for name in dict.fromkeys(n for n, _ in vec_lanes if n != gh4):
        dyn, obs = systems[name]
        x = dyn.simulate_discrete(gen, steps=ZOO_STEPS, mc_sims=MC)
        data[name] = (x.permute(2, 0, 1), obs.simulate_measurements(gen, x).permute(2, 0, 1))
    data[gh4] = tuple(t[..., :DD_GH4_STEPS] for t in data["pendulum + radar"])
    algs = {(n, r): general_filter(stt, np, *systems[n], r) for n, r in vec_lanes}
    par = np.array(UNGM_GPQ_PAR)
    wide = f"UNGM, {DD_WIDE_STEPS} steps"
    for rule, alg in (("GH-9", stt.GaussHermiteKalman(dyn_u, obs_u, deg=9)),
                      ("GH-15", stt.GaussHermiteKalman(dyn_u, obs_u, deg=15)),
                      ("GPQ-GH15", stt.GaussianProcessKalman(dyn_u, obs_u, par, par, points="gh",
                                                             point_hyp={"degree": 15})),
                      ("GH-17", stt.GaussHermiteKalman(dyn_u, obs_u, deg=17))):
        algs["UNGM", rule] = alg
    algs[wide, "GH-33"] = stt.GaussHermiteKalman(dyn_u, obs_u, deg=33)
    data["UNGM"] = (xs_u, ys_u)
    data[wide] = (xs_u[..., :DD_WIDE_STEPS], ys_u[..., :DD_WIDE_STEPS])
    torch.cuda.synchronize()

    # ---- the path: every lane once, the counts from 0 -------------------------
    want = dict.fromkeys(VF_KERNELS, 0)
    for lane in vec_lanes:
        a = algs[lane]
        want[vf_kernel(vf, vf.prepare(a.mod_dyn, a.mod_obs, a.tf_dyn, a.tf_obs))] += 1
    sf.LAUNCHES = sf.GENERAL_LAUNCHES = sf.SLOT_LAUNCHES = 0
    vf_zero(vf)
    results = {}
    for (name, rule), alg in algs.items():
        results[name, rule] = alg.forward_pass_batch(data[name][1], engine="dd")
    torch.cuda.synchronize()
    vf_launches = vf_counts(vf)
    sf_launches = (sf.LAUNCHES, sf.GENERAL_LAUNCHES, sf.SLOT_LAUNCHES)
    if (vf_launches != want or sf_launches != (5, 5, 4)
            or not all(vf_launches[k] for k in ("vector_filter_general",
                                                "vector_filter_general_lanes",
                                                "vector_filter_general_warp",
                                                "vector_filter_general_shaped",
                                                "vector_filter_slots"))):
        fail(f"dd pairs path: vector filter launches {vf_launches}, scalar filter launches "
             f"(all, general form, slot design) {sf_launches}; expected {want}, the four "
             "forms of the general kernel and the slot kernel, and 5 of the scalar general "
             "form, 4 in its slot design, nothing else")
    log(f"dd pairs path: vector filter launches {vf_launches}; scalar filter launches "
        f"{sf_launches[0]}, all of the general form, {sf_launches[2]} in its slot design (GH-17 "
        f"at 20 slots among them) and {sf_launches[1] - sf_launches[2]} (GH-33) one thread a "
        "trajectory")

    # ---- each lane: plain version, eager lane, scores, times -----------------------
    err = {"vector_filter_general": 0.0, "vector_filter_general_lanes": 0.0,
           "vector_filter_general_warp": 0.0, "vector_filter_general_shaped": 0.0,
           "vector_filter_slots": 0.0, "scalar_filter": 0.0}
    lat, mhz = sf.dependent_latencies(dev), float(clocks_line().split()[0])
    entries, slot_entry, wide_entry = {}, None, None
    for (name, rule), alg in algs.items():
        x_true, ys = data[name]
        res = results[name, rule]
        M, _, N = ys.shape
        scalar = name.startswith("UNGM")
        kernel = "scalar_filter" if scalar else vf_kernel(vf, vf.prepare(
            alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs))
        head_b = (MC if (name, rule) == vec_lanes[0] or (scalar and rule in SF_CEILING_RULES)
                  else DD_PLAIN_B)
        if scalar:
            params = sf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
            design = "one-thread" if rule == "GH-33" else "slots"
            if sf.geometry(params)[0] != design:
                fail(f"dd pairs UNGM {rule}: design {sf.geometry(params)}, not {design}")
            y_tm = ys[:, 0, :].T.contiguous()
            c = torch.as_tensor(sf.ungm_consts(N), device=dev)
            p_ms, plain = event_ms(torch, lambda: sf._scalar_filter_plain(
                params, y_tm[:, :head_b].contiguous(), c))
            got = (res.fi_mean[:head_b, 0].T, res.fi_cov[:head_b, 0, 0].T,
                   res.pr_mean[:head_b, 0].T, res.pr_cov[:head_b, 0, 0].T,
                   res.pr_xx_cov[:head_b, 0, 0].T)
            diff = max(float((a - b).nan_to_num().abs().max()) for a, b in zip(got, plain))
            if not all(same_bits(torch, a, b) for a, b in zip(got, plain)):
                fail(f"dd pairs UNGM {rule}: the kernel's streams differ from the plain "
                     f"version's on {head_b} trajectories, max |diff| {diff:.3e}")
            if rule in SF_CEILING_RULES:
                diff = max(diff, sf_held_at_batches(torch, sf, params, y_tm, c, plain,
                                                    f"dd pairs UNGM {rule}"))
            err[kernel] = max(err[kernel], diff)
        else:
            params = vf.prepare(alg.mod_dyn, alg.mod_obs, alg.tf_dyn, alg.tf_obs)
            p_ms, plain = event_ms(torch, lambda: vf._vector_filter_plain(params, ys[:head_b]))
            head = stt.FilterResult(*(getattr(res, f)[:head_b] for f in
                                      ("fi_mean", "fi_cov", "pr_mean", "pr_cov", "pr_xx_cov")))
            err[kernel] = max(err[kernel], vf_against_plain(
                torch, head, plain, f"dd pairs {name} {rule}, first {head_b} trajectories"))
            if vf.lanes_of(params) or kernel == "vector_filter_slots":
                lane_turns(torch, vf, params, ys, dev, "vector_filter_general",
                           _build.BUILD_LOGS.get("vector_filter", ""),
                           tuple(t[..., :DD_PLAIN_B] for t in plain), f"dd pairs {name} {rule}")
        del plain
        ref = alg.forward_pass_batch(ys, engine="f64")
        (r_fi, lost), (e_fi, e_lost) = (finite_rmse(torch, x_true, res.fi_mean),
                                        finite_rmse(torch, x_true, ref.fi_mean))
        r_sm = finite_rmse(torch, x_true, stt.gaussian_smoother(res)[0])[0]
        rel, limit = abs(r_fi - e_fi) / e_fi, 1e-3 if scalar else 1e-6
        batches = (", and at B = 1, 7, 4,097 through the wrapper" if scalar and
                   rule in SF_CEILING_RULES else "")
        log(f"dd pairs {name} {rule} ({M}x{N}, {kernel}{' general form' if scalar else ''}): "
            f"== plain version to the bit on {head_b} trajectories{batches}, all five streams; "
            f"RMSE filter {r_fi:.9f}, smoother {r_sm:.9f} (eager f64: filter {e_fi:.9f}; "
            f"relative {rel:.2e}, limit {limit}); not finite {lost:.2%} (eager {e_lost:.2%}, "
            "limit 1%)")
        if not (rel <= limit and lost <= 0.01):
            fail(f"dd pairs {name} {rule}: filter RMSE of dd and f64 differ by {rel:.3e} "
                 f"relative, or {lost:.2%} of the runs are not finite")
        del ref
        if scalar:
            raw = raw_ms(torch, sf_raw(torch, sf, params, y_tm, c, dev))
            k_ms = cuda_ms(torch, lambda: sf.scalar_filter(params, y_tm, c))
            b_ms, b_by = sf_bound(params, N, M)
            fl = sf.chain_floor_clocks(lat, params)
            fn = sf_entry(sf, params)
            regs, _, spill = ptxas_of(_build.BUILD_LOGS.get("scalar_filter", ""), fn)
            floor = (f", chain floor {fl:.0f} clocks a step = {fl * N / (mhz * 1e3):.4f} ms at "
                     f"{mhz:.0f} MHz; {sf.geometry(params)}, {regs} registers, {spill} bytes "
                     f"spilled ({fn})")
            if design == "one-thread":
                wide_entry = {"launches": sf_launches[1] - sf_launches[2], "ms": k_ms[0],
                              "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                              "library_ms": None, "max_abs_err": diff}
            slot_entry = slot_entry or {"launches": sf_launches[2], "ms": k_ms[0],
                                        "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                                        "library_ms": None}
        else:
            raw = raw_ms(torch, vf_raw(torch, vf, params, ys, dev))
            k_ms = cuda_ms(torch, lambda: vf.vector_filter(params, ys))
            b_ms, b_by = vf_bound(params, N, M)
            fl = vf.chain_floor_clocks(lat, params)
            floor = (f", chain floor {fl:.0f} clocks a step = {fl * N / (mhz * 1e3):.4f} ms at "
                     f"{mhz:.0f} MHz")
        log(f"  {kernel} <D={params.dim_state if not scalar else 1}, E={ys.shape[1]}, "
            f"N={params.dyn.n}/{params.obs.n}> raw launches {raw:.4f} ms a launch (CUDA events "
            f"around 20 behind torch.cuda._sleep); wrapper call {k_ms[0]:.4f} ms (min "
            f"{k_ms[1]:.4f}); plain version {p_ms:.1f} ms on {head_b} trajectories; bound "
            f"{b_ms:.4f} ms ({b_by}){floor}")
        if not scalar and kernel not in entries:
            # the kernel's first lane: CT + radar UKF in the shaped form, CT + 5 bearings in
            # the lane-group form, CT + 8 bearings under GH-3 in the warp form, the pendulum +
            # radar under GH-4 in the slot kernel and under GH-5 in the general one-thread form
            entries[kernel] = {"launches": vf_launches[kernel], "ms": k_ms[0], "plain_ms": p_ms,
                               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    # ---- the scalar general form's sine and range measurements ------------------------
    x_u = xs_u.permute(1, 2, 0)                                         # (1, N, M)
    for obs in (RangeMeasurement(GaussRV(1, cov=0.03, device=dev), dim_state=1),
                Pendulum2DMeasurement(GaussRV(1, cov=0.1, device=dev), dim_state=1)):
        y_m = obs.simulate_measurements(gen, x_u[:, :DD_SHAPE_STEPS])[0].contiguous()
        c = torch.as_tensor(sf.ungm_consts(DD_SHAPE_STEPS), device=dev)
        for rule, alg in (("UKF", stt.UnscentedKalman(dyn_u, obs)),
                          ("GH-15", stt.GaussHermiteKalman(dyn_u, obs, deg=15))):
            params = sf.prepare(dyn_u, obs, alg.tf_dyn, alg.tf_obs)
            if sf.form_of(params) != "general" or sf.geometry(params)[0] != "slots":
                fail(f"{type(obs).__name__} {rule}: form {sf.form_of(params)}, design "
                     f"{sf.geometry(params)}, not general in the slot design")
            ref_all = sf._scalar_filter_plain(params, y_m, c)
            for batch in (1, 7, 4097, MC):
                got = sf.scalar_filter(params, y_m[:, :batch].contiguous(), c)
                torch.cuda.synchronize()
                ref = tuple(r[:, :batch] for r in ref_all)
                diff = max(float((a - b).nan_to_num().abs().max()) for a, b in zip(got, ref))
                err["scalar_filter"] = max(err["scalar_filter"], diff)
                if not all(same_bits(torch, a, b) for a, b in zip(got, ref)):
                    fail(f"scalar general form, {type(obs).__name__} {rule}, B={batch}: max "
                         f"|diff| {diff:.3e}; expected equal bits")
    log(f"scalar general form (slot design) == plain to the bit with the range and sine "
        f"measurements of the UNGM state (UKF, GH-15), B = 1, 7, 4097, {MC}, N = "
        f"{DD_SHAPE_STEPS}")
    if bench is not None:
        d_re, o_re, y_re = bench
        ukf_re = stt.UnscentedKalman(d_re, o_re)
        p_re = vf.prepare(d_re, o_re, ukf_re.tf_dyn, ukf_re.tf_obs)
        turns = {}
        for kernel in ("vector_filter_shaped", "vector_filter_general", "vector_filter",
                       "vector_filter_general", "vector_filter_shaped"):
            turns.setdefault(kernel, []).append(
                raw_ms(torch, vf_raw(torch, vf, p_re, y_re, dev, kernel)))
        log(f"reentry bench lane UKF {y_re.shape[0]}x{y_re.shape[-1]}, raw launches in turns: "
            + ", ".join(f"{k} " + " / ".join(f"{t:.4f}" for t in v) + " ms"
                        for k, v in turns.items()))
    for kernel, entry in entries.items():
        entry["max_abs_err"] = err[kernel]
    slot_entry["max_abs_err"] = err["scalar_filter"]
    log(f"dd pairs phase: {time.perf_counter() - t27:.1f} s; libraries built in "
        + ", ".join(f"{k} {v:.1f} s" for k, v in built.items()) + f"; card: {card_line()}")
    return entries, sf_launches[1], err["scalar_filter"], slot_entry, wide_entry


#: phase 27's lanes of the pendulum + radar under GH-4 (16 points, the slot
#: kernel) and GH-5 (25, the general one-thread form): their steps, the first
#: of the GH-3 lane's data
DD_GH4_STEPS = 50

#: phase 28: the vector lanes' steps, the scalar lane's, and the bearing
#: sensors of the wide lanes (16 on a circle about the turning target's start)
REG_STEPS, REG_SCALAR_STEPS = 100, 500
REG_SENSORS = [[100.0 + 150.0 * math.cos(0.2 + 2 * math.pi * i / 16),
                100.0 + 150.0 * math.sin(0.2 + 2 * math.pi * i / 16)] for i in range(16)]


def registry_systems(np, dev):
    """Phase 28's systems, by lane name: (dynamics, measurement) on ``dev``.
    Models of a user's own, each registered in the port with a
    :class:`ssmtoybox_torch.ops.KernelForm` (C++ statements, constants and
    the plain PyTorch version, the statements in the plain version's order):

    - ``growth``: ``a x + b x / (1 + x^2) + 2 cos(0.7 t)``, its cosine a
      per-step stream, with ``x + 0.5 sin(x)``, both through the scalar
      registry (``register_dyn_dd`` / ``register_obs_dd``): the scalar filter
      kernel's registered form;
    - ``driven pendulum + mix``: ``[x0 + dt x1, x1 - w dt sin(x0) + dt u_t]``,
      ``u_t = 0.5 sin(0.1 t)`` a per-step stream, with the two outputs
      ``[b^2 + 0.5 a, sin(a) + 0.2 b]`` of the components (b, a) its
      ``state_index`` (1, 0) picks (``register_dyn_dd_vec`` /
      ``register_obs_dd_vec``); ``driven pendulum + radar``, the same
      transition with the table's radar;
    - ``chain 8-D + radar``: four coupled pendulums (8 states) with the
      table's radar of components 0 and 2;
    - ``pendulum copy + radar``: a subclass of ``Pendulum2DTransition``
      registered with the statements of ``VfDyn<VF_DYN_PENDULUM>``, with the
      radar; ``pendulum + radar`` is the same system with the table's
      pendulum (the general kernel);
    - ``CT + 9 bearings`` and ``CT + 16 bearings``: the zoo's coordinated turn
      with bearings from ``REG_SENSORS`` (the general kernel's wide form);
    - ``reentry + radar copy``: the bench lane's reentry with a subclass of
      ``Radar2DMeasurement`` registered with the statements of
      ``VfObs<VF_OBS_RADAR>`` (under GH-3 the registered kernel's warp form);
      ``reentry + radar`` is the same system with the table's radar.

    A registration replaces an earlier one of its class, so calling this
    again is harmless."""
    import torch
    from ssmtoybox_torch import ssmod
    from ssmtoybox_torch.ops import (KernelForm, register_dyn_dd, register_dyn_dd_vec,
                                     register_obs_dd, register_obs_dd_vec)
    from ssmtoybox_torch.utils import GaussRV

    class Growth1D(ssmod.TransitionModel):
        dim_state, dim_noise = 1, 1
        A, B = 0.5, 5.0

        def dyn_fcn(self, x, q, time):
            return self.A * x + self.B * (x / (1.0 + x * x)) + 2.0 * math.cos(0.7 * time) + q

    class Sat1D(ssmod.MeasurementModel):
        dim_substate, dim_out, dim_noise = 1, 1, 1

        def meas_fcn(self, x, r, time):
            return 1.0 * x + 0.5 * torch.sin(x) + r

    class DrivenPendulum(ssmod.TransitionModel):
        dim_state, dim_noise = 2, 2
        DT, W = 0.05, 4.0

        def dyn_fcn(self, x, q, time):
            x0, x1 = x.unbind(-1)
            u = 0.5 * math.sin(0.1 * time)
            return torch.stack([x0 + self.DT * x1,
                                x1 - (self.W * self.DT) * torch.sin(x0) + self.DT * u], -1) + q

    class Mix2(ssmod.MeasurementModel):
        dim_substate, dim_out, dim_noise = 2, 2, 2

        def meas_fcn(self, x, r, time):
            a, b = x[..., 0], x[..., 1]
            return torch.stack([a * a + 0.5 * b, torch.sin(b) + 0.2 * a], -1) + r

    class Chain8D(ssmod.TransitionModel):
        dim_state, dim_noise = 8, 8
        DT, W, K = 0.05, 2.0, 0.5

        def dyn_fcn(self, x, q, time):
            p, v = x[..., 0::2], x[..., 1::2]
            nxt = torch.roll(p, -1, dims=-1)
            f = torch.stack([p + self.DT * v,
                             v - self.DT * (self.W * torch.sin(p) - self.K * (nxt - p))], -1)
            return f.reshape(x.shape) + q

    class PendulumCopy(ssmod.Pendulum2DTransition):
        pass

    class RadarCopy(ssmod.Radar2DMeasurement):
        pass

    register_dyn_dd(Growth1D, lambda m, n: 2.0 * np.cos(0.7 * np.arange(n)), KernelForm(
        "f[0] = c[0] * x[0] + c[1] * (x[0] / (1.0 + x[0] * x[0])) + s[0];",
        (Growth1D.A, Growth1D.B), lambda x, c, s, fns: c[0] * x + c[1] * (x / (1.0 + x * x)) + s[0]))
    register_obs_dd(Sat1D, KernelForm("h[0] = c[0] * x[0] + c[1] * sin(x[0]);", (1.0, 0.5),
                                      lambda x, c, fns: c[0] * x + c[1] * fns.sin(x)))

    def driven(model, n_steps):
        def plain(x, c, s, fns):
            x0, x1 = x.unbind(-1)
            return torch.stack([x0 + c[0] * x1, x1 - c[1] * fns.sin(x0) + c[0] * s[0]], -1)
        return [0.5 * np.sin(0.1 * np.arange(n_steps))], KernelForm(
            "f[0] = x[0] + c[0] * x[1];\nf[1] = x[1] - c[1] * sin(x[0]) + c[0] * s[0];",
            (model.DT, model.W * model.DT), plain)

    def mix(model):
        i, j = model.state_index

        def plain(x, c, fns):
            a, b = x[..., i], x[..., j]
            return torch.stack([a * a + c[0] * b, fns.sin(b) + c[1] * a], -1)
        return KernelForm(f"h[0] = x[{i}] * x[{i}] + c[0] * x[{j}];\n"
                          f"h[1] = sin(x[{j}]) + c[1] * x[{i}];", (0.5, 0.2), plain)

    def chain(model, n_steps):
        lines = []
        for i in range(4):
            p, v, nxt = 2 * i, 2 * i + 1, 2 * ((i + 1) % 4)
            lines += [f"f[{p}] = x[{p}] + c[0] * x[{v}];",
                      f"f[{v}] = x[{v}] - c[0] * (c[1] * sin(x[{p}]) - c[2] * (x[{nxt}] - x[{p}]));"]

        def plain(x, c, s, fns):
            p, v = x[..., 0::2], x[..., 1::2]
            nxt = torch.roll(p, -1, dims=-1)
            f = torch.stack([p + c[0] * v, v - c[0] * (c[1] * fns.sin(p) - c[2] * (nxt - p))], -1)
            return f.reshape(x.shape)
        return [], KernelForm("\n".join(lines), (model.DT, model.W, model.K), plain)

    def pendulum(model, n_steps):
        def plain(x, c, s, fns):
            x0, x1 = x.unbind(-1)
            return torch.stack([x0 + x1 * c[0], x1 - c[1] * fns.sin(x0)], -1)
        return [], KernelForm("f[0] = x[0] + x[1] * c[0];\nf[1] = x[1] - c[1] * sin(x[0]);",
                              (model.dt, model.g * model.dt), plain)

    def radar_copy(model):
        i, j = model.state_index

        def plain(x, c, fns):
            dx, dy = x[..., i] - c[0], x[..., j] - c[1]
            return torch.stack([fns.sqrt(dx * dx + dy * dy), fns.atan2(dy, dx)], -1)
        return KernelForm(f"const double dx = x[{i}] - c[0];\nconst double dy = x[{j}] - c[1];\n"
                          "h[0] = sqrt(dx * dx + dy * dy);\nh[1] = atan2(dy, dx);",
                          tuple(model.radar_loc.tolist()), plain)

    register_dyn_dd_vec(DrivenPendulum, driven)
    register_obs_dd_vec(Mix2, mix)
    register_obs_dd_vec(RadarCopy, radar_copy)
    register_dyn_dd_vec(Chain8D, chain)
    register_dyn_dd_vec(PendulumCopy, pendulum)

    def rv(d, mean, cov):
        return GaussRV(d, mean=mean, cov=cov, device=dev)

    def radar(D, loc):
        return ssmod.Radar2DMeasurement(rv(2, None, np.diag([0.01, 1e-3])), dim_state=D,
                                        state_index=[0, 2] if D >= 4 else [0, 1],
                                        radar_loc=np.array(loc))

    def pend(cls):
        return cls(rv(2, np.array([1.5, 0.0]), 0.01 * np.eye(2)), rv(2, None, 1e-4 * np.eye(2)),
                   dt=0.01)

    ct = zoo_systems(np, dev)["CT + 4 bearings"][0]
    reentry, table_radar = reentry_system(np, dev)

    def bearings(S):
        return ssmod.BearingMeasurement(rv(S, None, 1e-3 * np.eye(S)), dim_state=5,
                                        state_index=[0, 2], sensor_pos=REG_SENSORS[:S])

    return {
        "growth": (Growth1D(rv(1, np.zeros(1), np.eye(1)), rv(1, None, np.eye(1))),
                   Sat1D(rv(1, None, 0.1 * np.eye(1)), dim_state=1)),
        "driven pendulum + mix": (DrivenPendulum(rv(2, np.array([1.0, 0.0]), 0.1 * np.eye(2)),
                                                 rv(2, None, 1e-3 * np.eye(2))),
                                  Mix2(rv(2, None, 0.05 * np.eye(2)), dim_state=2,
                                       state_index=[1, 0])),
        "driven pendulum + radar": (DrivenPendulum(rv(2, np.array([1.0, 0.0]), 0.1 * np.eye(2)),
                                                   rv(2, None, 1e-3 * np.eye(2))),
                                    radar(2, [-2.0, -2.0])),
        "chain 8-D + radar": (Chain8D(rv(8, np.tile([0.5, 0.0], 4), 0.05 * np.eye(8)),
                                      rv(8, None, 1e-4 * np.eye(8))), radar(8, [-3.0, -3.0])),
        "pendulum copy + radar": (pend(PendulumCopy), radar(2, [-2.0, -2.0])),
        "pendulum + radar": (pend(ssmod.Pendulum2DTransition), radar(2, [-2.0, -2.0])),
        "CT + 9 bearings": (ct, bearings(9)),
        "CT + 16 bearings": (ct, bearings(16)),
        "reentry + radar copy": (reentry, RadarCopy(table_radar.noise_rv, dim_state=5,
                                                    state_index=table_radar.state_index,
                                                    radar_loc=table_radar.radar_loc)),
        "reentry + radar": (reentry, table_radar),
    }


#: phase 28's lanes: (system, rule, kernel, steps); the first vector lane is
#: held against its plain version on all of its trajectories
#: phase 28's lanes of the driven pendulum + radar under GH-4 (16 points, the
#: registered kernel's slot form) and GH-5 (25, its one-thread form) on the
#: first ``REG_GH4_STEPS`` steps of the GH-3 lane's data
REG_GH4_STEPS = 50
REG_GH4 = f"driven pendulum + radar, {REG_GH4_STEPS} steps"
REG_GH5 = f"{REG_GH4}, GH-5"
REG_LANES = [("growth", "UKF", "scalar_filter", REG_SCALAR_STEPS),
             ("driven pendulum + mix", "UKF", "vector_filter_registered", REG_STEPS),
             ("driven pendulum + radar", "GH-3", "vector_filter_registered", REG_STEPS),
             (REG_GH4, "GH-4", "vector_filter_registered", REG_GH4_STEPS),
             ("chain 8-D + radar", "CKF", "vector_filter_registered", REG_STEPS),
             ("pendulum copy + radar", "UKF", "vector_filter_registered", REG_STEPS),
             ("CT + 9 bearings", "CKF", "vector_filter_general", REG_STEPS),
             ("CT + 16 bearings", "CKF", "vector_filter_general", REG_STEPS),
             ("reentry + radar copy", "GH-3", "vector_filter_registered", REG_STEPS),
             (REG_GH5, "GH-5", "vector_filter_registered", REG_GH4_STEPS)]
#: phase 28's filters by rule: (class, keyword arguments)
REG_RULES = {"UKF": ("UnscentedKalman", {}), "CKF": ("CubatureKalman", {}),
             **{f"GH-{g}": ("GaussHermiteKalman", {"deg": g}) for g in (3, 4, 5)}}
#: phase 28's registered 1-D lanes around the slot design's ceiling, the
#: growth model on the growth lane's data: (name, Gauss-Hermite points,
#: steps, design): GH-17 at 20 slots, and GH-33 one thread a trajectory on
#: the first ``DD_WIDE_STEPS`` steps
REG_WIDE = (("growth GH-17", 17, REG_SCALAR_STEPS, "slots"),
            ("growth GH-33", 33, DD_WIDE_STEPS, "one-thread"))


def registry_slice(torch, np, dev):
    """Phase 28, "registry": models of a user's own registered in the port's
    fused kernels, and bearings from more than 8 sensors, at full width
    (``REG_LANES``, systems of ``registry_systems``, 10,000 trajectories
    simulated from the seed, ``REG_STEPS`` steps, ``REG_SCALAR_STEPS`` on the
    1-D lane).  First the libraries of the registered forms are built, the
    vector lanes' and the scalar lane's at once (their build times and each
    instantiation's ptxas registers and spills printed).  Then every lane
    once through ``engine="dd"`` with the counts set to 0: seven launches of
    the registered vector kernel (the driven pendulum's and the pendulum
    copy's under the UKF and the driven pendulum with the radar under GH-3
    in its shaped one-thread form, the latter under GH-4 in its slot form
    and under GH-5 in its general one-thread form, the chain's in its
    lane-group form, the radar copy's under GH-3 in its warp form), two of
    the general kernel (its lane-group form), one of the scalar kernel's
    registered form, nothing else.  Each lane: every stream
    of its first ``DD_PLAIN_B`` trajectories (all on the 2-D lane) equal to
    its plain version's to the bit; filter RMSE within 1e-6 relative (1e-3 on
    the 1-D lane) of the eager f64 lane's, at most 1% not finite; raw
    launches, the wrapper's and the plain version's time, the bound
    (``vf_bound`` / ``sf_bound``).  The pendulum copy's streams equal the
    table pendulum's in the general kernel on the same data, to the bit, and
    the radar copy's the table radar's in the general kernel's warp form; each
    pair is timed in turns (raw launches).  The 8-D chain and CT with 9
    and 16 bearings run in the lane-group form, the radar copy in the warp
    form, the driven pendulum and the pendulum copy under the UKF in the
    shaped form, the driven pendulum + radar under GH-4 in the slot form; on
    them both forms of their kernel (that form and the general one-thread
    form) are held to the plain version and timed in turns (``lane_turns``;
    the registered library is built with the two forms of each); the slot
    form's lane also through the wrapper at B = 1, 7 and 4,097 against the
    plain version to the bit.  Then the
    registered 1-D lanes around the slot design's ceiling (``registered_wide``,
    ``REG_WIDE``: the growth model under GH-17 at 20 slots and under GH-33
    one thread a trajectory, built into the same library as the growth
    lane).  Returns the entries of ``vector_filter_registered``,
    ``vector_filter_registered_lanes``, ``vector_filter_registered_warp``,
    ``vector_filter_registered_shaped`` and ``vector_filter_registered_slots``
    for the ``kernels`` line, the scalar
    kernel's launches and largest |diff| on this phase, and the launches and
    largest |diff| of the general kernel's forms, by ``VF_KERNELS`` name,
    and the ``kernels`` entries of the scalar registered form's slot design
    and of its one-thread design."""
    import ssmtoybox_torch as stt
    from ssmtoybox_torch.ops import _build, scalar_filter as sf, vector_filter as vf

    t28 = time.perf_counter()
    systems = registry_systems(np, dev)
    systems[REG_GH4] = systems[REG_GH5] = systems["driven pendulum + radar"]
    gen = torch.Generator(device=dev).manual_seed(SEED + 28)
    algs, data, params = {}, {}, {}
    tables = {"pendulum + radar": ("pendulum copy + radar", "UKF"),
              "reentry + radar": ("reentry + radar copy", "GH-3")}
    for name, rule, _, steps in REG_LANES + [(n, r, None, REG_STEPS)
                                             for n, (_, r) in tables.items()]:
        dyn, obs = systems[name]
        cls, kwargs = REG_RULES[rule]
        algs[name] = getattr(stt, cls)(dyn, obs, **kwargs)
        lowering = sf if dyn.dim_state == 1 else vf
        params[name] = lowering.prepare(dyn, obs, algs[name].tf_dyn, algs[name].tf_obs)
        if name not in tables and name not in (REG_GH4, REG_GH5):
            x = dyn.simulate_discrete(gen, steps=steps, mc_sims=MC)
            data[name] = (x.permute(2, 0, 1), obs.simulate_measurements(gen, x).permute(2, 0, 1))
    for name, (copy, _) in tables.items():
        data[name] = data[copy]
    data[REG_GH4] = data[REG_GH5] = tuple(t[..., :REG_GH4_STEPS]
                                          for t in data["driven pendulum + radar"])
    for name, deg, _, _ in REG_WIDE:
        algs[name] = stt.GaussHermiteKalman(*systems["growth"], deg=deg)
        params[name] = sf.prepare(*systems["growth"], algs[name].tf_dyn, algs[name].tf_obs)
    torch.cuda.synchronize()

    # ---- the registered forms' libraries, built at once -------------------------
    t0 = time.perf_counter()
    vec = [params[n] for n, _, k, _ in REG_LANES if k == "vector_filter_registered"]
    vec += [(p, 0) for p in vec if vf.lanes_of(p)]

    def timed(build, configs):
        return build(configs), time.perf_counter() - t0
    with ThreadPoolExecutor(2) as pool:
        v_job = pool.submit(timed, vf.build_registered, vec)
        s_job = pool.submit(timed, sf.build_registered,
                            [params["growth"]] + [params[n] for n, _, _, _ in REG_WIDE])
        (v_name, v_s), (s_name, s_s) = v_job.result(), s_job.result()
    log(f"registry: built vector_filter_registered.cu ({len(vec)} configurations) in {v_s:.1f} s "
        f"and scalar_filter_registered.cu ({1 + len(REG_WIDE)}) in {s_s:.1f} s, at once, from "
        "generated headers")
    ptxas = {}
    for name, _, kernel, _ in REG_LANES:
        p = params[name]
        if kernel == "scalar_filter":
            text, fn = _build.BUILD_LOGS.get(s_name, ""), sf_entry(sf, p)
        else:
            text = _build.BUILD_LOGS.get(
                v_name if kernel == "vector_filter_registered" else "vector_filter", "")
            fn = form_ptxas(vf, p, kernel, vf.lanes_of(p), text)[3]
        ptxas[name] = ptxas_of(text, fn)
        log(f"  ptxas {name}: {ptxas[name][0]} registers, {ptxas[name][1]} bytes stack frame, "
            f"{ptxas[name][2]} bytes spill stores ({fn})")

    # ---- the path: every lane once, the counts from 0 ----------------------------
    sf.LAUNCHES = sf.GENERAL_LAUNCHES = sf.REGISTERED_LAUNCHES = sf.SLOT_LAUNCHES = 0
    vf_zero(vf)
    results = {}
    for name, _, _, _ in REG_LANES:
        results[name] = algs[name].forward_pass_batch(data[name][1], engine="dd")
    torch.cuda.synchronize()
    vf_launches = vf_counts(vf)
    sf_launches = (sf.LAUNCHES, sf.GENERAL_LAUNCHES, sf.REGISTERED_LAUNCHES, sf.SLOT_LAUNCHES)
    want = dict.fromkeys(VF_KERNELS, 0)
    for name, _, kernel, _ in REG_LANES:
        if kernel != "scalar_filter":
            want[vf_kernel(vf, params[name])] += 1
    registered = ("vector_filter_registered", "vector_filter_registered_lanes",
                  "vector_filter_registered_warp", "vector_filter_registered_shaped",
                  "vector_filter_registered_slots")
    if (vf_launches != want or sf_launches != (1, 0, 1, 1)
            or sum(want[k] for k in registered) != 7 or not all(want[k] for k in registered)):
        fail(f"registry path: vector filter launches {vf_launches}, scalar filter launches (all, "
             f"general, registered, slot design) {sf_launches}; expected {want} (seven of the "
             "registered kernel, in each of its five forms) and (1, 0, 1, 1)")
    log(f"registry path: vector filter launches {vf_launches}; scalar filter launches "
        f"{sf_launches[0]}, of the registered form in its slot design "
        f"{sf.geometry(params['growth'])}")
    wide = {name: registered_wide(torch, sf, name, algs[name], params[name],
                                  data["growth"][1][..., :steps], dev, design,
                                  ptxas_of(_build.BUILD_LOGS.get(s_name, ""),
                                           sf_entry(sf, params[name])))
            for name, _, steps, design in REG_WIDE}

    # ---- each lane: plain version, eager lane, scores, times -------------------------
    err = dict.fromkeys(VF_KERNELS, 0.0)
    err["scalar_filter"] = 0.0
    entries, slot_entry = {}, None
    for name, rule, family, steps in REG_LANES:
        x_true, ys = data[name]
        res, p = results[name], params[name]
        M, E, N = ys.shape
        scalar = family == "scalar_filter"
        kernel = family if scalar else vf_kernel(vf, p)
        head_b = MC if name == "driven pendulum + mix" else DD_PLAIN_B
        if scalar:
            y_tm = ys[:, 0, :].T.contiguous()
            c = sf.step_consts(p, N, dev)
            p_ms, plain = event_ms(torch, lambda: sf._scalar_filter_plain(
                p, y_tm[:, :head_b].contiguous(), c))
            got = (res.fi_mean[:head_b, 0].T, res.fi_cov[:head_b, 0, 0].T,
                   res.pr_mean[:head_b, 0].T, res.pr_cov[:head_b, 0, 0].T,
                   res.pr_xx_cov[:head_b, 0, 0].T)
            diff = max(float((a - b).nan_to_num().abs().max()) for a, b in zip(got, plain))
            if not all(same_bits(torch, a, b) for a, b in zip(got, plain)):
                fail(f"registry {name} {rule}: the kernel's streams differ from the plain "
                     f"version's on {head_b} trajectories, max |diff| {diff:.3e}")
            err[kernel] = max(err[kernel], diff)
        else:
            p_ms, plain = event_ms(torch, lambda: vf._vector_filter_plain(p, ys[:head_b]))
            head = stt.FilterResult(*(getattr(res, f)[:head_b] for f in
                                      ("fi_mean", "fi_cov", "pr_mean", "pr_cov", "pr_xx_cov")))
            err[kernel] = max(err[kernel], vf_against_plain(
                torch, head, plain, f"registry {name} {rule}, first {head_b} trajectories"))
            if vf.lanes_of(p):
                lane_turns(torch, vf, p, ys, dev, family, _build.BUILD_LOGS.get(
                    v_name if family == "vector_filter_registered" else "vector_filter", ""),
                    tuple(t[..., :DD_PLAIN_B] for t in plain), f"registry {name} {rule}")
            if vf.lanes_of(p) == vf._SLOTS:
                err[kernel] = max(err[kernel], registered_slot_batches(torch, vf, p, ys,
                                                                       f"registry {name} {rule}"))
        del plain
        ref = algs[name].forward_pass_batch(ys, engine="f64")
        (r_fi, lost), (e_fi, e_lost) = (finite_rmse(torch, x_true, res.fi_mean),
                                        finite_rmse(torch, x_true, ref.fi_mean))
        r_sm = finite_rmse(torch, x_true, stt.gaussian_smoother(res)[0])[0]
        rel, limit = abs(r_fi - e_fi) / e_fi, 1e-3 if scalar else 1e-6
        log(f"registry {name} {rule} ({M}x{N}, {kernel}"
            f"{' registered form' if scalar else ''}): == plain version to the bit on {head_b} "
            f"trajectories, all five streams; RMSE filter {r_fi:.9f}, smoother {r_sm:.9f} (eager "
            f"f64: filter {e_fi:.9f}; relative {rel:.2e}, limit {limit}); not finite "
            f"{lost:.2%} (eager {e_lost:.2%}, limit 1%)")
        if not (rel <= limit and lost <= 0.01):
            fail(f"registry {name}: filter RMSE of dd and f64 differ by {rel:.3e} relative, or "
                 f"{lost:.2%} of the runs are not finite")
        del ref
        if scalar:
            raw = raw_ms(torch, sf_raw(torch, sf, p, y_tm, c, dev))
            k_ms = cuda_ms(torch, lambda: sf.scalar_filter(p, y_tm, c))
            b_ms, b_by = sf_bound(p, N, M)
        else:
            raw = raw_ms(torch, vf_raw(torch, vf, p, ys, dev))
            k_ms = cuda_ms(torch, lambda: vf.vector_filter(p, ys))
            b_ms, b_by = vf_bound(p, N, M)
        regs, frame, spill = ptxas[name]
        log(f"  {kernel} <D={p.dim_state if not scalar else 1}, E={E}, N={p.dyn.n}/{p.obs.n}> "
            f"raw launches {raw:.4f} ms a launch (CUDA events around 20 behind "
            f"torch.cuda._sleep); wrapper call {k_ms[0]:.4f} ms (min {k_ms[1]:.4f}); plain "
            f"version {p_ms:.1f} ms on {head_b} trajectories; bound {b_ms:.4f} ms ({b_by}); "
            f"{regs} registers, {spill} bytes spilled")
        if scalar:
            slot_entry = {"launches": sf_launches[3], "ms": k_ms[0], "plain_ms": p_ms,
                          "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
        if family == "vector_filter_registered" and kernel not in entries:
            # the first lane of each form: the driven pendulum + mix (shaped), the driven
            # pendulum + radar GH-4 (slot form) and GH-5 (one thread), the chain (lane-group)
            # and the radar copy (warp)
            entries[kernel] = {"launches": vf_launches[kernel], "ms": k_ms[0], "plain_ms": p_ms,
                               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}

    # ---- the registered copies against the table's models in the general kernel -------
    for table, (copy, _) in tables.items():
        p_copy, p_table = params[copy], params[table]
        ys = data[copy][1]
        forms = (vf_kernel(vf, p_copy), vf_kernel(vf, p_table))
        if forms[1] != forms[0].replace("registered", "general"):
            fail(f"{copy} runs in {forms[0]}, {table} in {forms[1]}: not the same form")
        copy_run, table_run = vf_raw(torch, vf, p_copy, ys, dev), vf_raw(torch, vf, p_table, ys,
                                                                          dev)
        turns = {"registered copy": [], "table (general)": []}
        for who in ("registered copy", "table (general)", "table (general)", "registered copy"):
            turns[who].append(raw_ms(torch, copy_run if who == "registered copy" else table_run,
                                     reps=5))
        torch.cuda.synchronize()
        diff = max(float((a - b).nan_to_num().abs().max())
                   for a, b in zip(copy_run.out, table_run.out))
        if not all(same_bits(torch, a, b) for a, b in zip(copy_run.out, table_run.out)):
            fail(f"the registered {copy} differs from the table's {table} in the general kernel "
                 f"on {ys.shape[0]} trajectories, max |diff| {diff:.3e}; expected equal bits")
        log(f"registered {copy} ({forms[0]}) == the table's {table} ({forms[1]}) to the bit, "
            f"{ys.shape[0]}x{ys.shape[-1]}, all five streams; raw launches in turns: "
            + ", ".join(f"{k} " + " / ".join(f"{t:.4f}" for t in v) + " ms"
                        for k, v in turns.items()))
    for kernel, entry in entries.items():
        entry["max_abs_err"] = err[kernel]
    # the GH-17 lane runs in the slot design, GH-33 one thread a trajectory
    slot_entry["launches"] += wide["growth GH-17"]["launches"]
    slot_entry["max_abs_err"] = max(err["scalar_filter"], wide["growth GH-17"]["max_abs_err"])
    wide_entry = wide["growth GH-33"]
    log(f"registry phase: {time.perf_counter() - t28:.1f} s; card: {card_line()}")
    general = {k: (vf_launches[k], err[k])
               for k in ("vector_filter_general", "vector_filter_general_lanes",
                         "vector_filter_general_shaped")}
    return entries, sf_launches[2], err["scalar_filter"], general, slot_entry, wide_entry


def registered_slot_batches(torch, vf, params, ys, what):
    """The registered kernel's slot form on the first 1, 7 and 4,097
    trajectories of ``ys`` through the wrapper (one launch each, counted on
    that form), every stream equal to the plain version's on those 4,097 to
    the bit (its prefix: on the card the plain version's operations are
    elementwise across trajectories); logs and returns the largest |diff|."""
    batches, err = (1, 7, 4097), 0.0
    ref_all = vf._vector_filter_plain(params, ys[:max(batches)])
    for batch in batches:
        before = vf_counts(vf)
        got = vf.vector_filter(params, ys[:batch])
        torch.cuda.synchronize()
        moved = {k: v - before[k] for k, v in vf_counts(vf).items()}
        if moved != only("vector_filter_registered_slots"):
            fail(f"{what}, B={batch}: the wrapper's launches {moved}; the registered slot form "
                 "was to run once")
        ref = tuple(r[..., :batch] for r in ref_all)
        err = max(err, *(float((g_ - r_).nan_to_num().abs().max()) for g_, r_ in zip(got, ref)))
        if not all(same_bits(torch, g_, r_) for g_, r_ in zip(got, ref)):
            fail(f"{what}, B={batch}: the registered slot form differs from the plain version, "
                 f"max |diff| {err:.3e}; expected equal bits")
    log(f"  {what}: the registered slot form == plain to the bit at B = {batches} through the "
        f"wrapper, all five streams")
    return err


def registered_wide(torch, sf, name, alg, params, ys, dev, want, ptxas):
    """One of phase 28's registered 1-D lanes around the slot design's
    ceiling (``REG_WIDE``: GH-17 at 20 slots, GH-33 one thread a
    trajectory): once through ``engine="dd"`` with the counts set to 0 (one
    launch of the registered form, in the slot design or not as
    ``geometry`` says), every stream equal to the plain version's to the bit
    on all trajectories, then launches of B = 1, 7 and 4,097 of them through
    the wrapper likewise; its design ``want``; at most 1% of the runs not
    finite; raw launches,
    the wrapper's and the plain version's time, the bound.  Returns its
    entry for the ``kernels`` line (its launches those of the registered
    form on this path)."""
    M, _, N = ys.shape
    design = sf.geometry(params)
    slot = design[0] == "slots"
    sf.LAUNCHES = sf.GENERAL_LAUNCHES = sf.REGISTERED_LAUNCHES = sf.SLOT_LAUNCHES = 0
    res = alg.forward_pass_batch(ys, engine="dd")
    torch.cuda.synchronize()
    launches = (sf.LAUNCHES, sf.GENERAL_LAUNCHES, sf.REGISTERED_LAUNCHES, sf.SLOT_LAUNCHES)
    if launches != (1, 0, 1, int(slot)) or design[0] != want:
        fail(f"registry {name}: scalar filter launches (all, general, registered, slot design) "
             f"{launches}, design {design}; expected (1, 0, 1, {int(slot)}) in the design {want}")
    y_tm = ys[:, 0, :].T.contiguous()
    c = sf.step_consts(params, N, dev)
    p_ms, plain = event_ms(torch, lambda: sf._scalar_filter_plain(params, y_tm, c))
    got = (res.fi_mean[:, 0].T, res.fi_cov[:, 0, 0].T, res.pr_mean[:, 0].T,
           res.pr_cov[:, 0, 0].T, res.pr_xx_cov[:, 0, 0].T)
    err = max(float((a - b).nan_to_num().abs().max()) for a, b in zip(got, plain))
    if not all(same_bits(torch, a, b) for a, b in zip(got, plain)):
        fail(f"registry {name}, B={M}: the kernel's streams differ from the plain version's, "
             f"max |diff| {err:.3e}; expected equal bits")
    err = max(err, sf_held_at_batches(torch, sf, params, y_tm, c, plain, f"registry {name}"))
    lost = 1.0 - float(torch.isfinite(plain[0]).all(0).double().mean())
    if lost > 0.01:
        fail(f"registry {name}: {lost:.2%} of the runs not finite")
    del plain
    raw = raw_ms(torch, sf_raw(torch, sf, params, y_tm, c, dev))
    k_ms = cuda_ms(torch, lambda: sf.scalar_filter(params, y_tm, c))
    b_ms, b_by = sf_bound(params, N, M)
    log(f"registry {name} ({M}x{N}, scalar_filter registered form, {design}): launches "
        f"{launches}; == plain version to the bit at B = 1, 7, 4097, {M}, all five streams; not "
        f"finite {lost:.2%}; raw launches {raw:.4f} ms a launch; wrapper call {k_ms[0]:.4f} ms "
        f"(min {k_ms[1]:.4f}); plain version {p_ms:.1f} ms; bound {b_ms:.4f} ms ({b_by}); "
        f"{ptxas[0]} registers, {ptxas[2]} bytes spilled")
    return {"launches": launches[2], "max_abs_err": err, "ms": k_ms[0], "plain_ms": p_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def registry_alone():
    """Phase 28 alone: the scalar and vector filter libraries built first (at
    once, their times printed), then ``registry_slice``: ``python3 -c
    "import chip_smoke; chip_smoke.registry_alone()"``."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    from ssmtoybox_torch.ops import scalar_filter as sf, vector_filter as vf

    if not torch.cuda.is_available():
        fail("registry_alone: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"card: {card_line()} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for job in [pool.submit(lib.build) for lib in (sf, vf)]:
            job.result()
    log(f"built the three scalar filter sources and the seven vector filter sources in "
        f"{time.perf_counter() - t0:.1f} s")
    entries, sf_reg, sf_err, general, _, _ = registry_slice(torch, np, dev)
    log(f"registry_alone: registered entries {json.dumps(entries)}; scalar registered launches "
        f"{sf_reg}, max |diff| {sf_err:.3e}; general kernel (launches, max |diff|) {general}; "
        f"{time.perf_counter() - t0:.1f} s; card: {card_line()}")


#: the classical phase: steps a lane, trajectories held against the CPU,
#: Monte-Carlo points of the transform studies' truth
CLASSICAL_STEPS = 100
CLASSICAL_CPU_B = 200
TRUTH_POINTS = 100_000
#: the hybrid demo's RBF parameters (experiments/gpqd_demo.py:57-66) and the
#: transform study's (experiments/gpqd_demo.py:38-55)
GPQD_RBF = [[1.0, 3.0]]
GPQD_DEMO_RBF = [[1.0, 1.5]]


def on_cpu(torch, obj):
    """A copy of a filter, model, random variable or transform of the port
    with each of its tensors copied to the CPU: the same numbers, weights
    included (the GPQ+D Gram of the demo has a condition number of 3.5e5;
    weights built apart would differ by its rounding, as the JAX package's
    and the port's do by 1e-7 of ``Wc``'s largest entry)."""
    from ssmtoybox_torch.utils.arrays import map_tensors
    return map_tensors(obj, lambda t: t.cpu())


def streams_err(torch, got, want) -> float:
    """The largest of ``max |got - want| / max |want|`` over the streams of
    two filter results; inf where their non-finite entries differ."""
    worst = 0.0
    for f in got.__dataclass_fields__:
        a, b = getattr(got, f).cpu(), getattr(want, f)
        ok = torch.isfinite(b)
        if not torch.equal(torch.isfinite(a), ok):
            return float("inf")
        if bool(ok.any()):
            worst = max(worst, float((a - b)[ok].abs().max() / b[ok].abs().max()))
    return worst


def truth_moments(torch, mtran, f, means, cov, chunk=500):
    """Moments of ``f`` under ``N(means, cov)`` by Monte Carlo on
    ``TRUTH_POINTS`` points, ``chunk`` means at a time."""
    mc = mtran.MonteCarloTransform.create(means.shape[-1], n=TRUTH_POINTS, seed=SEED + 7,
                                          device=means.device)
    parts = [mc.apply(f, means[i:i + chunk], cov[i:i + chunk], 0)[:2]
             for i in range(0, means.shape[0], chunk)]
    return tuple(torch.cat(p) for p in zip(*parts))


def classical_slice(torch, np, dev, ungm, reentry, glint):
    """Phase 20, "classical": the moment transforms and the filters that no
    fused kernel takes, at MC trajectories on the card.

    Lanes, CLASSICAL_STEPS steps each: (a) the hybrid demo's system (UNGM,
    init cov 5, Q 10, R 1; the main path's data) under the EKF, the EKF-GPQD
    (RBF ``[[1, 3]]``) and the GPQ+D Kalman filter (``[[1, 3]]``, UT
    points); (b) the reentry bench lane's data under the EKF, the truncated
    UKF and CKF, and the truncated GHKF-3 on non-additive UNGM dynamics
    (``tests/test_ssmod_ssinf.py:299-311``, simulated here); (c) the extended
    Student filter on the CV glint study's data of phase 8.  Each lane: the
    filter through ``engine="auto"`` (the Student filter has no engine),
    then ``"f64"`` timed with CUDA events, which must give the same bits;
    ``engine="dd"`` must raise ``ValueError``; the RTS smoother, timed;
    RMSE / NCI / NLL; at most 1% of the runs not finite; the first
    ``CLASSICAL_CPU_B`` trajectories against the same filter on the CPU
    (its tensors copied there) within 1e-9 of each stream's largest entry.

    (d) The two transform studies at MC input means around theirs: polar to
    cartesian (``experiments/polar2cartesian_mt.py:44-87``) through the
    linearization, MC-1000 and the truncated UT at dimensions 2, 3, 5 and
    8 beside the UT, and GPQ against GPQ+D on ``sin(x) + x^2 / 2``
    (``experiments/gpqd_demo.py:38-55``): the symmetrized KL divergence from
    Monte-Carlo truth on ``TRUTH_POINTS`` points, and each transform's time.

    No kernel may launch in the phase: every launch counter is read before
    and after."""
    import ssmtoybox_torch as stt
    from ssmtoybox_torch import mtran, ssmod
    from ssmtoybox_torch.bq import GaussianProcessDerTransform, GaussianProcessTransform
    from ssmtoybox_torch.ops import scalar_filter as sf, student_mc as smc
    from ssmtoybox_torch.ops import vandermonde as vdm, vector_filter as vf
    from ssmtoybox_torch.utils import GaussRV
    from ssmtoybox_torch.utils.metrics import symmetrized_kl_divergence

    def counters():
        return (sf.LAUNCHES, vf.LAUNCHES, vf.SHAPED_LAUNCHES, vdm.LAUNCHES,
                tuple(smc.LAUNCHES.values()))

    before = counters()
    n = CLASSICAL_STEPS
    dyn_u, obs_u, xs_u, ys_u = ungm
    xs_u, ys_u = xs_u[..., :n].contiguous(), ys_u[..., :n].contiguous()
    dyn_re, obs_re, xs_re, ys_re = reentry
    dyn_cv, obs_cv, xs_cv, ys_cv = glint
    dyn_na = ssmod.UNGMNATransition(GaussRV(1, mean=1.0, cov=1.0, device=dev),
                                    GaussRV(1, cov=1.0, device=dev))
    obs_na = ssmod.UNGMMeasurement(GaussRV(1, cov=1.0, device=dev), dim_state=1)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    x_na = dyn_na.simulate_discrete(gen, steps=n, mc_sims=MC)
    xs_na, ys_na = x_na.permute(2, 0, 1), obs_na.simulate_measurements(gen, x_na).permute(2, 0, 1)

    rbf = np.array(GPQD_RBF)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gpqd_kf = stt.GaussianProcessDerKalman(dyn_u, obs_u, rbf, rbf)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    lanes = [
        ("UNGM", "EKF", stt.ExtendedKalman(dyn_u, obs_u), xs_u, ys_u),
        ("UNGM", "EKF-GPQD", stt.ExtendedKalmanGPQD(dyn_u, obs_u, rbf, rbf), xs_u, ys_u),
        ("UNGM", "GPQ+D KF", gpqd_kf, xs_u, ys_u),
        ("reentry", "EKF", stt.ExtendedKalman(dyn_re, obs_re), xs_re, ys_re),
        ("reentry", "TUKF", stt.TruncatedUnscentedKalman(dyn_re, obs_re), xs_re, ys_re),
        ("reentry", "TCKF", stt.TruncatedCubatureKalman(dyn_re, obs_re), xs_re, ys_re),
        ("UNGM-NA dynamics", "TGHKF-3", stt.TruncatedGaussHermiteKalman(dyn_na, obs_na, 3),
         xs_na, ys_na),
        ("CV glint", "extended Student", stt.ExtendedStudent(dyn_cv, obs_cv, dof=4.0), xs_cv,
         ys_cv),
    ]
    log(f"classical: GPQ+D Kalman filter built on the card in {build_ms:.1f} ms (two "
        "transforms, RBF [[1, 3]], UT points, derivatives at all 3)")
    for system, rule, alg, x_true, ys in lanes:
        what = f"classical {system} {rule} ({MC}x{ys.shape[-1]})"
        student = isinstance(alg, stt.StudentianInference)
        if student:
            res = alg.forward_pass_batch(ys)
            f_ms, _ = event_ms(torch, lambda: alg.forward_pass_batch(ys))
            smoother = stt.studentian_smoother
        else:
            try:
                alg.forward_pass_batch(ys[:7], engine="dd")
            except ValueError as e:
                reason = str(e).split(": ", 1)[-1]
            else:
                fail(f"{what}: engine='dd' ran a configuration no kernel takes")
            res = alg.forward_pass_batch(ys, engine="auto")
            f_ms, ref = event_ms(torch, lambda: alg.forward_pass_batch(ys, engine="f64"))
            if not all(torch.equal(getattr(res, f), getattr(ref, f))
                       for f in res.__dataclass_fields__):
                fail(f"{what}: engine='auto' and engine='f64' differ")
            del ref
            smoother = stt.gaussian_smoother
        sm, _ = smoother(res)
        s_ms, (sm, _) = event_ms(torch, lambda: smoother(res))
        rmse_r, inc_r, nll_r, nci_r = study_scores(torch, x_true, res.fi_mean, res.fi_cov)
        ok = torch.isfinite(rmse_r) & torch.isfinite(nci_r) & torch.isfinite(nll_r)
        lost = 1.0 - float(ok.double().mean())
        r_sm = torch.sqrt(torch.mean(torch.sum((sm - x_true) ** 2, 1), -1))[ok]
        cpu = on_cpu(torch, alg).forward_pass_batch(ys[:CLASSICAL_CPU_B].cpu())
        head = type(res)(*(getattr(res, f)[:CLASSICAL_CPU_B] for f in res.__dataclass_fields__))
        err = streams_err(torch, head, cpu)
        del head, cpu
        log(f"{what}: filter {f_ms:.1f} ms, smoother {s_ms:.1f} ms (CUDA events, one call "
            f"after a warm-up); RMSE filter {float(rmse_r[ok].mean()):.6f}, smoother "
            f"{float(r_sm.mean()):.6f}, NCI {float(nci_r[ok].mean()):.4f}, NLL "
            f"{float(nll_r[ok].mean()):.4f}; not finite {lost:.2%} (limit 1%); first "
            f"{CLASSICAL_CPU_B} trajectories vs the CPU {err:.2e} of each stream's largest "
            "entry (limit 1e-9)"
            + ("" if student else f"; 'auto' == 'f64' to the bit; 'dd' refused: {reason}"))
        if lost > 0.01:
            fail(f"{what}: {lost:.2%} of the runs are not finite (limit 1%)")
        if not err <= 1e-9:
            fail(f"{what}: the card's streams are {err:.3e} off the CPU's (limit 1e-9)")
        del res, sm

    # ---- (d) the transform studies at MC means ---------------------------------
    f64 = dict(dtype=torch.float64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED + 5)

    def p2c(x, time):
        return x[..., :1] * torch.stack([torch.cos(x[..., 1]), torch.sin(x[..., 1])], dim=-1)

    means = (torch.tensor([1.0, np.pi / 6], **f64)
             + torch.randn(MC, 2, generator=gen, **f64) * torch.tensor([0.05, 0.1], **f64))
    cov = torch.diag(torch.tensor([0.05 ** 2, (np.pi / 10) ** 2], **f64)).expand(MC, 2, 2)
    m_mc, c_mc = truth_moments(torch, mtran, p2c, means, cov)

    def study(name, tf, mean, cov_in, f=p2c, truth=(m_mc, c_mc)):
        ms = cuda_ms(torch, lambda: tf.apply(f, mean, cov_in, 0), reps=3)[0]
        mf, cf, _ = tf.apply(f, mean, cov_in, 0)
        skl = symmetrized_kl_divergence(truth[0], truth[1], mf, cf)
        err = torch.linalg.vector_norm(mf - truth[0], dim=-1)
        if not (bool(torch.isfinite(skl).all()) and bool(torch.isfinite(err).all())):
            fail(f"classical transform {name}: non-finite moments or divergence")
        return (f"{name} {ms:.2f} ms, mean error {float(err.mean()):.3e}, "
                f"SKL {float(skl.mean()):.4e}")

    rows = [study("linearization", mtran.LinearizationTransform(2, device=dev), means, cov),
            study("MC-1000", mtran.MonteCarloTransform.create(2, n=1000, seed=1, device=dev),
                  means, cov)]
    for d in (2, 3, 5, 8):
        m_d = torch.cat([means, torch.zeros(MC, d - 2, **f64)], dim=-1)
        c_d = torch.block_diag(cov[0], torch.eye(d - 2, **f64)).expand(MC, d, d)
        rows.append(study(f"UT dim {d}", mtran.UnscentedTransform(d, device=dev), m_d, c_d))
        rows.append(study(f"TUT dim {d}", mtran.TruncatedUnscentedTransform(d, 2, device=dev),
                          m_d, c_d))
    log(f"classical polar2cartesian ({MC} input means, truth from {TRUTH_POINTS} MC points; "
        "ms = CUDA events, median of 3): " + "; ".join(rows))

    def sin_quad(x, time):
        return torch.sin(x) + 0.5 * x ** 2

    means1 = 0.5 + 0.3 * torch.randn(MC, 1, generator=gen, **f64)
    cov1 = torch.full((MC, 1, 1), 0.8, **f64)
    truth1 = truth_moments(torch, mtran, sin_quad, means1, cov1)
    kpar = np.array(GPQD_DEMO_RBF)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gpqd_tf = GaussianProcessDerTransform(1, 1, kpar, "ut", device=dev)
    torch.cuda.synchronize()
    gpqd_ms = (time.perf_counter() - t0) * 1e3
    rows = [study(name, tf, means1, cov1, sin_quad, truth1) for name, tf in (
        ("GPQ", GaussianProcessTransform(1, 1, kpar, "rbf", "ut", device=dev)),
        ("GPQ+D", gpqd_tf))]
    log(f"classical GPQ vs GPQ+D on sin(x) + x^2/2 ({MC} input means; GPQ+D weights built in "
        f"{gpqd_ms:.1f} ms): " + "; ".join(rows))

    torch.cuda.synchronize()
    if counters() != before:
        fail(f"the classical phase launched a kernel: counters {before} -> {counters()}")
    log(f"classical phase: no kernel launched (counters unchanged); card: {card_line()}")


#: phase 21, "bq_rest".  The RQ kernel's approximate Gaussian expectations
#: give a negative expected model variance at the GPQ lanes' length-scales,
#: and on reentry (l = 10) every run loses positive definiteness at alpha =
#: 1e3 and none at 1e4 (``tools/bq_rest_probes.py``): the lanes take l = 1 on
#: UNGM and alpha = 1e4 on reentry
RQ_UNGM = [[1.0, 2.0, 1.0]]
RQ_REENTRY = [[1.0, 1e4, 10.0, 10.0, 10.0, 10.0, 10.0]]
#: the per-call theta lanes: construction parameters and another theta.  The
#: gradient of the UNGM NLL is ill-conditioned in theta: a relative change
#: of 1e-15 in theta moves it by 4.9e-9 of its largest entry over 10 steps
#: and by 3.5e-6 over 100 (``tools/bq_rest_probes.py``, CPU), and the card's
#: 100-step gradient was 7.7e-3 off the CPU's: the card is held to the CPU
#: over GRAD_STEPS steps
THETA_STEPS, GRAD_STEPS = 100, 10
THETA_GPQ, THETA_GPQ_2 = [[1.0, 3.0]], [[1.3, 2.5]]
THETA_BSQ, THETA_BSQ_2 = [[3.0, 0.3]], [[2.0, 0.5]]
#: the IPLF setting of tests/test_ssmod_ssinf.py:511-530 (CV, poor prior,
#: precise radar)
IPLF_STEPS = 60
#: the UNGM prefix on which the fused and the eager engines are held
#: pointwise: the UNGM map grows rounding differences with the steps
#: (``tools/bq_rest_probes.py``, CPU, 200 runs of GPQ-RQ: 2.3e-10 of the
#: largest entry at 50 steps, 1.7e-9 at 500)
UNGM_PREFIX = 50
OPT_POINTS = 50


def bq_rest_slice(torch, np, dev, ungm, reentry, glint):
    """Phase 21, "bq_rest": the RQ kernel, per-call kernel parameters, the
    IPLF, the multi-output filters and GP optimization at MC trajectories on
    the card.  Returns the launches of the fused kernels in the lanes' first
    runs, ``{"scalar_filter", "vector_filter_shaped_bq", "vandermonde"}``.

    (a) GPQKF with the RQ kernel under ``engine="auto"``: UNGM (the main
    path's 10,000 x 500 data) through the scalar filter kernel and reentry
    (10,000 x 100) through the vector filter kernel of the BQ shapes, one launch
    each; each kernel's result equals its plain version on the same input to
    the bit, all five streams; against ``"f64"`` on the first
    ``CLASSICAL_CPU_B`` runs within 1e-9 of each stream's largest entry
    (UNGM over its first ``UNGM_PREFIX`` steps, whose filtered estimates read
    only those steps' data; the whole study's RMSE within 1e-3 relative).

    (b) Per-call kernel parameters on UNGM (10,000 x ``THETA_STEPS``) for the
    GPQKF (RBF) and the BSQKF: ``gaussian_filter`` with theta equal to the
    construction parameters gives the construction-time bits, with another
    theta the bits of a filter built at it; the gradient of the batch-mean
    NLL of the truth with respect to log theta (both transforms) against the
    same on the CPU (the filter's tensors copied there) over
    the first ``GRAD_STEPS`` steps within 1e-7 (the whole record's reported);
    the BSQ lane's Vandermonde launches are counted.

    (c) The IPLF on CV + precise radar (10,000 x ``IPLF_STEPS``): one
    iteration is the UKF within 1e-11, five iterations have a lower RMSE.

    (d) Multi-output filters: MO-GPQKF on UNGM (10,000 x 500) against the
    GPQKF's ``"f64"`` result (the first step within 1e-9 of each stream's
    largest entry, the study RMSE within 1e-6 relative; the weights agree to
    2.7e-14 and the UNGM map grows that to 2.2e-7 in 50 steps,
    ``tools/bq_rest_probes.py``); the MO-TP
    Student filter on the 1-D Student UNGM system of
    ``tests/test_ssmod_ssinf.py:341-362`` (10,000 x 100, 2e6 samples) with at
    most 1% of the runs not finite and its first ``CLASSICAL_CPU_B`` runs
    within 1e-9 of the CPU's, and on phase 8's CV glint data with its kernel
    parameters, where every run diverges on the composed weights (PERF.md):
    its non-finite share and its difference from the CPU reported.
    The MO-GPQKF's ``"dd"`` raises and ``"auto"`` gives ``"f64"``'s bits;
    none of the MO lanes launches a kernel.

    (e) ``GaussianProcessModel.optimize`` of a 1-D GP on the UNGM dynamics at
    ``OPT_POINTS`` points: NLML before and after, the optimum's NLML within
    1e-6 relative of the same call on the CPU.  The noiseless data drive the
    Gram to a condition number of ~5e16 at the optimum, BFGS stops on
    precision loss, and a 1e-14 change of the data moves the optimum by
    2.8e-4 in log parameters (``tools/bq_rest_probes.py``, CPU): where it
    lies is reported.
    """
    import ssmtoybox_torch as stt
    from ssmtoybox_torch import ssmod
    from ssmtoybox_torch.bq import GaussianProcessModel
    from ssmtoybox_torch.ops import scalar_filter as sf, student_mc as smc
    from ssmtoybox_torch.ops import vandermonde as vdm, vector_filter as vf
    from ssmtoybox_torch.utils import GaussRV, StudentRV

    def counters():
        return (sf.LAUNCHES, vf.LAUNCHES, vf.SHAPED_LAUNCHES, vdm.LAUNCHES,
                tuple(smc.LAUNCHES.values()))

    def rmse(x_true, res):
        r = torch.sqrt(torch.mean(torch.sum((res.fi_mean - x_true) ** 2, 1), -1))
        return float(r[torch.isfinite(r)].mean()), 1.0 - float(torch.isfinite(r).double().mean())

    def head(res, n=CLASSICAL_CPU_B, steps=None):
        return type(res)(*(getattr(res, f)[:n, ..., :steps] for f in res.__dataclass_fields__))

    t_phase = time.perf_counter()
    dyn_u, obs_u, xs_u, ys_u = ungm
    dyn_re, obs_re, xs_re, ys_re = reentry
    dyn_cv, obs_cv, xs_cv, ys_cv = glint
    B = CLASSICAL_CPU_B
    launches = {"scalar_filter": 0, "vector_filter_shaped_bq": 0, "vandermonde": 0}

    # ---- (a) GPQKF with the RQ kernel through the fused engines ------------
    rq_u = stt.GaussianProcessKalman(dyn_u, obs_u, np.array(RQ_UNGM), np.array(RQ_UNGM),
                                     kernel="rq")
    rq_re = stt.GaussianProcessKalman(dyn_re, obs_re, np.array(RQ_REENTRY),
                                      np.array(RQ_REENTRY), kernel="rq")
    torch.cuda.synchronize()
    for lane, alg, x_true, ys, lib, key in (
            ("UNGM", rq_u, xs_u, ys_u, sf, "scalar_filter"),
            ("reentry", rq_re, xs_re, ys_re, vf, "vector_filter_shaped_bq")):
        what = f"bq_rest GPQKF-RQ {lane} ({MC}x{ys.shape[-1]})"
        n0, vf0 = lib.LAUNCHES, vf_counts(vf)
        res = alg.forward_pass_batch(ys, engine="auto")
        torch.cuda.synchronize()
        n = lib.LAUNCHES - n0
        vf_moved = {k: v - vf0[k] for k, v in vf_counts(vf).items()}
        if lib is vf:
            n = vf_moved[key]
        if n != 1 or sum(vf_moved.values()) != int(lib is vf):
            fail(f"{what}: engine='auto' launched {key} {n} times (vector filter kernels "
                 f"{vf_moved}); expected {key} once")
        launches[key] += n
        if lib is sf:
            params = sf.prepare(dyn_u, obs_u, alg.tf_dyn, alg.tf_obs)
            y_tm = ys[:, 0, :].T.contiguous()
            c = torch.as_tensor(sf.ungm_consts(ys.shape[-1]), device=dev)
            plain = sf._scalar_filter_plain(params, y_tm, c)
            got = (res.fi_mean[:, 0].T, res.fi_cov[:, 0, 0].T, res.pr_mean[:, 0].T,
                   res.pr_cov[:, 0, 0].T, res.pr_xx_cov[:, 0, 0].T)
            if not all(same_bits(torch, a, b) for a, b in zip(got, plain)):
                fail(f"{what}: the kernel's streams differ from the plain version's")
            steps = UNGM_PREFIX
        else:
            params = vf.prepare(dyn_re, obs_re, alg.tf_dyn, alg.tf_obs)
            if vf.kernel_of(params) != "vector_filter_shaped_bq":
                fail(f"{what}: runs {vf.kernel_of(params)}, expected the BQ shapes")
            plain = vf._vector_filter_plain(params, ys)
            vf_against_plain(torch, res, plain, what)
            steps = None
        ref = alg.forward_pass_batch(ys[:B, :, :steps], engine="f64")
        err = streams_err(torch, head(res, B, steps), ref.__class__(
            *(getattr(ref, f).cpu() for f in ref.__dataclass_fields__)))
        f_ms, _ = event_ms(torch, lambda: alg.forward_pass_batch(ys, engine="auto"))
        e_ms, full = event_ms(torch, lambda: alg.forward_pass_batch(ys, engine="f64"))
        (r_k, lost), (r_e, _) = rmse(x_true, res), rmse(x_true, full)
        log(f"{what}: {key} kernel once, == its plain version to the bit (5 streams); vs "
            f"'f64' on the first {B} runs" + (f" x {steps} steps" if steps else "")
            + f" {err:.2e} of each stream's largest entry (limit 1e-9); RMSE kernel "
            f"{r_k:.6f}, eager {r_e:.6f} (relative {abs(r_k - r_e) / r_e:.2e}, limit 1e-3), "
            f"not finite {lost:.2%}; 'auto' {f_ms:.1f} ms, 'f64' {e_ms:.1f} ms (CUDA events)")
        if not err <= 1e-9:
            fail(f"{what}: 'auto' is {err:.3e} off 'f64' (limit 1e-9)")
        if not abs(r_k - r_e) / r_e < 1e-3 or lost > 0.01:
            fail(f"{what}: RMSE {r_k} vs eager {r_e}, {lost:.2%} not finite")
        del res, ref, full, plain

    # ---- (b) per-call kernel parameters -----------------------------------
    xs_t, ys_t = xs_u[..., :THETA_STEPS].contiguous(), ys_u[..., :THETA_STEPS].contiguous()
    f64 = dict(dtype=torch.float64, device=dev)
    for lane, make, par, par_2 in (
            ("GPQKF", lambda p, q: stt.GaussianProcessKalman(dyn_u, obs_u, p, q),
             THETA_GPQ, THETA_GPQ_2),
            ("BSQKF", lambda p, q: stt.BayesSardKalman(dyn_u, obs_u, p, q),
             THETA_BSQ, THETA_BSQ_2)):
        what = f"bq_rest theta {lane} ({MC}x{THETA_STEPS})"
        alg = make(np.array(par), np.array(par))
        base = stt.gaussian_filter(dyn_u, obs_u, alg.tf_dyn, alg.tf_obs, ys_t)
        n0 = vdm.LAUNCHES
        same = stt.gaussian_filter(dyn_u, obs_u, alg.tf_dyn, alg.tf_obs, ys_t,
                                   theta_dyn=torch.tensor(par, **f64),
                                   theta_obs=torch.tensor(par, **f64))
        torch.cuda.synchronize()
        n_vdm = vdm.LAUNCHES - n0
        launches["vandermonde"] += n_vdm
        other = stt.gaussian_filter(dyn_u, obs_u, alg.tf_dyn, alg.tf_obs, ys_t,
                                    theta_dyn=torch.tensor(par_2, **f64),
                                    theta_obs=torch.tensor(par_2, **f64))
        built = make(np.array(par_2), np.array(par_2)).forward_pass_batch(ys_t, engine="f64")
        for f in base.__dataclass_fields__:
            if not torch.equal(getattr(same, f), getattr(base, f)):
                fail(f"{what}: theta = the construction parameters changed {f}")
            if not torch.equal(getattr(other, f), getattr(built, f)):
                fail(f"{what}: theta = {par_2} differs from a filter built at it in {f}")

        def grad(tf_dyn, tf_obs, dyn, obs, ys, xs, device):
            lt = torch.log(torch.tensor(par_2, dtype=torch.float64, device=device))
            lt_d, lt_o = lt.clone().requires_grad_(True), lt.clone().requires_grad_(True)
            res = stt.gaussian_filter(dyn, obs, tf_dyn, tf_obs, ys, theta_dyn=lt_d.exp(),
                                      theta_obs=lt_o.exp())
            var = res.fi_cov[:, 0]
            nll = 0.5 * torch.mean((res.fi_mean - xs) ** 2 / var + torch.log(2 * np.pi * var))
            return (nll.detach(),) + torch.autograd.grad(nll, (lt_d, lt_o))

        g_ms, (nll, *g_card) = event_ms(torch, lambda: grad(
            alg.tf_dyn, alg.tf_obs, dyn_u, obs_u, ys_t, xs_t, dev))
        cpu = on_cpu(torch, alg)
        g_err = {}
        for n in (GRAD_STEPS, THETA_STEPS):
            card = g_card if n == THETA_STEPS else grad(
                alg.tf_dyn, alg.tf_obs, dyn_u, obs_u, ys_t[..., :n], xs_t[..., :n], dev)[1:]
            _, *g_cpu = grad(cpu.tf_dyn, cpu.tf_obs, cpu.mod_dyn, cpu.mod_obs,
                             ys_t[..., :n].cpu(), xs_t[..., :n].cpu(), "cpu")
            g_err[n] = max(rel_err(a.cpu(), b) for a, b in zip(card, g_cpu))
        t_ms, _ = event_ms(torch, lambda: stt.gaussian_filter(
            dyn_u, obs_u, alg.tf_dyn, alg.tf_obs, ys_t, theta_dyn=torch.tensor(par_2, **f64),
            theta_obs=torch.tensor(par_2, **f64)))
        b_ms, _ = event_ms(torch, lambda: stt.gaussian_filter(dyn_u, obs_u, alg.tf_dyn,
                                                              alg.tf_obs, ys_t))
        log(f"{what}: theta = construction parameters gives the construction-time bits, theta "
            f"= {par_2} the bits of a filter built at it; batch-mean NLL {nll.item():.6f}, "
            f"d/d log theta dyn {g_card[0].cpu().numpy().round(6).tolist()}, obs "
            f"{g_card[1].cpu().numpy().round(6).tolist()}; card vs CPU, relative: the gradient "
            f"over the first {GRAD_STEPS} steps {g_err[GRAD_STEPS]:.2e} (limit 1e-7), over "
            f"all {THETA_STEPS} {g_err[THETA_STEPS]:.2e} (reported); Vandermonde launches "
            f"{n_vdm}; filter with theta {t_ms:.1f} ms, without {b_ms:.1f} ms, filter + "
            f"gradient {g_ms:.1f} ms (CUDA events)")
        if not g_err[GRAD_STEPS] <= 1e-7:
            fail(f"{what}: the card's gradient over {GRAD_STEPS} steps is "
                 f"{g_err[GRAD_STEPS]:.3e} off the CPU's (limit 1e-7)")
        if lane == "BSQKF" and n_vdm < 2:
            fail(f"{what}: {n_vdm} Vandermonde launches re-deriving the weights; expected 2")
        del base, same, other, built

    before = counters()
    # ---- (c) the IPLF on CV + precise radar ---------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED + 21)
    x0 = GaussRV(4, mean=np.array([100., 2., 100., -1.]),
                 cov=np.diag([400.0, 25.0, 400.0, 25.0]), device=dev)
    dyn_i = ssmod.ConstantVelocity(x0, GaussRV(2, cov=0.1 * np.eye(2), device=dev), dt=0.5)
    obs_i = ssmod.Radar2DMeasurement(GaussRV(2, cov=np.diag([1.0, 1e-4]), device=dev),
                                     dim_state=4, state_index=[0, 2])
    x_i = dyn_i.simulate_discrete(gen, steps=IPLF_STEPS, mc_sims=MC)
    xs_i, ys_i = x_i.permute(2, 0, 1), obs_i.simulate_measurements(gen, x_i).permute(2, 0, 1)
    what = f"bq_rest IPLF CV + precise radar ({MC}x{IPLF_STEPS})"
    ukf = stt.UnscentedKalman(dyn_i, obs_i).forward_pass_batch(ys_i, engine="f64")
    rows = []
    for it in (1, 5):
        alg = stt.IteratedPosteriorLinearizationKalman(dyn_i, obs_i, iterations=it)
        i_ms, res = event_ms(torch, lambda: alg.forward_pass_batch(ys_i))
        s_ms, (sm, _) = event_ms(torch, lambda: stt.gaussian_smoother(res))
        (r, lost), r_sm = rmse(xs_i, res), float(
            torch.sqrt(torch.mean(torch.sum((sm - xs_i) ** 2, 1), -1)).nanmean())
        rows.append((it, r, lost, r_sm, i_ms, s_ms))
        if it == 1:
            err1 = streams_err(torch, res, ukf.__class__(
                *(getattr(ukf, f).cpu() for f in ukf.__dataclass_fields__)))
    r_ukf = rmse(xs_i, ukf)[0]
    log(f"{what}: one iteration vs the UKF {err1:.2e} of each stream's largest entry (limit "
        f"1e-11); UKF RMSE {r_ukf:.6f}; " + "; ".join(
            f"{it} iteration(s): RMSE filter {r:.6f}, smoother {r_sm:.6f}, not finite "
            f"{lost:.2%}, filter {i_ms:.1f} ms, smoother {s_ms:.1f} ms" for
            it, r, lost, r_sm, i_ms, s_ms in rows))
    if not err1 <= 1e-11:
        fail(f"{what}: one iteration is {err1:.3e} off the UKF (limit 1e-11)")
    if not rows[1][1] < rows[0][1] or rows[1][2] > 0.01:
        fail(f"{what}: five iterations' RMSE {rows[1][1]} not below one's {rows[0][1]}, or "
             f"{rows[1][2]:.2%} not finite")
    del ukf, res, sm

    # ---- (d) multi-output filters ------------------------------------------
    kpar = np.array(THETA_GPQ)
    what = f"bq_rest MO-GPQKF UNGM ({MC}x{ys_u.shape[-1]})"
    mo = stt.MultiOutputGaussianProcessKalman(dyn_u, obs_u, kpar, kpar)
    try:
        mo.forward_pass_batch(ys_u[:7], engine="dd")
    except ValueError as e:
        reason = str(e).split(": ", 1)[-1]
    else:
        fail(f"{what}: engine='dd' ran a multi-output transform")
    res = mo.forward_pass_batch(ys_u, engine="auto")
    m_ms, ref = event_ms(torch, lambda: mo.forward_pass_batch(ys_u, engine="f64"))
    if not all(torch.equal(getattr(res, f), getattr(ref, f)) for f in res.__dataclass_fields__):
        fail(f"{what}: engine='auto' and engine='f64' differ")
    g_ms, gpq = event_ms(torch, lambda: stt.GaussianProcessKalman(
        dyn_u, obs_u, kpar, kpar).forward_pass_batch(ys_u, engine="f64"))
    err1, err = (streams_err(torch, head(res, MC, n), gpq.__class__(
        *(getattr(head(gpq, MC, n), f).cpu() for f in gpq.__dataclass_fields__)))
        for n in (1, UNGM_PREFIX))
    (r_mo, lost), (r_so, _) = rmse(xs_u, res), rmse(xs_u, gpq)
    log(f"{what}: 'dd' refused: {reason}; 'auto' == 'f64' to the bit; vs the GPQKF: first "
        f"step {err1:.2e} of each stream's largest entry (limit 1e-9), first {UNGM_PREFIX} "
        f"steps {err:.2e} (reported: the UNGM map grows the weights' rounding), RMSE "
        f"{r_mo:.6f} vs {r_so:.6f} (relative {abs(r_mo - r_so) / r_so:.2e}, limit 1e-6), not "
        f"finite {lost:.2%}; MO-GPQKF {m_ms:.1f} ms, GPQKF {g_ms:.1f} ms (CUDA events)")
    if not err1 <= 1e-9 or not abs(r_mo - r_so) / r_so < 1e-6:
        fail(f"{what}: {err1:.3e} off the GPQKF at the first step, RMSE relative "
             f"{abs(r_mo - r_so) / r_so:.3e}")
    del res, ref, gpq

    gen = torch.Generator(device=dev).manual_seed(SEED + 22)
    dyn_st = ssmod.UNGMTransition(StudentRV(1, dof=4.0, device=dev),
                                  StudentRV(1, scale=10.0, dof=4.0, device=dev))
    obs_st = ssmod.UNGMMeasurement(StudentRV(1, scale=0.01, dof=4.0, device=dev), dim_state=1)
    x_st = dyn_st.simulate_discrete(gen, steps=CV_STEPS, mc_sims=MC)
    xs_st, ys_st = x_st.permute(2, 0, 1), obs_st.simulate_measurements(gen, x_st).permute(2, 0, 1)
    mo_lanes = (
        ("Student UNGM", (dyn_st, obs_st, np.array([[1.0, 1.0]]), np.array([[1.0, 1.0]])),
         {}, xs_st, ys_st, True),
        ("CV glint", (dyn_cv, obs_cv, np.tile(PAR_DYN, (4, 1)), np.tile(PAR_OBS, (2, 1))),
         {"point_par": {"kappa": 0.0}}, xs_cv, ys_cv, False))
    for system, args, kw, x_true, ys, gated in mo_lanes:
        what = f"bq_rest MO-TP Student filter {system} ({MC}x{ys.shape[-1]})"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        alg = stt.MultiOutputStudentProcessStudent(*args, dof=4.0, dof_tp=4.0,
                                                   mc_opts={"num_samples": STUDENT_MC}, **kw)
        torch.cuda.synchronize()
        build_ms = (time.perf_counter() - t0) * 1e3
        f_ms, res = event_ms(torch, lambda: alg.forward_pass_batch(ys))
        r, lost = rmse(x_true, res) if bool(torch.isfinite(res.fi_mean).any()) else (
            float("nan"), 1.0)
        cpu = on_cpu(torch, alg).forward_pass_batch(ys[:B].cpu())
        err = streams_err(torch, head(res), cpu)
        log(f"{what}: weights built in {build_ms:.1f} ms ({STUDENT_MC} samples), filter "
            f"{f_ms:.1f} ms (CUDA events); RMSE {r:.6f}, not finite {lost:.2%}; first {B} "
            f"runs vs the CPU {err:.2e} of each stream's largest entry "
            + ("(limits 1% and 1e-9)" if gated else
               "(reported: every run diverges on the composed MO weights, PERF.md)"))
        if gated and (lost > 0.01 or not err <= 1e-9):
            fail(f"{what}: {lost:.2%} of the runs not finite (limit 1%), the card's streams "
                 f"{err:.3e} off the CPU's (limit 1e-9)")
        del res, cpu
    torch.cuda.synchronize()
    if counters() != before:
        fail(f"the IPLF and MO lanes launched a kernel: counters {before} -> {counters()}")

    # ---- (e) GP hyper-parameter optimization --------------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED + 23)
    x_obs = 20.0 * torch.rand(1, OPT_POINTS, generator=gen, **f64) - 10.0
    y_obs = dyn_u.dyn_eval(x_obs.T, 0)                                    # (N, 1)
    lp0 = np.log([10.0, 2.0])
    out = {}
    for device in (dev, "cpu"):
        gp = GaussianProcessModel(1, [[1.0, 1.0]], "rbf", "ut", device=device)
        jit = 1e-8 * torch.eye(OPT_POINTS, dtype=torch.float64, device=device)
        nlml0 = float(gp.neg_log_marginal_likelihood(torch.as_tensor(lp0, device=device),
                                                     y_obs.to(device), x_obs.to(device), jit))
        t0 = time.perf_counter()
        opt = gp.optimize(lp0, y_obs, x_obs)
        out[str(device)] = (opt, nlml0, (time.perf_counter() - t0) * 1e3)
    (opt, nlml0, o_ms), (opt_c, _, o_ms_c) = out[str(dev)], out["cpu"]
    d_fun = abs(opt.fun - opt_c.fun) / abs(opt_c.fun)
    d_x = float(np.abs(opt.x - opt_c.x).max())
    log(f"bq_rest GP optimize (UNGM dynamics at {OPT_POINTS} points, BFGS): NLML {nlml0:.6f} "
        f"-> {opt.fun:.9f} in {opt.nit} iterations ({o_ms:.0f} ms on the card, {o_ms_c:.0f} "
        f"ms on the CPU, host clock; SciPy: {opt.message}); card vs CPU: the optimum's NLML "
        f"{d_fun:.2e} relative (limit 1e-6), log parameters {opt.x.round(6).tolist()} vs "
        f"{opt_c.x.round(6).tolist()}, {d_x:.2e} apart (reported: the Gram at the optimum "
        "is near singular, PERF.md)")
    if not (opt.fun < nlml0 and d_fun <= 1e-6):
        fail(f"bq_rest GP optimize: NLML {nlml0} -> {opt.fun}, card vs CPU {d_fun:.3e}")
    log(f"bq_rest phase: launches {launches}, {time.perf_counter() - t_phase:.1f} s in all; "
        f"card: {card_line()}")
    return launches


def profile_split(torch, fn, top=4):
    """One call of ``fn`` under ``torch.profiler`` (after a warm-up):
    ``(wall ms, device-busy ms, device activities, top)``, ``top`` the
    ``(name, ms, count)`` of the device kernels with the most time.  Only
    device activity is recorded: the host's operator records of a
    launch-bound call (a marginalized UNGM step makes ~58,000 launches) took
    about a minute to parse, and nothing here reads them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name[:60], (0.0, 0))
            by_name[e.name[:60]] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_name.values())
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return wall, busy, sum(n for _, n in by_name.values()), [(k, ms, n) for k, (ms, n) in ranked]


#: the marginalized UNGM study (experiments/marginal_ungm.py:47-52,66-73):
#: 15 Newton iterations, damping 1e-2, cut to MARGINAL_STEPS steps (PERF.md:
#: a float64 call of 100 steps takes longer than 60 s)
MARGINAL_STEPS = 15
MARGINAL_ITERS = 15
MARGINAL_DAMPING = 1e-2
#: the CPU comparison's depth: its gate reads step 1 (cut from 5 for time)
MARGINAL_CPU_STEPS = 2
#: step 1 of the card against the CPU (PERF.md, PR 13: rounding decides the
#: converged search's last steps; 1.5e-8 was measured on one run of 200)
MARGINAL_STEP1_TOL = 1e-7
#: a marginalized UNGM run off the truth by more than this has diverged
DIVERGED_ERR = 1e3
#: the golden BFGS run's limit: RMSE below 1.25x the reference's
#: (tests/test_parity.py:480-500)
BFGS_RMSE_FACTOR = 1.25
ONLINE_STEPS = 100
ONLINE_LAG = 5
ONLINE_CUTS = (5, 50, 100)


def marginal_online_slice(torch, np, dev, ungm):
    """Phase 22, "marginal_online": marginalized-parameter inference and the
    streaming API on the card, eager; no kernel may launch.

    (a) ``MarginalizedGaussianProcessKalman.forward_pass_batch`` on the main
    path's UNGM data (10,000 runs, seed 0, the study's system) cut to
    ``MARGINAL_STEPS`` steps, 15 Newton iterations, damping 1e-2, with the
    float64 and the float32 search: a warm-up call on two steps under
    ``torch.cuda.set_sync_debug_mode("error")`` (nothing reads the card),
    then one call each timed with CUDA events, whose first two steps are
    compared with the warm-up's bits (the runs that differ are counted);
    RMSE, NCI and NLL (means over the runs that did not diverge, and per-run
    medians) beside the UKF and the fixed-parameter GPQKF (``[[1, 1]]``) on
    the same data; one float64 step under the profiler.  A run diverged when
    a score is not finite, as in the JAX study harness, or when its estimate
    is off the truth by more than ``DIVERGED_ERR`` (a UNGM state stays
    within some 50 of 0): a run whose parameter nodes reach far past the
    box can end finite but huge, and through the NCI's normaliser, the
    runs' mean squared error, it would move every run's NCI.  Gates: at
    most 1% of the runs diverged; each lane's NCI and NLL below the fixed
    GPQKF's (the marginalized study's conclusion, which phase 26 leaves to
    this phase); the first ``CLASSICAL_CPU_B`` runs' first step within
    ``MARGINAL_STEP1_TOL`` of the same filter on the CPU (its tensors copied
    from the card's), the median and the 99th percentile printed, the gap
    over ``MARGINAL_CPU_STEPS`` steps reported.  Why 1e-7 (PERF.md, PR 13):
    once the search has converged, its "not increasing" test compares two
    values equal up to rounding, so rounding decides its last steps.

    (b) The SciPy-BFGS path (``forward_pass``) on
    ``tests/goldens/marginal_ungm.npz`` (20 steps) on the card: RMSE below
    1.25x the golden's, its time on the host clock.

    (c) ``make_online_filter(batch=True)`` on 10,000 UKF targets streamed
    over the data's first ``ONLINE_STEPS`` steps: the final state equal to
    ``gaussian_filter_batch(engine="f64")`` within 1e-12 of each stream's
    largest entry; per-step latency at batch 1 (one target, unbatched) and
    10,000 (CUDA events over the stream); ``make_fixed_lag_smoother`` with
    lag 5 on the same targets, its output at steps ``ONLINE_CUTS`` against
    ``gaussian_smoother(rts_full=True)`` of the record cut there (1e-12); a
    state saved with ``save_pytree`` at step 50 and restored with
    ``restore_pytree`` resumes to the bits of the stream that was not saved.
    """
    import tempfile

    import ssmtoybox_torch as stt
    from ssmtoybox_torch.online import make_fixed_lag_smoother, make_online_filter
    from ssmtoybox_torch.ops import scalar_filter as sf, student_mc as smc
    from ssmtoybox_torch.ops import vandermonde as vdm, vector_filter as vf
    from ssmtoybox_torch.ssmod import UNGMMeasurement, UNGMTransition
    from ssmtoybox_torch.utils import GaussRV
    from ssmtoybox_torch.utils.checkpoint import restore_pytree, save_pytree

    def counters():
        return (sf.LAUNCHES, vf.LAUNCHES, vf.SHAPED_LAUNCHES, vdm.LAUNCHES,
                tuple(smc.LAUNCHES.values()))

    def scores(x_true, res):
        """RMSE, NCI and NLL means over the runs that did not diverge, NCI and
        NLL medians, the runs off the truth by more than ``DIVERGED_ERR``,
        the share diverged (those, and the runs with a score not finite)."""
        err = (res.fi_mean - x_true).abs().flatten(1).nan_to_num(nan=torch.inf)
        far = err.max(1).values > DIVERGED_ERR
        keep = ~far
        rmse, _, nll, nci = study_scores(torch, x_true[keep], res.fi_mean[keep],
                                         res.fi_cov[keep])
        ok = torch.isfinite(rmse) & torch.isfinite(nll) & torch.isfinite(nci)
        return (float(rmse[ok].mean()), float(nci[ok].mean()), float(nll[ok].mean()),
                float(nci[ok].median()), float(nll[ok].median()),
                int((far & torch.isfinite(res.fi_mean).flatten(1).all(1)).sum()),
                1.0 - float(ok.sum()) / x_true.shape[0])

    def head(res, n, steps=None):
        return type(res)(*(getattr(res, f)[:n, ..., :steps].cpu()
                           for f in res.__dataclass_fields__))

    t_phase = time.perf_counter()
    before = counters()
    dyn, obs, xs_u, ys_u = ungm
    B = CLASSICAL_CPU_B

    # ---- (a) the marginalized filter, batch path ----------------------------
    xs, ys = xs_u[..., :MARGINAL_STEPS].contiguous(), ys_u[..., :MARGINAL_STEPS].contiguous()
    alg = stt.MarginalizedGaussianProcessKalman(dyn, obs)
    kw = dict(newton_iters=MARGINAL_ITERS, damping=MARGINAL_DAMPING)
    rows, repeat = {}, {}
    for name, inner in (("MGPQKF f64", None), ("MGPQKF f32", "float32")):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            warm = alg.forward_pass_batch(ys[..., :2], inner_dtype=inner, **kw)
            torch.cuda.synchronize()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        ms, res = event_ms(torch, lambda: alg.forward_pass_batch(ys, inner_dtype=inner, **kw))
        repeat[name] = int((res.fi_mean[..., :2] != warm.fi_mean).flatten(1).any(1).sum())
        rows[name] = (ms, res) + scores(xs, res)
    kp = np.ones((1, 2))
    for name, base in (("UKF", stt.UnscentedKalman(dyn, obs)),
                       ("GPQKF-fix", stt.GaussianProcessKalman(dyn, obs, kp, kp))):
        base.forward_pass_batch(ys[..., :2], engine="f64")
        ms, res = event_ms(torch, lambda: base.forward_pass_batch(ys, engine="f64"))
        rows[name] = (ms, res) + scores(xs, res)
    cpu_alg = on_cpu(torch, alg)
    gaps = {}
    for name, inner in (("MGPQKF f64", None), ("MGPQKF f32", "float32")):
        cpu = cpu_alg.forward_pass_batch(ys[:B, :, :MARGINAL_CPU_STEPS].cpu(), inner_dtype=inner,
                                         **kw)
        card = head(rows[name][1], B, MARGINAL_CPU_STEPS)
        step1 = torch.stack([
            (getattr(card, f)[..., 0] - getattr(cpu, f)[..., 0]).flatten(1).abs().max(1).values
            / getattr(cpu, f)[..., 0].abs().max() for f in card.__dataclass_fields__]).max(0).values
        gaps[name] = (float(step1.median()), float(step1.quantile(0.99)), float(step1.max()),
                      streams_err(torch, card, cpu))
    what = f"marginal UNGM ({MC}x{MARGINAL_STEPS}, {MARGINAL_ITERS} Newton iterations, damping " \
           f"{MARGINAL_DAMPING})"
    for name, (ms, res, r, nci, nll, nci_med, nll_med, huge, lost) in rows.items():
        extra = ""
        if name in gaps:
            med, p99, top, later = gaps[name]
            extra = (f"; first {B} runs vs the CPU, step 1 (each run's largest gap over the "
                     f"streams, relative to the stream's largest entry): median {med:.2e}, 99th "
                     f"percentile {p99:.2e}, max {top:.2e}; steps 1-{MARGINAL_CPU_STEPS} "
                     f"{later:.2e}; runs whose first two steps differ from the warm-up call's "
                     f"bits {repeat[name]}")
        log(f"{what} {name}: {ms:.1f} ms (CUDA events, one call; {ms / MARGINAL_STEPS:.1f} ms a "
            f"step), RMSE {r:.6f}, NCI {nci:.6f} (median {nci_med:.6f}), NLL {nll:.6f} (median "
            f"{nll_med:.6f}); diverged {lost:.2%}, {huge} of them finite but off the truth by "
            f"more than {DIVERGED_ERR:g}" + extra)
    m64, fix = rows["MGPQKF f64"], rows["GPQKF-fix"]
    for name in ("MGPQKF f64", "MGPQKF f32"):
        if rows[name][-1] > 0.01:
            fail(f"{what} {name}: {rows[name][-1]:.2%} of the runs diverged (limit 1%)")
    for name in ("MGPQKF f64", "MGPQKF f32"):
        m = rows[name]
        if not (m[3] < fix[3] and m[4] < fix[4]):
            fail(f"{what} {name}: the marginalized filter's NCI {m[3]} / NLL {m[4]} not below "
                 f"the fixed GPQKF's {fix[3]} / {fix[4]}")
    if not gaps["MGPQKF f64"][2] <= MARGINAL_STEP1_TOL:
        fail(f"{what}: the first step is {gaps['MGPQKF f64'][2]:.3e} off the CPU's (limit "
             f"{MARGINAL_STEP1_TOL})")
    log(f"{what}: the warm-up calls of both searches ran under sync debug mode 'error' (no "
        f"read-back from the card); a float64 call of 100 steps would take "
        f"~{m64[0] * 100 / MARGINAL_STEPS / 1e3:.0f} s at this rate")
    wall, busy, n_dev, top = profile_split(torch, lambda: alg.forward_pass_batch(ys[..., :1], **kw))
    log(f"{what}: one float64 step under torch.profiler: wall {wall:.1f} ms, device busy "
        f"{busy:.1f} ms ({busy / wall:.1%}), {n_dev} device activities; top: "
        + "; ".join(f"{name} {ms:.1f} ms in {n}" for name, ms, n in top))
    del rows, cpu_alg

    # ---- (b) the SciPy-BFGS path on the golden ------------------------------
    g = np.load(os.path.join(HERE, "tests", "goldens", "marginal_ungm.npz"))
    dyn_g = UNGMTransition(GaussRV(1, cov=1.0, device=dev), GaussRV(1, cov=10.0, device=dev))
    obs_g = UNGMMeasurement(GaussRV(1, cov=1.0, device=dev), dim_state=1)
    bfgs = stt.MarginalizedGaussianProcessKalman(dyn_g, obs_g)
    y_g = torch.as_tensor(g["y"], device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fm, fP = bfgs.forward_pass(y_g)
    torch.cuda.synchronize()
    b_ms = (time.perf_counter() - t0) * 1e3
    r_b = float(np.sqrt(np.mean((fm.cpu().numpy() - g["x"]) ** 2)))
    r_ref = float(g["rmse"][0])
    log(f"marginal BFGS golden (20 steps): {b_ms:.0f} ms (host clock), RMSE {r_b:.6f} against "
        f"the golden's {r_ref:.6f} (limit {BFGS_RMSE_FACTOR}x)")
    if not (bool(torch.isfinite(fm).all()) and bool((fP > 0).all())
            and r_b < BFGS_RMSE_FACTOR * r_ref):
        fail(f"marginal BFGS golden: RMSE {r_b} (limit {BFGS_RMSE_FACTOR * r_ref}) or a "
             "non-finite / non-positive moment")

    # ---- (c) streaming filter and fixed-lag smoother ------------------------
    ukf = stt.UnscentedKalman(dyn, obs)
    y_on = ys_u[..., :ONLINE_STEPS]
    ref = stt.gaussian_filter_batch(dyn, obs, ukf.tf_dyn, ukf.tf_obs, y_on, engine="f64")
    what = f"online UKF ({MC} targets x {ONLINE_STEPS} steps)"

    def stream(batch, targets, steps, state=None, start=0):
        init, step = make_online_filter(dyn, obs, ukf.tf_dyn, ukf.tf_obs, batch=batch)
        state = (init(batch_size=targets) if batch else init()) if state is None else state
        for k in range(start, steps):
            state, _ = step(state, y_on[:targets, :, k] if batch else y_on[0, :, k])
        return state

    stream(True, MC, 2)
    stream(False, 1, 2)
    lat = {}
    for label, batch, targets in (("batch 1", False, 1), (f"batch {MC}", True, MC)):
        ms, state = event_ms(torch, lambda: stream(batch, targets, ONLINE_STEPS))
        lat[label] = ms / ONLINE_STEPS
        want_m = ref.fi_mean[:targets, :, -1]
        want_P = ref.fi_cov[:targets, :, :, -1]
        got_m, got_P = (state.mean, state.cov) if batch else (state.mean[None], state.cov[None])
        err = max(rel_err(got_m, want_m), rel_err(got_P, want_P))
        log(f"{what}, {label}: final state vs gaussian_filter_batch(engine='f64') {err:.2e} of "
            f"each stream's largest entry (limit 1e-12); {lat[label] * 1e3:.1f} us a step "
            f"(CUDA events over the stream, eager; no replay: PERF.md)")
        if not err <= 1e-12 or int(state.step.reshape(-1)[0]) != ONLINE_STEPS + 1:
            fail(f"{what}, {label}: final state {err:.3e} off the batch filter (limit 1e-12)")

    wall, busy, n_dev, top = profile_split(torch, lambda: stream(True, MC, 1))
    log(f"{what}: one step at batch {MC} under torch.profiler: wall {wall:.2f} ms, device busy "
        f"{busy:.2f} ms ({busy / wall:.1%}), {n_dev} device activities; top: "
        + "; ".join(f"{name} {ms:.2f} ms in {n}" for name, ms, n in top))

    init, step = make_fixed_lag_smoother(dyn, obs, ukf.tf_dyn, ukf.tf_obs, lag=ONLINE_LAG,
                                         batch=True)
    state = init(batch_size=MC)
    fl_err = 0.0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    emitted = {}
    for k in range(1, ONLINE_STEPS + 1):
        state, _, (sm_m, sm_P) = step(state, y_on[..., k - 1])
        if k in ONLINE_CUTS:
            emitted[k] = (sm_m.clone(), sm_P.clone())
    torch.cuda.synchronize()
    fl_us = (time.perf_counter() - t0) / ONLINE_STEPS * 1e6
    for k, (sm_m, sm_P) in emitted.items():
        cut = stt.gaussian_filter_batch(dyn, obs, ukf.tf_dyn, ukf.tf_obs, y_on[..., :k],
                                        engine="f64")
        sm_all, sP_all = stt.gaussian_smoother(cut, rts_full=True)
        fl_err = max(fl_err, rel_err(sm_m, sm_all[..., k - ONLINE_LAG]),
                     rel_err(sm_P, sP_all[..., k - ONLINE_LAG]))
    log(f"online fixed-lag smoother (lag {ONLINE_LAG}, {MC} targets): output at steps "
        f"{ONLINE_CUTS} vs the offline RTS of the record cut there {fl_err:.2e} (limit 1e-12); "
        f"{fl_us:.1f} us a step (host clock)")
    if not fl_err <= 1e-12:
        fail(f"online fixed-lag smoother: {fl_err:.3e} off the offline RTS (limit 1e-12)")

    half = ONLINE_STEPS // 2
    mid = stream(True, MC, half)
    with tempfile.TemporaryDirectory() as tmp:
        path = save_pytree(os.path.join(tmp, "online"), mid)
        restored = restore_pytree(path, like=mid)
    on_card_ok = all(t.device == mid.mean.device for t in (restored.mean, restored.cov,
                                                           restored.step))
    a = stream(True, MC, ONLINE_STEPS, state=mid, start=half)
    b = stream(True, MC, ONLINE_STEPS, state=restored, start=half)
    same = torch.equal(a.mean, b.mean) and torch.equal(a.cov, b.cov)
    log(f"online checkpoint: state at step {half + 1} saved and restored (on the card: "
        f"{on_card_ok}), resumed to step {ONLINE_STEPS + 1}: equal to the bit {same}")
    if not (on_card_ok and same):
        fail("online checkpoint: the restored state did not resume to the same bits")

    torch.cuda.synchronize()
    if counters() != before:
        fail(f"the marginal and online lanes launched a kernel: counters {before} -> "
             f"{counters()}")
    log(f"marginal_online phase: {time.perf_counter() - t_phase:.1f} s in all; card: "
        f"{card_line()}")


#: the square-root phase: runs held against the CPU, the streaming lanes;
#: the UNGM prefix held pointwise (PERF.md: the map grows rounding
#: differences of 1e-16 to 1e-8 in some of 10,000 runs by step 50)
SQRT_CPU_B = 200
SQRT_UNGM_PREFIX = 20
#: the float32 reentry lane's means against its float64 lane, relative to
#: the largest entry: the JAX package's bound (tests/test_sqrt.py:157-170)
SQRT_F32_REENTRY_TOL = 1e-2
SQRT_ONLINE_STEPS = 100
SQRT_LAG = 5
SQRT_CUTS = (5, 50, 100)


def sqrt_slice(torch, np, dev, ungm, reentry, glint):
    """Phase 23, "sqrt": the square-root filters and smoothers
    (``ssmtoybox_torch/sqrt.py``) on the main path's data, eager; no kernel
    may launch.

    Lanes, 10,000 runs each: SR-UKF on UNGM (500 steps) and on reentry (100
    steps, ``tools/bench_sqrt.py``'s grid) in float64 and float32; the
    square-root GPQ filter (RBF ``[[1, 3]]``, UT points) and its RTS
    smoother on UNGM in float32 (float64 filter as its reference); SR-FSQ
    (``experiments/tpq_constant_velocity.py:137-138``) and the square-root
    Student smoother on phase 8's CV glint data in float32 (float64 filter
    as the reference).  Gates: each float64 SR-UKF lane against the eager
    full-covariance float64 filter within 1e-8 of each stream's largest
    entry (UNGM on its first ``SQRT_UNGM_PREFIX`` steps, the chaotic map
    growing rounding differences later, the gap at 50 steps printed;
    reentry over the whole record) and its RMSE equal to 1e-6; each float32
    lane's RMSE within 1% of its float64 square-root lane, but reentry's
    means within ``SQRT_F32_REENTRY_TOL`` of its float64 lane's largest
    entry and its RMSE gap printed (float32 moves the reentry RMSE by 2-4%,
    in the JAX package too: ``tests/test_torch_sqrt.py``); every factor
    diagonal of a lane's finite runs positive, at most 1% of its runs
    non-finite; each smoother's RMSE below its filter's.
    ``make_online_sqrt_filter`` at batch 1 and 10,000 over
    ``SQRT_ONLINE_STEPS`` steps, its final state equal to the offline
    filter's (1e-12); ``make_fixed_lag_sqrt_smoother`` (lag ``SQRT_LAG``,
    10,000 targets) at steps ``SQRT_CUTS`` against the offline smoother of
    the record cut there (1e-12).  The first ``SQRT_CPU_B`` runs of every
    float64 lane against the same function on the CPU (models and
    transforms copied there) within 1e-9 of each stream's largest entry.
    Times: each lane by CUDA events after its checked run; one step of the
    SR-UKF lanes under ``torch.profiler``; one ``tria`` and one batched
    triangular solve at the reentry step's shapes, with the device kernels
    they launch.
    """
    import ssmtoybox_torch as stt
    from ssmtoybox_torch import sqrt as tsq
    from ssmtoybox_torch.ops import scalar_filter as sf, student_mc as smc
    from ssmtoybox_torch.ops import vandermonde as vdm, vector_filter as vf
    from ssmtoybox_torch.utils.linalg import tri_solve_small, tria
    from ssmtoybox_torch.utils.metrics import rmse

    def counters():
        return (sf.LAUNCHES, vf.LAUNCHES, vf.SHAPED_LAUNCHES, vdm.LAUNCHES,
                tuple(smc.LAUNCHES.values()))

    def outer(S):
        return torch.einsum("...ijn,...kjn->...ikn", S, S)

    def run_rmse(x_true, m):
        """Study RMSE over the finite runs, and the share not finite."""
        ok = torch.isfinite(m).flatten(1).all(1)
        r = float(rmse(x_true[ok].permute(1, 2, 0), m[ok].permute(1, 2, 0)))
        return r, 1.0 - float(ok.double().mean())

    def diag_ok(S, m):
        ok = torch.isfinite(m).flatten(1).all(1)
        return bool((torch.diagonal(S[ok], dim1=1, dim2=2) > 0).all())

    def head(res, n, steps=None):
        return type(res)(*(getattr(res, f)[:n, ..., :steps].cpu()
                           for f in res.__dataclass_fields__))

    def moments(res):
        """``(result, mean, factor)`` of a filter's or a smoother's output."""
        if isinstance(res, tuple):
            return res
        return res, res.fi_mean, res.fi_sqrt if hasattr(res, "fi_sqrt") else res.fi_smat_sqrt

    t_phase = time.perf_counter()
    before = counters()
    dyn, obs, xs, ys = ungm
    dyn_re, obs_re, xs_re, ys_re = reentry
    dyn_cv, obs_cv, xs_cv, ys_cv = glint
    f32 = torch.float32
    ukf = stt.UnscentedKalman(dyn, obs)
    ukf_re = stt.UnscentedKalman(dyn_re, obs_re)
    gpq = stt.GaussianProcessKalman(dyn, obs, np.array([[1.0, 3.0]]), np.array([[1.0, 3.0]]))
    fsq = stt.FullySymmetricStudent(dyn_cv, obs_cv, degree=3, kappa=0.0, dof=4.0)
    systems = {"UNGM": (dyn, obs, xs, ys), "reentry": (dyn_re, obs_re, xs_re, ys_re),
               "CV glint": (dyn_cv, obs_cv, xs_cv, ys_cv)}
    # name -> (system, transforms' owner, factory, dtype, reference lane)
    lanes = {
        "SR-UKF UNGM f64": ("UNGM", ukf, tsq.make_sqrt_filter, None, None),
        "SR-UKF UNGM f32": ("UNGM", ukf, tsq.make_sqrt_filter, f32, "SR-UKF UNGM f64"),
        "SR-UKF reentry f64": ("reentry", ukf_re, tsq.make_sqrt_filter, None, None),
        "SR-UKF reentry f32": ("reentry", ukf_re, tsq.make_sqrt_filter, f32,
                               "SR-UKF reentry f64"),
        "SR-GPQ UNGM f64": ("UNGM", gpq, tsq.make_sqrt_filter, None, None),
        "SR-GPQ UNGM f32": ("UNGM", gpq, tsq.make_sqrt_filter, f32, "SR-GPQ UNGM f64"),
        "SR-GPQ RTS UNGM f32": ("UNGM", gpq, tsq.make_sqrt_smoother, f32, "SR-GPQ UNGM f32"),
        "SR-FSQ CV glint f64": ("CV glint", fsq, tsq.make_sqrt_studentian_filter, None, None),
        "SR-FSQ CV glint f32": ("CV glint", fsq, tsq.make_sqrt_studentian_filter, f32,
                                "SR-FSQ CV glint f64"),
        "SR-FSQ RTS CV glint f32": ("CV glint", fsq, tsq.make_sqrt_studentian_smoother, f32,
                                    "SR-FSQ CV glint f32"),
    }
    fns, out, ms, scores, steps_of = {}, {}, {}, {}, {}
    for name, (system, alg, factory, dtype, _) in lanes.items():
        d, o, x_true, y = systems[system]
        fns[name] = factory(d, o, alg.tf_dyn, alg.tf_obs, dtype=dtype)
        res, m, S = moments(fns[name](y))                           # the checked run
        torch.cuda.synchronize()
        ms[name], _ = event_ms(torch, lambda: fns[name](y))
        out[name], steps_of[name] = res, y.shape[-1]
        scores[name] = run_rmse(x_true, m) + (diag_ok(S, m),)
    full = {}
    for name, system, alg in (("UKF UNGM f64 (full covariance)", "UNGM", ukf),
                              ("UKF reentry f64 (full covariance)", "reentry", ukf_re)):
        d, o, x_true, y = systems[system]
        full[name] = stt.gaussian_filter_batch(d, o, alg.tf_dyn, alg.tf_obs, y, engine="f64")
        torch.cuda.synchronize()
        ms[name], _ = event_ms(torch, lambda: stt.gaussian_filter_batch(
            d, o, alg.tf_dyn, alg.tf_obs, y, engine="f64"))
        scores[name], steps_of[name] = run_rmse(x_true, full[name].fi_mean) + (True,), y.shape[-1]
    for name, (r, lost, pos) in scores.items():
        log(f"sqrt {name} ({MC}x{steps_of[name]}): {ms[name]:.1f} ms (CUDA events, one call; "
            f"{ms[name] / steps_of[name]:.2f} ms a step), RMSE {r:.6f}, not finite {lost:.2%}, "
            f"factor diagonals positive {pos}")

    # float64 factor form against the full-covariance filter
    def gaps(res, fr, steps):
        return {"fi_mean": rel_err(res.fi_mean[..., :steps], fr.fi_mean[..., :steps]),
                "fi_cov": rel_err(outer(res.fi_sqrt[..., :steps]), fr.fi_cov[..., :steps]),
                "pr_mean": rel_err(res.pr_mean[..., :steps], fr.pr_mean[..., :steps]),
                "pr_cov": rel_err(outer(res.pr_sqrt[..., :steps]), fr.pr_cov[..., :steps])}

    for name, ref, steps in (("SR-UKF UNGM f64", "UKF UNGM f64 (full covariance)",
                              SQRT_UNGM_PREFIX),
                             ("SR-UKF reentry f64", "UKF reentry f64 (full covariance)", None)):
        errs = gaps(out[name], full[ref], steps)
        r_rel = abs(scores[name][0] - scores[ref][0]) / scores[ref][0]
        later = (f"; first 50 steps {max(gaps(out[name], full[ref], 50).values()):.2e}"
                 if steps else "")
        log(f"sqrt {name} vs {ref}" + (f", first {steps} steps" if steps else ", whole record")
            + ": " + ", ".join(f"{k} {v:.2e}" for k, v in errs.items())
            + f" of each stream's largest entry (limit 1e-8){later}; RMSE relative {r_rel:.2e} "
            "(limit 1e-6)")
        if not (max(errs.values()) <= 1e-8 and r_rel <= 1e-6):
            fail(f"sqrt {name}: off the full-covariance filter ({errs}, RMSE {r_rel:.3e})")
    for name, (system, _, _, dtype, ref) in lanes.items():
        r, lost, pos = scores[name]
        if dtype == f32 and "RTS" not in name:
            rel = abs(r - scores[ref][0]) / scores[ref][0]
            if system == "reentry":
                pw = rel_err(out[name].fi_mean.double(), out[ref].fi_mean)
                log(f"sqrt {name}: means {pw:.2e} of its float64 lane's largest entry (limit "
                    f"{SQRT_F32_REENTRY_TOL}); RMSE {rel:.3%} off the float64 lane's")
                if not pw <= SQRT_F32_REENTRY_TOL:
                    fail(f"sqrt {name}: means {pw:.3e} off the float64 lane")
                continue
            log(f"sqrt {name}: RMSE {rel:.3%} off its float64 lane (limit 1%)")
            if not rel <= 0.01:
                fail(f"sqrt {name}: RMSE {r} is {rel:.2%} off the float64 lane's")
        if "RTS" in name and not r < scores[ref][0]:
            fail(f"sqrt {name}: smoother RMSE {r} not below the filter's {scores[ref][0]}")
        if lost > 0.01 or not pos:
            fail(f"sqrt {name}: {lost:.2%} of the runs not finite (limit 1%) or a factor "
                 f"diagonal not positive ({pos})")

    # card against CPU, float64 lanes, first SQRT_CPU_B runs
    B = SQRT_CPU_B
    for name, (system, alg, factory, dtype, _) in lanes.items():
        if dtype is not None:
            continue
        d, o, _, y = systems[system]
        steps = SQRT_UNGM_PREFIX if system == "UNGM" else None
        cpu_fn = factory(on_cpu(torch, d), on_cpu(torch, o), on_cpu(torch, alg.tf_dyn),
                         on_cpu(torch, alg.tf_obs))
        cpu = cpu_fn(y[:B, :, :50 if steps else None].cpu())
        err = streams_err(torch, head(out[name], B, steps), head(cpu, B, steps))
        later = (f"; first 50 steps {streams_err(torch, head(out[name], B, 50), cpu):.2e}"
                 if steps else "")
        log(f"sqrt {name}: first {B} runs" + (f", {steps} steps," if steps else "")
            + f" vs the CPU {err:.2e} of each stream's largest entry (limit 1e-9){later}")
        if not err <= 1e-9:
            fail(f"sqrt {name}: {err:.3e} off the CPU")

    # streaming: online filter and fixed-lag smoother
    tf_d, tf_o = ukf.tf_dyn, ukf.tf_obs
    y_on = ys[..., :SQRT_ONLINE_STEPS]
    off = fns["SR-UKF UNGM f64"](y_on)

    def stream(batch, targets):
        init, step = tsq.make_online_sqrt_filter(dyn, obs, tf_d, tf_o, batch=batch)
        state = init(batch_size=targets) if batch else init()
        for k in range(SQRT_ONLINE_STEPS):
            state, _ = step(state, y_on[:targets, :, k] if batch else y_on[0, :, k])
        return state

    for label, batch, targets in (("batch 1", False, 1), (f"batch {MC}", True, MC)):
        stream(batch, targets)
        torch.cuda.synchronize()
        t_ms, state = event_ms(torch, lambda: stream(batch, targets))
        got_m, got_S = ((state.mean, state.sqrt) if batch
                        else (state.mean[None], state.sqrt[None]))
        err = max(rel_err(got_m, off.fi_mean[:targets, :, -1]),
                  rel_err(got_S, off.fi_sqrt[:targets, :, :, -1]))
        log(f"sqrt online SR-UKF, {label}: final state vs the offline filter {err:.2e} (limit "
            f"1e-12); {t_ms / SQRT_ONLINE_STEPS * 1e3:.1f} us a step (CUDA events over "
            f"{SQRT_ONLINE_STEPS} steps)")
        if not err <= 1e-12:
            fail(f"sqrt online SR-UKF, {label}: {err:.3e} off the offline filter")
    init, step = tsq.make_fixed_lag_sqrt_smoother(dyn, obs, tf_d, tf_o, lag=SQRT_LAG, batch=True)
    state = init(batch_size=MC)
    emitted = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for k in range(1, SQRT_ONLINE_STEPS + 1):
        state, _, (sm_m, sm_S) = step(state, y_on[..., k - 1])
        if k in SQRT_CUTS:
            emitted[k] = (sm_m.clone(), sm_S.clone())
    torch.cuda.synchronize()
    fl_us = (time.perf_counter() - t0) / SQRT_ONLINE_STEPS * 1e6
    smooth = tsq.make_sqrt_smoother(dyn, obs, tf_d, tf_o)
    fl_err = 0.0
    for k, (sm_m, sm_S) in emitted.items():
        _, m_all, S_all = smooth(y_on[..., :k])
        fl_err = max(fl_err, rel_err(sm_m, m_all[..., k - SQRT_LAG]),
                     rel_err(sm_S, S_all[..., k - SQRT_LAG]))
    log(f"sqrt fixed-lag SR-UKF smoother (lag {SQRT_LAG}, {MC} targets): output at steps "
        f"{SQRT_CUTS} vs the offline smoother of the record cut there {fl_err:.2e} (limit "
        f"1e-12); {fl_us:.1f} us a step (host clock)")
    if not fl_err <= 1e-12:
        fail(f"sqrt fixed-lag smoother: {fl_err:.3e} off the offline smoother")

    # where a step's time goes
    for name in ("SR-UKF UNGM f64", "SR-UKF reentry f64", "SR-UKF reentry f32"):
        y = systems[lanes[name][0]][3]
        wall, busy, n_dev, top = profile_split(torch, lambda: fns[name](y[..., :1]))
        log(f"sqrt {name}: one step under torch.profiler: wall {wall:.2f} ms, device busy "
            f"{busy:.2f} ms ({busy / wall:.1%}), {n_dev} device activities; top: "
            + "; ".join(f"{k} {v:.3f} ms in {n}" for k, v, n in top))
    def kernels_of(fn, top):
        """The device kernels of one call, profiled again (up to three times)
        where the profiler kept no device record."""
        for _ in range(3):
            ranked = profile_split(torch, fn, top=top)[3]
            if ranked:
                return "; ".join(f"{k} {v:.3f} ms in {n}" for k, v, n in ranked)
        return "none recorded"

    gen = torch.Generator(device=dev).manual_seed(SEED)
    for dtype in (torch.float64, f32):
        cols = torch.randn(MC, 5, 14, generator=gen, device=dev, dtype=dtype)
        L = tria(cols)
        rhs = torch.randn(MC, 2, 5, generator=gen, device=dev, dtype=dtype)
        S_yy = tria(torch.randn(MC, 2, 13, generator=gen, device=dev, dtype=dtype))
        q_ms = cuda_ms(torch, lambda: tria(cols))
        s_ms = cuda_ms(torch, lambda: tri_solve_small(S_yy, rhs))
        log(f"sqrt tria of {MC} x (5 x 14), {dtype}: {q_ms[0]:.3f} ms (min {q_ms[1]:.3f}; "
            f"kernels: {kernels_of(lambda: tria(cols), 6)}); solve_triangular of {MC} x (2 x 2) "
            f"against (2 x 5): {s_ms[0]:.3f} ms (min {s_ms[1]:.3f}; kernels: "
            f"{kernels_of(lambda: tri_solve_small(S_yy, rhs), 3)}); diagonal positive "
            f"{bool((torch.diagonal(L, dim1=1, dim2=2) > 0).all())}")

    torch.cuda.synchronize()
    if counters() != before:
        fail(f"the square-root lanes launched a kernel: counters {before} -> {counters()}")
    log(f"sqrt phase: {time.perf_counter() - t_phase:.1f} s in all; card: {card_line()}")


#: phase 24, the time-parallel smoothers (tools/bench_iplf.py's pendulum:
#: dt 0.01, its Q, prior N([1.5, 0], 0.01 I), sin measurement R = 0.1, UT,
#: IPLS(2)); the records are prefixes of one simulated trajectory
PAR_DT = 0.01
PAR_ITERS = 2
#: the float64 observer is a host-bound loop of ~2 ms a step on the card and
#: the record's simulation ~0.15 ms a step, so for the script's time limit
#: the records are cut to a quarter (PAR_SHORT, PAR_LONG) and a half
#: (PAR_BLOCK) of the 10,000, 20,000 and 100,000 steps they were
PAR_SHORT, PAR_LONG, PAR_BLOCK = 2_500, 5_000, 50_000
#: the sequential UKF + RTS reference and the IPLS(2) held to it run on the
#: first PAR_SEQ steps: the eager reference takes ~2 ms a step on the card
PAR_SEQ = 2_000
PAR_CPU_PREFIX = 500
PAR_RMSE_FACTOR = 1.05
PAR_BLOCK_RMSE = 0.2        # tests/test_iplf.py's bound of a 10,000-step run in its basin
PAR_LINEAR = (10_000, 100_000, 1_000_000)
PAR_SCAN_BLOCK = 65_536
PAR_FIT_SETS, PAR_FIT_STEPS, PAR_FIT_CPU_STEPS = 10_000, 200, 20
PAR_AFFINE_DIMS = (4, 2)


def random_affine(torch, gen, n):
    """Phase 24's random stable time-varying affine model of ``n`` steps
    (D, E = ``PAR_AFFINE_DIMS``) drawn from ``gen`` on its device: the
    full-covariance scans' arguments ``(Fs, bs, Qs, Hs, cs, Rs, m0, P0,
    ys)`` and the square-root ones' (the covariances as Cholesky factors)."""
    d, e = PAR_AFFINE_DIMS
    dev = gen.device
    rnd = lambda *shape: torch.randn(*shape, generator=gen, device=dev, dtype=torch.float64)

    def pd(*lead, k):
        a = rnd(*lead, k, k)
        return a @ a.mT + 0.5 * torch.eye(k, dtype=torch.float64, device=dev)

    # spectral norm at most 0.9 (a Frobenius-normed draw; a batched QR with its
    # Q took a minute at 10^6 matrices on the card)
    A = rnd(n, d, d)
    Fs = 0.9 * A / torch.linalg.matrix_norm(A)[..., None, None]
    bs, Qs, Hs = 0.1 * rnd(n, d), 0.2 * pd(n, k=d), rnd(n, e, d)
    cs, Rs, ys = 0.1 * rnd(n, e), 0.5 * pd(n, k=e), rnd(e, n)
    m0, P0 = rnd(d), pd(k=d)
    SQs, SRs, S0 = (torch.linalg.cholesky(a) for a in (Qs, Rs, P0))
    return (Fs, bs, Qs, Hs, cs, Rs, m0, P0, ys), (Fs, bs, SQs, Hs, cs, SRs, m0, S0, ys)


def parallel_slice(torch, np, dev):
    """Phase 24, "parallel": the time-parallel filters and smoothers
    (``ssmtoybox_torch/parallel/``) on one long record; eager, no kernel may
    launch.

    The pendulum of ``tools/bench_iplf.py`` simulated on the card from the
    seed for ``PAR_BLOCK`` steps, measured by ``sin`` (R = 0.1) and by the
    angle itself (``tests/test_iplf.py``'s ``AngleMeasurement``); UT
    transforms, IPLS(2), the record's prefixes.  Gates: IPLS(2) with the
    observer init in float64 within ``PAR_RMSE_FACTOR`` of the smoothed RMSE
    of the sequential UKF + RTS smoother on the same record of ``PAR_SEQ``
    steps (the eager reference cut from ``PAR_SHORT`` steps for time);
    ``sqrt=True`` in float32 within 5% of the float64 run's smoothed RMSE at
    ``PAR_SHORT`` steps (its own observer) and ``PAR_LONG`` steps (from the
    float64 observer's trajectory: one observer of ``PAR_LONG`` steps, not
    two); ``"block-observer"`` on the angle record at ``PAR_BLOCK`` steps,
    finite, smoothed RMSE under ``PAR_BLOCK_RMSE`` and below the filter's;
    on a ``PAR_CPU_PREFIX``-step prefix the card against the CPU within 1e-9
    of each stream's largest entry, and ``init="observer"`` equal to the run
    from its trajectory passed as ``init`` (the path of the timed runs).  The linear scans on a
    random stable affine model (D = 4, E = 2, seeded) at ``PAR_LINEAR``
    steps: the affine filter and smoother against their square-root forms
    within 1e-8 of each stream's largest entry, and at the last length the
    square-root scans by blocks of ``PAR_SCAN_BLOCK`` equal to the unblocked
    ones to 1e-12.  The fit: ``fit_kernel_params`` on the UNGM GPQKF's GP
    model (RBF ``[[1, 3]]``, UT points) over ``PAR_FIT_SETS``
    function-observation sets along simulated UNGM trajectories,
    ``PAR_FIT_STEPS`` Adam steps, the loss falling, the first
    ``PAR_FIT_CPU_STEPS`` against the CPU within 1e-9.  Times: each run once
    after its checked run (CUDA events), the initial trajectory apart from
    the iterations, one IPLS iteration under ``torch.profiler``, the peak
    memory of the linear scans.
    """
    import ssmtoybox_torch as stt
    from ssmtoybox_torch import mtran, parallel as par
    from ssmtoybox_torch.bq.models import GaussianProcessModel
    from ssmtoybox_torch.ops import scalar_filter as sf, student_mc as smc
    from ssmtoybox_torch.ops import vandermonde as vdm, vector_filter as vf
    from ssmtoybox_torch.parallel import iplf
    from ssmtoybox_torch.ssmod import (MeasurementModel, Pendulum2DMeasurement,
                                       Pendulum2DTransition, UNGMTransition)
    from ssmtoybox_torch.utils import GaussRV

    def counters():
        return (sf.LAUNCHES, vf.LAUNCHES, vf.SHAPED_LAUNCHES, vdm.LAUNCHES,
                tuple(smc.LAUNCHES.values()))

    class AngleMeasurement(MeasurementModel):
        """The angle itself: a unimodal measurement, block-observer territory."""
        dim_substate, dim_out, dim_noise = 2, 1, 1

        def meas_fcn(self, x, r, time):
            return x[..., :1] + r

    def rmse(x_true, m):
        return float(torch.sqrt(torch.mean((m.double() - x_true) ** 2)))

    t_phase = time.perf_counter()
    before = counters()

    def plog(msg):
        """``log`` with the seconds since the phase began in front."""
        log(f"[{time.perf_counter() - t_phase:6.1f} s] {msg}")

    f32 = torch.float32
    q = 0.1 * np.array([[PAR_DT ** 3 / 3, PAR_DT ** 2 / 2], [PAR_DT ** 2 / 2, PAR_DT]])
    dyn = Pendulum2DTransition(GaussRV(2, mean=[1.5, 0.0], cov=0.01 * np.eye(2), device=dev),
                               GaussRV(2, cov=q, device=dev), dt=PAR_DT)
    obs = Pendulum2DMeasurement(GaussRV(1, cov=0.1, device=dev), dim_state=2)
    obs_angle = AngleMeasurement(GaussRV(1, cov=0.1, device=dev), dim_state=2)
    ut = mtran.UnscentedTransform(2, device=dev)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    t0 = time.perf_counter()
    x = dyn.simulate_discrete(gen, steps=PAR_BLOCK, mc_sims=1)[..., 0]  # (2, N)
    # both measurements of the whole record in one call each (additive noise)
    y_sin, y_ang = (o.meas_eval(x.T, 0).T + o.noise_rv.sample(gen, (PAR_BLOCK,))
                    for o in (obs, obs_angle))
    torch.cuda.synchronize()
    plog(f"parallel: pendulum simulated on the card, {PAR_BLOCK} steps, both measurements, "
        f"{time.perf_counter() - t0:.1f} s")

    # the sequential UKF + RTS reference (eager) and IPLS(2) on the same record
    t0 = time.perf_counter()
    seq = stt.gaussian_filter_batch(dyn, obs, ut, ut, y_sin[None, :, :PAR_SEQ], engine="f64")
    seq_sm, _ = stt.gaussian_smoother(seq, rts_full=True)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    ipls = par.iterated_parallel_smoother(dyn, obs, ut, ut, y_sin[:, :PAR_SEQ],
                                          iterations=PAR_ITERS)
    r_seq, r_ipls = rmse(x[:, :PAR_SEQ], seq_sm[0]), rmse(x[:, :PAR_SEQ], ipls.sm_mean)
    plog(f"parallel: sequential UKF + RTS (eager f64), {PAR_SEQ} steps: {seq_s:.2f} s (host "
         f"clock, one call), filter RMSE {rmse(x[:, :PAR_SEQ], seq.fi_mean[0]):.6f}, smoother "
         f"RMSE {r_seq:.6f}; IPLS(2) f64 (init 'observer') on the same record: smoother RMSE "
         f"{r_ipls:.6f} (limit x{PAR_RMSE_FACTOR})")
    if not r_ipls <= PAR_RMSE_FACTOR * r_seq:
        fail(f"parallel IPLS(2): smoother RMSE {r_ipls} above {PAR_RMSE_FACTOR} x {r_seq}")

    def run(y, n, dtype, sqrt, obs_, init):
        """One checked IPLS(2) configuration: the initial trajectory timed
        alone (an array ``init`` is taken as it is; the block observer at
        the defaults, blocks of 2,048 steps and 512 of warm-up), the
        smoother from it checked, then timed."""
        prob = iplf._Problem(dyn, obs_, ut, ut, y[:, :n], dtype=dtype)
        init_ms, traj = event_ms(torch, lambda: iplf._initial_trajectory(prob, init))
        call = lambda: par.iterated_parallel_smoother(
            dyn, obs_, ut, ut, y[:, :n], iterations=PAR_ITERS, init=traj, sqrt=sqrt,
            dtype=dtype, chol_jitter=0.0 if dtype is None else 1e-7)
        res = call()
        torch.cuda.synchronize()
        scan_ms, _ = event_ms(torch, call)
        return res, traj, init_ms, scan_ms

    out = {}
    for name, y, n, dtype, sqrt, obs_, init in (
            ("IPLS(2) f64", y_sin, PAR_SHORT, None, False, obs, "observer"),
            ("SR-IPLS(2) f32", y_sin, PAR_SHORT, f32, True, obs, "observer"),
            ("IPLS(2) f64", y_sin, PAR_LONG, None, False, obs, "observer"),
            # from the float64 observer's trajectory: the observer is a host-bound
            # loop (~1 ms a step), and a second one of PAR_LONG steps would double
            # the phase
            ("SR-IPLS(2) f32", y_sin, PAR_LONG, f32, True, obs, "float64 observer"),
            ("IPLS(2) f64 angle", y_ang, PAR_BLOCK, None, False, obs_angle, "block-observer")):
        given = init == "float64 observer"
        res, traj, init_ms, scan_ms = run(
            y, n, dtype, sqrt, obs_, out["IPLS(2) f64", n][1].to(dtype) if given else init)
        out[name, n] = (res, traj)
        fin = all(bool(torch.isfinite(getattr(res, f)).all()) for f in res.__dataclass_fields__)
        r_fi, r_sm = rmse(x[:, :n], res.fi_mean), rmse(x[:, :n], res.sm_mean)
        depth = n if init == "observer" else 2048 + 512
        plog(f"parallel {name}, {n} steps, init {init!r}: "
            + ("" if given else f"init {init_ms:.1f} ms ({init_ms / depth * 1e3:.1f} us a "
                                f"sequential step of {depth}), ")
            + f"{PAR_ITERS} iterations {scan_ms:.1f} ms (CUDA events, one call after the "
            f"checked one), in all {init_ms + scan_ms:.1f} ms; RMSE filter {r_fi:.6f}, smoother "
            f"{r_sm:.6f}, finite {fin}")
        if not fin:
            fail(f"parallel {name}, {n} steps: not finite")
    if not (r_sm < r_fi and r_sm < PAR_BLOCK_RMSE):
        fail(f"parallel block-observer run: smoother RMSE {r_sm} (filter {r_fi}, limit "
             f"{PAR_BLOCK_RMSE})")

    for n in (PAR_SHORT, PAR_LONG):
        r32 = rmse(x[:, :n], out["SR-IPLS(2) f32", n][0].sm_mean)
        r64 = rmse(x[:, :n], out["IPLS(2) f64", n][0].sm_mean)
        plog(f"parallel SR-IPLS(2) f32 vs IPLS(2) f64, {n} steps: smoother RMSE {r32:.6f} vs "
            f"{r64:.6f} ({abs(r32 - r64) / r64:.3%} off; limit 5%)")
        if not abs(r32 - r64) <= 0.05 * r64:
            fail(f"parallel SR-IPLS(2) f32 at {n} steps: RMSE {r32} more than 5% off {r64}")

    # the card against the CPU on a prefix
    y_pre = y_sin[:, :PAR_CPU_PREFIX]
    card = par.iterated_parallel_smoother(dyn, obs, ut, ut, y_pre, iterations=PAR_ITERS)
    cpu = par.iterated_parallel_smoother(on_cpu(torch, dyn), on_cpu(torch, obs),
                                         on_cpu(torch, ut), on_cpu(torch, ut), y_pre.cpu(),
                                         iterations=PAR_ITERS)
    err = streams_err(torch, card, cpu)
    traj = iplf._initial_trajectory(iplf._Problem(dyn, obs, ut, ut, y_pre), "observer")
    from_traj = par.iterated_parallel_smoother(dyn, obs, ut, ut, y_pre, iterations=PAR_ITERS,
                                               init=traj)
    same = all(torch.equal(getattr(card, f), getattr(from_traj, f))
               for f in card.__dataclass_fields__)
    plog(f"parallel IPLS(2) f64, {PAR_CPU_PREFIX} steps: card vs CPU {err:.2e} of each "
        f"stream's largest entry (limit 1e-9); init='observer' equal to the run from its "
        f"trajectory passed as init (the timed runs' path): {same}")
    if not err <= 1e-9:
        fail(f"parallel IPLS(2): card {err:.3e} off the CPU")
    if not same:
        fail("parallel IPLS(2): init='observer' differs from its trajectory passed as init")

    # where one iteration's time goes
    traj = out["IPLS(2) f64", PAR_SHORT][1]
    wall, busy, n_dev, top = profile_split(torch, lambda: par.iterated_parallel_smoother(
        dyn, obs, ut, ut, y_sin[:, :PAR_SHORT], iterations=1, init=traj))
    plog(f"parallel IPLS(1) f64, {PAR_SHORT} steps, under torch.profiler: wall {wall:.1f} ms, "
        f"device busy {busy:.2f} ms ({busy / wall:.1%}), {n_dev} device activities; top: "
        + "; ".join(f"{k} {v:.3f} ms in {n_}" for k, v, n_ in top))

    # the linear scans on a random stable affine model
    gen = torch.Generator(device=dev).manual_seed(SEED + 24)
    d, e = PAR_AFFINE_DIMS
    n_max = PAR_LINEAR[-1]
    torch.cuda.reset_peak_memory_stats()
    (Fs, bs, Qs, Hs, cs, Rs, m0, P0, ys), (_, _, SQs, _, _, SRs, _, S0, _) = random_affine(
        torch, gen, n_max)

    def outer(S):
        return torch.einsum("ijn,kjn->ikn", S, S)

    for n in PAR_LINEAR:
        a = (Fs[:n], bs[:n], Qs[:n], Hs[:n], cs[:n], Rs[:n], m0, P0, ys[:, :n])
        s_a = (Fs[:n], bs[:n], SQs[:n], Hs[:n], cs[:n], SRs[:n], m0, S0, ys[:, :n])
        fm, fP = par.parallel_affine_filter(*a)
        sm, sP = par.parallel_affine_smoother(Fs[:n], bs[:n], Qs[:n], fm, fP)
        qm, qS = par.parallel_affine_sqrt_filter(*s_a)
        rm, rS = par.parallel_affine_sqrt_smoother(Fs[:n], bs[:n], SQs[:n], qm, qS)
        torch.cuda.synchronize()
        t = {"filter": event_ms(torch, lambda: par.parallel_affine_filter(*a))[0],
             "smoother": event_ms(torch, lambda: par.parallel_affine_smoother(
                 Fs[:n], bs[:n], Qs[:n], fm, fP))[0],
             "sqrt filter": event_ms(torch, lambda: par.parallel_affine_sqrt_filter(*s_a))[0],
             "sqrt smoother": event_ms(torch, lambda: par.parallel_affine_sqrt_smoother(
                 Fs[:n], bs[:n], SQs[:n], qm, qS))[0]}
        errs = {"fi_mean": rel_err(qm, fm), "fi_cov": rel_err(outer(qS), fP),
                "sm_mean": rel_err(rm, sm), "sm_cov": rel_err(outer(rS), sP)}
        plog(f"parallel linear scans, D={d}, E={e}, {n} steps: "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in t.items())
            + " (CUDA events, one call after the checked one); square-root vs full: "
            + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + " (limit 1e-8)")
        if not max(errs.values()) <= 1e-8:
            fail(f"parallel linear scans at {n} steps: square-root forms off the full ({errs})")
    bm, bS = par.parallel_affine_sqrt_filter(*s_a, scan_block_len=PAR_SCAN_BLOCK)
    bsm, bsS = par.parallel_affine_sqrt_smoother(Fs, bs, SQs, bm, bS,
                                                 scan_block_len=PAR_SCAN_BLOCK)
    torch.cuda.synchronize()
    tb = {"sqrt filter": event_ms(torch, lambda: par.parallel_affine_sqrt_filter(
        *s_a, scan_block_len=PAR_SCAN_BLOCK))[0],
          "sqrt smoother": event_ms(torch, lambda: par.parallel_affine_sqrt_smoother(
              Fs, bs, SQs, bm, bS, scan_block_len=PAR_SCAN_BLOCK))[0]}
    errs = {"fi_mean": rel_err(bm, qm), "fi_sqrt": rel_err(bS, qS), "sm_mean": rel_err(bsm, rm),
            "sm_sqrt": rel_err(bsS, rS)}
    plog(f"parallel linear square-root scans by blocks of {PAR_SCAN_BLOCK}, {n_max} steps: "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in tb.items()) + "; vs unblocked "
        + ", ".join(f"{k} {v:.2e}" for k, v in errs.items()) + " (limit 1e-12); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    if not max(errs.values()) <= 1e-12:
        fail(f"parallel blocked scans off the unblocked ones ({errs})")
    del Fs, bs, Qs, Hs, cs, Rs, ys, SQs, SRs

    # the batched NLML fit of the UNGM GPQKF's GP model
    u_dyn = UNGMTransition(GaussRV(1, cov=5.0, device=dev), GaussRV(1, cov=10.0, device=dev))
    steps = 100
    xu = u_dyn.simulate_discrete(gen, steps=steps, mc_sims=PAR_FIT_SETS // steps)  # (1, N, M)
    gp = GaussianProcessModel(1, np.array([[1.0, 3.0]]), "rbf", "ut", device=dev)
    states = xu[0].T.reshape(-1, 1, 1)                                             # (B, 1, 1)
    times = torch.arange(steps, dtype=torch.float64, device=dev).repeat(PAR_FIT_SETS // steps)
    fo = u_dyn.dyn_eval(states + gp.points.T, times[:, None, None])                # (B, 3, 1)
    lp, losses = par.fit_kernel_params(gp, np.zeros(2), fo, gp.points,
                                       num_steps=PAR_FIT_STEPS)
    torch.cuda.synchronize()
    fit_ms, _ = event_ms(torch, lambda: par.fit_kernel_params(gp, np.zeros(2), fo, gp.points,
                                                              num_steps=PAR_FIT_STEPS))
    lp_cpu, losses_cpu = par.fit_kernel_params(on_cpu(torch, gp), np.zeros(2), fo.cpu(),
                                               gp.points.cpu(), num_steps=PAR_FIT_CPU_STEPS)
    cpu_err = max(rel_err(losses[:PAR_FIT_CPU_STEPS].cpu(), losses_cpu),
                  float((lp_cpu - par.fit_kernel_params(
                      gp, np.zeros(2), fo, gp.points,
                      num_steps=PAR_FIT_CPU_STEPS)[0].cpu()).abs().max()))
    plog(f"parallel fit: {PAR_FIT_SETS} sets, {PAR_FIT_STEPS} Adam steps in {fit_ms:.1f} ms "
        f"({fit_ms / PAR_FIT_STEPS:.2f} ms a step, CUDA events); loss {float(losses[0]):.6f} -> "
        f"{float(losses[-1]):.6f}, log-parameters {lp.tolist()}; first {PAR_FIT_CPU_STEPS} "
        f"steps vs the CPU {cpu_err:.2e} (limit 1e-9)")
    if not (float(losses[-1]) < float(losses[0]) and bool(torch.isfinite(lp).all())):
        fail(f"parallel fit: the loss did not fall ({float(losses[0])} -> {float(losses[-1])})")
    if not cpu_err <= 1e-9:
        fail(f"parallel fit: {cpu_err:.3e} off the CPU")

    torch.cuda.synchronize()
    if counters() != before:
        fail(f"the time-parallel path launched a kernel: counters {before} -> {counters()}")
    plog(f"parallel phase: {time.perf_counter() - t_phase:.1f} s in all; card: {card_line()}")
    return {"pendulum": (dyn, obs, ut, y_sin[:, :PAR_SHORT], out["IPLS(2) f64", PAR_SHORT][1]),
            "fit": (gp, fo)}


#: phase 25, "mesh": the multi-rank half of parallel/ on the one card, ranks
#: as threads sharing it (gloo) beside a real NCCL world of one rank
MESH_TIMEOUT = 300.0
MESH_AFFINE = (1_000_000, 1_000_003)
MESH_BANK_SCALES = (0.5, 1.0, 2.0, 4.0)
#: the bank runs on the study's first steps: eight eager filters a rank
#: issue their launches under one interpreter lock (22.9 s at 500 steps)
MESH_BANK_STEPS = 100
MESH_FIT_STEPS = 20
#: the EKF + RTS reference is host-bound (~10 ms a step on the card): 500
#: steps, cut from 2,000 for the script's time limit (IPLS / EKS smoothed RMSE
#: 0.79-0.93 over 8 seeds at 500 steps on the CPU, against the limit 1.05)
MESH_LIN_STEPS = 500
MESH_LIN_FACTOR = 1.05


def free_port() -> int:
    """A TCP port on the loopback that nothing listens on now."""
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def mesh_slice(torch, np, dev, ungm, shared):
    """Phase 25, "mesh": the multi-rank half of ``parallel/`` (the sharded
    time scans, the Monte-Carlo meshes, the fit on a mesh) on the one card;
    eager, no kernel may launch.

    Two setups of ranks: the default process group initialised here as an
    NCCL world of one rank (``tcp://127.0.0.1:<free port>``), destroyed at
    the end; and 2-4 ranks as threads sharing the card, each with its own
    gloo group over one ``HashStore`` (NCCL refuses two ranks on one device;
    the ``Mesh`` stages a CUDA tensor through the host for gloo and counts
    those bytes).  Every thread joins within ``MESH_TIMEOUT`` s; a timeout or
    an exception in any rank fails the run.  Gates, relative to each
    stream's largest entry, every rank's result checked:
    ``filter_mc_sharded`` on the main path's UNGM UKF data (10,000 x 500,
    float64) at dp = 1 (NCCL), 2 and 3 (threads; 10,000 rows pad to 10,002)
    within 1e-12 of the unsharded ``gaussian_filter_batch``, and
    ``mc_metrics_sharded`` within 1e-12 of the study RMSE;
    ``filter_bank_sharded`` of four GPQ-UT transforms (RBF ``[[1, 3 s]]``, s
    in ``MESH_BANK_SCALES``) on the study's first ``MESH_BANK_STEPS`` steps
    at (dp, fb) = (1, 1) (NCCL) and (2, 2) (threads), each member within
    1e-12 of its own unsharded run on the same rows (at dp = 2 the two row
    blocks filtered apart: the eager GPQ filter's rows depend on the batch's
    size by rounding on the card, and UNGM grows it; the gap is printed); phase
    24's random affine model at ``MESH_AFFINE`` steps (the second pads 3
    identities on 2 and 4 ranks, 1 on 2), the full and square-root filters
    and smoothers at t = 1 (NCCL), 2 and 4 (threads) within 1e-10 of the
    unsharded scans; ``iterated_parallel_smoother(iterations=2, mesh=)`` on
    phase 24's 10,000-step pendulum record from its float64 observer
    trajectory, both ``sqrt`` settings, t = 1 and 4, within 1e-9;
    ``fit_kernel_params(mesh=)`` on phase 24's 10,000 function-observation
    sets, ``MESH_FIT_STEPS`` steps at dp = 1 and 3 (zero-weight padding)
    within 1e-9; ``LinearizationTransform`` through the iterated smoother
    (IPLS(2) from the EKF's filtered means) on a ``MESH_LIN_STEPS``-step UNGM
    record, finite, smoothed RMSE within ``MESH_LIN_FACTOR`` of the
    sequential EKF + RTS smoother's on the same record.  Times: CUDA events
    around each sharded call (the thread ranks' work included: every thread
    issues on the legacy default stream) beside the unsharded call, with
    the collectives and bytes of a call (``Mesh.stats``).
    """
    import torch.distributed as dist

    import ssmtoybox_torch as stt
    from ssmtoybox_torch import mtran, parallel as par
    from ssmtoybox_torch.bq.transforms import GaussianProcessTransform
    from ssmtoybox_torch.ops import scalar_filter as sf, student_mc as smc
    from ssmtoybox_torch.ops import vandermonde as vdm, vector_filter as vf
    from ssmtoybox_torch.parallel.mesh import Mesh, thread_ranks

    def counters():
        return (sf.LAUNCHES, vf.LAUNCHES, vf.SHAPED_LAUNCHES, vdm.LAUNCHES,
                tuple(smc.LAUNCHES.values()))

    t_phase = time.perf_counter()
    before = counters()

    def plog(msg):
        """``log`` with the seconds since the phase began in front."""
        log(f"[{time.perf_counter() - t_phase:6.1f} s] {msg}")

    def stats_line(stats):
        return (f"{stats['all_gather']} all_gather + {stats['all_reduce']} all_reduce, "
                f"{stats['bytes'] / 2 ** 20:.2f} MiB sent a rank, "
                f"{stats['host_bytes'] / 2 ** 20:.2f} MiB through the host")

    def ranked(mesh, fn):
        """``(fn(mesh), this call's collectives)``."""
        torch.cuda.set_device(dev)          # a thread rank's first call has no context
        start = dict(mesh.stats)
        out = fn(mesh)
        return out, {k: v - start[k] for k, v in mesh.stats.items()}

    def sharded(label, size, make, fn):
        """``fn`` on every rank of a mesh: the NCCL world of one for
        ``size == 1``, else ``size`` thread ranks with gloo groups; timed
        with CUDA events; returns the ranks' results."""
        torch.cuda.synchronize()
        try:
            if size == 1:
                ms, outs = event_ms(torch, lambda: [ranked(make(None), fn)])
            else:
                ms, outs = event_ms(torch, lambda: thread_ranks(
                    lambda g: ranked(make(g), fn), size, timeout=MESH_TIMEOUT))
        except Exception as e:  # noqa: BLE001 - any rank's failure is fatal
            fail(f"mesh {label} on {size} rank(s): {type(e).__name__}: {e}")
        return ms, [o for o, _ in outs], outs[-1][1]

    def streams(got, want, names):
        return max(rel_err(getattr(got, n), getattr(want, n)) for n in names)

    # the NCCL world of one rank
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    t0 = time.perf_counter()
    try:
        dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{free_port()}",
                                world_size=1, rank=0)
        probe = Mesh({"t": 1})
        probe.all_reduce(torch.ones(1, device=dev))
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 - a world that does not start is fatal
        fail(f"mesh: the NCCL world of one rank did not initialise: {type(e).__name__}: {e}")
    if probe.backend != "nccl":
        fail(f"mesh: the default group runs {probe.backend}, not nccl")
    plog(f"mesh: NCCL world of one rank up in {time.perf_counter() - t0:.2f} s (the first "
         f"collective included); {probe!r}")
    try:
        # ---- Monte-Carlo studies ------------------------------------------
        dyn, obs, xs, ys = ungm
        ukf = stt.UnscentedKalman(dyn, obs)
        td, to = ukf.tf_dyn, ukf.tf_obs
        names = ("fi_mean", "fi_cov", "pr_mean", "pr_cov", "pr_xx_cov")
        torch.cuda.synchronize()
        ref_ms, ref = event_ms(torch, lambda: stt.gaussian_filter_batch(dyn, obs, td, to, ys))
        study = torch.sqrt(torch.mean(torch.sum((xs - ref.fi_mean) ** 2, dim=1), dim=1)).mean()
        plog(f"mesh MC: unsharded gaussian_filter_batch (f64), {tuple(ys.shape)}: "
             f"{ref_ms:.1f} ms; study RMSE {float(study):.6f}")

        def mc(mesh):
            out = par.filter_mc_sharded(dyn, obs, td, to, ys, mesh)
            return out, par.mc_metrics_sharded(xs, out, mesh)

        for size in (1, 2, 3):
            ms, outs, st = sharded("filter_mc_sharded", size,
                                   lambda g, k=size: par.make_mesh(dp=k, group=g), mc)
            err = max(streams(o, ref, names) for o, _ in outs)
            rerr = max(float(abs(r - study) / study) for _, r in outs)
            plog(f"mesh MC: filter_mc_sharded + mc_metrics_sharded, dp={size} "
                 f"({'NCCL' if size == 1 else 'threads, gloo'}): {ms:.1f} ms (unsharded "
                 f"{ref_ms:.1f}); streams {err:.2e}, RMSE {rerr:.2e} off (limits 1e-12); "
                 f"a call: {stats_line(st)}")
            if not (err <= 1e-12 and rerr <= 1e-12):
                fail(f"mesh MC dp={size}: streams {err:.3e}, RMSE {rerr:.3e} off the unsharded")
        del outs

        bank = [GaussianProcessTransform(1, 1, np.array([[1.0, 3.0 * sc]]), point_str="ut",
                                         device=dev) for sc in MESH_BANK_SCALES]
        yb = ys[..., :MESH_BANK_STEPS]
        filt = lambda rows: [stt.gaussian_filter_batch(dyn, obs, t, t, rows) for t in bank]
        torch.cuda.synchronize()
        bank_ms, refs = event_ms(torch, lambda: filt(yb))
        # the eager GPQ filter's rows depend on the batch's size by rounding on
        # the card (batched cuBLAS / MAGMA calls), which UNGM grows: the members
        # are held to unsharded runs of the same row blocks, and the gap of
        # those blocks to the whole batch is printed
        half = -(-yb.shape[0] // 2)            # the rows of dp = 2's first rank
        blocks = [filt(yb[:half]), filt(yb[half:])]
        gap = max(rel_err(getattr(b[k], n), getattr(refs[k], n)[sl])
                  for b, sl in zip(blocks, (slice(0, half), slice(half, None)))
                  for k in range(len(bank)) for n in names)
        plog(f"mesh bank: K={len(bank)} GPQ-UT members unsharded, {tuple(yb.shape)} (the study "
             f"cut to {MESH_BANK_STEPS} steps): {bank_ms:.1f} ms; the two halves of the batch "
             f"filtered apart are {gap:.2e} off the whole batch's rows")
        for (dp, fb) in ((1, 1), (2, 2)):
            ms, outs, st = sharded("filter_bank_sharded", dp * fb,
                                   lambda g, a=dp, b=fb: par.make_mesh(dp=a, fb=b, group=g),
                                   lambda mesh: par.filter_bank_sharded(dyn, obs, bank, bank,
                                                                        yb, mesh))
            want = (lambda k, n: getattr(refs[k], n)) if dp == 1 else (
                lambda k, n: torch.cat([getattr(b[k], n) for b in blocks]))
            err = max(rel_err(getattr(o, n)[k], want(k, n))
                      for o in outs for k in range(len(bank)) for n in names)
            whole = max(rel_err(getattr(o, n)[k], getattr(refs[k], n))
                        for o in outs for k in range(len(bank)) for n in names)
            plog(f"mesh bank: filter_bank_sharded, (dp, fb)=({dp}, {fb}) "
                 f"({'NCCL' if dp * fb == 1 else 'threads, gloo'}): {ms:.1f} ms (unsharded, "
                 f"member by member, {bank_ms:.1f}); members {err:.2e} off their unsharded runs "
                 f"of the same row blocks (limit 1e-12), {whole:.2e} off the whole batch's; a "
                 f"call: {stats_line(st)}")
            if not err <= 1e-12:
                fail(f"mesh bank ({dp}, {fb}): {err:.3e} off the unsharded members")
        del outs, refs, blocks, ref

        # ---- the time axis ------------------------------------------------
        gen = torch.Generator(device=dev).manual_seed(SEED + 24)
        full_all, sqrt_all = random_affine(torch, gen, max(MESH_AFFINE))

        def cut(args, n):
            """The first ``n`` steps of a model: the six per-step arrays and
            the record, the prior as it is."""
            return tuple(a[:n] for a in args[:6]) + args[6:8] + (args[8][:, :n],)

        def passes(n, mesh=None):
            full, sqr = cut(full_all, n), cut(sqrt_all, n)
            Fs, bs, Qs, SQs = full[0], full[1], full[2], sqr[2]
            if mesh is None:
                fm, fP = par.parallel_affine_filter(*full)
                qm, qS = par.parallel_affine_sqrt_filter(*sqr)
                return ((fm, fP) + par.parallel_affine_smoother(Fs, bs, Qs, fm, fP) + (qm, qS)
                        + par.parallel_affine_sqrt_smoother(Fs, bs, SQs, qm, qS))
            fm, fP = par.sharded_parallel_affine_filter(*full, mesh)
            qm, qS = par.sharded_parallel_affine_sqrt_filter(*sqr, mesh)
            return ((fm, fP) + par.sharded_parallel_affine_smoother(Fs, bs, Qs, fm, fP, mesh)
                    + (qm, qS) + par.sharded_parallel_affine_sqrt_smoother(Fs, bs, SQs, qm, qS,
                                                                           mesh))

        for n in MESH_AFFINE:
            passes(n)
            torch.cuda.synchronize()
            ref_ms, want = event_ms(torch, lambda: passes(n))
            for size in (1, 2, 4):
                ms, outs, st = sharded("affine scans", size,
                                       lambda g, k=size: Mesh({"t": k}, g),
                                       lambda mesh: passes(n, mesh))
                err = max(rel_err(g_, w_) for o in outs for g_, w_ in zip(o, want))
                plog(f"mesh time axis: filter, smoother and their square-root forms, {n} steps, "
                     f"t={size} ({'NCCL' if size == 1 else 'threads, gloo'}): {ms:.1f} ms "
                     f"(unsharded {ref_ms:.1f}); {err:.2e} off (limit 1e-10); the four calls: "
                     f"{stats_line(st)}")
                if not err <= 1e-10:
                    fail(f"mesh time axis, {n} steps, t={size}: {err:.3e} off the unsharded")
            del outs, want
        del full_all, sqrt_all

        p_dyn, p_obs, ut, y_p, traj = shared["pendulum"]
        fields = ("fi_mean", "fi_cov", "sm_mean", "sm_cov")
        for sq in (False, True):
            run = lambda mesh=None: par.iterated_parallel_smoother(
                p_dyn, p_obs, ut, ut, y_p, iterations=PAR_ITERS, init=traj, sqrt=sq, mesh=mesh)
            torch.cuda.synchronize()
            ref_ms, want = event_ms(torch, run)
            for size in (1, 4):
                ms, outs, st = sharded("iterated smoother", size,
                                       lambda g, k=size: Mesh({"t": k}, g), run)
                err = max(streams(o, want, fields) for o in outs)
                plog(f"mesh IPLS({PAR_ITERS}) {'square-root ' if sq else ''}f64, pendulum "
                     f"{y_p.shape[-1]} steps from the observer's trajectory, t={size}: {ms:.1f} "
                     f"ms (unsharded {ref_ms:.1f}); {err:.2e} off (limit 1e-9); a call: "
                     f"{stats_line(st)}")
                if not err <= 1e-9:
                    fail(f"mesh IPLS sqrt={sq}, t={size}: {err:.3e} off the unsharded")

        gp, fo = shared["fit"]
        fit = lambda mesh=None: par.fit_kernel_params(gp, np.zeros(2), fo, gp.points,
                                                      num_steps=MESH_FIT_STEPS, mesh=mesh)
        torch.cuda.synchronize()
        ref_ms, (lp0, l0) = event_ms(torch, fit)
        for size in (1, 3):
            ms, outs, st = sharded("fit", size, lambda g, k=size: par.make_mesh(dp=k, group=g),
                                   fit)
            err = max(max(rel_err(lp, lp0), rel_err(l, l0)) for lp, l in outs)
            plog(f"mesh fit: fit_kernel_params, {fo.shape[0]} sets, {MESH_FIT_STEPS} Adam steps, "
                 f"dp={size}: {ms:.1f} ms (unsharded {ref_ms:.1f}); {err:.2e} off (limit 1e-9); "
                 f"a call: {stats_line(st)}")
            if not err <= 1e-9:
                fail(f"mesh fit dp={size}: {err:.3e} off the unsharded fit")
    finally:
        dist.destroy_process_group()

    # ---- the linearizing transforms in the time-parallel smoother ---------
    dyn, obs = ungm[:2]
    gen = torch.Generator(device=dev).manual_seed(SEED + 25)
    x = dyn.simulate_discrete(gen, steps=MESH_LIN_STEPS, mc_sims=1)
    y = obs.simulate_measurements(gen, x)
    xt = x[:, :, 0]
    lin = mtran.LinearizationTransform(1, device=dev)
    rmse = lambda m: float(torch.sqrt(torch.mean((m - xt) ** 2)))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ekf = stt.gaussian_filter_batch(dyn, obs, lin, lin, y.permute(2, 0, 1))
    eks, _ = stt.gaussian_smoother(ekf, rts_full=True)
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    init = torch.cat([dyn.init_rv.mean[None], ekf.fi_mean[0].T])
    run = lambda: par.iterated_parallel_smoother(dyn, obs, lin, lin, y[:, :, 0],
                                                 iterations=PAR_ITERS, init=init)
    run()
    torch.cuda.synchronize()
    ipls_ms, res = event_ms(torch, run)
    fin = all(bool(torch.isfinite(getattr(res, f)).all()) for f in res.__dataclass_fields__)
    r_eks, r_ipls = rmse(eks[0]), rmse(res.sm_mean)
    plog(f"mesh linearizing: EKF + RTS (eager f64), UNGM {MESH_LIN_STEPS} steps: {seq_s:.2f} s "
         f"(host clock), filter RMSE {rmse(ekf.fi_mean[0]):.6f}, smoother RMSE {r_eks:.6f}; "
         f"IPLS({PAR_ITERS}) with LinearizationTransform from the EKF's means: {ipls_ms:.1f} ms, "
         f"filter RMSE {rmse(res.fi_mean):.6f}, smoother RMSE {r_ipls:.6f} (limit "
         f"x{MESH_LIN_FACTOR}), finite {fin}")
    if not (fin and r_ipls <= MESH_LIN_FACTOR * r_eks):
        fail(f"mesh linearizing IPLS: finite {fin}, smoother RMSE {r_ipls} against the EKS's "
             f"{r_eks}")

    torch.cuda.synchronize()
    if counters() != before:
        fail(f"the mesh path launched a kernel: counters {before} -> {counters()}")
    plog(f"mesh phase: {time.perf_counter() - t_phase:.1f} s in all; card: {card_line()}")


def mesh_alone():
    """Phase 25 alone, without the kernels' builds and the other phases:
    ``python3 -c "import chip_smoke; chip_smoke.mesh_alone()"``.  The main
    path's UNGM data and a ``PAR_SHORT``-step pendulum record with its
    float64 observer trajectory and the fit's function-observation sets,
    simulated as phases 4 and 24 simulate theirs (the pendulum's
    measurements drawn after its ``PAR_SHORT`` states, not 100,000)."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    from ssmtoybox_torch import mtran, parallel as par
    from ssmtoybox_torch.bq.models import GaussianProcessModel
    from ssmtoybox_torch.parallel import iplf
    from ssmtoybox_torch.ssmod import (Pendulum2DMeasurement, Pendulum2DTransition,
                                       UNGMMeasurement, UNGMTransition)
    from ssmtoybox_torch.utils import GaussRV

    if not torch.cuda.is_available():
        fail("mesh_alone: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"card: {card_line()} | torch {torch.__version__} cuda {torch.version.cuda}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    dyn = UNGMTransition(GaussRV(1, cov=5.0, device=dev), GaussRV(1, cov=10.0, device=dev))
    obs = UNGMMeasurement(GaussRV(1, cov=1.0, device=dev), dim_state=1)
    x = dyn.simulate_discrete(gen, steps=UNGM_STEPS, mc_sims=MC)
    xs, ys = x.permute(2, 0, 1), obs.simulate_measurements(gen, x).permute(2, 0, 1)
    q = 0.1 * np.array([[PAR_DT ** 3 / 3, PAR_DT ** 2 / 2], [PAR_DT ** 2 / 2, PAR_DT]])
    p_dyn = Pendulum2DTransition(GaussRV(2, mean=[1.5, 0.0], cov=0.01 * np.eye(2), device=dev),
                                 GaussRV(2, cov=q, device=dev), dt=PAR_DT)
    p_obs = Pendulum2DMeasurement(GaussRV(1, cov=0.1, device=dev), dim_state=2)
    ut = mtran.UnscentedTransform(2, device=dev)
    p_x = p_dyn.simulate_discrete(gen, steps=PAR_SHORT, mc_sims=1)[..., 0]
    y_p = p_obs.meas_eval(p_x.T, 0).T + p_obs.noise_rv.sample(gen, (PAR_SHORT,))
    traj = iplf._initial_trajectory(iplf._Problem(p_dyn, p_obs, ut, ut, y_p), "observer")
    steps = 100
    xu = dyn.simulate_discrete(gen, steps=steps, mc_sims=PAR_FIT_SETS // steps)
    gp = GaussianProcessModel(1, np.array([[1.0, 3.0]]), "rbf", "ut", device=dev)
    times = torch.arange(steps, dtype=torch.float64, device=dev).repeat(PAR_FIT_SETS // steps)
    fo = dyn.dyn_eval(xu[0].T.reshape(-1, 1, 1) + gp.points.T, times[:, None, None])
    par.fit_kernel_params(gp, np.zeros(2), fo, gp.points, num_steps=2)   # as phase 24 warms it
    mesh_slice(torch, np, dev, (dyn, obs, xs, ys),
               {"pendulum": (p_dyn, p_obs, ut, y_p, traj), "fit": (gp, fo)})


#: phase 26, "studies": each module of ``ssmtoybox_torch/experiments`` run
#: through its ``main`` on the card, with these flags beside ``--device cuda``.
#: The UNGM classical-vs-GPQ study runs twice: at the main path's width
#: through the scalar filter kernel, and in float64 at its published 100
#: runs.  For the script's time limit the float64 UNGM studies run 250 of
#: their 500 steps and BSQ tracking 50 of its 200 s (the eager lanes are
#: launch-bound, and the harness runs each filter twice); every gate held
#: there by a wide margin on the CPU (BSQ-GH NCI 3.3-3.8 against GH 9.4-10.4,
#: GPQKF-GH7 NCI 5.2 / NLL 4.5 against the UKF's 8.2 / 11.2, tracking RMSE
#: 0.69 < 6.1 < 15.7).  The marginalized study does not run here: its filter
#: takes 1.5-2.8 s a step, launch-bound, its gate needs 15 steps (at 5 and 10
#: it does not hold yet), and phase 22 runs both of its searches on the same
#: system at 10,000 runs and holds each to that gate.  The GPQ+D
#: demo runs 200 trajectories, not its published 50: there its gate (the
#: EKF-GPQD's NLL below the EKF's, whose NLL runs into the thousands on a
#: few runs) stood 2.0 standard errors clear (PERF.md, PR 17).
STUDY_UNGM_STEPS, STUDY_TRACK_DUR = 250, 50.0
STUDY_RUNS = (
    ("icinco_ungm", ("--mc", str(MC), "--engine", "dd")),
    ("icinco_ungm", ("--steps", str(STUDY_UNGM_STEPS))),
    ("bsq_ungm", ("--steps", str(STUDY_UNGM_STEPS))),
    ("gpq_tracking", ("--engine", "auto")),
    ("bsq_tracking", ("--dur", str(STUDY_TRACK_DUR))),
    ("tpq_ungm", ()),
    ("tpq_constant_velocity", ()),
    ("gpqd_demo", ("--mc", "200")),
    ("polar2cartesian_mt", ()),
)
#: the conclusion experiments/RESULTS.md draws from each study, as gates:
#: (table title's start, (row, column) that must lie below (row, column))
STUDY_GATES = {
    "icinco_ungm": [("UNGM, ", ("GPQKF-GH7", c), ("UKF", c)) for c in ("nci", "nll")],
    "bsq_ungm": [("UNGM filtered", (f"BSQ-GH{d}", "nci"), (f"GH-{d}", "nci")) for d in (5, 7)],
    "tpq_ungm": [("UNGM glint", ("TPQSF-3", c), ("UKF", c)) for c in ("rmse", "inc")],
    "tpq_constant_velocity": [("CV radar", (r, "inc"), (o, "inc"))
                              for r in ("TPQSF(nu=4)", "GPQSF") for o in ("UKF", "FSQ")],
    "bsq_tracking": [("Reentry tracking", ("bsqkf", "rmse"), ("bsqkf_2e-6", "rmse")),
                     ("Reentry tracking", ("bsqkf_2e-6", "rmse"), ("ukf", "rmse"))],
    "gpqd_demo": [("EKF vs", ("EKF-GPQD", "nll"), ("EKF", "nll"))],
    "polar2cartesian_mt": [("truncated UT", ("dim=8", "TUT_skl"), ("dim=8", "UT_skl"))],
}
#: the largest share of a gated table's runs that may diverge, a row
STUDY_DIVERGED = 0.01


def studies_slice(torch, np, dev):
    """Phase 26, "studies": the studies of ``ssmtoybox_torch/experiments``
    through their ``main([...])`` on the card (``STUDY_RUNS``), each with its
    tables printed, its wall time and the kernel launches it caused (the
    counts set to 0 first).  Gates, each fatal: at most ``STUDY_DIVERGED`` of
    the runs diverged in any row of a table that has a ``diverged`` column;
    each conclusion of ``STUDY_GATES``, its margin printed in standard
    errors where the table has them; ``icinco_ungm --engine dd`` runs every
    lane in the scalar filter kernel (engine ``dd``, at least 7 launches);
    ``gpq_tracking --engine auto`` launches both shaped vector filter kernels
    (the UKF the classical one, the GPQKF the BQ shapes); the
    BSQ studies and ``polar2cartesian_mt`` the Vandermonde kernel; the TPQ
    studies the pairwise Student-MC kernel.  Returns the launches of the
    phase a kernel entry of the ``kernels`` line."""
    import importlib

    from ssmtoybox_torch.ops import scalar_filter as sf, student_mc as smc
    from ssmtoybox_torch.ops import vandermonde as vdm, vector_filter as vf

    def zero():
        sf.LAUNCHES = vdm.LAUNCHES = 0
        vf_zero(vf)
        for k in smc.LAUNCHES:
            smc.LAUNCHES[k] = 0

    def counts():
        return {"scalar_filter": sf.LAUNCHES, "vandermonde": vdm.LAUNCHES, **vf_counts(vf),
                **{f"student_{k}": v for k, v in smc.LAUNCHES.items()}}

    def cell(tables, prefix, row, col):
        (title,) = [t for t in tables if t.startswith(prefix)]
        return tables[title][row], title

    t_phase = time.perf_counter()
    total, walls = {}, {}
    for name, flags in STUDY_RUNS:
        mod = importlib.import_module(f"ssmtoybox_torch.experiments.{name}")
        argv = [*flags, "--device", "cuda"]
        runs = mod.parse(argv).__dict__.get("mc")
        log(f"---- study {name} {' '.join(flags)}")
        torch.cuda.synchronize()
        zero()
        t0 = time.perf_counter()
        tables = mod.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = counts()
        walls[f"{name} {' '.join(flags)}".strip()] = wall
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        log(f"study {name} {' '.join(flags)}: {wall:.1f} s wall on the card, launches "
            + ", ".join(f"{k} {v}" for k, v in got.items() if v))
        # every table whose rows count diverged runs
        for title, rows in tables.items():
            for row, vals in rows.items():
                if "diverged" in vals and runs and vals["diverged"] > STUDY_DIVERGED * runs:
                    fail(f"study {name}, {title}: {row} lost {vals['diverged']} of {runs} runs "
                         f"(limit {STUDY_DIVERGED:.0%})")
        for prefix, (row_a, col_a), (row_b, col_b) in STUDY_GATES.get(name, ()):
            (a, title), (b, _) = cell(tables, prefix, row_a, col_a), cell(tables, prefix, row_b,
                                                                          col_b)
            lo, hi = a[col_a], b[col_b]
            se = [r.get(f"{c}_2std") for r, c in ((a, col_a), (b, col_b))]
            margin = ""
            if None not in se:
                z = (hi - lo) / max(float(np.hypot(se[0] / 2, se[1] / 2)), 1e-300)
                margin = f", {z:.1f} standard errors apart"
            log(f"  gate {title}: {row_a} {col_a} {lo:.4f} < {row_b} {col_b} {hi:.4f}{margin}")
            if not lo < hi:
                fail(f"study {name}: {row_a} {col_a} {lo:.4f} is not below {row_b} {col_b} "
                     f"{hi:.4f} ({title})")
        if name == "icinco_ungm" and "dd" in flags:
            (rows,) = tables.values()
            engines = {row: vals["engine"] for row, vals in rows.items()}
            if set(engines.values()) != {"dd"} or got["scalar_filter"] < 7:
                fail(f"icinco_ungm --engine dd: engines {engines}, scalar filter launches "
                     f"{got['scalar_filter']} (expected dd on every lane, at least 7)")
        need = {"gpq_tracking": ("vector_filter_shaped", "vector_filter_shaped_bq"),
                "bsq_ungm": ("vandermonde",), "bsq_tracking": ("vandermonde",),
                "polar2cartesian_mt": ("vandermonde",), "tpq_ungm": ("student_kxy",),
                "tpq_constant_velocity": ("student_kxy",)}.get(name, ())
        for k in need:
            if got[k] < 1:
                fail(f"study {name}: the {k} kernel was not launched")
    log(f"studies phase: {time.perf_counter() - t_phase:.1f} s in all ("
        + ", ".join(f"{k} {v:.1f} s" for k, v in walls.items()) + f"); launches {total}; "
        f"card: {card_line()}")
    return total


def studies_alone():
    """Phase 26 alone, the kernels built first (each study module's
    ``main`` on the card): ``python3 -c "import chip_smoke;
    chip_smoke.studies_alone()"``."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    from ssmtoybox_torch.ops import scalar_filter as sf, student_mc as smc
    from ssmtoybox_torch.ops import vandermonde as vdm, vector_filter as vf

    if not torch.cuda.is_available():
        fail("studies_alone: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"card: {card_line()} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        for build in [pool.submit(lib.build) for lib in (sf, smc, vdm, vf)]:
            build.result()
    log(f"built the four kernel libraries in {time.perf_counter() - t0:.1f} s")
    studies_slice(torch, np, dev)


def reentry_system(np, dev):
    """The reentry + radar system of ``bench.py``'s lane (``bench.py:109-115``)
    on ``dev``: (dynamics, measurement)."""
    from ssmtoybox_torch.ssmod import Radar2DMeasurement, ReentryVehicle2DTransition
    from ssmtoybox_torch.utils import GaussRV
    dyn = ReentryVehicle2DTransition(
        GaussRV(5, mean=np.array([6500.4, 349.14, -1.8093, -6.7967, 0.6932]),
                cov=np.diag([1e-6, 1e-6, 1e-6, 1e-6, 1.0]), device=dev),
        GaussRV(3, cov=np.diag([2.4064e-5, 2.4064e-5, 1e-6]), device=dev), dt=0.05)
    obs = Radar2DMeasurement(GaussRV(2, cov=np.diag([1e-3, 1e-5]), device=dev),
                             dim_state=5, state_index=[0, 1], radar_loc=np.array([6374.0, 0.0]))
    return dyn, obs


def vector_alone():
    """Phases 15-19 alone (the vector filter kernels' checks, paths and
    timings, then the zoo), the library built first and its build time and
    ptxas lines printed: ``python3 -c "import chip_smoke;
    chip_smoke.vector_alone()"``.  The reentry bench lane is simulated here
    from the seed (not after the UNGM data, as in ``main``)."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    import ssmtoybox_torch as stt
    from ssmtoybox_torch.ops import _build, vector_filter as vf

    if not torch.cuda.is_available():
        fail("vector_alone: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"card: {card_line()} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    vf.build()
    log(f"built the vector filter library's sources ({' + '.join(vf.SOURCES)}) for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in _build.BUILD_LOGS.get("vector_filter", "").splitlines():
        if "Compiling entry" in line or "registers" in line or "spill" in line:
            log(f"  ptxas vector_filter: {line.strip()}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    dyn_re, obs_re = reentry_system(np, dev)
    x_re = dyn_re.simulate_discrete(gen, steps=REENTRY_STEPS, mc_sims=MC)
    xs_re, ys_re = x_re.permute(2, 0, 1), obs_re.simulate_measurements(gen, x_re).permute(2, 0, 1)
    ukf_re = stt.UnscentedKalman(dyn_re, obs_re)
    fused = ukf_re.forward_pass_batch(ys_re, engine="dd")
    torch.cuda.synchronize()
    entries = vector_slice(torch, np, dev, ukf_re, xs_re, ys_re, fused)
    launches, err = zoo_slice(torch, np, dev)
    log(f"vector_alone: entries {json.dumps(entries)}; zoo launches {launches}, errors {err}; "
        f"{time.perf_counter() - t0:.1f} s; card: {card_line()}")


def dd_pairs_alone():
    """The checks of the general forms alone: both libraries built (their
    times printed), the scalar kernel against its plain version at every
    instantiation of phase 2 (the general form's rules included) on the main
    path's UNGM data, phase 15's general vector kernel checks
    (``vf_general_checks``, the five pairs of the other kernels by force) and
    phase 27 (``dd_pairs_slice``): ``python3 -c "import chip_smoke;
    chip_smoke.dd_pairs_alone()"``."""
    import numpy as np
    import torch

    sys.path.insert(0, HERE)
    import ssmtoybox_torch as stt
    from ssmtoybox_torch.ops import _build, scalar_filter as sf, vector_filter as vf
    from ssmtoybox_torch.ssmod import UNGMMeasurement, UNGMTransition
    from ssmtoybox_torch.utils import GaussRV

    if not torch.cuda.is_available():
        fail("dd_pairs_alone: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"card: {card_line()} | torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        took = {lib.__name__.split(".")[-1]: pool.submit(
            lambda m: (m.build(), time.perf_counter() - t0)[1], lib) for lib in (sf, vf)}
        took = {name: f.result() for name, f in took.items()}
    log(f"built the three scalar filter sources and the seven vector filter sources in "
        f"{time.perf_counter() - t0:.1f} s ({took})")
    for line in _build.BUILD_LOGS.get("vector_filter", "").splitlines():
        if "general" in line or "registers" in line or "spill" in line:
            log(f"  ptxas vector_filter: {line.strip()}")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    dyn = UNGMTransition(GaussRV(1, cov=5.0, device=dev), GaussRV(1, cov=10.0, device=dev))
    obs = UNGMMeasurement(GaussRV(1, cov=1.0, device=dev), dim_state=1)
    x = dyn.simulate_discrete(gen, steps=UNGM_STEPS, mc_sims=MC)
    xs, ys = x.permute(2, 0, 1), obs.simulate_measurements(gen, x).permute(2, 0, 1)
    y_tm = ys[:, 0, :].T.contiguous()
    scalar_filter_shapes(torch, np, dev, dyn, obs, y_tm,
                         torch.as_tensor(sf.ungm_consts(UNGM_STEPS), device=dev))
    forced = []
    systems = {"reentry": reentry_system(np, dev), **zoo_systems(np, dev)}
    for name in ("reentry", "pendulum", "falling body", "CT + 4 bearings"):
        d, o = systems[name]
        ukf = stt.UnscentedKalman(d, o)
        yy = o.simulate_measurements(gen, d.simulate_discrete(gen, steps=VF_STEPS, mc_sims=MC))
        forced.append((f"{name} UKF", vf.prepare(d, o, ukf.tf_dyn, ukf.tf_obs),
                       yy.permute(2, 0, 1)))
    seen, err, n = vf_general_checks(torch, np, dev, forced)
    log(f"general vector kernel == plain to the bit at {n} configurations, instantiations "
        f"{sorted(seen)}, max |diff| {max(err.values()):.3e}")
    d_re, o_re = systems["reentry"]
    x_re = d_re.simulate_discrete(gen, steps=REENTRY_STEPS, mc_sims=MC)
    y_re = o_re.simulate_measurements(gen, x_re).permute(2, 0, 1)
    entry, sf_general, sf_err, _, _ = dd_pairs_slice(torch, np, dev, (dyn, obs, xs, ys), took,
                                                     bench=(d_re, o_re, y_re))
    log(f"dd_pairs_alone: general entries {json.dumps(entry)}; scalar general launches "
        f"{sf_general}, max |diff| {sf_err:.3e}; {time.perf_counter() - t0:.1f} s; card: "
        f"{card_line()}")


def main():
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script runs the "
              "port on a CUDA card only", file=sys.stderr)
        return 1
    if not os.path.exists(os.path.join(HERE, "ssmtoybox_torch", "__init__.py")):
        print("chip_smoke: ssmtoybox_torch/ not found beside this script; run it from "
              "a checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)

    import ssmtoybox_torch as stt
    from ssmtoybox_torch.ops import _build, scalar_filter as sf, student_mc as smc, vandermonde as vdm
    from ssmtoybox_torch.ops import vector_filter as vf
    from ssmtoybox_torch.ssmod import UNGMMeasurement, UNGMTransition
    from ssmtoybox_torch.utils import GaussRV
    from ssmtoybox_torch.utils.metrics import rmse

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    log(f"card: {card_line()} | torch {torch.__version__} cuda {torch.version.cuda}")

    # ---- 1. build ---------------------------------------------------------
    t0 = t_start = time.perf_counter()

    def timed_build(lib):
        lib.build()
        return time.perf_counter() - t0

    with ThreadPoolExecutor(4) as pool:
        took = {lib.__name__.split(".")[-1]: pool.submit(timed_build, lib)
                for lib in (sf, smc, vdm, vf)}
        took = {name: build.result() for name, build in took.items()}
    log(f"built scalar_filter.cu + scalar_filter_slots.cu + scalar_filter_slots_wide.cu, "
        f"student_mc.cu + student_qrq.cu, vandermonde.cu and "
        f"vector_filter.cu + vector_filter_shaped.cu + vector_filter_shaped_bq.cu + "
        f"vector_filter_general.cu + vector_filter_general_shaped.cu + "
        f"vector_filter_general_shaped_mixed.cu + vector_filter_shaped_bq_mixed.cu + "
        f"vector_filter_general_shaped_gh.cu + vector_filter_general_slots.cu + "
        f"vector_filter_general_slots_hi.cu + vector_filter_slots.cu for sm_90a in "
        f"{time.perf_counter() - t0:.1f} s (each library done after: "
        + ", ".join(f"{name} {t:.1f} s" for name, t in took.items()) + ")")
    for name in ("scalar_filter", "student_mc", "vandermonde", "vector_filter"):
        text = _build.BUILD_LOGS.get(name, "")
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
        spills = [int(m) for m in re.findall(r"(\d+) bytes spill stores", text)]
        spilled = re.findall(r"Compiling entry function '(\w+)'[^\n]*\n[^\n]*\n[^\n]*?"
                             r"([1-9]\d*) bytes spill stores", text)
        log(f"  ptxas {name}: {len(regs)} kernels, {min(regs, default=0)}-{max(regs, default=0)} "
            f"registers, {sum(spills)} bytes of spill stores in all"
            + "".join(f"; {n_} in {fn}" for fn, n_ in spilled))
        if name in ("student_mc", "vector_filter"):
            for line in text.splitlines():
                if "Compiling entry" in line or "registers" in line or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")

    # ---- the study's models and data, simulated on the card ---------------
    # the UNGM models and the UKF lane are built with no device argument: the
    # port's default device is the card
    gen = torch.Generator(device=dev).manual_seed(SEED)
    dyn = UNGMTransition(GaussRV(1, cov=5.0), GaussRV(1, cov=10.0))
    obs = UNGMMeasurement(GaussRV(1, cov=1.0), dim_state=1)
    x = dyn.simulate_discrete(gen, steps=UNGM_STEPS, mc_sims=MC)
    y = obs.simulate_measurements(gen, x)
    xs, ys = x.permute(2, 0, 1), y.permute(2, 0, 1)                # (M, D, N)
    ukf = stt.UnscentedKalman(dyn, obs)
    on_card = {"init mean": dyn.init_rv.mean, "noise gain": dyn.noise_gain,
               "measurement noise": obs.noise_rv.cov, "UT points": ukf.tf_dyn.unit_sp,
               "UT weights": ukf.tf_obs.wm, "trajectories": x}
    off = [k for k, t in on_card.items() if t.device.type != "cuda"]
    if off:
        fail(f"built with no device argument, these lie off the card: {off}")
    log(f"default device: the UNGM UKF lane built with no device argument lies on "
        f"{stt.default_device()} ({len(on_card)} tensors checked)")
    gpq = stt.GaussianProcessKalman(dyn, obs, np.array([[1.0, 3.0]]), np.array([[1.0, 3.0]]),
                                    points="ut")
    dyn_re, obs_re = reentry_system(np, dev)
    x_re = dyn_re.simulate_discrete(gen, steps=REENTRY_STEPS, mc_sims=MC)
    y_re = obs_re.simulate_measurements(gen, x_re)
    xs_re, ys_re = x_re.permute(2, 0, 1), y_re.permute(2, 0, 1)
    ukf_re = stt.UnscentedKalman(dyn_re, obs_re)
    lanes = {"ungm_ukf": (ukf, xs, ys, "dd"), "ungm_gpqkf": (gpq, xs, ys, "dd"),
             "reentry_ukf": (ukf_re, xs_re, ys_re, "dd")}
    torch.cuda.synchronize()

    # ---- 2. kernel vs plain twin, both on the card --------------------------
    y_tm = ys[:, 0, :].T.contiguous()                                # (N, M)
    c = torch.as_tensor(sf.ungm_consts(UNGM_STEPS), device=dev)
    names = ("m_fi", "P_fi", "m_pr", "P_pr", "xx")
    max_err = 0.0
    for rule, alg in (("ukf", ukf), ("gpq", gpq)):
        params = sf.prepare(dyn, obs, alg.tf_dyn, alg.tf_obs)
        for n_steps, tol in ((1, 1e-13), (20, 1e-9)):
            yy = y_tm[:n_steps, :COMPARE_B].contiguous()
            got = sf.scalar_filter(params, yy, c[:n_steps].contiguous())
            ref = sf._scalar_filter_plain(params, yy, c[:n_steps].contiguous())
            torch.cuda.synchronize()
            errs = [float((g_ - r_).abs().max()) for g_, r_ in zip(got, ref)]
            if n_steps == 20:
                max_err = max(max_err, *errs)
            for name, g_, r_, err in zip(names, got, ref, errs):
                if not torch.allclose(g_, r_, atol=tol, rtol=tol):
                    fail(f"{rule} kernel vs twin, N={n_steps}, {name}: max |diff| {err:.3e} "
                         f"exceeds atol=rtol={tol}")
            log(f"kernel == twin ({rule}, N={n_steps}, B={COMPARE_B}, tol {tol}): max |diff| "
                + ", ".join(f"{n} {e:.2e}" for n, e in zip(names, errs)))
        got = sf.scalar_filter(params, y_tm, c)[0]
        ref = sf._scalar_filter_plain(params, y_tm, c)[0]
        x_tm = xs[:, 0].T[None]                                      # (1, N, M)
        r_got, r_ref = float(rmse(x_tm, got[None])), float(rmse(x_tm, ref[None]))
        rel = abs(r_got - r_ref) / r_ref
        log(f"kernel vs twin study RMSE ({rule}, B={MC}, N={UNGM_STEPS}): {r_got:.6f} vs "
            f"{r_ref:.6f}, relative {rel:.2e} (limit 1e-3)")
        if not rel < 1e-3:
            fail(f"{rule} study RMSE of kernel and twin differ by {rel:.3e} relative")

    scalar_filter_shapes(torch, np, dev, dyn, obs, y_tm, c)

    # ---- 3. goldens on the card ------------------------------------------
    g = np.load(os.path.join(HERE, "tests", "goldens", "ungm.npz"))
    dyn_g = UNGMTransition(GaussRV(1, cov=1.0, device=dev), GaussRV(1, cov=10.0, device=dev))
    obs_g = UNGMMeasurement(GaussRV(1, cov=1.0, device=dev), dim_state=1)
    batch_g = torch.as_tensor(np.moveaxis(g["y"], -1, 0), device=dev)
    for name, alg in (("ukf", stt.UnscentedKalman(dyn_g, obs_g)),
                      ("gpqkf", stt.GaussianProcessKalman(dyn_g, obs_g, np.array([[1.0, 3.0]]),
                                                          np.array([[1.0, 3.0]])))):
        for engine in ("dd", "f64"):
            res = alg.forward_pass_batch(batch_g, engine=engine)
            sm, _ = stt.gaussian_smoother(res)
            for got, key in ((res.fi_mean[0], "fm"), (res.fi_cov[0], "fP"), (sm[0], "sm")):
                if not np.allclose(got.cpu().numpy(), g[f"{name}_{key}"], atol=1e-8, rtol=1e-8):
                    fail(f"golden ungm {name}_{key} ({engine}) off by "
                         f"{np.abs(got.cpu().numpy() - g[f'{name}_{key}']).max():.3e}")
    g = np.load(os.path.join(HERE, "tests", "goldens", "reentry.npz"))
    fm, fP = ukf_re.forward_pass(torch.as_tensor(g["y"][..., 0], device=dev))
    for got, key in ((fm, "ukf_fm"), (fP, "ukf_fP")):
        if not np.allclose(got.cpu().numpy(), g[key], atol=1e-7, rtol=1e-6):
            fail(f"golden reentry {key} off by {np.abs(got.cpu().numpy() - g[key]).max():.3e}")
    ukf_re.reset()
    log("goldens on the card: ungm UKF/GPQKF (dd and f64, 1e-8), reentry UKF (1e-7/1e-6) ok")

    # ---- 4. the main path -------------------------------------------------
    sf.LAUNCHES = 0
    vf_zero(vf)
    results = {}
    for lane, (alg, x_true, data, engine) in lanes.items():
        res = alg.forward_pass_batch(data, engine=engine)
        sm_m, sm_P = stt.gaussian_smoother(res)
        results[lane] = (res, sm_m, sm_P, x_true)
    torch.cuda.synchronize()
    launches, main_vf = sf.LAUNCHES, vf_counts(vf)
    if launches < 2:
        fail(f"the UNGM lanes launched the scalar filter kernel {launches} times; expected 2")
    if main_vf != only("vector_filter_shaped"):
        fail(f"the reentry lane launched the vector filter kernels {main_vf}; expected the "
             "shaped kernel, once")
    for lane, (res, sm_m, sm_P, x_true) in results.items():
        M, D, N = x_true.shape
        if tuple(res.fi_mean.shape) != (M, D, N) or tuple(sm_P.shape) != (M, D, D, N):
            fail(f"{lane}: shapes {tuple(res.fi_mean.shape)}, {tuple(sm_P.shape)}")
        for name, t in (("fi_mean", res.fi_mean), ("fi_cov", res.fi_cov), ("sm_mean", sm_m),
                        ("sm_cov", sm_P)):
            if not bool(torch.isfinite(t).all()):
                fail(f"{lane}: {name} is not finite")
        r_fi = float(rmse(x_true.permute(1, 2, 0), res.fi_mean.permute(1, 2, 0)))
        r_sm = float(rmse(x_true.permute(1, 2, 0), sm_m.permute(1, 2, 0)))
        if not r_sm < r_fi:
            fail(f"{lane}: smoother RMSE {r_sm} not below filter RMSE {r_fi}")
        log(f"{lane} ({lanes[lane][3]}, {M}x{N}): RMSE filter {r_fi:.6f}, smoother {r_sm:.6f}")
    log(f"main path: scalar filter kernel launches {launches}, vector filter kernel launches "
        f"{main_vf}")

    # ---- 5. timings (after the counts were read) --------------------------
    params = sf.prepare(dyn, obs, ukf.tf_dyn, ukf.tf_obs)
    k_ms, k_min = cuda_ms(torch, lambda: sf.scalar_filter(params, y_tm, c))
    p_ms, p_min = cuda_ms(torch, lambda: sf._scalar_filter_plain(params, y_tm, c), reps=3)
    log(f"scalar_filter UKF rule {MC}x{UNGM_STEPS}: kernel {k_ms:.3f} ms (min {k_min:.3f}), "
        f"plain twin {p_ms:.1f} ms (min {p_min:.1f})")
    for lane, (alg, _, data, engine) in lanes.items():
        t = {engine: cuda_ms(torch, lambda: alg.forward_pass_batch(data, engine=engine), reps=3)}
        if engine == "dd":
            t["f64"] = cuda_ms(torch, lambda: alg.forward_pass_batch(data, engine="f64"), reps=3)
        res = results[lane][0]
        t["smoother"] = cuda_ms(torch, lambda: stt.gaussian_smoother(res), reps=3)
        log(f"{lane}: " + ", ".join(f"{k} {v[0]:.2f} ms (min {v[1]:.2f})" for k, v in t.items()))

    vf_entries = vector_slice(torch, np, dev, ukf_re, xs_re, ys_re, results["reentry_ukf"][0])
    vf_entries["vector_filter_shaped"]["launches"] += main_vf["vector_filter_shaped"]
    student, glint = student_slice(torch, np, dev)
    vdm_entry, bsq_sf_launches, vf_track, vf_track_err = bsq_slice(torch, np, dev, xs, ys)
    shaped = vf_entries["vector_filter_shaped"]
    shaped["launches"] += vf_track
    shaped["max_abs_err"] = max(shaped["max_abs_err"], vf_track_err)
    zoo_launches, zoo_err = zoo_slice(torch, np, dev)
    for k, entry in vf_entries.items():
        entry["launches"] += zoo_launches[k]
        entry["max_abs_err"] = max(entry["max_abs_err"], zoo_err[k])
    general, _, _, sf_slots, sf_wide = dd_pairs_slice(
        torch, np, dev, (dyn, obs, xs, ys), took, bench=(dyn_re, obs_re, ys_re))
    for k, entry in general.items():
        checked = vf_entries.pop(k)
        if "ms" in checked:         # timed on its path in phase 18 (the warp form's reentry GH-3)
            checked, entry = entry, checked
        entry["launches"] += checked["launches"]
        entry["max_abs_err"] = max(entry["max_abs_err"], checked["max_abs_err"])
        vf_entries[k] = entry
    registered, _, _, reg_general, sf_reg_slots, sf_reg_wide = registry_slice(
        torch, np, dev)
    for k, (n, e) in reg_general.items():
        vf_entries[k]["launches"] += n
        vf_entries[k]["max_abs_err"] = max(vf_entries[k]["max_abs_err"], e)
    vf_entries.update(registered)
    classical_slice(torch, np, dev, (dyn, obs, xs, ys), (dyn_re, obs_re, xs_re, ys_re), glint)
    rest = bq_rest_slice(torch, np, dev, (dyn, obs, xs, ys), (dyn_re, obs_re, xs_re, ys_re),
                         glint)
    vdm_entry["launches"] += rest["vandermonde"]
    vf_entries["vector_filter_shaped_bq"]["launches"] += rest["vector_filter_shaped_bq"]
    marginal_online_slice(torch, np, dev, (dyn, obs, xs, ys))
    sqrt_slice(torch, np, dev, (dyn, obs, xs, ys), (dyn_re, obs_re, xs_re, ys_re), glint)
    shared = parallel_slice(torch, np, dev)
    mesh_slice(torch, np, dev, (dyn, obs, xs, ys), shared)
    studies = studies_slice(torch, np, dev)
    for entry in student:
        entry["launches"] += studies[entry["name"]]
    vdm_entry["launches"] += studies["vandermonde"]
    for k, entry in vf_entries.items():
        entry["launches"] += studies[k]

    b_ms, b_by = sf_bound(params, *y_tm.shape)
    kernels = {"kernels": [{
        "name": "scalar_filter", "route": "cuda", "source": "ssmtoybox_torch/csrc/scalar_filter.cu",
        "replaces": "ssmtoybox_tpu/ops/ddscan_pallas.py:37",
        "launches": launches + bsq_sf_launches + rest["scalar_filter"] + studies["scalar_filter"],
        "max_abs_err": max_err, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None}, {
        "name": "scalar_filter_slots", "route": "cuda",
        "source": "ssmtoybox_torch/csrc/scalar_filter_slots.cu",
        "replaces": "ssmtoybox_tpu/ops/ddscan_pallas.py:37", **sf_slots}, {
        "name": "scalar_filter_registered_slots", "route": "cuda",
        "source": "ssmtoybox_torch/csrc/scalar_filter_registered.cu",
        "replaces": "ssmtoybox_tpu/ops/ddscan_pallas.py:37", **sf_reg_slots}, {
        "name": "scalar_filter_general", "route": "cuda",
        "source": "ssmtoybox_torch/csrc/scalar_filter.cu",
        "replaces": "ssmtoybox_tpu/ops/ddscan_pallas.py:37", **sf_wide}, {
        "name": "scalar_filter_registered", "route": "cuda",
        "source": "ssmtoybox_torch/csrc/scalar_filter_registered.cu",
        "replaces": "ssmtoybox_tpu/ops/ddscan_pallas.py:37", **sf_reg_wide}] + student + [
        vdm_entry] + [{
        "name": k, "route": "cuda", "source": vf_source(k),
        "replaces": "ssmtoybox_tpu/ops/ddvec.py:514", **entry} for k, entry in vf_entries.items()]}
    log(f"chip_smoke.py ran {time.perf_counter() - t_start:.0f} s in all")
    print(json.dumps(kernels), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
