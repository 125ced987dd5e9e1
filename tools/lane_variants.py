#!/usr/bin/env python3
"""Time the shaped one-thread, lane-group and warp forms of the general and
registered vector filter kernels (``csrc/vector_filter_general_shaped.cuh``,
``csrc/vector_filter_lanes.cuh``) against the other forms and against
another tree, on one CUDA card.

    python3 tools/lane_variants.py [--tree DIR] [--reps 5] [--only TEXT ...] [--slots]

Without ``--tree``: this tree's vector filter library is built three times
at once, as the package ships it (the lane-group form on ``VFL_G`` = 8
lanes a trajectory, the warp form on 32), with ``-DVFL_G=4`` and with
``-DVFL_WARP=16`` (the warp form's design on half a warp, two trajectories
a warp), and so is a registered library for the 8-D chain of
``chip_smoke.registry_systems`` (its forms, and 4 lanes) and for the
registered lanes of the shaped form (that form and the one-thread form),
and the general kernel's two shaped sources alone four times more, with every
point loop rolled (``-DVGS_UNROLL_BUDGET=0``), every one unrolled (a budget
of 10^9), and on 64 and 128 threads a block (``-DVGS_THREADS``). On each lane of
``LANES`` (10,000 trajectories x 100 steps simulated on the card from the
seed) every form runs by force: the warp form on 32 and on 16 lanes, the
lane-group form on 8 and on 4 lanes where a block holds it, the one-thread
form (EB = 8 up to 8 outputs, the wide form above), the shaped one-thread
form where it takes the shape (as shipped and as those four builds) and,
on the five pairs the first version instantiates, the first version; each
held to the plain PyTorch version on the first 200 trajectories to the bit,
then timed in turns (the forms, then the same in reverse): ``reps`` raw
launches between two CUDA events behind ``torch.cuda._sleep``. Each form's
line gives its ptxas registers and spills and, for the lane-group and warp
forms, the warps an SM holds and the bytes of shared memory a trajectory,
and for the shaped form its SASS: instructions in all and f64 instructions
a step (``chip_smoke.sass_f64_a_step``).
The lanes: PR 21's lane-group lanes under CKF, the Gauss-Hermite lanes
(reentry + radar, CT + radar, CT + 5, 8, 9 and 16 bearings under GH-3), the
probes of the warp form's threshold on the point count (falling body +
range, CV + radar and CT + 4 bearings under GH-3: 27, 81 and 243 points),
the shaped form's lanes (CT + radar under the UKF and the CKF, CT + 2 and
3 bearings and the falling body with 4 under the CKF, the table's pendulum
with the radar, the registered driven pendulum with its two-output
measurement and the registered pendulum copy with the radar under the UKF)
and lanes of other kernels and forms, for turns between trees (the reentry
bench lane's UKF and CT + 4 bearings CKF in the shaped kernel, CT + radar
and reentry + radar under the UKF beside the CKF, in the general kernel's
shaped form and the shaped kernel, the driven pendulum with the radar under
GH-3 in the registered one, reentry + radar under GPQ-UT and under GPQ-UT
beside the CKF in the kernel of the BQ shapes).  A lane of a shaped kernel
(classical or of the BQ shapes) runs there and in the first version by
force, each with its ptxas counts and SASS.

With ``--tree DIR``: the package of the checkout ``DIR`` is imported (only
the wrapper's API is called on it) and each lane of ``LANES`` timed as that
tree routes it (raw launches of the wrapper call), after its first 200
trajectories are held to its plain version to the bit. Two trees are
compared in one call in turns: the other, this, this, the other.
``--sass-out FILE`` (with ``--tree``) writes the SASS opcodes of each lane's
slot-kernel instantiation of the five pairs (``VSL_SHAPES``) in that tree's
library to ``FILE`` as JSON, for comparing two trees' code.

With ``--slots``: the lanes of ``SLOT_LANES`` instead, the Gauss-Hermite
rules that left the first version and the general and registered one-thread
forms: each of the slot kernel's shapes (``csrc/vector_filter_slots.cuh``:
the five pairs' and the general kernel's pairs') as routed and in every
design of ``SLOT_VARIANTS`` (builds of the slot kernel's three sources
alone): G lanes a trajectory (2, 4 and 8) and one thread a trajectory with
the point count a template argument (G = 1), the covariance sums on every
lane or split by output row, the offsets kept or made again, beside the
route each left (the first version; the general kernel's one-thread form);
the registered kernel's slot form against its one-thread form; the shaped
forms' Gauss-Hermite counts (the shaped kernel against the first version,
the general and registered kernels' shaped form against their one-thread
form; the registered shaped form's UKF beside the CKF against its
one-thread form).  Each held to the plain version on the first 200
trajectories to the bit, then timed in turns, with ptxas registers, stack
and spills.

``--only`` keeps the lanes whose name contains one of the texts. With
``--clocks`` the library is built once more with ``-DVFL_CLOCKS`` and each
lane run once in the warp form: lane 0 of every warp reads ``clock64`` at the
end of each phase of a step (``vfl_mark``), and the tool prints each phase's
share of the clocks and its clocks a warp a step (the wait for the issue
slots that other warps take included). Every line names the card and its
power limit. Exits with 1 if a form is not equal to
its reference to the bit.
"""
import argparse
import ctypes
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (system of ``chip_smoke.general_systems`` / ``registry_systems`` /
#: ``vf_probe_systems``, rule)
LANES = [("CT + radar", "UKF"), ("CT + radar", "CKF"), ("CT + 2 bearings", "CKF"),
         ("falling body + 4 bearings", "CKF"), ("pendulum + radar", "UKF"),
         ("driven pendulum + mix", "UKF"), ("pendulum copy + radar", "UKF"),
         ("reentry + radar", "UKF"), ("CT + 4 bearings", "CKF"), ("CT + radar", "UKF/CKF"),
         ("reentry + radar", "UKF/CKF"), ("driven pendulum + radar", "GH-3"),
         ("CT + 3 bearings", "CKF"), ("CT + 5 bearings", "CKF"), ("CT + 6 bearings", "CKF"),
         ("CT + 7 bearings", "CKF"), ("CT + 8 bearings", "CKF"), ("CT + 9 bearings", "CKF"),
         ("CT + 16 bearings", "CKF"), ("chain 8-D + radar", "CKF"),
         ("reentry + radar", "GH-3"), ("CT + radar", "GH-3"), ("CT + 5 bearings", "GH-3"),
         ("CT + 8 bearings", "GH-3"), ("CT + 9 bearings", "GH-3"), ("CT + 16 bearings", "GH-3"),
         ("falling body + range", "GH-3"), ("CV + radar", "GH-3"), ("CT + 4 bearings", "GH-3"),
         ("reentry + radar", "GPQ-UT/CKF"), ("reentry + radar", "GPQ-UT")]
#: ``--slots``: the slot kernel's shapes of the five pairs (GH-2 on reentry +
#: radar, CT + 4 bearings and CV + radar; GH-3 on CV + radar and the falling
#: body) and the shaped forms' Gauss-Hermite counts (the zoo's pendulum under
#: GH-3 and falling body under GH-2 in the shaped kernel, the pendulum + radar
#: under GH-3 in the general kernel's shaped form, the registered driven
#: pendulum + radar under GH-3 in the registered kernel's), the registered
#: lanes of the UKF beside the CKF (the driven pendulum + mix and the
#: pendulum copy + radar, in the registered shaped form against its
#: one-thread form), the first version's GH-4 on the pendulum (16 points),
#: which it keeps; then the general kernel's pairs' shapes in the slot kernel
#: (``VSL_GENERAL``) and the registered driven pendulum + radar under GH-4 in
#: the registered slot form
SLOT_LANES = [("reentry + radar", "GH-2"), ("CT + 4 bearings", "GH-2"), ("CV + radar", "GH-2"),
              ("CV + radar", "GH-3"), ("falling body + range", "GH-3"),
              ("pendulum + sine", "GH-3"), ("falling body + range", "GH-2"),
              ("pendulum + radar", "GH-3"), ("driven pendulum + radar", "GH-3"),
              ("driven pendulum + mix", "UKF/CKF"), ("pendulum copy + radar", "UKF/CKF"),
              ("pendulum + sine", "GH-4"),
              ("pendulum + radar", "GH-4"), ("pendulum + UNGM", "GH-4"),
              ("pendulum + 3 bearings", "GH-4"), ("falling body + sine", "GH-3"),
              ("falling body + 4 bearings", "GH-3"), ("falling body + sine", "GH-4"),
              ("falling body + 4 bearings", "GH-4"), ("CV + 2 bearings", "GH-2"),
              ("CV + 3 bearings", "GH-2"), ("CV + 2 bearings", "GH-3"), ("CV + 3 bearings", "GH-3"),
              ("CT + radar", "GH-2"), ("CT + 2 bearings", "GH-2"), ("CT + 3 bearings", "GH-2"),
              ("reentry + range", "GH-2"), ("reentry + UNGM", "GH-2"),
              ("driven pendulum + radar", "GH-4")]
#: ``--slots``' builds of the slot kernel's sources alone, every shape in each
#: design: G lanes a trajectory (1: the shaped step one thread a trajectory),
#: the covariance sums on every lane (rep.) or split by row, the offsets kept
#: or made again
SLOT_SOURCES = ["vector_filter_general_slots.cu", "vector_filter_general_slots_hi.cu",
                "vector_filter_slots.cu"]
SLOT_VARIANTS = {f"G={g}{' split' * split}{', kept' if keep else ''}":
                 f"-DVSL_LANES={g} -DVSL_SPLIT={split} -DVSL_KEEP_OFFSETS={keep}"
                 for g in (1, 2, 4, 8) for split in (0, 1) for keep in (0, 1)
                 if g > 1 or not split}
#: the first trajectories held to the plain version
HEAD = 200


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None, help="a checkout of the repository to time")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", nargs="*", default=None, help="lanes whose name contains one of these")
    ap.add_argument("--clocks", action="store_true", help="the warp form's clocks a phase")
    ap.add_argument("--slots", action="store_true", help="the slot kernel's and the shaped "
                    "forms' Gauss-Hermite lanes (SLOT_LANES)")
    ap.add_argument("--sass-out", default=None, help="with --tree: the five pairs' slot "
                    "kernels' SASS opcodes to this JSON file")
    args = ap.parse_args()
    root = os.path.abspath(args.tree or HERE)
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import ssmtoybox_torch as stt
    from ssmtoybox_torch.ops import _build, forms, vector_filter as vf

    if os.path.dirname(os.path.dirname(os.path.abspath(stt.__file__))) != root:
        cs.fail(f"imported {stt.__file__}, not the package of {root}")
    if not torch.cuda.is_available():
        cs.fail("no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    tag = "this tree" if root == HERE else root
    card = cs.card_line()
    cs.log(f"lane_variants ({tag}): card {card} | torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    systems = {**cs.general_systems(np, dev), **cs.registry_systems(np, dev),
               **cs.vf_probe_systems(np, dev)}
    systems["pendulum + sine"] = cs.zoo_systems(np, dev)["pendulum"]
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 21)
    gpq_re = (np.array(cs.VF_GPQ_DYN), np.array(cs.VF_GPQ_OBS))     # reentry's GPQ parameters
    rules = {"UKF": stt.UnscentedKalman, "CKF": stt.CubatureKalman,
             **{f"GH-{g}": (lambda g: lambda d, o: stt.GaussHermiteKalman(d, o, deg=g))(g)
                for g in (2, 3, 4)},
             "UKF/CKF": lambda d, o: stt.GaussianInference(d, o, stt.UnscentedKalman(d, o).tf_dyn,
                                                           stt.CubatureKalman(d, o).tf_obs),
             "GPQ-UT": lambda d, o: stt.GaussianProcessKalman(d, o, *gpq_re),
             "GPQ-UT/CKF": lambda d, o: stt.GaussianInference(
                 d, o, stt.GaussianProcessKalman(d, o, *gpq_re).tf_dyn,
                 stt.CubatureKalman(d, o).tf_obs)}
    lanes = [ln for ln in (SLOT_LANES if args.slots else LANES)
             if args.only is None or any(t in f"{ln[0]} {ln[1]}" for t in args.only)]
    params, data = {}, {}
    for name, rule in lanes:
        dyn, obs = systems[name]
        alg = rules[rule](dyn, obs)
        params[name, rule] = vf.prepare(dyn, obs, alg.tf_dyn, alg.tf_obs)
        if name not in data:
            x = dyn.simulate_discrete(gen, steps=cs.REG_STEPS, mc_sims=cs.MC)
            data[name] = obs.simulate_measurements(gen, x).permute(2, 0, 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if args.clocks:
        clocks(cs, torch, vf, _build, params, data, dev, card)
    if args.tree:
        other_tree(cs, torch, vf, params, data, args.reps, tag, card, args.sass_out)
    elif args.slots:
        slot_turns(cs, torch, vf, _build, params, data, dev, args.reps, card)
    else:
        this_tree(cs, torch, vf, _build, forms, params, data, dev, args.reps, card)
    cs.log(f"lane_variants ({tag}): {time.perf_counter() - t0:.1f} s; card: {cs.card_line()}")


def held(cs, torch, vf, p, ys, out, what, plain=None):
    """``out``'s first ``HEAD`` trajectories against the plain version's
    (``plain``, computed here if None)."""
    if plain is None:
        plain = vf._vector_filter_plain(p, ys[:HEAD])
    got = tuple(o[..., :HEAD] for o in out)
    if not all(cs.same_bits(torch, a, b) for a, b in zip(got, plain)):
        diff = max(float((a - b).nan_to_num().abs().max()) for a, b in zip(got, plain))
        cs.fail(f"{what}: differs from the plain version on {HEAD} trajectories, max |diff| "
                f"{diff:.3e}; expected equal bits")


def other_tree(cs, torch, vf, params, data, reps, tag, card, sass_out=None):
    """Each lane as the tree routes it, through the wrapper; ``sass_out``: a
    JSON file for the SASS opcodes of the five pairs' slot-kernel lanes."""
    import json
    sass = {}
    for (name, rule), p in params.items():
        ys = data[name]
        out = vf.vector_filter(p, ys)
        torch.cuda.synchronize()
        held(cs, torch, vf, p, ys, out, f"{tag} {name} {rule}")
        ms = cs.raw_ms(torch, lambda: (vf.vector_filter(p, ys), 0)[1], reps=reps)
        b_ms, b_by = cs.vf_bound(p, ys.shape[-1], ys.shape[0])
        cs.log(f"lane_variants ({tag}) {name} {rule} ({p.dyn.n}/{p.obs.n} points) {ys.shape[0]}x"
               f"{ys.shape[-1]}: {vf.kernel_of(p)} on {vf.lanes_of(p)} lanes (0: one thread; "
               f"1, since the shaped form: one thread, shaped); "
               f"== plain to "
               f"the bit on {HEAD} trajectories; raw wrapper launches {ms:.4f} ms; bound "
               f"{b_ms:.4f} ms ({b_by}); card {card}")
        if sass_out and vf.kernel_of(p) == "vector_filter_slots" and vf._instantiated(p):
            fn = cs.shaped_entry("vector_filter_slots", p)
            sass[fn] = [op for _, op, _ in cs.sass_listing(vf.build()._name, fn) or []]
    if sass_out:
        with open(sass_out, "w") as f:
            json.dump(sass, f)
        cs.log(f"lane_variants ({tag}): SASS of {len(sass)} slot-kernel instantiations ("
               + ", ".join(f"{len(v)} instructions" for v in sass.values()) + f") to {sass_out}")


#: the phases of a step that ``vfl_mark`` ends, in order
PHASES = ("chol(P)", "dyn points", "dyn mean", "dyn sums", "P_pr, chol(P_pr)", "obs points",
          "obs mean", "obs sums", "chol(S), gain, update")


def clocks(cs, torch, vf, _build, params, data, dev, card):
    """Each lane once in the warp form of a ``-DVFL_CLOCKS`` build: the clocks
    of each phase of a step, summed over the warps."""
    lib = _build.bound("vector_filter_clk", vf.SOURCES, vf._bind,
                       vf._NVCC_FLAGS + ["-DVFL_CLOCKS"])
    lib.vfl_clock_totals.restype = ctypes.c_int
    lib.vfl_clock_totals.argtypes = [ctypes.c_void_p]
    tot = (ctypes.c_longlong * 16)()
    for (name, rule), p in params.items():
        if not vf._form_fit(p, vf._WARP)[0] or vf.kernel_of(p) == "vector_filter_registered":
            continue
        ys = data[name]
        run = launcher(torch, vf, lib, None, p, ys, dev, vf._WARP)
        if lib.vfl_clock_totals(tot) != 0 or run() != 0 or lib.vfl_clock_totals(tot) != 0:
            cs.fail(f"{name} {rule}: the clocks build's launch failed")
        steps = ys.shape[0] * ys.shape[-1]
        per = [tot[i] / steps for i in range(len(PHASES))]
        cs.log(f"lane_variants --clocks {name} {rule} ({p.dyn.n} points) {ys.shape[0]}x"
               f"{ys.shape[-1]}: clocks a warp a step {sum(per):.0f}: "
               + ", ".join(f"{ph} {c:.0f} ({c / sum(per):.1%})" for ph, c in zip(PHASES, per))
               + f"; card {card}")


def launcher(torch, vf, lib, pair, p, y, dev, lanes):
    """A raw launch of the general (``pair`` None) or registered kernel of
    ``lib`` in the form of ``lanes`` (the registered slot form too), into
    buffers made once (``.out``)."""
    B, _, T = y.shape
    out = vf._empty_streams(p.dim_state, T, B, dev)
    c = vf._c_struct("vector_filter_general" if pair is None else "vector_filter_registered", p,
                     dev, lanes)
    scratch = vf._scratch(p, B, dev, lanes)
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs = [o.data_ptr() for o in out]
    if lanes in (vf._SHAPED, vf._SLOTS) and pair is not None:
        s = vf._streams_on(p, T, dev)
        run = lib.vfr_shaped_launch if lanes == vf._SHAPED else lib.vfr_slots_launch

        def launch():
            return run(pair, ctypes.byref(c), y.data_ptr(), *y.stride(), s.data_ptr(), p.n_s, B,
                       T, dev.index or 0, *outs, stream)
    elif lanes == vf._SHAPED:
        def launch():
            return lib.vgs_launch(ctypes.byref(c), y.data_ptr(), *y.stride(), B, T,
                                  dev.index or 0, *outs, stream)
    elif pair is None:
        def launch():
            return lib.vfg_launch(ctypes.byref(c), y.data_ptr(), *y.stride(), B, T,
                                  dev.index or 0, *outs, scratch.data_ptr(), lanes, stream)
    else:
        s = vf._streams_on(p, T, dev)

        def launch():
            return lib.vfr_launch(pair, ctypes.byref(c), y.data_ptr(), *y.stride(), s.data_ptr(),
                                  p.n_s, B, T, dev.index or 0, *outs, scratch.data_ptr(), stream)
    launch.out = out
    return launch


#: the shaped form's other builds: every point loop rolled or unrolled
#: (``VGS_UNROLL_BUDGET``), 64 or 128 threads a block (``VGS_THREADS``)
BUDGETS = {"rolled": "VGS_UNROLL_BUDGET=0", "unrolled": f"VGS_UNROLL_BUDGET={10 ** 9}",
           "64 threads a block": "VGS_THREADS=64", "128 threads a block": "VGS_THREADS=128"}


def _bind_vgs(lib):
    lib.vgs_launch.restype = ctypes.c_int
    lib.vgs_launch.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3
                               + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6)


def sass_of(cs, lib, fn, n_points):
    """``(SASS instructions, f64 instructions a step)`` of the kernel whose
    mangled name contains ``fn`` in ``lib``; Nones without cuobjdump."""
    listing = cs.sass_listing(lib._name, fn)
    if not listing:
        return None, None
    return len(listing), cs.sass_f64_a_step(listing, n_points)


def this_tree(cs, torch, vf, _build, forms, params, data, dev, reps, card):
    """Every form of every lane by force, in turns."""
    from concurrent.futures import ThreadPoolExecutor
    chain = params.get(("chain 8-D + radar", "CKF"))
    key4 = chain and (8, 0, 4, vf._model_policy(chain, "VfrPair", 0))
    reg4 = {}
    # the registered lanes' forms: the chain's every form, the others' shaped and one-thread
    reg_forms = {lane: ((vf._WARP, vf._LANES, 0) if p is chain else
                        (vf._SHAPED, 0) if vf._shaped_takes(p) else (vf.lanes_of(p),))
                 for lane, p in params.items() if vf.kernel_of(p) == "vector_filter_registered"}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(6) as pool:
        jobs = [pool.submit(vf.build),
                pool.submit(_build.bound, "vector_filter_g4", vf.SOURCES, vf._bind,
                            vf._NVCC_FLAGS + ["-DVFL_G=4"]),
                pool.submit(_build.bound, "vector_filter_w16", vf.SOURCES, vf._bind,
                            vf._NVCC_FLAGS + ["-DVFL_WARP=16"])]
        jobs += [pool.submit(_build.bound, f"vector_filter_gs_{name.split()[0]}",
                             ["vector_filter_general_shaped.cu",
                              "vector_filter_general_shaped_mixed.cu"], _bind_vgs,
                             vf._NVCC_FLAGS + [f"-D{setting}"])
                 for name, setting in BUDGETS.items()]
        if reg_forms:
            jobs.append(pool.submit(vf.build_registered, [(params[lane], g) for lane, gs in
                                                          reg_forms.items() for g in gs]))
        if chain:
            jobs.append(pool.submit(forms.build_generated, reg4, [key4],
                                    vf._registered_header([key4]),
                                    name="vector_filter_registered_g4",
                                    source="vector_filter_registered.cu", file="vfr_forms.cuh",
                                    bind=vf._bind_registered,
                                    flags=vf._NVCC_FLAGS + ["-DVFL_G=4"], host=False))
        lib8, lib4, lib16, *rest = (j.result() for j in jobs)
    budget_libs = dict(zip(BUDGETS, rest))
    reg_name = rest[len(BUDGETS)] if reg_forms else None
    fit16 = _build.bound("vector_filter_fit_w16", ["vector_filter_fit.cpp"], vf._bind_fit,
                         ["-DVFL_WARP=16"], host=True)
    cs.log(f"lane_variants: built the library on 8 and 4 lanes and with the warp form on 16, the "
           f"shaped source rolled and unrolled, and the registered lanes' libraries at once in "
           f"{time.perf_counter() - t0:.1f} s")
    logs = {("general", g): _build.BUILD_LOGS.get("vector_filter", "")
            for g in (32, 8, 0, vf._SHAPED)}
    logs["general", 4] = _build.BUILD_LOGS.get("vector_filter_g4", "")
    logs["general", 16] = _build.BUILD_LOGS.get("vector_filter_w16", "")
    for name in BUDGETS:
        logs["general", name] = _build.BUILD_LOGS.get(f"vector_filter_gs_{name.split()[0]}", "")
    for g in (32, 8, 0, vf._SHAPED):
        logs["registered", g] = _build.BUILD_LOGS.get(reg_name, "")
    if chain:
        logs["registered", 4] = _build.BUILD_LOGS.get(rest[-1], "")

    def fit(p, g):
        """``vf._form_fit`` on g lanes; the warp form on 16 from its own build."""
        if g != 16:
            return vf._form_fit(p, g)
        out = (ctypes.c_int * 4)()
        fit16.vfl_fit_on(ctypes.byref(vf._c_params(p, torch.device("cpu"))), 16, out)
        return tuple(out)
    for (name, rule), p in params.items():
        kernel = vf.kernel_of(p)
        ys = data[name]
        registered = kernel == "vector_filter_registered"
        shaped = vf._shaped_takes(p)
        runs, entry = {}, {}
        plain = vf._vector_filter_plain(p, ys[:HEAD])
        candidates = (("kernel", "first") if kernel in ("vector_filter_shaped",
                                                        "vector_filter_shaped_bq") else
                      (vf._SHAPED, *BUDGETS, vf._WARP, 16, 8, 4, 0, "first"))
        for g in candidates:
            if g == "kernel":
                # a shaped kernel (classical, or of the BQ shapes), the point counts
                # template arguments
                runs[g] = cs.vf_raw(torch, vf, p, ys, dev, kernel)
                entry[g] = (cs.shaped_entry(kernel, p), _build.BUILD_LOGS.get("vector_filter", ""),
                            vf.build())
            elif g == "first":
                if not vf._instantiated(p) or registered:
                    continue
                runs[g] = cs.vf_raw(torch, vf, p, ys, dev, "vector_filter")
                targs = (p.dim_state, p.dim_out, p.dyn_model, p.obs_model, p.dyn.kind, p.obs.kind)
                entry[g] = ("vector_filter_kernelI" + "".join(f"Li{t}E" for t in targs) + "E",
                            _build.BUILD_LOGS.get("vector_filter", ""), vf.build())
            elif g == vf._SHAPED or g in BUDGETS:
                if not shaped or (registered and g != vf._SHAPED):
                    continue
                if registered:
                    lib, pair = vf._registered(p, False, g)
                    fn = f"VfrPair{pair}E"
                else:
                    lib, pair = budget_libs.get(g, lib8), None
                    fn = cs.form_ptxas(vf, p, "vector_filter_general", vf._SHAPED, "")[3]
                runs[g] = launcher(torch, vf, lib, pair, p, ys, dev, vf._SHAPED)
                entry[g] = (fn, logs["registered" if registered else "general", g], lib)
            else:
                if (g and not fit(p, g)[0]) or (registered and g == 16) or (
                        registered and g not in reg_forms[name, rule] and g != 4) or (
                        registered and g == 4 and p is not chain):
                    continue
                if registered:
                    lib, pair = reg4[False, key4] if g == 4 else vf._registered(p, False, g)
                    fn = f"VfrPair{pair}E"
                else:
                    lib, pair = {4: lib4, 16: lib16}.get(g, lib8), None
                    fn = (f"vector_filter_lanes_kernelILi{p.dim_state}ELi{g}E" if g else
                          f"vector_filter_general_kernelILi{p.dim_state}ELi"
                          f"{vf._bound_of(p.dim_out)}E")
                runs[g] = launcher(torch, vf, lib, pair, p, ys, dev, g)
                entry[g] = (fn, logs["registered" if registered else "general", g], lib)
            if runs[g]() != 0:
                cs.fail(f"{name} {rule}: the launch of form {g} failed")
            torch.cuda.synchronize()
            held(cs, torch, vf, p, ys, runs[g].out, f"{name} {rule} form {g}", plain)
        order = list(runs)
        turns = {}
        for g in order + order[::-1]:
            turns.setdefault(g, []).append(cs.raw_ms(torch, runs[g], reps=reps))
        b_ms, b_by = cs.vf_bound(p, ys.shape[-1], ys.shape[0])
        routed = {"vector_filter": "first", "vector_filter_shaped": "kernel",
                  "vector_filter_shaped_bq": "kernel"}.get(kernel, vf.lanes_of(p))
        cs.log(f"lane_variants {name} {rule} ({p.dyn.n}/{p.obs.n} points) {ys.shape[0]}x"
               f"{ys.shape[-1]}, E={p.dim_out}, D={p.dim_state}: routed {kernel}, form {routed} "
               f"(lanes; 0: one thread, {vf._SHAPED}: shaped one thread); bound {b_ms:.4f} ms "
               f"({b_by}); card {card}")
        for g, ms in turns.items():
            fn, log_text, lib = entry[g]
            regs, frame, spill = cs.ptxas_of(log_text, fn)
            occupancy = ""
            if g in (vf._WARP, 16, 8, 4):
                _, _, size, warps = fit(p, g)
                shared = size * 8
                occupancy = (f"; {warps} warps an SM resident, {ys.shape[0] * g / 32 / 132:.1f} "
                             f"in the lane; {shared} bytes of shared memory a trajectory")
            elif g in (vf._SHAPED, "kernel") or g in BUDGETS:
                n_sass, f64 = sass_of(cs, lib, fn, p.dyn.n)
                occupancy = (f"; SASS {n_sass} instructions, {f64} f64 a step (loops counted at "
                             f"{p.dyn.n} points)")
            form = ("first version" if g == "first" else "shaped kernel" if g == "kernel" else
                    "warp form" if g == vf._WARP else
                    "warp form on 16 lanes" if g == 16 else
                    "shaped one thread" if g == vf._SHAPED else
                    f"shaped one thread, {g}" if "threads" in str(g) else
                    f"shaped one thread, every point loop {g}" if g in BUDGETS else
                    f"{g} lanes" if g else "one thread")
            cs.log(f"  {name} {rule}: {form}{' (routed)' if g == routed else ''}: raw launches "
                   + " / ".join(f"{t:.4f}" for t in ms) + f" ms in turns; == plain on {HEAD}; "
                   f"{regs} registers, {frame} bytes stack frame, {spill} bytes spilled "
                   f"({fn}){occupancy}; card {card}")
        del runs


def _bind_vsl(lib):
    lib.vsl_launch.restype = ctypes.c_int
    lib.vsl_launch.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 3
                               + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 6)
    lib.vsl_lanes_on.restype = ctypes.c_int
    lib.vsl_lanes_on.argtypes = [ctypes.c_void_p]


def _slot_lib(variant):
    """The library name of a ``--slots`` build of the slot source."""
    return "vector_filter_slots_" + "".join(ch for ch in variant if ch.isalnum())


def slot_turns(cs, torch, vf, _build, params, data, dev, reps, card):
    """``--slots``: every design of each lane of ``SLOT_LANES`` by force, in
    turns with the route it left."""
    from concurrent.futures import ThreadPoolExecutor
    variants = dict(SLOT_VARIANTS)
    reg = [(p, g) for p in params.values() if vf.kernel_of(p) == "vector_filter_registered"
           for g in (vf.lanes_of(p), 0)]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(variants) + 2) as pool:
        jobs = {name: pool.submit(_build.bound, _slot_lib(name), SLOT_SOURCES,
                                  _bind_vsl, vf._NVCC_FLAGS + flag.split())
                for name, flag in variants.items()}
        main = pool.submit(vf.build)
        if reg:
            regj = pool.submit(vf.build_registered, reg)
        libs = {name: j.result() for name, j in jobs.items()}
        lib = main.result()
        reg_name = regj.result() if reg else None
    cs.log(f"lane_variants --slots: built the library, the slot source on "
           f"{', '.join(variants)} and the registered lanes at once in "
           f"{time.perf_counter() - t0:.1f} s")
    main_log = _build.BUILD_LOGS.get("vector_filter", "")
    for (name, rule), p in params.items():
        kernel = vf.kernel_of(p)
        ys = data[name]
        B, _, T = ys.shape
        plain = vf._vector_filter_plain(p, ys[:HEAD])
        runs, entry = {}, {}
        targs = (p.dim_state, p.dim_out, p.dyn_model, p.obs_model)
        first_fn = ("vector_filter_kernelI" + "".join(f"Li{t}E" for t in targs + (
            p.dyn.kind, p.obs.kind)) + "E")
        if kernel in ("vector_filter", "vector_filter_shaped", "vector_filter_slots"):
            if kernel != "vector_filter":
                runs["routed"] = cs.vf_raw(torch, vf, p, ys, dev)
                fn = cs.shaped_entry(kernel, p)
                entry["routed"] = (fn, main_log)
            if vf._instantiated(p):
                runs["first"] = cs.vf_raw(torch, vf, p, ys, dev, "vector_filter")
                entry["first"] = (first_fn, main_log)
            else:
                # a general pair: the general kernel's one-thread form, the route it left
                runs[0] = launcher(torch, vf, lib, None, p, ys, dev, 0)
                entry[0] = (f"vector_filter_general_kernelILi{p.dim_state}ELi"
                            f"{vf._bound_of(p.dim_out)}E", main_log)
            if kernel == "vector_filter_slots":
                c = vf._c_slot_params(p, dev)
                stream = torch.cuda.current_stream(dev).cuda_stream
                for name_v, vlib in libs.items():
                    vname = f"{name_v} ({vlib.vsl_lanes_on(ctypes.byref(c.base))} lanes)"
                    out = vf._empty_streams(p.dim_state, T, B, dev)
                    outs = [o.data_ptr() for o in out]

                    def launch(vlib=vlib, outs=outs):
                        return vlib.vsl_launch(ctypes.byref(c), ys.data_ptr(), *ys.stride(), B,
                                               T, dev.index or 0, *outs, stream)
                    launch.out = out
                    runs[vname] = launch
                    entry[vname] = (cs.shaped_entry(kernel, p),
                                    _build.BUILD_LOGS.get(_slot_lib(name_v), ""))
        else:
            registered = kernel == "vector_filter_registered"
            for g in (vf.lanes_of(p), 0):
                if registered:
                    rlib, pair = vf._registered(p, False, g)
                    fn = cs.form_ptxas(vf, p, kernel, g, "")[3]
                    log_text = _build.BUILD_LOGS.get(reg_name, "")
                else:
                    rlib, pair = lib, None
                    fn = (cs.form_ptxas(vf, p, kernel, g, "")[3] if g else
                          f"vector_filter_general_kernelILi{p.dim_state}ELi"
                          f"{vf._bound_of(p.dim_out)}E")
                    log_text = main_log
                runs[g] = launcher(torch, vf, rlib, pair, p, ys, dev, g)
                entry[g] = (fn, log_text)
        for g, run in runs.items():
            if run() != 0:
                cs.fail(f"{name} {rule}: the launch of {g} failed")
            torch.cuda.synchronize()
            held(cs, torch, vf, p, ys, run.out, f"{name} {rule} {g}", plain)
        order = list(runs)
        turns = {}
        for g in order + order[::-1]:
            turns.setdefault(g, []).append(cs.raw_ms(torch, runs[g], reps=reps))
        b_ms, b_by = cs.vf_bound(p, T, B)
        cs.log(f"lane_variants --slots {name} {rule} ({p.dyn.n} points) {B}x{T}, D={p.dim_state}, "
               f"E={p.dim_out}: routed {kernel} (lanes_of {vf.lanes_of(p)}, slot_lanes "
               f"{vf.slot_lanes(p)}); bound {b_ms:.4f} ms ({b_by}); card {card}")
        for g, ms in turns.items():
            fn, log_text = entry[g]
            regs, frame, spill = cs.ptxas_of(log_text, fn)
            form = {vf._SHAPED: "shaped one thread", 0: "one thread (N at run time)",
                    vf._SLOTS: f"slot form on {vf.slot_lanes(p)} lanes"}.get(g, g)
            cs.log(f"  {name} {rule}: {form}: raw launches " + " / ".join(f"{t:.4f}" for t in ms)
                   + f" ms in turns; == plain on {HEAD}; {regs} registers, {frame} bytes stack "
                   f"frame, {spill} bytes spilled ({fn}); card {card}")
        del runs


if __name__ == "__main__":
    main()
