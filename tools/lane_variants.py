#!/usr/bin/env python3
"""Time the lane-group and warp forms of the general and registered vector
filter kernels (``csrc/vector_filter_lanes.cuh``) against the other forms
and against another tree, on one CUDA card.

    python3 tools/lane_variants.py [--tree DIR] [--reps 5] [--only TEXT ...]

Without ``--tree``: this tree's vector filter library is built three times
at once, as the package ships it (the lane-group form on ``VFL_G`` = 8
lanes a trajectory, the warp form on 32), with ``-DVFL_G=4`` and with
``-DVFL_WARP=16`` (the warp form's design on half a warp, two trajectories
a warp), and so is a registered library for the 8-D chain of
``chip_smoke.registry_systems`` (its forms, and 4 lanes). On each lane of
``LANES`` (10,000 trajectories x 100 steps simulated on the card from the
seed) every form runs by force: the warp form on 32 and on 16 lanes, the
lane-group form on 8 and on 4 lanes where a block holds it, the one-thread
form (EB = 8 up to 8 outputs, the wide form above) and,
on the five pairs the first version instantiates, the first version; each
held to the plain PyTorch version on the first 200 trajectories to the bit,
then timed in turns (the forms, then the same in reverse): ``reps`` raw
launches between two CUDA events behind ``torch.cuda._sleep``. Each form's
line gives its ptxas registers and spills and, for the lane-group and warp
forms, the warps an SM holds and the bytes of shared memory a trajectory.
The lanes: PR 21's lane-group lanes under CKF, the Gauss-Hermite lanes
(reentry + radar, CT + radar, CT + 5, 8, 9 and 16 bearings under GH-3) and
the probes of the warp form's threshold on the point count (falling body +
range, CV + radar and CT + 4 bearings under GH-3: 27, 81 and 243 points).

With ``--tree DIR``: the package of the checkout ``DIR`` is imported (only
the wrapper's API is called on it) and each lane of ``LANES`` timed as that
tree routes it (raw launches of the wrapper call), after its first 200
trajectories are held to its plain version to the bit. Two trees are
compared in one call in turns: the other, this, this, the other.

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
LANES = [("CT + 3 bearings", "CKF"), ("CT + 5 bearings", "CKF"), ("CT + 6 bearings", "CKF"),
         ("CT + 7 bearings", "CKF"), ("CT + 8 bearings", "CKF"), ("CT + 9 bearings", "CKF"),
         ("CT + 16 bearings", "CKF"), ("chain 8-D + radar", "CKF"),
         ("reentry + radar", "GH-3"), ("CT + radar", "GH-3"), ("CT + 5 bearings", "GH-3"),
         ("CT + 8 bearings", "GH-3"), ("CT + 9 bearings", "GH-3"), ("CT + 16 bearings", "GH-3"),
         ("falling body + range", "GH-3"), ("CV + radar", "GH-3"), ("CT + 4 bearings", "GH-3")]
#: the first trajectories held to the plain version
HEAD = 200


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None, help="a checkout of the repository to time")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--only", nargs="*", default=None, help="lanes whose name contains one of these")
    ap.add_argument("--clocks", action="store_true", help="the warp form's clocks a phase")
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
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 21)
    rules = {"CKF": stt.CubatureKalman, "GH-3": lambda d, o: stt.GaussHermiteKalman(d, o, deg=3)}
    lanes = [ln for ln in LANES if args.only is None or any(t in f"{ln[0]} {ln[1]}"
                                                            for t in args.only)]
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
        other_tree(cs, torch, vf, params, data, args.reps, tag, card)
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


def other_tree(cs, torch, vf, params, data, reps, tag, card):
    """Each lane as the tree routes it, through the wrapper."""
    for (name, rule), p in params.items():
        ys = data[name]
        out = vf.vector_filter(p, ys)
        torch.cuda.synchronize()
        held(cs, torch, vf, p, ys, out, f"{tag} {name} {rule}")
        ms = cs.raw_ms(torch, lambda: (vf.vector_filter(p, ys), 0)[1], reps=reps)
        b_ms, b_by = cs.vf_bound(p, ys.shape[-1], ys.shape[0])
        cs.log(f"lane_variants ({tag}) {name} {rule} ({p.dyn.n} points) {ys.shape[0]}x"
               f"{ys.shape[-1]}: {vf.kernel_of(p)} on {vf.lanes_of(p)} lanes (0: one thread); "
               f"== plain to "
               f"the bit on {HEAD} trajectories; raw wrapper launches {ms:.4f} ms; bound "
               f"{b_ms:.4f} ms ({b_by}); card {card}")


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
    ``lib`` in the form of ``lanes``, into buffers made once (``.out``)."""
    B, _, T = y.shape
    out = vf._empty_streams(p.dim_state, T, B, dev)
    c = vf._c_general(p, dev)
    scratch = vf._scratch(p, B, dev, lanes)
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs = [o.data_ptr() for o in out]
    if pair is None:
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


def this_tree(cs, torch, vf, _build, forms, params, data, dev, reps, card):
    """Every form of every lane by force, in turns."""
    from concurrent.futures import ThreadPoolExecutor
    chain = params.get(("chain 8-D + radar", "CKF"))
    key4 = chain and (8, 0, 4, vf._model_policy(chain, "VfrPair", 0))
    reg4 = {}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        jobs = [pool.submit(vf.build),
                pool.submit(_build.bound, "vector_filter_g4", vf.SOURCES, vf._bind,
                            vf._NVCC_FLAGS + ["-DVFL_G=4"]),
                pool.submit(_build.bound, "vector_filter_w16", vf.SOURCES, vf._bind,
                            vf._NVCC_FLAGS + ["-DVFL_WARP=16"])]
        if chain:
            jobs += [pool.submit(vf.build_registered,
                                 [(chain, g) for g in (vf._WARP, vf._LANES, 0)]),
                     pool.submit(forms.build_generated, reg4, [key4],
                                 vf._registered_header([key4]),
                                 name="vector_filter_registered_g4",
                                 source="vector_filter_registered.cu", file="vfr_forms.cuh",
                                 bind=vf._bind_registered, flags=vf._NVCC_FLAGS + ["-DVFL_G=4"],
                                 host=False)]
        lib8, lib4, lib16, *reg = (j.result() for j in jobs)
    fit16 = _build.bound("vector_filter_fit_w16", ["vector_filter_fit.cpp"], vf._bind_fit,
                         ["-DVFL_WARP=16"], host=True)
    cs.log(f"lane_variants: built the library on 8 and 4 lanes and with the warp form on 16, and "
           f"the chain's registered libraries at once in {time.perf_counter() - t0:.1f} s")
    logs = {("general", g): _build.BUILD_LOGS.get("vector_filter", "") for g in (32, 8, 0)}
    logs["general", 4] = _build.BUILD_LOGS.get("vector_filter_g4", "")
    logs["general", 16] = _build.BUILD_LOGS.get("vector_filter_w16", "")

    def fit(p, g):
        """``vf._form_fit`` on g lanes; the warp form on 16 from its own build."""
        if g != 16:
            return vf._form_fit(p, g)
        out = (ctypes.c_int * 4)()
        fit16.vfl_fit_on(ctypes.byref(vf._c_params(p, torch.device("cpu"))), 16, out)
        return tuple(out)
    if chain:
        for g in (32, 8, 0):
            logs["registered", g] = _build.BUILD_LOGS.get(reg[0], "")
        logs["registered", 4] = _build.BUILD_LOGS.get(reg[1], "")
    for (name, rule), p in params.items():
        ys = data[name]
        registered = vf.kernel_of(p) == "vector_filter_registered"
        runs, entry = {}, {}
        plain = vf._vector_filter_plain(p, ys[:HEAD])
        for g in (vf._WARP, 16, 8, 4, 0, "first"):
            if g == "first":
                if not vf._instantiated(p) or registered:
                    continue
                runs[g] = cs.vf_raw(torch, vf, p, ys, dev, "vector_filter")
                targs = (p.dim_state, p.dim_out, p.dyn_model, p.obs_model, p.dyn.kind, p.obs.kind)
                entry[g] = ("vector_filter_kernelI" + "".join(f"Li{t}E" for t in targs) + "E",
                            _build.BUILD_LOGS.get("vector_filter", ""))
            else:
                if (g and not fit(p, g)[0]) or (registered and g == 16):
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
                entry[g] = (fn, logs["registered" if registered else "general", g])
            if runs[g]() != 0:
                cs.fail(f"{name} {rule}: the launch of form {g} failed")
            torch.cuda.synchronize()
            held(cs, torch, vf, p, ys, runs[g].out, f"{name} {rule} form {g}", plain)
        order = list(runs)
        turns = {}
        for g in order + order[::-1]:
            turns.setdefault(g, []).append(cs.raw_ms(torch, runs[g], reps=reps))
        b_ms, b_by = cs.vf_bound(p, ys.shape[-1], ys.shape[0])
        routed = vf.lanes_of(p) if vf.kernel_of(p) != "vector_filter" else "first"
        cs.log(f"lane_variants {name} {rule} ({p.dyn.n} points) {ys.shape[0]}x{ys.shape[-1]}, "
               f"E={p.dim_out}, D={p.dim_state}: routed {vf.kernel_of(p)}, form {routed} "
               f"(lanes; 0: one thread); bound {b_ms:.4f} ms ({b_by}); card {card}")
        for g, ms in turns.items():
            regs, frame, spill = cs.ptxas_of(entry[g][1], entry[g][0])
            occupancy = ""
            if g in (vf._WARP, 16, 8, 4):
                _, _, size, warps = fit(p, g)
                shared = size * 8
                occupancy = (f"; {warps} warps an SM resident, {ys.shape[0] * g / 32 / 132:.1f} "
                             f"in the lane; {shared} bytes of shared memory a trajectory")
            form = ("first version" if g == "first" else "warp form" if g == vf._WARP else
                    "warp form on 16 lanes" if g == 16 else f"{g} lanes" if g else "one thread")
            cs.log(f"  {name} {rule}: {form}{' (routed)' if g == routed else ''}: raw launches "
                   + " / ".join(f"{t:.4f}" for t in ms) + f" ms in turns; == plain on {HEAD}; "
                   f"{regs} registers, {frame} bytes stack frame, {spill} bytes spilled "
                   f"({entry[g][0]}){occupancy}; card {card}")
        del runs


if __name__ == "__main__":
    main()
