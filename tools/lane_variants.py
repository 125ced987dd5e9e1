#!/usr/bin/env python3
"""Time the lane-group form of the general and registered vector filter
kernels (``csrc/vector_filter_lanes.cuh``) against the other forms and
against another tree, on one CUDA card.

    python3 tools/lane_variants.py [--tree DIR] [--reps 5]

Without ``--tree``: this tree's vector filter library is built twice at once,
as the package ships it (the lane-group form on ``VFL_G`` = 8 lanes a
trajectory) and with ``-DVFL_G=4``, and so is a registered library for the
8-D chain of ``chip_smoke.registry_systems`` (both forms, and 4 lanes). On
each lane of ``LANES`` (10,000 trajectories x 100 steps simulated on the card
from the seed) every form runs by force: the lane-group form on 8 and on 4
lanes and the one-thread form (EB = 8 up to 8 outputs, the wide form
above), each held to the plain PyTorch version on the first 200
trajectories to the bit, then timed in turns (8, 4, 0, 0, 4, 8): ``reps`` raw launches between two CUDA
events behind ``torch.cuda._sleep``. Each form's line gives its ptxas
registers and spills and, for the lane-group form, the warps an SM holds.
The reentry bench lane under GH-3 (243 points, the first version's path)
runs through the lane-group form by force beside the first version, to the
bit against it.

With ``--tree DIR``: the package of the checkout ``DIR`` is imported (only
the wrapper's API is called on it) and each lane of ``LANES`` timed as that
tree routes it (raw launches of the wrapper call), after its first 200
trajectories are held to its plain version to the bit. Two trees are
compared in one call in turns: the other, this, this, the other.

Exits with 1 if a form is not equal to its reference to the bit.
"""
import argparse
import ctypes
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (system of ``chip_smoke.general_systems`` / ``registry_systems``, rule)
LANES = [("CT + 3 bearings", "CKF"), ("CT + 5 bearings", "CKF"), ("CT + 6 bearings", "CKF"),
         ("CT + 7 bearings", "CKF"), ("CT + 8 bearings", "CKF"), ("CT + 9 bearings", "CKF"),
         ("CT + 16 bearings", "CKF"), ("chain 8-D + radar", "CKF"),
         ("CT + 5 bearings", "GH-3"), ("CT + 8 bearings", "GH-3"), ("CT + 9 bearings", "GH-3")]
#: the first trajectories held to the plain version
HEAD = 200


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=None, help="a checkout of the repository to time")
    ap.add_argument("--reps", type=int, default=5)
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
    cs.log(f"lane_variants ({tag}): card {cs.card_line()} | torch {torch.__version__} cuda "
           f"{torch.version.cuda}")
    systems = {**cs.general_systems(np, dev), **cs.registry_systems(np, dev)}
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 21)
    rules = {"CKF": stt.CubatureKalman, "GH-3": lambda d, o: stt.GaussHermiteKalman(d, o, deg=3)}
    params, data = {}, {}
    for name, rule in LANES:
        dyn, obs = systems[name]
        alg = rules[rule](dyn, obs)
        params[name, rule] = vf.prepare(dyn, obs, alg.tf_dyn, alg.tf_obs)
        if name not in data:
            x = dyn.simulate_discrete(gen, steps=cs.REG_STEPS, mc_sims=cs.MC)
            data[name] = obs.simulate_measurements(gen, x).permute(2, 0, 1)
    d_re, o_re = cs.reentry_system(np, dev)
    x_re = d_re.simulate_discrete(gen, steps=cs.REENTRY_STEPS, mc_sims=cs.MC)
    y_re = o_re.simulate_measurements(gen, x_re).permute(2, 0, 1)
    gh3 = stt.GaussHermiteKalman(d_re, o_re, deg=3)
    p_re = vf.prepare(d_re, o_re, gh3.tf_dyn, gh3.tf_obs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if args.tree:
        other_tree(cs, torch, vf, params, data, p_re, y_re, dev, args.reps, tag)
    else:
        this_tree(cs, torch, vf, _build, forms, params, data, p_re, y_re, dev, args.reps)
    cs.log(f"lane_variants ({tag}): {time.perf_counter() - t0:.1f} s; card: {cs.card_line()}")


def held(cs, torch, vf, p, ys, out, what):
    """``out``'s first ``HEAD`` trajectories against the plain version."""
    plain = vf._vector_filter_plain(p, ys[:HEAD])
    got = tuple(o[..., :HEAD] for o in out)
    if not all(cs.same_bits(torch, a, b) for a, b in zip(got, plain)):
        diff = max(float((a - b).nan_to_num().abs().max()) for a, b in zip(got, plain))
        cs.fail(f"{what}: differs from the plain version on {HEAD} trajectories, max |diff| "
                f"{diff:.3e}; expected equal bits")


def other_tree(cs, torch, vf, params, data, p_re, y_re, dev, reps, tag):
    """Each lane as the tree routes it, through the wrapper."""
    for (name, rule), p in list(params.items()) + [(("reentry + radar", "GH-3"), p_re)]:
        ys = y_re if name == "reentry + radar" else data[name]
        out = vf.vector_filter(p, ys)
        torch.cuda.synchronize()
        held(cs, torch, vf, p, ys, out, f"{tag} {name} {rule}")
        ms = cs.raw_ms(torch, lambda: (vf.vector_filter(p, ys), 0)[1], reps=reps)
        b_ms, b_by = cs.vf_bound(p, ys.shape[-1], ys.shape[0])
        cs.log(f"lane_variants ({tag}) {name} {rule} ({p.dyn.n} points) {ys.shape[0]}x"
               f"{ys.shape[-1]}: {vf.kernel_of(p)}; == plain to the bit on {HEAD} trajectories; "
               f"raw wrapper launches {ms:.4f} ms; bound {b_ms:.4f} ms ({b_by})")


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


def this_tree(cs, torch, vf, _build, forms, params, data, p_re, y_re, dev, reps):
    """Every form of every lane by force, in turns; GH-3 on the reentry lane."""
    from concurrent.futures import ThreadPoolExecutor
    chain = params["chain 8-D + radar", "CKF"]
    key4 = (8, 0, 4, vf._model_policy(chain, "VfrPair", 0))
    reg4 = {}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        jobs = [pool.submit(vf.build),
                pool.submit(_build.bound, "vector_filter_g4", vf.SOURCES, vf._bind,
                            vf._NVCC_FLAGS + ["-DVFL_G=4"]),
                pool.submit(vf.build_registered, [(chain, vf._LANES), (chain, 0)]),
                pool.submit(forms.build_generated, reg4, [key4], vf._registered_header([key4]),
                            name="vector_filter_registered_g4",
                            source="vector_filter_registered.cu", file="vfr_forms.cuh",
                            bind=vf._bind_registered, flags=vf._NVCC_FLAGS + ["-DVFL_G=4"],
                            host=False)]
        lib8, lib4, reg8_name, reg4_name = (j.result() for j in jobs)
    fits = {8: vf._fit(), 4: _build.bound("vector_filter_fit_g4", ["vector_filter_fit.cpp"],
                                          vf._bind_fit, ["-DVFL_G=4"], host=True)}
    cs.log(f"lane_variants: built the library on 8 and 4 lanes and the chain's registered "
           f"libraries at once in {time.perf_counter() - t0:.1f} s")
    logs = {("general", 8): _build.BUILD_LOGS.get("vector_filter", ""),
            ("general", 4): _build.BUILD_LOGS.get("vector_filter_g4", ""),
            ("registered", 8): _build.BUILD_LOGS.get(reg8_name, ""),
            ("registered", 4): _build.BUILD_LOGS.get(reg4_name, "")}
    for (name, rule), p in params.items():
        ys = data[name]
        registered = vf.kernel_of(p) == "vector_filter_registered"
        runs, entry = {}, {}
        for g in (8, 4, 0):
            if registered:
                lib, pair = reg4[False, key4] if g == 4 else vf._registered(p, False, g)
                fn = f"VfrPair{pair}E"
            else:
                lib, pair = (lib4 if g == 4 else lib8), None
                fn = (f"vector_filter_lanes_kernelILi{p.dim_state}ELi{g}E" if g else
                      f"vector_filter_general_kernelILi{p.dim_state}ELi{vf._bound_of(p.dim_out)}E")
            if g and not fits[g].vfl_fit_block(ctypes.byref(vf._c_params(p, torch.device("cpu")))):
                continue
            runs[g] = launcher(torch, vf, lib, pair, p, ys, dev, g)
            entry[g] = (fn, logs["registered" if registered else "general", g or 8])
            if runs[g]() != 0:
                cs.fail(f"{name} {rule}: the launch on {g} lanes failed")
            torch.cuda.synchronize()
            held(cs, torch, vf, p, ys, runs[g].out, f"{name} {rule} on {g} lanes")
        turns = {}
        for g in (8, 4, 0, 0, 4, 8):
            if g in runs:
                turns.setdefault(g, []).append(cs.raw_ms(torch, runs[g], reps=reps))
        b_ms, b_by = cs.vf_bound(p, ys.shape[-1], ys.shape[0])
        cs.log(f"lane_variants {name} {rule} ({p.dyn.n} points) {ys.shape[0]}x{ys.shape[-1]}, "
               f"E={p.dim_out}, D={p.dim_state}: routed {vf.lanes_of(p)} lanes (0: one thread); "
               f"bound {b_ms:.4f} ms ({b_by})")
        for g, ms in turns.items():
            regs, frame, spill = cs.ptxas_of(entry[g][1], entry[g][0])
            occupancy = ""
            if g:
                warps, shared = cs.lane_warps(torch, fits[g], vf, p)
                occupancy = (f"; {warps} warps an SM resident, {ys.shape[0] * g / 32 / 132:.1f} "
                             f"in the lane; {shared} bytes of shared memory a trajectory")
            cs.log(f"  {name} {rule}: {str(g) + ' lanes' if g else 'one thread'}: raw launches "
                   + " / ".join(f"{t:.4f}" for t in ms) + f" ms in turns; == plain on {HEAD}; "
                   f"{regs} registers, {frame} bytes stack frame, {spill} bytes spilled "
                   f"({entry[g][0]}){occupancy}")
        del runs
    first = cs.vf_raw(torch, vf, p_re, y_re, dev, "vector_filter")
    runs = {"first version": first,
            "8 lanes": launcher(torch, vf, lib8, None, p_re, y_re, dev, 8),
            "4 lanes": launcher(torch, vf, lib4, None, p_re, y_re, dev, 4)}
    turns = {}
    for k in ("first version", "8 lanes", "4 lanes", "4 lanes", "8 lanes", "first version"):
        turns.setdefault(k, []).append(cs.raw_ms(torch, runs[k], reps=reps))
    torch.cuda.synchronize()
    for k in ("8 lanes", "4 lanes"):
        if not all(cs.same_bits(torch, a, b) for a, b in zip(runs[k].out, first.out)):
            cs.fail(f"reentry GH-3: the lane-group form on {k} differs from the first version")
    b_ms, b_by = cs.vf_bound(p_re, y_re.shape[-1], y_re.shape[0])
    cs.log(f"lane_variants reentry + radar GH-3 ({p_re.dyn.n} points) {y_re.shape[0]}x"
           f"{y_re.shape[-1]}: the lane-group form by force == the first version to the bit; raw "
           "launches in turns: " + ", ".join(f"{k} " + " / ".join(f"{t:.4f}" for t in v) + " ms"
                                             for k, v in turns.items())
           + f"; bound {b_ms:.4f} ms ({b_by})")


if __name__ == "__main__":
    main()
