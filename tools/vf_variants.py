#!/usr/bin/env python3
"""Build the vector filter library (``csrc/vector_filter.cu`` and
``csrc/vector_filter_shaped.cu``) under several compile-time settings and time
both kernels on one CUDA card.

    python3 tools/vf_variants.py [--reps 20] [--batch 10000] [--steps 100] \\
        [--sass DIR] NAME[:SETTING,...] ...

Every variant is one build of the library; a ``SETTING`` is a macro, added as
a ``-D`` flag, or, if it starts with ``-``, an nvcc flag passed as it is
(``-maxrregcount=128``).  ``default`` with no setting is the build the package
ships.  All variants are built at once.  For each the script prints the
registers and spills that ptxas reports for every kernel, holds the shaped
kernel against the plain PyTorch version at the four shapes it takes
(reentry + radar under UKF and CKF, N = 11 and 10; constant velocity + radar
under UKF and CKF, N = 9 and 8), all five streams over the whole batch, to
the bit, and times ``reps`` raw launches between two CUDA events (no
wrapper, ``torch.cuda._sleep`` queued ahead) at each shape, the variants in
turns, forwards then backwards through the list, each beside the
first-version kernel of the first variant's build on the same inputs.
``--sass DIR`` writes ``cuobjdump -sass`` of every variant there and prints
the float64 instructions of each kernel, those one step issues (the point
loops inside the step loop counted N times, N the rule's points, 2 D + 1 for
the first version, whose classical instantiations alone are listed; the slow
paths of divide and square root not counted)
and the issue floor they give at this batch: f64 warp instructions over the
132 SMs' 2 a clock.  Exits with 1 if a variant
is not equal to the plain version to the bit.
"""
import argparse
import collections
import ctypes
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

#: shape name -> (system, rule)
SHAPES = {"reentry UKF": ("reentry", "UKF"), "reentry CKF": ("reentry", "CKF"),
          "CV UKF": ("cv", "UKF"), "CV CKF": ("cv", "CKF")}
#: f64 opcodes of Hopper's SASS (the double-precision pipe and its MUFU seeds)
F64_OPS = ("DADD", "DMUL", "DFMA", "DSETP", "DMNMX", "MUFU.RCP64H", "MUFU.RSQ64H")
SMS, F64_WARP_INSTR_A_CLOCK = 132, 2


def smi(query):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"


def kernel_listings(text):
    """``(address, opcode with modifiers, branch target or None)`` of every
    instruction, by kernel function, in a ``cuobjdump -sass`` listing."""
    listings, current = {}, None
    for line in text.splitlines():
        if "Function :" in line:
            current = listings.setdefault(line.split("Function :")[1].strip(), [])
        elif current is not None:
            m = re.match(r"\s+/\*([0-9a-f]{4,6})\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_.]+)([^;]*);", line)
            if m:
                target = re.search(r"0x([0-9a-f]+)\s*$", m.group(3)) if "BRA" in m.group(2) else None
                current.append((int(m.group(1), 16), m.group(2),
                                int(target.group(1), 16) if target else None))
    return listings


def f64_a_step(listing, n_points):
    """The f64 instructions one step issues: those inside the widest backward
    branch (the step loop), the loops nested in it (the point loops) counted
    ``n_points`` times; the slow paths of divide and square root, which lie
    outside the step loop, are not counted."""
    loops = sorted(((tgt, addr) for addr, _, tgt in listing if tgt is not None and tgt < addr),
                   key=lambda r: r[0] - r[1])
    if not loops:
        return 0
    (lo, hi), inner = loops[0], loops[1:]
    count = 0
    for addr, op, _ in listing:
        if lo <= addr <= hi and op.startswith(F64_OPS):
            count += n_points if any(a <= addr <= b for a, b in inner) else 1
    return count


def f64_count(mix):
    return sum(n for op, n in mix.items() if op.startswith(F64_OPS))


def systems(dev, np, stt):
    from ssmtoybox_torch.ssmod import ConstantVelocity, Radar2DMeasurement, ReentryVehicle2DTransition
    from ssmtoybox_torch.utils import GaussRV
    re_dyn = ReentryVehicle2DTransition(
        GaussRV(5, mean=[6500.4, 349.14, -1.8093, -6.7967, 0.6932],
                cov=np.diag([1e-6, 1e-6, 1e-6, 1e-6, 1.0]), device=dev),
        GaussRV(3, cov=np.diag([2.4064e-5, 2.4064e-5, 1e-6]), device=dev), dt=0.05)
    re_obs = Radar2DMeasurement(GaussRV(2, cov=np.diag([1e-3, 1e-5]), device=dev), dim_state=5,
                                state_index=[0, 1], radar_loc=np.array([6374.0, 0.0]))
    cv_dyn = ConstantVelocity(GaussRV(4, mean=[10000.0, 300.0, 1000.0, -40.0],
                                      cov=np.diag([1e4, 100.0, 1e4, 100.0]), device=dev),
                              GaussRV(2, cov=np.diag([50.0, 5.0]), device=dev), dt=0.5)
    cv_obs = Radar2DMeasurement(GaussRV(2, cov=np.diag([50.0, 0.4e-6]), device=dev),
                                dim_state=4, state_index=[0, 2, 1, 3])
    return {"reentry": (re_dyn, re_obs), "cv": (cv_dyn, cv_obs)}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="+")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=10_000)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--sass", default=None)
    args = ap.parse_args()
    import numpy as np
    import torch
    import ssmtoybox_torch as stt
    from ssmtoybox_torch.ops import _build, vector_filter as vf
    if not torch.cuda.is_available():
        print("vf_variants: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(smi("name,power.limit,clocks.sm,clocks.max.sm"), flush=True)

    specs = {}
    for spec in args.variants:
        name, _, settings = spec.partition(":")
        specs[name] = ([s if s.startswith("-") else f"-D{s}" for s in settings.split(",") if s]
                       + vf._NVCC_FLAGS)
    nvcc = _build.find_nvcc()

    def build(item):
        name, flags = item
        lib = _build.load(f"vector_filter_{name}", vf.SOURCES, [nvcc] + _build.NVCC_FLAGS + flags)
        vf._bind(lib)
        return name, lib

    with ThreadPoolExecutor(len(specs)) as pool:
        libs = dict(pool.map(build, specs.items()))
    for name in libs:
        lines = _build.BUILD_LOGS.get(f"vector_filter_{name}", "").splitlines()
        for i, line in enumerate(lines):
            m = re.search(r"Compiling entry function '(\w+)'", line)
            if m:
                used = [u.split("info    :")[-1].strip() for u in lines[i + 1:i + 4]
                        if "Used" in u or "spill" in u]
                print(f"ptxas {name} {m.group(1)}: {' | '.join(used)}")

    gen = torch.Generator(device=dev).manual_seed(0)
    ys, params, plains = {}, {}, {}
    for sysname, (dyn, obs) in systems(dev, np, stt).items():
        x = dyn.simulate_discrete(gen, steps=args.steps, mc_sims=args.batch)
        ys[sysname] = obs.simulate_measurements(gen, x).permute(2, 0, 1)
        for rule, make in (("UKF", stt.UnscentedKalman), ("CKF", stt.CubatureKalman)):
            alg = make(dyn, obs)
            shape = f"{'reentry' if sysname == 'reentry' else 'CV'} {rule}"
            params[shape] = vf.prepare(dyn, obs, alg.tf_dyn, alg.tf_obs)
            assert vf.kernel_of(params[shape]) == "vector_filter_shaped"
    for shape, p in params.items():
        plains[shape] = vf._vector_filter_plain(p, ys[SHAPES[shape][0]])
    stream = torch.cuda.current_stream(dev).cuda_stream
    outs = {s: vf._empty_streams(p.dim_state, args.steps, args.batch, dev)
            for s, p in params.items()}
    scratch = {s: vf._scratch(p, args.batch, dev) for s, p in params.items()}

    def launcher(lib, shape, first=False):
        p, y, out = params[shape], ys[SHAPES[shape][0]], outs[shape]
        if first:
            c = vf._c_params(p, dev)
            return lambda: lib.vf_launch(ctypes.byref(c), y.data_ptr(), *y.stride(), args.batch,
                                         args.steps, dev.index or 0,
                                         *(o.data_ptr() for o in out),
                                         scratch[shape].data_ptr(), stream)
        c = vf._c_shaped_params(p, dev)
        return lambda: lib.vfs_launch(ctypes.byref(c), y.data_ptr(), *y.stride(), args.batch,
                                      args.steps, dev.index or 0, *(o.data_ptr() for o in out),
                                      stream)

    def same_bits(a, b):
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())

    ok = True
    for name, lib in libs.items():
        for shape in params:
            for o in outs[shape]:
                o.fill_(float("nan"))
            rc = launcher(lib, shape)()
            torch.cuda.synchronize()
            equal = rc == 0 and all(same_bits(a, b) for a, b in zip(outs[shape], plains[shape]))
            diff = max(float((a - b).nan_to_num().abs().max())
                       for a, b in zip(outs[shape], plains[shape]))
            print(f"check {name} {shape} ({args.batch} x {args.steps}): rc {rc}, "
                  + ("equal to the plain version to the bit" if equal
                     else f"max |diff| {diff:.3e}: NOT equal"), flush=True)
            ok = ok and equal

    def timed(launch):
        if launch() != 0:
            raise RuntimeError("a launch failed")
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000 * args.reps)
        start.record()
        for _ in range(args.reps):
            launch()
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / args.reps

    first_lib = next(iter(libs.values()))
    for name in list(libs) + list(libs)[::-1]:
        print(f"time {name}: " + ", ".join(f"{s} {timed(launcher(libs[name], s)):.4f} ms"
                                            for s in params)
              + f" a launch ({args.batch} x {args.steps}, {args.reps} launches between CUDA "
              f"events)", flush=True)
        print("time first version: " + ", ".join(
            f"{s} {timed(launcher(first_lib, s, first=True)):.4f} ms" for s in params), flush=True)
    print("after the timed launches:", smi("clocks.sm,clocks.max.sm,power.draw"))

    cuobjdump = shutil.which("cuobjdump") or os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if args.sass and os.path.exists(cuobjdump):
        os.makedirs(args.sass, exist_ok=True)
        mhz = float(smi("clocks.max.sm").split()[0])
        for name, lib in libs.items():
            text = subprocess.run([cuobjdump, "-sass", lib._name], capture_output=True,
                                  text=True).stdout
            with open(os.path.join(args.sass, f"vector_filter_{name}.sass"), "w") as f:
                f.write(text)
            for fn, listing in kernel_listings(text).items():
                m = re.search(r"(vector_filter(?:_shaped)?_kernel)I((?:Li\d+E)+)", fn)
                if not m:
                    continue
                kernel, targs = m.group(1), [int(t) for t in re.findall(r"Li(\d+)E", m.group(2))]
                # points of the shaped kernel's dynamics rule; the first version's at the UT
                # count, classical rules only (a BQ rule's loops nest)
                shaped = kernel.endswith("shaped_kernel")
                if not shaped and targs[4:] != [0, 0]:
                    continue
                n = targs[4] if shaped else 2 * targs[0] + 1
                mix = collections.Counter(op for _, op, _ in listing)
                per_step = f64_a_step(listing, n)
                floor_ms = (per_step * args.batch / 32 / (SMS * F64_WARP_INSTR_A_CLOCK)
                            * args.steps / (mhz * 1e3))
                top = ", ".join(f"{op} {c}" for op, c in mix.most_common(8))
                print(f"sass {name} {kernel}<{', '.join(map(str, targs))}>: {len(listing)} "
                      f"instructions, {f64_count(mix)} f64 ({top}); {per_step} f64 a step at "
                      f"N = {n}, f64 issue floor {floor_ms:.4f} ms at {args.batch} x "
                      f"{args.steps}, {mhz:.0f} MHz", flush=True)
    elif args.sass:
        print(f"sass: no cuobjdump at {cuobjdump}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
