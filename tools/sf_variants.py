#!/usr/bin/env python3
"""Build the scalar filter kernel (``csrc/scalar_filter.cu``) under several
compile-time settings and time them on one CUDA card.

    python3 tools/sf_variants.py [--reps 20] [--batch 10000] [--steps 500] \\
        [--rules UT,GH-7,BSQ-GH7] [--sass DIR] NAME[:SETTING,...] ...

Every variant is one nvcc build of ``scalar_filter.cu``; a ``SETTING`` is a
macro of that file, added as a ``-D`` flag,

- ``SF_RUNTIME_SHAPE=1``: the step with run-time shapes, one thread a
  trajectory (the kernel as it was before the shapes became template
  arguments);
- ``SF_LANES=1|2|4|8``: lanes a trajectory at every slot count (1: compile-time
  shapes alone, one thread a trajectory);
- ``SF_THREADS=32|64|128|256``: threads a block;
- ``SF_SPREAD_STORES=1``: lanes 0..3 (0..4 of 8) store one stream each,

or the word ``fma``, which drops ``--fmad=false`` (multiply-add contraction
on: a measurement only, the result then drifts from the twin).  ``default``
with no setting is the build the package ships.  All variants are built at
once.  For each the script prints the registers and spills ptxas reports for
the kernels of the three timed rules, checks all five streams against the
plain PyTorch twin on the whole batch (equal bits are expected of every
variant but ``fma``, whose drift is printed instead), and times ``reps`` raw
launches between two CUDA events (no wrapper) for the UT (3 points), GH-7 and
BSQ-GH7 rules of the UNGM study (``--rules`` names others: GPQ-UT, GH-5,
BSQ-GH5).  The variants are timed in turns, forwards
then backwards through the list, and both readings are printed.  It ends
with the card's dependent-issue latencies and the chain floor of a step that
they give (``ops/scalar_filter.py::chain_floor_clocks``).  ``--sass DIR`` writes ``cuobjdump -sass`` of every
variant there and prints the instruction mix of the timed kernels.
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

PAR_UT, PAR_GH5, PAR_GH7 = [[3.0, 0.3]], [[5.0, 0.6]], [[3.0, 0.4]]
#: (kind of both rules, slots) of the rules that can be timed, as in the
#: kernels' names; without ``--rules`` the first three are
SHAPES = {"UT": (0, 3), "GH-7": (0, 7), "BSQ-GH7": (1, 7), "GPQ-UT": (1, 3), "GH-5": (0, 5),
          "BSQ-GH5": (1, 5)}


def smi(query):
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "not read"


def sass_mix(text, kind, slots):
    """Instruction counts by opcode of the kernel <kind, kind, slots, *> in a
    ``cuobjdump -sass`` listing."""
    mix = collections.Counter()
    inside = False
    for line in text.splitlines():
        if "Function :" in line:
            inside = (f"ILi{kind}ELi{kind}ELi{slots}E" in line) or (
                "scalar_filter_rt_kernel" in line)
        elif inside:
            m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_]+)", line)
            if m:
                mix[m.group(1)] += 1
    return mix


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="+")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=10_000)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--rules", default="UT,GH-7,BSQ-GH7")
    ap.add_argument("--sass", default=None)
    args = ap.parse_args()
    shapes = {rule: SHAPES[rule] for rule in args.rules.split(",")}
    import numpy as np
    import torch
    import ssmtoybox_torch as stt
    from ssmtoybox_torch.ops import _build, scalar_filter as sf
    from ssmtoybox_torch.ssmod import UNGMMeasurement, UNGMTransition
    from ssmtoybox_torch.utils import GaussRV
    if not torch.cuda.is_available():
        print("sf_variants: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(smi("name,power.limit,clocks.sm,clocks.max.sm"), flush=True)

    specs = {}
    for spec in args.variants:
        name, _, settings = spec.partition(":")
        settings = [s for s in settings.split(",") if s]
        flags = [f"-D{s}" for s in settings if s != "fma"]
        specs[name] = flags + ([] if "fma" in settings else sf._NVCC_FLAGS)
    nvcc = _build.find_nvcc()

    def build(item):
        name, flags = item
        return name, sf._bind(_build.load(f"scalar_filter_{name}", ["scalar_filter.cu"],
                                          [nvcc] + _build.NVCC_FLAGS + flags))

    with ThreadPoolExecutor(len(specs)) as pool:
        libs = dict(pool.map(build, specs.items()))
    for name in libs:
        lines = _build.BUILD_LOGS.get(f"scalar_filter_{name}", "").splitlines()
        for i, line in enumerate(lines):
            for rule, (kind, slots) in shapes.items():
                if "Compiling entry" in line and (f"ILi{kind}ELi{kind}ELi{slots}E" in line
                                                  or "rt_kernel" in line):
                    used = [u.strip() for u in lines[i + 1:i + 4] if "Used" in u or "spill" in u]
                    print(f"ptxas {name} {'any shape' if 'rt_kernel' in line else rule}: "
                          f"{' | '.join(used)}")
                    if "rt_kernel" in line:
                        break
        geometry = []
        for rule, (kind, slots) in shapes.items():
            lanes, threads = ctypes.c_int(), ctypes.c_int()
            libs[name].sf_geometry(kind, kind, slots, ctypes.byref(lanes), ctypes.byref(threads))
            geometry.append(f"{rule} {lanes.value}")
        print(f"geometry {name}: lanes a trajectory {', '.join(geometry)}; "
              f"{threads.value} threads a block", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    dyn = UNGMTransition(GaussRV(1, cov=5.0), GaussRV(1, cov=10.0))
    obs = UNGMMeasurement(GaussRV(1, cov=1.0), dim_state=1)
    x = dyn.simulate_discrete(gen, steps=args.steps, mc_sims=args.batch)
    y = obs.simulate_measurements(gen, x).permute(2, 0, 1)[:, 0, :].T.contiguous()   # (N, B)
    x_tm = x.permute(2, 0, 1)[:, 0, :].T
    c = torch.as_tensor(sf.ungm_consts(args.steps), device=dev)
    def bsq_gh(deg, par):
        mi = np.atleast_2d(np.arange(deg))
        return stt.BayesSardKalman(dyn, obs, np.array(par), np.array(par), mulind_dyn=mi,
                                   mulind_obs=mi, points="gh", point_hyp={"degree": deg})

    makers = {"UT": lambda: stt.UnscentedKalman(dyn, obs, alpha=1.0, beta=0.0),
              "GH-5": lambda: stt.GaussHermiteKalman(dyn, obs, deg=5),
              "GH-7": lambda: stt.GaussHermiteKalman(dyn, obs, deg=7),
              "GPQ-UT": lambda: stt.GaussianProcessKalman(dyn, obs, np.array(PAR_UT),
                                                          np.array(PAR_UT), points="ut"),
              "BSQ-GH5": lambda: bsq_gh(5, PAR_GH5), "BSQ-GH7": lambda: bsq_gh(7, PAR_GH7)}
    algs = {rule: makers[rule]() for rule in shapes}
    params = {r: sf.prepare(dyn, obs, a.tf_dyn, a.tf_obs) for r, a in algs.items()}
    twins = {r: torch.stack(sf._scalar_filter_plain(p, y, c)) for r, p in params.items()}
    out = torch.empty((5,) + tuple(y.shape), dtype=torch.float64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(lib, rule):
        rc = lib.sf_launch(ctypes.byref(sf._c_params(params[rule])), y.data_ptr(), y.stride(0),
                           y.stride(1), c.data_ptr(), y.shape[1], y.shape[0], dev.index or 0,
                           *(o.data_ptr() for o in out), stream)
        if rc != 0:
            raise RuntimeError(f"sf_launch returned cudaError {rc}")

    def rmse(m):
        return float(torch.sqrt(torch.mean((m - x_tm) ** 2, 0)).mean())

    ok = True
    for name, lib in libs.items():
        for rule in algs:
            out.fill_(float("nan"))
            launch(lib, rule)
            torch.cuda.synchronize()
            diff = (out - twins[rule]).abs()
            equal = torch.equal(out, twins[rule])
            line = (f"check {name} {rule} ({args.batch} x {args.steps}): "
                    + ("equal to the twin to the bit" if equal else
                       f"max |diff| {float(diff.max()):.3e} (by step 20: "
                       f"{float(diff[:, :20].max()):.3e}), study RMSE {rmse(out[0]):.6f} "
                       f"against the twin's {rmse(twins[rule][0]):.6f}"))
            print(line, flush=True)
            if not equal and "fma" not in args.variants[list(libs).index(name)]:
                ok = False

    def timed(lib, rule):
        launch(lib, rule)
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            launch(lib, rule)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / args.reps

    for name in list(libs) + list(libs)[::-1]:
        print(f"time {name}: " + ", ".join(f"{rule} {timed(libs[name], rule):.4f} ms"
                                            for rule in algs)
              + f" a launch ({args.batch} x {args.steps}, {args.reps} launches between CUDA "
              f"events)", flush=True)
    print("after the timed launches:", smi("clocks.sm,clocks.max.sm,power.draw"))

    lat = sf.dependent_latencies(dev, lib=next(iter(libs.values())))
    mhz = float(smi("clocks.sm").split()[0])
    print("dependent-issue latency in clocks: "
          + ", ".join(f"{op} {clocks:.1f}" for op, clocks in lat.items()))
    for rule in algs:
        clocks = sf.chain_floor_clocks(lat, params[rule])
        print(f"chain floor {rule}: {clocks:.0f} clocks a step, "
              f"{clocks * args.steps / (mhz * 1e3):.4f} ms for {args.steps} steps at {mhz:.0f} MHz")

    cuobjdump = shutil.which("cuobjdump") or os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if args.sass and os.path.exists(cuobjdump):
        os.makedirs(args.sass, exist_ok=True)
        for name, lib in libs.items():
            text = subprocess.run([cuobjdump, "-sass", lib._name], capture_output=True,
                                  text=True).stdout
            with open(os.path.join(args.sass, f"scalar_filter_{name}.sass"), "w") as f:
                f.write(text)
            for rule, (kind, slots) in shapes.items():
                mix = sass_mix(text, kind, slots)
                top = ", ".join(f"{op} {n}" for op, n in mix.most_common(12))
                print(f"sass {name} {rule}: {sum(mix.values())} instructions ({top})")
    elif args.sass:
        print(f"sass: no cuobjdump at {cuobjdump}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
