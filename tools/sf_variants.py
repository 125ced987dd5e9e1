#!/usr/bin/env python3
"""Build the scalar filter kernel (``csrc/scalar_filter.cu`` and
``scalar_filter_slots.cu``, and the registered form's library) under several
compile-time settings and time them on one CUDA card, or time another
checkout's route.

    python3 tools/sf_variants.py [--reps 20] [--batch 10000] [--steps 500] \\
        [--rules UT,GH-7,BSQ-GH7] [--sass DIR] NAME[:SETTING,...] ...
    python3 tools/sf_variants.py --tree DIR [--rules ...]

Every variant is one nvcc build of the library's sources (and, if a rule
of ``--rules`` has a registered model, one of the registered form's library
for those rules); a ``SETTING`` is a macro of those files, added as a ``-D``
flag,

- ``SF_RUNTIME_SHAPE=1``: the shaped form's step with run-time shapes, one
  thread a trajectory (the kernel as it was before the shapes became
  template arguments);
- ``SF_LANES=1|2|4|8``: lanes a trajectory of the shaped form at every slot
  count (1: compile-time shapes alone, one thread a trajectory);
- ``SFS_LANES=1|2|4|8``: lanes a trajectory of the slot design (the general
  and registered forms up to 32 points) at every shape;
- ``SF_THREADS=32|64|128|256``: threads a block;
- ``SF_SPREAD_STORES=1``: lanes 0..3 (0..4 of 8) of the shaped form store
  one stream each,

or the word ``fma``, which drops ``--fmad=false`` (multiply-add contraction
on: a measurement only, the result then drifts from the plain version).
``default`` with no setting is the build the package ships.  All variants
are built at once.  For each the script prints the registers and spills
ptxas reports for the kernels of the timed rules, checks all five streams
against the plain PyTorch version on the whole batch (equal bits are
expected of every variant but ``fma``, whose drift is printed instead), and
times ``reps`` raw launches of each rule's C entry point (``sf_launch``,
``sfg_launch`` or ``sfr_launch``, no wrapper) between two CUDA events behind
``torch.cuda._sleep``.  The variants are timed in turns, forwards then
backwards through the list, and both readings are printed.  It ends with
the card's dependent-issue latencies, the chain floor of a step of each rule
that they give (``ops/scalar_filter.py::chain_floor_clocks``, at the rule's
slot count) and its bound (``chip_smoke.sf_bound``).  ``--sass DIR`` writes
``cuobjdump -sass`` of every variant there and prints the instruction mix of
the timed kernels.

The rules (``RULES``; UNGM transition and measurement unless named): the
shaped form's UT, GH-5, GH-7, GPQ-UT, BSQ-GH5 and BSQ-GH7; the general
form's GH-9, GH-12, GH-15, GH-16, GH-17, GH-20, GH-24, GH-32, GH-33 (one
thread a trajectory), GPQ on GH-9, GH-12, GH-15, GH-17, GH-20, GH-24 and
GH-32 points (above 16 points with ``chip_smoke.UNGM_GPQ_WIDE_PAR``),
BSQ-GH9, the range and sine measurements under the UKF (and the sine under
GH-5, GH-7, the range and sine under GH-15); the registered form's growth
lane of ``chip_smoke.py`` phase 28 under the UKF, GH-5, GH-9, GH-17 and
GH-33.  A shaped rule named with `` by slots``
(``"UT by slots"``) runs in the slot design by force, through
``sfg_launch``.

With ``--tree DIR`` nothing is built by hand: the package of the checkout
``DIR`` is imported and each rule timed as that tree routes it (``reps``
raw launches of its ``scalar_filter`` wrapper behind ``_sleep``), after its
first ``--head`` trajectories are held to its plain version to the bit.  Two
trees are compared in one call in turns: the other, this, this, the other.
Every line names the card and its power limit; exits with 1 if a variant
that should be is not equal to the plain version to the bit.
"""
import argparse
import collections
import ctypes
import os
import re
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the rules that can be timed, and the measurement or registered system
#: each runs on
RULES = ("UT", "GH-5", "GH-7", "GPQ-UT", "BSQ-GH5", "BSQ-GH7", "GH-9", "GH-12", "GH-15",
         "GH-16", "GH-17", "GH-20", "GH-24", "GH-32", "GH-33", "GPQ-GH9", "GPQ-GH12",
         "GPQ-GH15", "GPQ-GH17", "GPQ-GH20", "GPQ-GH24", "GPQ-GH32", "BSQ-GH9", "range UKF",
         "range GH-15", "sine UKF", "sine GH-5", "sine GH-7", "sine GH-15", "growth UKF",
         "growth GH-5", "growth GH-9", "growth GH-17", "growth GH-33")
#: a rule of the shaped form with this suffix runs in the slot design by force
#: (``sfg_launch``, which takes any rule of at most 32 points)
FORCED = " by slots"
DEFAULT_RULES = "UT,GH-7,BSQ-GH7"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="*")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=10_000)
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--rules", default=DEFAULT_RULES)
    ap.add_argument("--sass", default=None)
    ap.add_argument("--tree", default=None, help="a checkout of the repository to time")
    ap.add_argument("--head", type=int, default=200,
                    help="trajectories held to the plain version with --tree")
    args = ap.parse_args()
    rules = args.rules.split(",")
    unknown = [r for r in rules if r.removesuffix(FORCED) not in RULES]
    if unknown or not (args.tree or args.variants):
        ap.error(f"unknown rules {unknown} (known: {', '.join(RULES)})" if unknown else
                 "name a variant (default) or --tree")
    root = os.path.abspath(args.tree or HERE)
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import ssmtoybox_torch as stt
    from ssmtoybox_torch.ops import scalar_filter as sf

    if os.path.dirname(os.path.dirname(os.path.abspath(stt.__file__))) != root:
        cs.fail(f"imported {stt.__file__}, not the package of {root}")
    if not torch.cuda.is_available():
        print("sf_variants: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    tag = "this tree" if root == HERE else root
    card = cs.card_line()
    cs.log(f"sf_variants ({tag}): card {card} | {cs.clocks_line()} | torch {torch.__version__} "
           f"cuda {torch.version.cuda}")
    params, data = lanes(cs, np, torch, stt, sf, dev, rules, args.batch, args.steps)
    t0 = time.perf_counter()
    if args.tree:
        ok = other_tree(cs, torch, sf, params, data, args.reps, args.head, tag, card)
    else:
        ok = variants(cs, torch, sf, params, data, args, dev, card)
    cs.log(f"sf_variants ({tag}): {time.perf_counter() - t0:.1f} s; card: {cs.card_line()}")
    return 0 if ok else 1


def lanes(cs, np, torch, stt, sf, dev, rules, batch, steps):
    """``params[rule]`` and ``data[rule]`` = ``(y, c)`` (y (steps, batch)
    time-major, c the per-step streams) of every rule, simulated on the card
    from the seed: the UNGM system for the UNGM, range and sine lanes (one
    state record), the growth system of ``chip_smoke.registry_systems``."""
    from ssmtoybox_torch.ssmod import (Pendulum2DMeasurement, RangeMeasurement,
                                       UNGMMeasurement, UNGMTransition)
    from ssmtoybox_torch.utils import GaussRV
    gen = torch.Generator(device=dev).manual_seed(cs.SEED + 23)
    dyn = UNGMTransition(GaussRV(1, cov=5.0, device=dev), GaussRV(1, cov=10.0, device=dev))
    meas = {"": UNGMMeasurement(GaussRV(1, cov=1.0, device=dev), dim_state=1),
            "range": RangeMeasurement(GaussRV(1, cov=0.03, device=dev), dim_state=1),
            "sine": Pendulum2DMeasurement(GaussRV(1, cov=0.1, device=dev), dim_state=1)}
    x = dyn.simulate_discrete(gen, steps=steps, mc_sims=batch)
    ys = {k: o.simulate_measurements(gen, x)[0].contiguous() for k, o in meas.items()}
    growth = cs.registry_systems(np, dev)["growth"]
    xg = growth[0].simulate_discrete(gen, steps=steps, mc_sims=batch)
    yg = growth[1].simulate_measurements(gen, xg)[0].contiguous()

    def gpq(d, o, deg):
        par = np.array(cs.UNGM_GPQ_PAR if deg <= 16 else cs.UNGM_GPQ_WIDE_PAR)
        return stt.GaussianProcessKalman(d, o, par, par, points="gh", point_hyp={"degree": deg})

    def bsq(d, o, deg, par):
        mi = np.atleast_2d(np.arange(deg))
        return stt.BayesSardKalman(d, o, np.array(par), np.array(par), mulind_dyn=mi,
                                   mulind_obs=mi, points="gh", point_hyp={"degree": deg})

    def make(rule, d, o):
        if rule == "UT":
            return stt.UnscentedKalman(d, o, alpha=1.0, beta=0.0)
        if rule == "UKF":
            return stt.UnscentedKalman(d, o)
        if rule.startswith("GH-"):
            return stt.GaussHermiteKalman(d, o, deg=int(rule[3:]))
        if rule == "GPQ-UT":
            return stt.GaussianProcessKalman(d, o, np.array(cs.PAR_UT), np.array(cs.PAR_UT),
                                             points="ut")
        if rule.startswith("GPQ-GH"):
            return gpq(d, o, int(rule[6:]))
        deg = int(rule[6:])
        return bsq(d, o, deg, {5: cs.PAR_GH5, 7: cs.PAR_GH7}.get(deg, cs.PAR_GH7))

    params, data = {}, {}
    for rule in rules:
        system, _, r = rule.removesuffix(FORCED).rpartition(" ")
        d, o, y = (*growth, yg) if system == "growth" else (dyn, meas[system], ys[system])
        alg = make(r, d, o)
        p = sf.prepare(d, o, alg.tf_dyn, alg.tf_obs)
        params[rule], data[rule] = p, (y, sf.step_consts(p, steps, dev))
    torch.cuda.synchronize()
    return params, data


def forced(sf, rule, p) -> bool:
    """Whether ``rule`` runs a shaped configuration in the slot design."""
    return rule.endswith(FORCED) and sf.form_of(p) == "shaped"


def entry(cs, sf, rule, p, keys):
    """The mangled-name part of the kernel that runs ``rule`` here."""
    if forced(sf, rule, p):
        return f"scalar_filter_slots_kernelILi{p.dyn.kind}ELi{p.obs.kind}ELi{sf.slots(p)}E6SfgZoo"
    reg = sf.form_of(p) == "registered"
    return cs.sf_entry(sf, p, keys.index(sf._key(p)) if reg else None)


def design(sf, p) -> str:
    """The form and design of ``p`` in words (the form alone on a tree that
    has no ``geometry``)."""
    form = sf.form_of(p)
    if not hasattr(sf, "geometry"):
        return form
    kind, n, lanes = sf.geometry(p)
    return f"{form}, {kind}" + (f" N={n} G={lanes}" if n else "")


def other_tree(cs, torch, sf, params, data, reps, head, tag, card):
    """Each rule as the tree routes it, through the wrapper."""
    for rule, p in params.items():
        if forced(sf, rule, p):
            continue
        y, c = data[rule]
        out = sf.scalar_filter(p, y, c)
        plain = sf._scalar_filter_plain(p, y[:, :head].contiguous(), c)
        torch.cuda.synchronize()
        if not all(cs.same_bits(torch, a[:, :head], b) for a, b in zip(out, plain)):
            cs.fail(f"{tag} {rule}: differs from the plain version on {head} trajectories")
        ms = cs.raw_ms(torch, lambda: (sf.scalar_filter(p, y, c), 0)[1], reps=reps)
        b_ms, b_by = cs.sf_bound(p, *y.shape)
        cs.log(f"sf_variants ({tag}) {rule} ({p.dyn.n}/{p.obs.n} points) {y.shape[1]}x"
               f"{y.shape[0]}: {design(sf, p)}; == plain to the bit on {head} trajectories; raw "
               f"wrapper launches {ms:.4f} ms; bound {b_ms:.4f} ms ({b_by}); card {card}")
    return True


def variants(cs, torch, sf, params, data, args, dev, card):
    """Every rule in every variant, by its C entry point, in turns."""
    from ssmtoybox_torch.ops import _build
    specs = {}
    for spec in args.variants:
        name, _, settings = spec.partition(":")
        settings = [s for s in settings.split(",") if s]
        specs[name] = ([f"-D{s}" for s in settings if s != "fma"]
                       + ([] if "fma" in settings else sf._NVCC_FLAGS))
    registered = [r for r, p in params.items() if sf.form_of(p) == "registered"]
    keys = list(dict.fromkeys(sf._key(params[r]) for r in registered))
    nvcc = _build.find_nvcc()

    def build(item):
        name, flags = item
        cmd = [nvcc] + _build.NVCC_FLAGS + flags
        lib = sf._bind(_build.load(f"scalar_filter_{name}", sf.SOURCES, cmd))
        reg = None
        if keys:
            reg = _build.load(f"scalar_filter_registered_{name}", ["scalar_filter_registered.cu"],
                              cmd, {"sfr_forms.cuh": sf._registered_header(keys)})
            sf._bind_registered(reg)
        return name, (lib, reg)

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(specs)) as pool:
        libs = dict(pool.map(build, specs.items()))
    cs.log(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s, at once")
    for name in libs:
        for rule, p in params.items():
            reg = sf.form_of(p) == "registered"
            log_text = _build.BUILD_LOGS.get(f"scalar_filter{'_registered' if reg else ''}_{name}",
                                             "")
            fn = entry(cs, sf, rule, p, keys)
            regs, frame, spill = cs.ptxas_of(log_text, fn)
            cs.log(f"ptxas {name} {rule}: {regs} registers, {frame} bytes stack frame, {spill} "
                   f"bytes spill stores ({fn})")
        lanes = []
        lib = libs[name][0]
        for rule, p in params.items():
            s_, g_ = ctypes.c_int(), ctypes.c_int()
            if sf.form_of(p) == "shaped" and not forced(sf, rule, p):
                lib.sf_geometry(p.dyn.kind, p.obs.kind, sf.slots(p), ctypes.byref(g_),
                                ctypes.byref(s_))
                lanes.append(f"{rule} shaped G={g_.value}")
            else:
                lib.sf_design(0, p.dyn.kind, p.obs.kind, p.dyn.n, p.obs.n, ctypes.byref(s_),
                              ctypes.byref(g_))
                lanes.append(f"{rule} " + (f"slots N={s_.value} G={g_.value}" if s_.value
                                           else "one thread"))
        cs.log(f"geometry {name}: {'; '.join(lanes)}")

    stream = torch.cuda.current_stream(dev).cuda_stream

    def launcher(lib_pair, rule):
        lib, reg = lib_pair
        p, (y, c) = params[rule], data[rule]
        out = torch.empty((5,) + tuple(y.shape), dtype=torch.float64, device=dev)
        outs = [o.data_ptr() for o in out]
        scratch = sf._scratch(p, y.shape[1], dev)
        args_ = (y.data_ptr(), y.stride(0), y.stride(1), c.data_ptr())
        form = "general" if forced(sf, rule, p) else sf.form_of(p)
        if form == "shaped":
            cp = sf._c_params(p)

            def launch():
                return lib.sf_launch(ctypes.byref(cp), *args_, y.shape[1], y.shape[0],
                                     dev.index or 0, *outs, stream)
        elif form == "general":
            cg, vecs = sf._c_general_params(p, dev), sf._c_slot_rules(p)

            def launch():
                return lib.sfg_launch(ctypes.byref(cg), ctypes.byref(vecs), *args_, y.shape[1],
                                      y.shape[0], dev.index or 0, *outs, scratch.data_ptr(),
                                      stream)
        else:
            cr, pair = sf._c_registered_params(p, dev), keys.index(sf._key(p))
            vecs = sf._c_slot_rules(p)

            def launch():
                return reg.sfr_launch(pair, ctypes.byref(cr), ctypes.byref(vecs), *args_, p.n_s,
                                      y.shape[1], y.shape[0], dev.index or 0, *outs,
                                      scratch.data_ptr(), stream)
        launch.out = out
        return launch

    launches = {(n, r): launcher(libs[n], r) for n in libs for r in params}
    ok = True
    for rule, p in params.items():
        y, c = data[rule]
        plain = torch.stack(sf._scalar_filter_plain(p, y, c))
        for name in libs:
            run = launches[name, rule]
            run.out.fill_(float("nan"))
            if run() != 0:
                cs.fail(f"{name} {rule}: the launch failed")
            torch.cuda.synchronize()
            equal = cs.same_bits(torch, run.out, plain)
            diff = (run.out - plain).nan_to_num().abs()
            cs.log(f"check {name} {rule} ({y.shape[1]} x {y.shape[0]}): "
                   + ("equal to the plain version to the bit" if equal else
                      f"max |diff| {float(diff.max()):.3e} (by step 20: "
                      f"{float(diff[:, :20].max()):.3e})"))
            if not equal and "fma" not in args.variants[list(libs).index(name)]:
                ok = False
        del plain
    for name in list(libs) + list(libs)[::-1]:
        cs.log(f"time {name}: " + ", ".join(
            f"{rule} {cs.raw_ms(torch, launches[name, rule], reps=args.reps):.4f}"
            for rule in params)
            + f" ms a launch ({args.batch} x {args.steps}, {args.reps} raw launches behind "
            f"_sleep); {cs.clocks_line()}")
    cs.log(f"after the timed launches: {card}, {cs.clocks_line()}")

    first = next(iter(libs.values()))[0]
    lat = sf.dependent_latencies(dev, lib=first)
    mhz = float(cs.clocks_line().split()[0])
    cs.log("dependent-issue latency in clocks: "
           + ", ".join(f"{op} {clocks:.1f}" for op, clocks in lat.items()))
    for rule, p in params.items():
        clocks = sf.chain_floor_clocks(lat, p)
        b_ms, b_by = cs.sf_bound(p, args.steps, args.batch)
        cs.log(f"chain floor {rule} ({design(sf, p)}): {clocks:.0f} clocks a step, "
               f"{clocks * args.steps / (mhz * 1e3):.4f} ms for {args.steps} steps at "
               f"{mhz:.0f} MHz; bound {b_ms:.4f} ms ({b_by})")

    cuobjdump = shutil.which("cuobjdump") or os.path.join(os.path.dirname(_build.find_nvcc()),
                                                          "cuobjdump")
    if args.sass and os.path.exists(cuobjdump):
        os.makedirs(args.sass, exist_ok=True)
        for name, (lib, reg) in libs.items():
            text = "".join(subprocess.run([cuobjdump, "-sass", x._name], capture_output=True,
                                          text=True).stdout for x in (lib, reg) if x)
            with open(os.path.join(args.sass, f"scalar_filter_{name}.sass"), "w") as f:
                f.write(text)
            for rule, p in params.items():
                mix = sass_mix(text, entry(cs, sf, rule, p, keys))
                top = ", ".join(f"{op} {n}" for op, n in mix.most_common(12))
                cs.log(f"sass {name} {rule}: {sum(mix.values())} instructions ({top})")
    elif args.sass:
        cs.log(f"sass: no cuobjdump at {cuobjdump}")
    return ok


def sass_mix(text, entry):
    """Instruction counts by opcode of the kernel whose mangled name contains
    ``entry`` in a ``cuobjdump -sass`` listing."""
    mix = collections.Counter()
    inside = False
    for line in text.splitlines():
        if "Function :" in line:
            inside = entry in line
        elif inside:
            m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\d\s+)?([A-Z0-9_]+)", line)
            if m:
                mix[m.group(1)] += 1
    return mix


if __name__ == "__main__":
    sys.exit(main())
