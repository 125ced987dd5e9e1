#!/usr/bin/env python3
"""Build the RBF-Student q/R/Q kernels (``csrc/student_qrq.cu``) under several
compile-time settings, check them and time them on one CUDA card.

    python3 tools/qrq_variants.py [--parent DIR] [--reps 50] [--shapes D:N,...]
                                  NAME[:MACRO=VALUE,...] ...

Every variant is one build of the Student-MC library (``student_mc.cu`` and
``student_qrq.cu``, compiled at once) with its macros added as
``-D`` flags: ``SMC_QRQ_SMALL_ACC`` (the most private sums a thread of the
small path may keep; 0 sends every shape to the large path).
``default`` with no macro is the build the package ships.  ``--parent``
names an unpacked checkout of another commit (``git archive``) whose
Student-MC sources are built too, as the variant ``parent``: its C entry
points take the same arguments.  All builds run at once.

For each variant the script prints what ptxas reports (registers and spills)
for the q/R/Q kernels, then at each shape (488 chunks of 4,096 Student-t
samples, D dimensions, N points) checks the forward and backward partials
against the plain versions (relative to their largest entry) and times raw
launches of the C entry points: ``torch.cuda._sleep`` is queued ahead of the
first CUDA event, so that all ``--reps`` launches are on the stream before
the card reaches the event and the time is the card's, not the host's
launch rate.  The variants are timed in turns, forwards then backwards
through the list, beside the bound of ``chip_smoke.py`` (bytes over
3.35 TB/s, operations over their peak).  A variant that is off the plain
versions by 1e-5 relative or more, or whose two launches differ in a bit,
is not timed, and the script exits with 1.  Without a card it exits with 1.
"""
import argparse
import ctypes
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: (D, N): the study's, the FS degree-5 rule at D = 4, the large path's
#: widest, fewer points than the small path's bucket, and both sides of the
#: small/large crossover at D = 1, 4, 5 and 8
SHAPES = "4:9,4:33,8:128,4:5,4:10,1:3,1:4,5:11,5:12,8:9,8:10"
CHUNK, CHUNKS = 4096, 488


def build(name, csrc, flags):
    """nvcc the Student-MC library's sources in ``csrc`` (``student_mc.cu``,
    and ``student_qrq.cu`` where there is one) with ``flags`` into
    build/kernels; the bound library and the compilers' output."""
    from ssmtoybox_torch.ops import _build, student_mc as smc
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, f"libqrq_variant_{name}.so")
    paths = [os.path.join(csrc, f) for f in ("student_mc.cu", "student_qrq.cu")
             if os.path.exists(os.path.join(csrc, f))]
    t0 = time.perf_counter()
    ok, log = _build._compile([_build.find_nvcc()] + _build.NVCC_FLAGS + flags, paths, out)
    if not ok:
        raise RuntimeError(f"building {name} failed:\n{log}")
    print(f"built {name} in {time.perf_counter() - t0:.1f} s", flush=True)
    return smc._bind(ctypes.CDLL(out)), log


def ptxas_lines(log):
    """``kernel: registers | spills`` for the q/R/Q kernels of a build log."""
    lines, out = log.splitlines(), []
    for i, line in enumerate(lines):
        if "Compiling entry" in line and "qrq" in line:
            fn = line.split("'")[1] if "'" in line else line
            used = [u.strip() for u in lines[i + 1:i + 4] if "Used" in u or "spill" in u]
            out.append(f"{fn}: {' | '.join(used)}")
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="+")
    ap.add_argument("--parent", default=None)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--shapes", default=SHAPES)
    ap.add_argument("--ptxas", action="store_true", help="print every q/R/Q kernel's line")
    args = ap.parse_args()
    import torch
    import chip_smoke
    from ssmtoybox_torch.ops import _build, student_mc as smc
    from ssmtoybox_torch.utils import rand
    if not torch.cuda.is_available():
        print("qrq_variants: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    jobs = {}
    for spec in args.variants:
        name, _, macros = spec.partition(":")
        jobs[name] = (_build.CSRC, [f"-D{m}" for m in macros.split(",") if m])
    if args.parent:
        jobs["parent"] = (os.path.join(args.parent, "ssmtoybox_torch", "csrc"), [])
    with ThreadPoolExecutor(len(jobs)) as pool:
        futures = {n: pool.submit(build, n, c, f) for n, (c, f) in jobs.items()}
        built = {n: f.result() for n, f in futures.items()}
    libs = {n: lib for n, (lib, _) in built.items()}
    for name, (_, log) in built.items():
        lines = ptxas_lines(log)
        print(f"ptxas {name}: {len(lines)} q/R/Q kernels")
        for ln in lines:
            if args.ptxas or any(f"ILi{d}ELi{n}E" in ln or ("large" in ln and f"ILi{d}E" in ln)
                                 for d, n in ((4, 9), (4, 33), (8, 128), (8, 9))):
                print(f"  {ln}")

    shapes = [tuple(int(v) for v in s.split(":")) for s in args.shapes.split(",")]
    gen = torch.Generator(device=dev).manual_seed(0)
    f32 = dict(dtype=torch.float32, device=dev)
    data = {}
    for d, n in shapes:
        xs = rand.multivariate_t(gen, torch.zeros(d, **f32), torch.eye(d, **f32), 4.0,
                                 (CHUNK * CHUNKS,)).contiguous()
        inv_l = 1.0 / (0.7 + 1.3 * torch.rand(d, generator=gen, **f32))
        xp = (1.5 * torch.randn((n, d), generator=gen, **f32)).contiguous()
        gq, gR, gQ = (torch.randn(s, generator=gen, **f32) for s in ((n,), (d, n), (n, n)))
        gQ2 = (gQ + gQ.T).contiguous()
        ref = (smc._qrq_partials_plain(inv_l, xs, xp, CHUNK).double(),
               smc._qrq_bwd_partials_plain(inv_l, xs, xp, gq, gR, gQ2, CHUNK).double())
        outs = (torch.empty((CHUNKS, n + d * n + n * n), **f32),
                torch.empty((CHUNKS, n + d * n + d), **f32))
        data[d, n] = (inv_l, xs, xp, gq, gR, gQ2, ref, outs)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(lib, d, n, bwd):
        inv_l, xs, xp, gq, gR, gQ2, _, outs = data[d, n]
        if bwd:
            return lib.smc_qrq_bwd_launch(inv_l.data_ptr(), xs.data_ptr(), xp.data_ptr(),
                                          gq.data_ptr(), gR.data_ptr(), gQ2.data_ptr(), CHUNKS,
                                          CHUNK, n, d, 0, outs[1].data_ptr(), stream)
        return lib.smc_qrq_launch(inv_l.data_ptr(), xs.data_ptr(), xp.data_ptr(), CHUNKS, CHUNK,
                                  n, d, 0, outs[0].data_ptr(), stream)

    def checked(lib, d, n, bwd):
        rc = launch(lib, d, n, bwd)
        if rc != 0:
            raise RuntimeError(f"launch failed: {lib.smc_error_string(rc).decode()}")

    def raw_ms(lib, d, n, bwd):
        checked(lib, d, n, bwd)
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(100_000 * args.reps)          # ~50 us a launch of host time
        start.record()
        for _ in range(args.reps):
            checked(lib, d, n, bwd)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / args.reps

    wrong = set()
    for name, lib in libs.items():
        for d, n in shapes:
            errs = []
            for bwd in (False, True):
                checked(lib, d, n, bwd)
                got = data[d, n][7][bwd].double()
                checked(lib, d, n, bwd)
                again = data[d, n][7][bwd].double()
                ref = data[d, n][6][bwd]
                errs.append(float((got - ref).abs().max() / ref.abs().max()))
                errs.append(bool(torch.equal(got, again)))
            torch.cuda.synchronize()
            print(f"check {name} D={d} N={n}: qrq relative {errs[0]:.2e} (repeat equal "
                  f"{errs[1]}), qrq_bwd relative {errs[2]:.2e} (repeat equal {errs[3]})")
            if not (errs[0] < 1e-5 and errs[1] and errs[2] < 1e-5 and errs[3]):
                print(f"FAILED {name} D={d} N={n}: not timed")
                wrong.add(name)
    good = [name for name in libs if name not in wrong]
    for name in good + good[::-1]:
        for d, n in shapes:
            tot = CHUNK * CHUNKS
            b_f, b_b = chip_smoke.qrq_bounds(tot, d, n)
            print(f"time {name} D={d} N={n}: qrq {raw_ms(libs[name], d, n, False):.4f} ms "
                  f"(bound {b_f[0]:.4f}, {b_f[1]}), qrq_bwd {raw_ms(libs[name], d, n, True):.4f} "
                  f"ms (bound {b_b[0]:.4f}, {b_b[1]}) a launch ({CHUNKS} x {CHUNK}, "
                  f"{args.reps} launches between CUDA events behind a sleep)")
    print("after the timed launches:", subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
