#!/usr/bin/env python3
"""Build the pairwise RBF-Student kernels (``csrc/student_mc.cu``) under
several compile-time settings and time them on one CUDA card.

    python3 tools/kxy_variants.py [--dims 4,8] [--reps 20] NAME[:MACRO=VALUE,...] ...

Every variant is one build of ``student_mc.cu`` (with ``student_qrq.cu``, its
library's other source) with its macros added as
``-D`` flags: ``SMC_KXY_MIN_BLOCKS_FWD`` / ``SMC_KXY_MIN_BLOCKS_BWD`` (blocks
an SM the register budget of the forward / backward kernel must allow at
D <= 4; ``student_mc.cu``).  ``default`` with no macro is the build the
package ships.  For each variant the script prints the registers and spills
ptxas reports for the ``kxy`` kernels of the chosen dimensions, checks the
forward and backward kernel against the plain versions at 1,953 chunks of
1,024 Student-t samples, and times ``reps`` launches between two CUDA events
(no wrapper, no host sums).  The variants are timed in turns, forwards then
backwards through the list, and both readings are printed.
"""
import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="+")
    ap.add_argument("--dims", default="4,8")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import torch
    from ssmtoybox_torch.ops import _build, student_mc as smc
    if not torch.cuda.is_available():
        print("kxy_variants: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    dims = [int(d) for d in args.dims.split(",")]
    chunk, chunks = smc.KXY_CHUNK, 1953
    gen = torch.Generator(device=dev).manual_seed(0)
    data = {}
    for d in dims:
        z = torch.randn((chunk * chunks, d), generator=gen, device=dev)
        g = torch.distributions.Chi2(torch.tensor(4.0, device=dev)).sample((chunk * chunks, 1))
        xs = (z * torch.sqrt(4.0 / g)).float().contiguous()
        inv_l = torch.full((d,), 0.01 if d == 4 else 0.5, device=dev)
        data[d] = (inv_l, xs, smc._kxy_partials_plain(inv_l, xs, chunk).double(),
                   smc._kxy_bwd_partials_plain(inv_l, xs, chunk).double().sum(0))
    libs = {}
    for spec in args.variants:
        name, _, macros = spec.partition(":")
        flags = [f"-D{m}" for m in macros.split(",") if m]
        libs[name] = smc._bind(_build.load(f"student_mc_{name}",
                                           ["student_mc.cu", "student_qrq.cu"],
                                           [_build.find_nvcc()] + smc._NVCC_FLAGS + flags))
        lines = _build.BUILD_LOGS.get(f"student_mc_{name}", "").splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and "kxy" in line and any(f"ILi{d}E" in line for d in dims):
                tag = ("kxy_bwd" if "kxy_bwd" in line else "kxy") + "<" + line.split("ILi")[1][0] + ">"
                used = [u.strip() for u in lines[i + 1:i + 4] if "Used" in u or "spill" in u]
                print(f"ptxas {name} {tag}: {' | '.join(used)}")

    def launch(lib, fn, d, out):
        inv_l, xs = data[d][:2]
        smc._run(lib, fn, "kxy_bwd" if "bwd" in fn else "kxy", dev,
                 (inv_l.data_ptr(), xs.data_ptr(), chunks, chunk, d, out.data_ptr()))

    def timed(lib, fn, d, out):
        launch(lib, fn, d, out)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            launch(lib, fn, d, out)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / args.reps

    for name, lib in libs.items():
        for d in dims:
            f, b = torch.empty((chunks,), device=dev), torch.empty((chunks, d), device=dev)
            launch(lib, "smc_kxy_launch", d, f)
            launch(lib, "smc_kxy_bwd_launch", d, b)
            torch.cuda.synchronize()
            ef = float((f.double() - data[d][2]).abs().max() / data[d][2].abs().max())
            eb = float((b.double().sum(0) - data[d][3]).abs().max() / data[d][3].abs().max())
            print(f"check {name} D={d}: kxy relative {ef:.2e}, kxy_bwd relative {eb:.2e}")
    order = list(libs) + list(libs)[::-1]
    for name in order:
        for d in dims:
            f, b = torch.empty((chunks,), device=dev), torch.empty((chunks, d), device=dev)
            print(f"time {name} D={d}: kxy {timed(libs[name], 'smc_kxy_launch', d, f):.4f} ms, "
                  f"kxy_bwd {timed(libs[name], 'smc_kxy_bwd_launch', d, b):.4f} ms a launch "
                  f"({chunks} x {chunk}, {args.reps} launches between CUDA events)")
    print("after the timed launches:", subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
