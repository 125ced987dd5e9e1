#!/usr/bin/env python3
"""Build the Vandermonde kernel (``csrc/vandermonde.cu``) under compile-time
settings and time them on one CUDA card.

    python3 tools/vdm_variants.py [--reps 20] NAME[:MACRO=VALUE,...] ...

A variant is one nvcc build of ``vandermonde.cu`` with its macros as ``-D``
flags: ``VDM_BULK_STORE=0`` stores a block's tile in a loop, neighbouring
threads to neighbouring doubles, where the shipped build (``default``, no
macro) hands it to one asynchronous bulk copy from shared to device memory
(``cp.async.bulk``) whenever the number of columns is odd and at most 32; ``VDM_COL_GROUPS=1|2|4`` fixes how many column groups the
warps of a block split a point's columns into, where the shipped build takes 4
below 33,792 points and 1 from there.  Each variant is checked against the plain PyTorch
version (equal bits) and timed by ``reps`` raw launches between two CUDA
events at two weight shapes (1 x 7, Q = 7 and 5 x 11, Q = 11), 5 x 20,000 with
Q = 11, the verifiers' shape (5 x 100,000, Q = 11), a wide shape (5 x
1,000,000, Q = 21) and a one-dimensional one (1 x 1,000,000, Q = 7), in
turns, forwards then backwards through the list.  Below ~0.012 ms a launch
that reading is the host's time to make one, so the kernel's own time is
printed beside it: the mean over the device records ``torch.profiler`` keeps
of 10 launches (their number in brackets; it drops some).
"""
import argparse
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("variants", nargs="+")
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    import numpy as np
    import torch
    from ssmtoybox_torch.ops import _build, vandermonde as vdm
    from ssmtoybox_torch.utils.combin import total_degree_multi_index
    if not torch.cuda.is_available():
        print("vdm_variants: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    nvcc = _build.find_nvcc()

    def build(spec):
        name, _, macros = spec.partition(":")
        flags = [f"-D{m}" for m in macros.split(",") if m]
        return name, vdm._bind(_build.load(f"vandermonde_{name}", ["vandermonde.cu"],
                                           [nvcc] + _build.NVCC_FLAGS + flags))

    with ThreadPoolExecutor(len(args.variants)) as pool:
        libs = dict(pool.map(build, args.variants))
    mul_ut5 = np.hstack((np.zeros((5, 1), int), np.eye(5, dtype=int), 2 * np.eye(5, dtype=int)))
    shapes = {"1 x 7, Q=7": (np.atleast_2d(np.arange(7)), 7), "5 x 11, Q=11": (mul_ut5, 11),
              "5 x 2e4, Q=11": (mul_ut5, 20_000),
              "verifier 5 x 1e5, Q=11": (mul_ut5, 100_000),
              "wide 5 x 1e6, Q=21": (total_degree_multi_index(5, 2), 1_000_000),
              "1 x 1e6, Q=7": (np.atleast_2d(np.arange(7)), 1_000_000)}
    gen = torch.Generator(device=dev).manual_seed(3)
    data = {}
    for tag, (mul, n) in shapes.items():
        x = torch.randn((mul.shape[0], n), generator=gen, dtype=torch.float64, device=dev)
        data[tag] = (vdm._index(mul, mul.shape[0]), x, vdm.vandermonde_plain(mul, x))
    stream = torch.cuda.current_stream(dev).cuda_stream

    def launch(lib, tag, out):
        index, x, _ = data[tag]
        rc = lib.vdm_launch(x.data_ptr(), index.e32.ctypes.data, None, x.shape[0], x.shape[1],
                            index.mul.shape[1], dev.index or 0, out.data_ptr(), stream)
        if rc != 0:
            raise RuntimeError(f"vdm_launch returned cudaError {rc}")

    ok = True
    for name, lib in libs.items():
        for tag, (_, _, ref) in data.items():
            out = torch.full_like(ref, float("nan"))
            launch(lib, tag, out)
            torch.cuda.synchronize()
            equal = torch.equal(out, ref)
            ok = ok and equal
            print(f"check {name} {tag}: " + ("equal to the plain version to the bit" if equal
                                             else f"max |diff| {float((out - ref).abs().max()):.3e}"))

    def timed(lib, tag):
        out = torch.empty_like(data[tag][2])
        launch(lib, tag, out)
        torch.cuda.synchronize()
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            launch(lib, tag, out)
        stop.record()
        stop.synchronize()
        return start.elapsed_time(stop) / args.reps

    def profiled(lib, tag):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        out = torch.empty_like(data[tag][2])
        launch(lib, tag, out)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                launch(lib, tag, out)
            torch.cuda.synchronize()
        found = [e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA and "vandermonde_kernel" in e.name]
        return f"{sum(found) / len(found) / 1e3:.4f} ({len(found)})" if found else "none kept"

    for name in list(libs) + list(libs)[::-1]:
        print(f"time {name}: " + ", ".join(
            f"{tag} {timed(libs[name], tag):.4f} ms, device {profiled(libs[name], tag)}"
            for tag in data) + f" a launch ({args.reps} launches between CUDA events)", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
