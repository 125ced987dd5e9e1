#!/usr/bin/env python3
"""Time two ways of building the Student-MC library (``csrc/student_mc.cu``
and ``csrc/student_qrq.cu``) with nvcc.

    python3 tools/build_times.py [--reps 2]

``one call``: a single nvcc command given both sources, which compiles them
one after the other.  ``at once``: what ``ssmtoybox_torch/ops/_build.py``
does, one nvcc a source started together, then a link.  The two are run in
turns, ``--reps`` times each, and every wall time is printed.  Needs nvcc;
no card.  The libraries go to a temporary directory and are deleted.
"""
import argparse
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args()
    from ssmtoybox_torch.ops import _build
    cmd = [_build.find_nvcc()] + _build.NVCC_FLAGS
    paths = [os.path.join(_build.CSRC, s) for s in ("student_mc.cu", "student_qrq.cu")]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "libstudent_mc.so")
        ways = {
            "one call": lambda: subprocess.run(cmd + [f"-I{_build.CSRC}", "-o", out] + paths,
                                               capture_output=True, text=True).returncode == 0,
            "at once": lambda: _build._compile(cmd, paths, out)[0],
        }
        for rep in range(args.reps):
            for name in (list(ways) if rep % 2 == 0 else list(ways)[::-1]):
                t0 = time.perf_counter()
                if not ways[name]():
                    print(f"build {name} failed", file=sys.stderr)
                    return 1
                print(f"build {name}: {time.perf_counter() - t0:.2f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
