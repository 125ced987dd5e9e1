#!/usr/bin/env python3
"""Time the builds of the port's CUDA libraries with nvcc.

    python3 tools/build_times.py [--reps 2]
    python3 tools/build_times.py --sources vector_filter [--tree DIR]

Without ``--sources``: two ways of building the Student-MC library
(``csrc/student_mc.cu`` and ``csrc/student_qrq.cu``).  ``one call``: a
single nvcc command given both sources, which compiles them one after the
other.  ``at once``: what ``ssmtoybox_torch/ops/_build.py`` does, one nvcc a
source started together, then a link.  The two are run in turns, ``--reps``
times each, and every wall time is printed.

With ``--sources LIB`` (``vector_filter``, ``scalar_filter``,
``student_mc`` or ``vandermonde``): the sources of that library (its
module's ``SOURCES``, its compiler flags) compiled at once, one nvcc each,
as ``_build`` compiles them, ``--reps`` times; the wall time of each
source's compiler, the library's (the slowest source) and the link's.
``--tree DIR``: the package (its sources and flags) of the checkout ``DIR``
instead of this one, to compare two commits in one call.

Needs nvcc; no card.  The libraries go to a temporary directory and are
deleted.
"""
import argparse
import importlib
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def student_ways(_build, reps):
    """``one call`` against ``at once`` for the Student-MC library."""
    cmd = [_build.find_nvcc()] + _build.NVCC_FLAGS
    paths = [os.path.join(_build.CSRC, s) for s in ("student_mc.cu", "student_qrq.cu")]
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "libstudent_mc.so")
        ways = {
            "one call": lambda: subprocess.run(cmd + [f"-I{_build.CSRC}", "-o", out] + paths,
                                               capture_output=True, text=True).returncode == 0,
            "at once": lambda: _build._compile(cmd, paths, out, [])[0],
        }
        for rep in range(reps):
            for name in (list(ways) if rep % 2 == 0 else list(ways)[::-1]):
                t0 = time.perf_counter()
                if not ways[name]():
                    print(f"build {name} failed", file=sys.stderr)
                    return 1
                print(f"build {name}: {time.perf_counter() - t0:.2f} s", flush=True)
    return 0


def per_source(_build, lib, reps):
    """Each source of ``lib`` compiled at once, one nvcc each, then linked;
    the wall time of each compiler and of the link."""
    module = importlib.import_module(f"ssmtoybox_torch.ops.{lib}")
    flags = list(getattr(module, "_NVCC_FLAGS", []))
    cmd = [a for a in [_build.find_nvcc()] + _build.NVCC_FLAGS + flags if a != "-shared"]
    paths = [os.path.join(_build.CSRC, s) for s in module.SOURCES]

    def compile_one(path, obj):
        t0 = time.perf_counter()
        p = subprocess.run(cmd + ["-c", f"-I{_build.CSRC}", "-o", obj, path],
                           capture_output=True, text=True)
        return p.returncode, time.perf_counter() - t0, p.stderr[-2000:]

    with tempfile.TemporaryDirectory() as tmp:
        for rep in range(reps):
            objs = [os.path.join(tmp, f"{i}.o") for i in range(len(paths))]
            t0 = time.perf_counter()
            with ThreadPoolExecutor(len(paths)) as pool:
                done = list(pool.map(lambda po: compile_one(*po), zip(paths, objs)))
            wall = time.perf_counter() - t0
            for path, (rc, _, err) in zip(paths, done):
                if rc != 0:
                    print(f"{os.path.basename(path)} failed:\n{err}", file=sys.stderr)
                    return 1
            t1 = time.perf_counter()
            link = subprocess.run([cmd[0], "-shared", "-o", os.path.join(tmp, "lib.so")] + objs,
                                  capture_output=True, text=True)
            if link.returncode != 0:
                print(f"link failed:\n{link.stderr[-2000:]}", file=sys.stderr)
                return 1
            print(f"build {lib} (rep {rep + 1}): {len(paths)} sources at once in {wall:.2f} s, "
                  f"link {time.perf_counter() - t1:.2f} s; "
                  + ", ".join(f"{os.path.basename(p)} {d[1]:.2f} s" for p, d in zip(paths, done)),
                  flush=True)
    return 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--sources", default=None,
                    help="a library whose sources to time one by one (vector_filter, ...)")
    ap.add_argument("--tree", default=None, help="a checkout of the repository to build")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.tree or ROOT))
    from ssmtoybox_torch.ops import _build
    if args.sources:
        return per_source(_build, args.sources, args.reps)
    return student_ways(_build, args.reps)


if __name__ == "__main__":
    sys.exit(main())
