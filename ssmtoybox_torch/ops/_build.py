"""Lazy builds of the package's native sources into shared libraries.

Sources live in ``ssmtoybox_torch/csrc``.  A library is compiled on first use
into ``build/kernels/`` beside the package, under a name that hashes the
sources, every header of ``csrc`` and the compiler command, so an edited
source never loads a stale build; the sources of one library compile at
once, a compiler each.  A library may also include headers generated at run
time (the registered model forms, :mod:`.forms`): their text is written into
a directory of ``build/kernels/`` named by the same hash, that directory is
on the include path, and the text enters the hash and the library's name.  Compiling goes to a process-unique
temporary file that is renamed into place, so concurrent processes never load
a half-written library.

:func:`bound` is what a launch wrapper calls: a library is found, built,
loaded and given its argument types once a process, and every later call is
one dictionary look-up.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(CSRC)), "build", "kernels")

_lock = threading.Lock()
_locks: dict[str, threading.Lock] = {}
_loaded: dict[str, ctypes.CDLL] = {}
_bound: dict[str, ctypes.CDLL] = {}

#: what every CUDA source of the package is compiled with
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
#: what the host builds of the kernels' headers (the tests' builds, and the
#: lane-group form's fit, ``vector_filter_fit.cpp``) are compiled with: no
#: multiply-add contraction, as in the plain PyTorch versions
HOST_CMD = ["g++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC"]

#: compiler output of each library built by this process, by name
BUILD_LOGS: dict[str, str] = {}


def find_nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME or
    /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (looked on PATH, in $CUDA_HOME and "
                       "/usr/local/cuda): the CUDA kernels cannot be built")


def load(name: str, sources: list[str], cmd: list[str],
         generated: dict[str, str] | None = None) -> ctypes.CDLL:
    """Compile ``sources`` (file names in ``csrc``) with ``cmd`` once and load
    the library; raises ``RuntimeError`` with the compiler's output on failure.
    ``generated``: headers the sources include, file name -> text.  Different
    libraries build concurrently when called from several threads; a library
    already loaded is returned without taking a lock."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name in _loaded:
            return _loaded[name]
        paths = [os.path.join(CSRC, s) for s in sources]
        digest = hashlib.sha256(" ".join(cmd).encode())
        for path in paths + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
            with open(path, "rb") as f:
                digest.update(f.read())
        for file, text in sorted((generated or {}).items()):
            digest.update(f"{file}\n{text}".encode())
        tag = digest.hexdigest()[:16]
        lib_path = os.path.join(BUILD_DIR, f"lib{name}-{tag}.so")
        if not os.path.exists(lib_path):
            include = _write_generated(os.path.join(BUILD_DIR, f"gen-{name}-{tag}"), generated)
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{lib_path}.{os.getpid()}.tmp"
            ok, BUILD_LOGS[name] = _compile(cmd, paths, tmp, include)
            if not ok:
                raise RuntimeError(f"building {name} failed ({' '.join(cmd)}):\n"
                                   f"{BUILD_LOGS[name]}")
            os.replace(tmp, lib_path)
        _loaded[name] = ctypes.CDLL(lib_path)
        return _loaded[name]


def _write_generated(directory: str, generated: dict[str, str] | None) -> list[str]:
    """Write the generated headers into ``directory`` (each file renamed into
    place, so a concurrent build never reads half of one); the include flags
    of the directory, none without headers."""
    if not generated:
        return []
    os.makedirs(directory, exist_ok=True)
    for file, text in generated.items():
        path = os.path.join(directory, file)
        tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
        with open(tmp, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    return [f"-I{directory}"]


def _compile(cmd: list[str], paths: list[str], out: str,
             include: list[str]) -> tuple[bool, str]:
    """Build the shared library ``out`` from ``paths`` with ``cmd`` and the
    include flags ``include``: the sources are compiled to objects at once,
    one compiler each, and linked.  Returns whether it worked and the
    compilers' output."""
    run = lambda args: subprocess.run(args, capture_output=True, text=True)  # noqa: E731
    objs = [f"{out}.{i}.o" for i in range(len(paths))]
    compile_cmd = [a for a in cmd if a != "-shared"] + ["-c", f"-I{CSRC}"] + include
    with ThreadPoolExecutor(len(paths)) as pool:
        procs = list(pool.map(lambda po: run(compile_cmd + ["-o", po[1], po[0]]),
                              zip(paths, objs)))
    ok = all(p.returncode == 0 for p in procs)
    log = "".join(p.stdout + p.stderr for p in procs)
    if ok:
        link = run([cmd[0], "-shared", "-o", out] + objs)
        ok, log = link.returncode == 0, log + link.stdout + link.stderr
    for o in objs:
        if os.path.exists(o):
            os.remove(o)
    return ok, log


def bound(name: str, sources: list[str], bind, flags=(), host: bool = False,
          generated: dict[str, str] | None = None) -> ctypes.CDLL:
    """The library ``name`` with its argument types declared by ``bind(lib)``.

    The first call compiles ``sources`` (with nvcc, :data:`NVCC_FLAGS` and
    ``flags``; with :data:`HOST_CMD` and ``flags`` if ``host``) and the
    ``generated`` headers they include, loads the library and binds it; every
    later call returns it from a dictionary, without a lock, a search for the
    compiler or a second binding.  A library of generated headers is known by
    ``name`` and a hash of their text (:func:`generated_name`), so other text
    makes another library.
    """
    if generated:
        name = generated_name(name, generated)
    lib = _bound.get(name)
    if lib is None:
        cmd = HOST_CMD + list(flags) if host else [find_nvcc()] + NVCC_FLAGS + list(flags)
        lib = load(name, sources, cmd, generated)
        bind(lib)
        _bound[name] = lib
    return lib


def generated_name(name: str, generated: dict[str, str]) -> str:
    """The name under which :func:`bound` keeps the library ``name`` built
    with the headers ``generated`` (and :data:`BUILD_LOGS` its compiler
    output): ``name``, a dash and a hash of the headers' text."""
    digest = hashlib.sha256()
    for file, text in sorted(generated.items()):
        digest.update(f"{file}\n{text}".encode())
    return f"{name}-{digest.hexdigest()[:12]}"
