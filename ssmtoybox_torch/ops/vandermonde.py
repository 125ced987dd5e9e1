"""Vandermonde matrix of multivariate monomials: CUDA kernel, launcher, plain version.

Counterpart of the JAX package's Pallas kernel
``ops/pallas_ops.py::_vandermonde_kernel`` (via ``pallas_ops.vandermonde``),
which returns float32 because the TPU has no f64 ALU, and of the exact f64
``utils/combin.py::vandermonde`` that the JAX package's BSQ code calls for
that reason.  The card has native f64, so one kernel (``csrc/vandermonde.cu``)
serves both: ``vdm[n, b] = prod_d x[d, n] ** mul_ind[d, b]`` in float64.

:func:`vandermonde` is the launch wrapper.  For a CPU tensor it runs the
plain PyTorch version :func:`vandermonde_plain`; for a CUDA tensor it
launches the kernel or raises.  Each launch adds one to :data:`LAUNCHES`.
Kernel and plain version multiply in the same order and agree to the bit;
the JAX package raises to integer powers by binary exponentiation, so the
port and the JAX package agree to about an ulp.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import _build

__all__ = ["LAUNCHES", "MAX_DIM", "MAX_SHARED_BYTES", "vandermonde", "vandermonde_plain",
           "build"]

#: kernel launches made by :func:`vandermonde` in this process
LAUNCHES = 0

#: most dimensions of a multi-index: every study needs D <= 7
MAX_DIM = 32

#: the multi-index is staged in shared memory as int32: D * Q * 4 bytes at most
MAX_SHARED_BYTES = 48 * 1024

_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _multi_index(mul_ind, dim: int) -> np.ndarray:
    """The multi-index as a (D, Q) int64 array; ``ValueError`` for what the
    kernel does not take."""
    mul = np.atleast_2d(np.asarray(mul_ind.cpu() if isinstance(mul_ind, torch.Tensor)
                                   else mul_ind))
    if mul.ndim != 2 or not np.issubdtype(mul.dtype, np.integer):
        raise ValueError(f"the multi-index must be a (D, Q) integer array; got "
                         f"{mul.dtype} of shape {mul.shape}")
    mul = mul.astype(np.int64)
    if mul.shape[0] != dim:
        raise ValueError(f"multi-index of dimension {mul.shape[0]} for points of "
                         f"dimension {dim}")
    if (mul < 0).any():
        raise ValueError("the multi-index has a negative exponent")
    if mul.max(initial=0) >= 2 ** 31:
        raise ValueError("an exponent does not fit in int32")
    if dim > MAX_DIM:
        raise ValueError(f"the Vandermonde kernel takes D <= {MAX_DIM}; got D = {dim}")
    if mul.size * 4 > MAX_SHARED_BYTES:
        raise ValueError(f"a (D, Q) = {mul.shape} multi-index needs {mul.size * 4} B of "
                         f"shared memory; the kernel has {MAX_SHARED_BYTES} B")
    return mul


def _check_points(x: torch.Tensor):
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float64:
        raise ValueError(f"the Vandermonde matrix takes float64 points; got "
                         f"{getattr(x, 'dtype', type(x))}")
    if x.ndim != 2:
        raise ValueError(f"points must be (D, N); got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("points must be contiguous")


def vandermonde_plain(mul: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """The kernel's computation as torch ops: ``col = 1``, then for each
    dimension ``p = 1``, ``p *= x_d`` ``e_d`` times, ``col *= p``.  ``mul``
    (D, Q) non-negative integers, ``x`` (D, N); returns (N, Q) on x's device."""
    D, N = x.shape
    Q = mul.shape[1]
    e = torch.as_tensor(mul, device=x.device)
    col = torch.ones((N, Q), dtype=x.dtype, device=x.device)
    for d in range(D):
        xd = x[d][:, None]
        p = torch.ones_like(col)
        for i in range(int(mul[d].max(initial=0))):
            p = torch.where(i < e[d], p * xd, p)
        col = col * p
    return col


def build() -> ctypes.CDLL:
    """Compile ``csrc/vandermonde.cu`` for sm_90a with nvcc (once) and bind it."""
    lib = _build.load("vandermonde", ["vandermonde.cu"], [_build.find_nvcc()] + _NVCC_FLAGS)
    lib.vdm_launch.restype = ctypes.c_int
    lib.vdm_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_void_p]
    lib.vdm_error_string.restype = ctypes.c_char_p
    lib.vdm_error_string.argtypes = [ctypes.c_int]
    return lib


def _host_shim() -> ctypes.CDLL:
    """The entry header built for the host with g++ (tests only)."""
    lib = _build.load("vandermonde_host", ["vandermonde_host.cpp"],
                      ["g++", "-O2", "-shared", "-fPIC"])
    lib.vdm_host_run.restype = None
    lib.vdm_host_run.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    return lib


def _host_shim_run(mul_ind, x: torch.Tensor) -> torch.Tensor:
    """Run the entry header compiled for the host on a CPU tensor."""
    _check_points(x)
    if x.device.type != "cpu":
        raise ValueError(f"the host build takes CPU tensors; got {x.device}")
    mul = _multi_index(mul_ind, x.shape[0])
    e = torch.as_tensor(mul, dtype=torch.int32).contiguous()
    D, N = x.shape
    out = torch.empty((N, mul.shape[1]), dtype=torch.float64)
    _host_shim().vdm_host_run(x.data_ptr(), e.data_ptr(), D, N, mul.shape[1], out.data_ptr())
    return out


def vandermonde(mul_ind, x: torch.Tensor) -> torch.Tensor:
    """``vdm[n, b] = prod_d x[d, n] ** mul_ind[d, b]``, (N, Q) float64.

    ``x`` (D, N) float64 and contiguous; ``mul_ind`` a (D, Q) array of
    non-negative integers (an int becomes a (1, 1) index).  A CPU tensor runs
    the plain version; a CUDA tensor launches the kernel on the current
    stream, without synchronising.  ``ValueError`` for a negative exponent,
    D > 32, a multi-index over 48 KB as int32, or points that are not
    contiguous float64.
    """
    global LAUNCHES
    _check_points(x)
    mul = _multi_index(mul_ind, x.shape[0])
    if x.device.type == "cpu":
        return vandermonde_plain(mul, x)
    if x.device.type != "cuda":
        raise ValueError(f"the Vandermonde matrix runs on CPU or CUDA tensors; got {x.device}")
    lib = build()
    D, N = x.shape
    Q = mul.shape[1]
    out = torch.empty((N, Q), dtype=torch.float64, device=x.device)
    if out.numel() == 0:
        return out
    e = torch.as_tensor(mul, dtype=torch.int32).to(x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    rc = lib.vdm_launch(x.data_ptr(), e.data_ptr(), D, N, Q, x.device.index or 0,
                        out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"Vandermonde kernel launch failed: "
                           f"{lib.vdm_error_string(rc).decode()} (cudaError {rc})")
    LAUNCHES += 1
    return out
