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

The kernel runs one thread a point and writes each block's tile as one
contiguous span (``csrc/vandermonde.cu``).  A multi-index is validated once
and kept, by its bytes, in a small cache: one of at most ``VALUE_INTS``
entries (every study's) then travels by value in the kernel's parameters and
nothing is copied to the card; a larger one is copied to the card once.
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass, field

import numpy as np
import torch

from . import _build

__all__ = ["LAUNCHES", "MAX_DIM", "MAX_SHARED_BYTES", "VALUE_INTS", "vandermonde",
           "vandermonde_plain", "build"]

#: kernel launches made by :func:`vandermonde` in this process
LAUNCHES = 0

#: most dimensions of a multi-index: every study needs D <= 7
MAX_DIM = 32

#: a multi-index of more than ``VALUE_INTS`` entries is staged in shared
#: memory as int32: D * Q * 4 bytes at most
MAX_SHARED_BYTES = 48 * 1024

#: most entries of a multi-index that travels by value in the kernel's
#: parameters (``VDM_VALUE_INTS`` in the kernel's source)
VALUE_INTS = 128

#: validated multi-indices kept by :func:`_index`
_CACHE_SIZE = 64


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


@dataclass
class _Index:
    """A validated multi-index: (D, Q) int64 for the plain version, the same
    as contiguous int32 for the kernel, and its copies on cards."""

    mul: np.ndarray
    e32: np.ndarray
    on_card: dict = field(default_factory=dict)

    def card(self, device: torch.device) -> torch.Tensor:
        e = self.on_card.get(device)
        if e is None:
            e = self.on_card[device] = torch.as_tensor(self.e32).to(device)
        return e


_INDICES: dict = {}


def _index(mul_ind, dim: int) -> _Index:
    """The validated multi-index for points of dimension ``dim``, from a
    cache keyed by its bytes, type and shape: validation, the int32 copy and
    a copy to a card happen once for a multi-index, not once a call."""
    raw = np.asarray(mul_ind.cpu() if isinstance(mul_ind, torch.Tensor) else mul_ind)
    key = (dim, raw.dtype.str, raw.shape, raw.tobytes())
    hit = _INDICES.get(key)
    if hit is None:
        mul = _multi_index(raw, dim)
        if len(_INDICES) >= _CACHE_SIZE:
            _INDICES.clear()
        hit = _INDICES[key] = _Index(mul, np.ascontiguousarray(mul, dtype=np.int32))
    return hit


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


def _bind(lib: ctypes.CDLL):
    lib.vdm_launch.restype = ctypes.c_int
    lib.vdm_launch.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_void_p]
    lib.vdm_error_string.restype = ctypes.c_char_p
    lib.vdm_error_string.argtypes = [ctypes.c_int]
    return lib


def build() -> ctypes.CDLL:
    """Compile ``csrc/vandermonde.cu`` for sm_90a with nvcc (once) and bind
    it; later calls return the bound library."""
    return _build.bound("vandermonde", ["vandermonde.cu"], _bind)


def _bind_host(lib: ctypes.CDLL):
    lib.vdm_host_run.restype = None
    lib.vdm_host_run.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]


def _host_shim() -> ctypes.CDLL:
    """The point header built for the host with g++ (tests only)."""
    return _build.bound("vandermonde_host", ["vandermonde_host.cpp"], _bind_host, host=True)


def _host_shim_run(mul_ind, x: torch.Tensor) -> torch.Tensor:
    """Run the point header compiled for the host on a CPU tensor."""
    _check_points(x)
    if x.device.type != "cpu":
        raise ValueError(f"the host build takes CPU tensors; got {x.device}")
    index = _index(mul_ind, x.shape[0])
    D, N = x.shape
    Q = index.mul.shape[1]
    out = torch.empty((N, Q), dtype=torch.float64)
    _host_shim().vdm_host_run(x.data_ptr(), index.e32.ctypes.data, D, N, Q, out.data_ptr())
    return out


def vandermonde(mul_ind, x: torch.Tensor) -> torch.Tensor:
    """``vdm[n, b] = prod_d x[d, n] ** mul_ind[d, b]``, (N, Q) float64.

    ``x`` (D, N) float64 and contiguous; ``mul_ind`` a (D, Q) array of
    non-negative integers (an int becomes a (1, 1) index).  A CPU tensor runs
    the plain version; a CUDA tensor launches the kernel on the current
    stream, without synchronising, and copies nothing to the card for a
    multi-index it has seen.  ``ValueError`` for a negative exponent, D > 32,
    a multi-index over 48 KB as int32, or points that are not contiguous
    float64.
    """
    global LAUNCHES
    _check_points(x)
    index = _index(mul_ind, x.shape[0])
    if x.device.type == "cpu":
        return vandermonde_plain(index.mul, x)
    if x.device.type != "cuda":
        raise ValueError(f"the Vandermonde matrix runs on CPU or CUDA tensors; got {x.device}")
    lib = build()
    D, N = x.shape
    Q = index.mul.shape[1]
    out = torch.empty((N, Q), dtype=torch.float64, device=x.device)
    if out.numel() == 0:
        return out
    by_value = D * Q <= VALUE_INTS
    rc = lib.vdm_launch(x.data_ptr(), index.e32.ctypes.data if by_value else None,
                        None if by_value else index.card(x.device).data_ptr(), D, N, Q,
                        x.device.index or 0, out.data_ptr(),
                        torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"Vandermonde kernel launch failed: "
                           f"{lib.vdm_error_string(rc).decode()} (cudaError {rc})")
    LAUNCHES += 1
    return out
