"""Fused Monte-Carlo expectations of the RBF kernel under a Student-t density:
CUDA kernels, launchers, plain versions and autograd.

Counterpart of the RBF-Student part of the JAX package's
``ops/pallas_ops.py``: four TPU kernels become CUDA kernels in
``csrc/student_qrq.cu`` (q/R/Q) and ``csrc/student_mc.cu`` (pairwise), one
library, with the math in ``csrc/student_mc_rows.cuh``:

- ``qrq``     (``_student_exp_kernel``): per-chunk sums of ``q[n] = sum_s k[s, n]``,
  ``R[d, n] = sum_s x[s, d] k[s, n]`` and ``Q[n, m] = sum_s k[s, n] k[s, m]``;
- ``qrq_bwd`` (``_student_qRQ_bwd_kernel``): its VJP partials ``cs``, ``B``, ``u``;
- ``kxy``     (``_student_kxy_kernel``): per-chunk sums of the sample-sample Gram;
- ``kxy_bwd`` (``_student_kxy_bwd_kernel``): its lengthscale VJP partials.

Here ``k[s, n] = exp(-0.5 |(x_s - x_n) / l|^2)``, unscaled.  Every kernel works
in float32 and writes per-block partial sums, which the wrapper sums in
float64 (the precision contract of the TPU kernels).  The sample stream is
cut into chunks: ``num_chunks = max(num_samples // chunk, 1)`` chunks, and only
``num_chunks * chunk`` samples are drawn and divided by (:func:`chunking`).
The pairs of ``kxy`` lie inside a chunk, so its chunk size is part of the
estimate.

Each wrapper (:func:`qrq_sums`, :func:`qrq_bwd_sums`, :func:`kxy_chunk_sums`,
:func:`kxy_bwd_sums`) runs its plain PyTorch version for CPU tensors and
launches its kernel for CUDA tensors, adding one to ``LAUNCHES[name]`` for
each launch.  :func:`student_qrq` and :func:`student_kxy` are differentiable
(``torch.autograd.Function``) with the backward kernels; the samples are
Monte-Carlo constants.  :func:`student_qrq_plain` and
:func:`student_kxy_plain` are the same estimators in plain differentiable
PyTorch, which a kernel's gradient is held against.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

__all__ = ["LAUNCHES", "MAX_D", "MAX_N", "QRQ_CHUNK", "KXY_CHUNK", "chunking",
           "qrq_sums", "qrq_bwd_sums", "kxy_chunk_sums", "kxy_bwd_sums",
           "student_qrq", "student_qrq_plain", "student_kxy", "student_kxy_plain", "build"]

#: kernel launches made by the wrappers in this process, by kernel
LAUNCHES = {"qrq": 0, "qrq_bwd": 0, "kxy": 0, "kxy_bwd": 0}

#: largest input dimension and point count the kernels take (SMC_MAX_D, SMC_MAX_N)
MAX_D = 8
MAX_N = 128
#: default chunks: the JAX package's (``student_expectations``, ``student_kxy``)
QRQ_CHUNK = 4096
KXY_CHUNK = 1024
#: largest chunk of the pairwise kernels (SMC_KXY_MAX_CHUNK)
KXY_MAX_CHUNK = 1024

#: elements of the largest intermediate a plain version makes at once
_PLAIN_ELEMS = 1 << 25

_NVCC_FLAGS = _build.NVCC_FLAGS


def chunking(num_samples: int, chunk: int):
    """``(chunk, num_chunks, total)`` for a sample budget: a chunk larger than
    the 8-aligned budget shrinks to it, and ``total = num_chunks * chunk``
    samples are drawn."""
    chunk = min(chunk, -(-max(num_samples, 8) // 8) * 8)
    num_chunks = max(num_samples // chunk, 1)
    return chunk, num_chunks, num_chunks * chunk


# ---------------------------------------------------------------------------
# plain versions (chunked PyTorch: f32 partials per chunk)
# ---------------------------------------------------------------------------

def _gram(s, p):
    """``exp(-0.5 (|s|^2 + |p|^2) + s p^T)`` of scaled rows s (..., S, D), p (..., P, D)."""
    s2 = torch.sum(s * s, dim=-1)[..., :, None]
    p2 = torch.sum(p * p, dim=-1)[..., None, :]
    return torch.exp(-0.5 * (s2 + p2) + s @ p.mT)


def _chunk_groups(num_chunks: int, per_chunk: int):
    g = max(1, _PLAIN_ELEMS // max(per_chunk, 1))
    return [(a, min(a + g, num_chunks)) for a in range(0, num_chunks, g)]


def _qrq_partials_plain(inv_l, xs, xp, chunk):
    x3 = xs.reshape(-1, chunk, xs.shape[-1])
    p = xp * inv_l
    out = []
    for a, b in _chunk_groups(x3.shape[0], chunk * xp.shape[0]):
        xc = x3[a:b]
        k = _gram(xc * inv_l, p)                                     # (g, C, N)
        out.append(torch.cat([k.sum(1), (xc.mT @ k).flatten(1), (k.mT @ k).flatten(1)], 1))
    return torch.cat(out)


def _qrq_bwd_partials_plain(inv_l, xs, xp, gq, gR, gQ2, chunk):
    x3 = xs.reshape(-1, chunk, xs.shape[-1])
    p = xp * inv_l
    out = []
    for a, b in _chunk_groups(x3.shape[0], chunk * xp.shape[0]):
        xc = x3[a:b]
        k = _gram(xc * inv_l, p)
        M = (gq + xc @ gR + k @ gQ2) * k
        rowsum = M.sum(2, keepdim=True)
        out.append(torch.cat([M.sum(1), (xc.mT @ M).flatten(1), (xc * xc * rowsum).sum(1)], 1))
    return torch.cat(out)


def _kxy_partials_plain(inv_l, xs, chunk):
    x3 = xs.reshape(-1, chunk, xs.shape[-1])
    out = []
    for a, b in _chunk_groups(x3.shape[0], chunk * chunk):
        s = x3[a:b] * inv_l
        out.append(_gram(s, s).sum((1, 2)))
    return torch.cat(out)


def _kxy_bwd_partials_plain(inv_l, xs, chunk):
    x3 = xs.reshape(-1, chunk, xs.shape[-1])
    out = []
    for a, b in _chunk_groups(x3.shape[0], chunk * chunk):
        xc = x3[a:b]
        k = _gram(xc * inv_l, xc * inv_l)
        rowsum = k.sum(2, keepdim=True)
        out.append((xc * xc * rowsum).sum(1) - (xc * (k @ xc)).sum(1))
    return torch.cat(out)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def build() -> ctypes.CDLL:
    """Compile ``csrc/student_mc.cu`` and ``csrc/student_qrq.cu`` for sm_90a
    with nvcc (once, the two at once) into one library and bind it; later
    calls return the bound library."""
    return _build.bound("student_mc", ["student_mc.cu", "student_qrq.cu"], _bind)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the launchers' argument types on a built library."""
    p, i = ctypes.c_void_p, ctypes.c_int
    for name, args in (("smc_qrq_launch", [p] * 3 + [i] * 5 + [p] * 2),
                       ("smc_qrq_bwd_launch", [p] * 6 + [i] * 5 + [p] * 2),
                       ("smc_kxy_launch", [p] * 2 + [i] * 4 + [p] * 2),
                       ("smc_kxy_bwd_launch", [p] * 2 + [i] * 4 + [p] * 2)):
        getattr(lib, name).restype = ctypes.c_int
        getattr(lib, name).argtypes = args
    lib.smc_error_string.restype = ctypes.c_char_p
    lib.smc_error_string.argtypes = [ctypes.c_int]
    return lib


def _host_shim() -> ctypes.CDLL:
    """The per-element header built for the host with g++ (tests only)."""
    return _build.bound("student_mc_host", ["student_mc_host.cpp"], _bind_host, host=True)


def _bind_host(lib: ctypes.CDLL):
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.smc_host_qrq.argtypes = [p] * 3 + [i] * 4 + [p]
    lib.smc_host_qrq_bwd.argtypes = [p] * 6 + [i] * 4 + [p]
    lib.smc_host_qrq_bucket.argtypes = [i]
    lib.smc_host_qrq_bucket.restype = ctypes.c_int
    lib.smc_host_kxy.argtypes = [p] * 2 + [i] * 4 + [p]
    for f in (lib.smc_host_qrq, lib.smc_host_qrq_bwd, lib.smc_host_kxy):
        f.restype = None
    return lib


def _check(inv_l, xs, chunk, *others, pairwise=False):
    """Validate the wrappers' inputs: float32, contiguous, one device, D <= 8,
    N <= 128 points, whole chunks (2..1024 samples for the pairwise kernels)."""
    tensors = (inv_l, xs) + others
    if any(t.dtype != torch.float32 for t in tensors):
        raise TypeError(f"the Student-MC kernels take float32; got "
                        f"{[str(t.dtype) for t in tensors]}")
    if any(t.device != xs.device for t in tensors):
        raise ValueError("the Student-MC inputs lie on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the Student-MC inputs must be contiguous")
    if xs.ndim != 2 or not 1 <= xs.shape[1] <= MAX_D or inv_l.shape != (xs.shape[1],):
        raise ValueError(f"samples must be (S, D) with 1 <= D <= {MAX_D} and inv_l (D,); got "
                         f"{tuple(xs.shape)} and {tuple(inv_l.shape)}")
    if chunk < 1 or xs.shape[0] == 0 or xs.shape[0] % chunk:
        raise ValueError(f"{xs.shape[0]} samples do not make whole chunks of {chunk}")
    if pairwise and not 2 <= chunk <= KXY_MAX_CHUNK:
        raise ValueError(f"the pairwise kernels take chunks of 2..{KXY_MAX_CHUNK} samples; "
                         f"got {chunk}")
    if xs.shape[0] // chunk >= 2 ** 31:
        raise ValueError(f"at most 2**31 - 1 chunks; got {xs.shape[0] // chunk}")
    if others:
        xp = others[0]
        if xp.ndim != 2 or xp.shape[1] != xs.shape[1] or not 1 <= xp.shape[0] <= MAX_N:
            raise ValueError(f"points must be (N, D) with 1 <= N <= {MAX_N}; got "
                             f"{tuple(xp.shape)} for D = {xs.shape[1]}")
    if xs.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the Student-MC kernels run on CPU or CUDA tensors; got {xs.device}")


def _run(lib, fn: str, name: str, device: torch.device, args):
    """Call launcher ``fn`` with ``args`` (the output pointer last), the card
    index and the current stream; raise on its CUDA error."""
    rc = getattr(lib, fn)(*args[:-1], device.index or 0, args[-1],
                          torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"Student-MC kernel {name} launch failed: "
                           f"{lib.smc_error_string(rc).decode()} (cudaError {rc})")
    LAUNCHES[name] += 1


def qrq_sums(inv_l, xs, xp, chunk: int) -> torch.Tensor:
    """float64 sums over all samples of ``(q, R, Q)``, flattened as
    ``[q (N), R (D, N), Q (N, N)]``.

    ``inv_l`` (D,) inverse lengthscales, ``xs`` (S, D) raw samples, ``xp``
    (N, D) raw points, all float32; ``S`` a multiple of ``chunk``.
    """
    _check(inv_l, xs, chunk, xp)
    if xs.device.type == "cpu":
        return _qrq_partials_plain(inv_l, xs, xp, chunk).double().sum(0)
    (N, D), C = xp.shape, xs.shape[0] // chunk
    out = torch.empty((C, N + D * N + N * N), dtype=torch.float32, device=xs.device)
    _run(build(), "smc_qrq_launch", "qrq", xs.device,
         (inv_l.data_ptr(), xs.data_ptr(), xp.data_ptr(), C, chunk, N, D, out.data_ptr()))
    return out.double().sum(0)


def qrq_bwd_sums(inv_l, xs, xp, gq, gR, gQ2, chunk: int) -> torch.Tensor:
    """float64 sums of the backward partials ``[cs (N), B (D, N), u (D)]`` for
    the output cotangents ``gq`` (N,), ``gR`` (D, N) and ``gQ2 = gQ + gQ^T``
    (N, N), float32."""
    _check(inv_l, xs, chunk, xp, gq, gR, gQ2)
    (N, D), C = xp.shape, xs.shape[0] // chunk
    if gq.shape != (N,) or gR.shape != (D, N) or gQ2.shape != (N, N):
        raise ValueError(f"cotangents must be (N,), (D, N), (N, N); got {tuple(gq.shape)}, "
                         f"{tuple(gR.shape)}, {tuple(gQ2.shape)}")
    if xs.device.type == "cpu":
        return _qrq_bwd_partials_plain(inv_l, xs, xp, gq, gR, gQ2, chunk).double().sum(0)
    out = torch.empty((C, N + D * N + D), dtype=torch.float32, device=xs.device)
    _run(build(), "smc_qrq_bwd_launch", "qrq_bwd", xs.device,
         (inv_l.data_ptr(), xs.data_ptr(), xp.data_ptr(), gq.data_ptr(), gR.data_ptr(),
          gQ2.data_ptr(), C, chunk, N, D, out.data_ptr()))
    return out.double().sum(0)


def kxy_chunk_sums(inv_l, xs, chunk: int) -> torch.Tensor:
    """float64 (num_chunks,): the sum of every chunk's sample-sample Gram,
    diagonal included.  The kernel sums the pairs ``r < c`` of a chunk in one
    block, doubles them and adds the diagonal as the exact ``chunk``."""
    _check(inv_l, xs, chunk, pairwise=True)
    if xs.device.type == "cpu":
        return _kxy_partials_plain(inv_l, xs, chunk).double()
    C, D = xs.shape[0] // chunk, xs.shape[1]
    out = torch.empty((C,), dtype=torch.float32, device=xs.device)
    _run(build(), "smc_kxy_launch", "kxy", xs.device,
         (inv_l.data_ptr(), xs.data_ptr(), C, chunk, D, out.data_ptr()))
    return out.double()


def kxy_bwd_sums(inv_l, xs, chunk: int) -> torch.Tensor:
    """float64 (D,): ``sum_{r<c} k_rc (x_rd - x_cd)^2`` over the pairs of
    every chunk, half the TPU kernel's ``t_d``.  The kernel sums the pairs
    themselves; the plain version takes the expanded form
    ``sum_s x_sd^2 rowsum_s - x_d^T k x_d``."""
    _check(inv_l, xs, chunk, pairwise=True)
    if xs.device.type == "cpu":
        return _kxy_bwd_partials_plain(inv_l, xs, chunk).double().sum(0)
    C, D = xs.shape[0] // chunk, xs.shape[1]
    out = torch.empty((C, D), dtype=torch.float32, device=xs.device)
    _run(build(), "smc_kxy_bwd_launch", "kxy_bwd", xs.device,
         (inv_l.data_ptr(), xs.data_ptr(), C, chunk, D, out.data_ptr()))
    return out.double().sum(0)


# ---------------------------------------------------------------------------
# expectations with autograd
# ---------------------------------------------------------------------------

def _kernel_args(par, x=None):
    ell = par.reshape(-1)[1:]
    inv_l = (1.0 / ell.to(torch.float32)).contiguous()
    return ell, inv_l, (None if x is None else x.T.to(torch.float32).contiguous())


def _split_qrq(v, d: int, n: int):
    return v[:n], v[n:n + d * n].reshape(d, n), v[n + d * n:].reshape(n, n)


class _StudentQRQ(torch.autograd.Function):

    @staticmethod
    def forward(ctx, par, x, samples, chunk):
        _, inv_l, xp = _kernel_args(par, x)
        v = qrq_sums(inv_l, samples, xp, chunk) / samples.shape[0]
        ctx.save_for_backward(par, x, samples)
        ctx.chunk = chunk
        return tuple(t.to(x.dtype) for t in _split_qrq(v, *x.shape))

    @staticmethod
    def backward(ctx, gq, gR, gQ):
        par, x, samples = ctx.saved_tensors
        ell, inv_l, xp = _kernel_args(par, x)
        f32 = lambda t: t.to(torch.float32).contiguous()
        v = qrq_bwd_sums(inv_l, samples, xp, f32(gq), f32(gR), f32(gQ + gQ.T), ctx.chunk)
        d, n = x.shape
        cs, B, u = v[:n], v[n:n + d * n].reshape(d, n), v[n + d * n:]
        xn, ell = x.double(), ell.double()
        total = samples.shape[0]
        # d exponent / dx[d, n] = (x_s - x_n) / l^2; / dl[d] = (x_s - x_n)^2 / l^3
        x_bar = (B - xn * cs) / (ell ** 2)[:, None] / total
        l_bar = ((u - 2.0 * torch.sum(B * xn, 1) + torch.sum(xn * xn * cs, 1))
                 / ell ** 3 / total)
        par_bar = torch.cat([l_bar.new_zeros(1), l_bar]).reshape(par.shape)
        return par_bar.to(par.dtype), x_bar.to(x.dtype), None, None


def student_qrq(par, x, samples, chunk: int = QRQ_CHUNK):
    """``(q, R, Q)`` of the RBF kernel ``[s, l_1..l_D]`` at the points ``x``
    (D, N), unscaled, averaged over the float32 ``samples`` (S, D) in chunks;
    differentiable in ``par`` (lengthscales; the scale's gradient is 0) and
    ``x``, through the backward kernel."""
    return _StudentQRQ.apply(par, x, samples, chunk)


def student_qrq_plain(par, x, samples, chunk: int = QRQ_CHUNK):
    """:func:`student_qrq` in plain PyTorch, differentiable by autograd."""
    _, inv_l, _ = _kernel_args(par)
    v = _qrq_partials_plain(inv_l, samples, x.T.to(torch.float32), chunk).double().sum(0)
    return tuple(t.to(x.dtype) for t in _split_qrq(v / samples.shape[0], *x.shape))


class _StudentKxy(torch.autograd.Function):

    @staticmethod
    def forward(ctx, par, samples, chunk):
        _, inv_l, _ = _kernel_args(par)
        sums = kxy_chunk_sums(inv_l, samples, chunk)
        ctx.save_for_backward(par, samples)
        ctx.chunk = chunk
        return (torch.sum((sums - chunk) / (chunk - 1)) / samples.shape[0]).to(par.dtype)

    @staticmethod
    def backward(ctx, g):
        par, samples = ctx.saved_tensors
        ell, inv_l, _ = _kernel_args(par)
        t = 2.0 * kxy_bwd_sums(inv_l, samples, ctx.chunk)
        l_bar = g.double() * t / ell.double() ** 3 / (samples.shape[0] * (ctx.chunk - 1))
        par_bar = torch.cat([l_bar.new_zeros(1), l_bar]).reshape(par.shape)
        return par_bar.to(par.dtype), None, None


def student_kxy(par, samples, chunk: int = KXY_CHUNK):
    """``E[k(x, y)]`` of the unscaled RBF kernel over independent samples: the
    mean of the off-diagonal pairs of each chunk of ``samples`` (S, D),
    averaged over chunks; differentiable in the lengthscales through the
    backward kernel."""
    return _StudentKxy.apply(par, samples, chunk)


def student_kxy_plain(par, samples, chunk: int = KXY_CHUNK):
    """:func:`student_kxy` in plain PyTorch, differentiable by autograd."""
    _, inv_l, _ = _kernel_args(par)
    sums = _kxy_partials_plain(inv_l, samples, chunk).double()
    return (torch.sum((sums - chunk) / (chunk - 1)) / samples.shape[0]).to(par.dtype)
