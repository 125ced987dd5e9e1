"""The time axis of the time-parallel filters and smoothers split over a
mesh of ranks (counterpart of :mod:`ssmtoybox_tpu.parallel.shardtime`).

:mod:`~ssmtoybox_torch.parallel.timescan` and
:mod:`~ssmtoybox_torch.parallel.sqrttime` scan one record's time axis on one
card.  Here the record's steps are split into one contiguous chunk a rank of
a :class:`~ssmtoybox_torch.parallel.mesh.Mesh` axis, the two-level
decomposition of an associative scan:

1. each rank scans its chunk with
   :func:`~ssmtoybox_torch.parallel.scan.associative_scan`;
2. one ``all_gather`` collects the chunks' aggregates (one element each);
3. each rank scans the ``n_dev`` aggregates and folds its exclusive prefix
   (forward) or suffix (reverse) into its chunk with ``fn(prefix, local)``;
   the edge chunk keeps its local scan.

A length that the axis does not divide is padded with the combine's
two-sided identity and trimmed afterwards (exact: an identity changes no real
prefix).  The affine wrappers build only their chunk's elements, with the
element builders and combines of ``timescan`` and ``sqrttime``, so the
sharded and single-card paths share their arithmetic.  They take the whole
record on every rank and return the whole result on every rank: a second
``all_gather`` a call moves the result once.  Results equal the unsharded
scans to rounding.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..utils.linalg import symmetrize
from .common import as_tensors, ieee
from .scan import associative_scan
from .sqrttime import (_combine_sqrt_filter, _combine_sqrt_smoother, _filter_identity,
                       _smoother_identity, _sqrt_filter_elements, _sqrt_smoother_elements)
from .timescan import (_affine_filter_elements, _affine_smoother_elements, _combine_filter,
                       _combine_smoother)

__all__ = ["sharded_associative_scan",
           "sharded_parallel_affine_filter", "sharded_parallel_affine_smoother",
           "sharded_parallel_affine_sqrt_filter",
           "sharded_parallel_affine_sqrt_smoother"]


def _chunk(n: int, mesh, axis_name: str):
    """``(start, stop, chunk)``: this rank's steps ``[start, stop)`` of ``n``
    in chunks of ``chunk`` (the last chunks may hold fewer real steps)."""
    n_dev = mesh.shape[axis_name]
    chunk = -(-n // n_dev)
    start = min(mesh.coords[axis_name] * chunk, n)
    return start, min(start + chunk, n), chunk


def _pad(elems, identity, chunk: int):
    """``elems`` padded up to ``chunk`` rows with the identity element."""
    pad = chunk - elems[0].shape[0]
    if not pad:
        return tuple(elems)
    return tuple(torch.cat([e, torch.as_tensor(i, dtype=e.dtype, device=e.device)
                            .expand((pad,) + e.shape[1:])])
                 for e, i in zip(elems, identity))


def _scan_chunk(fn, local, mesh, axis_name: str, reverse: bool = False):
    """The inclusive scan of this rank's chunk ``local`` within the whole
    sequence: local scan, one gather of the aggregates, prefix fold."""
    loc = associative_scan(fn, local, reverse=reverse)
    agg = tuple(a[0] if reverse else a[-1] for a in loc)
    pref = associative_scan(fn, mesh.gather_along(axis_name, agg), reverse=reverse)
    n_dev, idx = mesh.shape[axis_name], mesh.coords[axis_name]
    if idx == (n_dev - 1 if reverse else 0):
        return loc                       # the edge chunk has no prefix / suffix
    take = idx + 1 if reverse else idx - 1
    chunk = loc[0].shape[0]
    # the prefix (suffix) aggregate is arg0 in both directions
    return fn(tuple(p[take].expand((chunk,) + p.shape[1:]) for p in pref), loc)


def _whole(mesh, axis_name: str, tensors, n: int):
    """Every rank's chunk of ``tensors`` gathered along the axis, trimmed to
    ``n`` steps."""
    return tuple(g.reshape((-1,) + g.shape[2:])[:n]
                 for g in mesh.gather_along(axis_name, tensors))


def sharded_associative_scan(fn, elems, mesh, axis_name: str, reverse: bool = False,
                             identity=None):
    """:func:`~ssmtoybox_torch.parallel.scan.associative_scan` with the
    leading axis split over ``mesh``'s axis ``axis_name``.

    ``fn`` and ``elems`` (a sequence of tensors of one leading length ``N``,
    the whole sequence on every rank) are as there; returns the inclusive
    scan (the suffix scan for ``reverse=True``), whole, on every rank.  ``N``
    must divide by the axis size unless ``identity`` (a sequence of the
    unbatched two-sided identity elements of ``fn``) is given, which pads the
    tail.  Two collectives: the aggregates and the result.
    """
    elems = tuple(elems)
    sizes = {e.shape[0] for e in elems}
    if len(sizes) != 1:
        raise ValueError(f"scan elements disagree on the leading (time) axis: {sizes}")
    n, n_dev = sizes.pop(), mesh.shape[axis_name]
    if n % n_dev and identity is None:
        raise ValueError(f"scan length {n} does not divide by mesh axis '{axis_name}' "
                         f"({n_dev}) and no identity element was given")
    start, stop, chunk = _chunk(n, mesh, axis_name)
    local = _pad(tuple(e[start:stop] for e in elems), identity, chunk)
    return _whole(mesh, axis_name, _scan_chunk(fn, local, mesh, axis_name, reverse), n)


def _filter_chunk(build, coeffs, m0, P0, ys, start: int, stop: int):
    """The filtering elements of steps ``[start, stop)``: built from the step
    before the chunk as well, whose row (the prior's element) is dropped."""
    lo = max(start - 1, 0)
    elems = build(*(c[lo:stop] for c in coeffs), m0, P0, ys[lo:stop])
    return tuple(e[start - lo:] for e in elems)


def _smoother_chunk(build, Fs, bs, Qs, m, P, start: int, stop: int, n: int):
    """The smoothing elements of steps ``[start, stop)``: built with the step
    after the chunk as well (element ``k`` uses the dynamics into ``k + 1``),
    whose row is dropped."""
    hi = min(stop + 1, n)
    elems = build(Fs[start:hi], bs[start:hi], Qs[start:hi], m[start:hi], P[start:hi])
    return tuple(e[:stop - start] for e in elems)


def _empty(like, shapes):
    """No elements: a rank whose chunk is all padding."""
    return tuple(like.new_zeros((0,) + s) for s in shapes)


@ieee
def sharded_parallel_affine_filter(Fs, bs, Qs, Hs, cs, Rs, m0, P0, data, mesh,
                                   axis_name: str = "t") -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`~ssmtoybox_torch.parallel.timescan.parallel_affine_filter`
    with the time axis split over ``mesh``'s axis ``axis_name``: the same
    model, indexing and ``(fi_mean (D, N), fi_cov (D, D, N))``, equal to the
    unsharded scan to rounding."""
    Fs, bs, Qs, Hs, cs, Rs, m0, P0, data = as_tensors(Fs, bs, Qs, Hs, cs, Rs, m0, P0, data)
    ys, d = data.T, m0.shape[0]
    n = ys.shape[0]
    start, stop, chunk = _chunk(n, mesh, axis_name)
    elems = (_filter_chunk(_affine_filter_elements, (Fs, bs, Qs, Hs, cs, Rs), m0, P0, ys,
                           start, stop) if stop > start
             else _empty(m0, ((d, d), (d,), (d, d), (d,), (d, d))))
    local = _pad(elems, _filter_identity(d, m0), chunk)
    _, b, C, _, _ = _scan_chunk(_combine_filter, local, mesh, axis_name)
    b, C = _whole(mesh, axis_name, (b, C), n)
    return b.T, symmetrize(C).permute(1, 2, 0)


@ieee
def sharded_parallel_affine_smoother(Fs, bs, Qs, fi_mean, fi_cov, mesh,
                                     axis_name: str = "t") -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`~ssmtoybox_torch.parallel.timescan.parallel_affine_smoother`
    with the time axis split over ``mesh``'s axis ``axis_name`` (a reverse
    scan)."""
    Fs, bs, Qs, fi_mean, fi_cov = as_tensors(Fs, bs, Qs, fi_mean, fi_cov)
    m, P = fi_mean.T, fi_cov.permute(2, 0, 1)
    n, d = m.shape
    start, stop, chunk = _chunk(n, mesh, axis_name)
    elems = (_smoother_chunk(_affine_smoother_elements, Fs, bs, Qs, m, P, start, stop, n)
             if stop > start else _empty(m, ((d, d), (d,), (d, d))))
    local = _pad(elems, _smoother_identity(d, m), chunk)
    _, g, L = _scan_chunk(_combine_smoother, local, mesh, axis_name, reverse=True)
    g, L = _whole(mesh, axis_name, (g, L), n)
    return g.T, symmetrize(L).permute(1, 2, 0)


@ieee
def sharded_parallel_affine_sqrt_filter(Fs, bs, SQs, Hs, cs, SRs, m0, S0, data, mesh,
                                        axis_name: str = "t"
                                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`~ssmtoybox_torch.parallel.sqrttime.parallel_affine_sqrt_filter`
    with the time axis split over ``mesh``'s axis ``axis_name``: factor-form
    elements and QR combines; returns ``(fi_mean (D, N), fi_sqrt (D, D,
    N))``."""
    Fs, bs, SQs, Hs, cs, SRs, m0, S0, data = as_tensors(Fs, bs, SQs, Hs, cs, SRs, m0, S0, data)
    ys, d = data.T, m0.shape[0]
    n = ys.shape[0]
    start, stop, chunk = _chunk(n, mesh, axis_name)
    elems = (_filter_chunk(_sqrt_filter_elements, (Fs, bs, SQs, Hs, cs, SRs), m0, S0, ys,
                           start, stop) if stop > start
             else _empty(m0, ((d, d), (d,), (d, d), (d,), (d, d))))
    local = _pad(elems, _filter_identity(d, m0), chunk)
    _, b, U, _, _ = _scan_chunk(_combine_sqrt_filter, local, mesh, axis_name)
    b, U = _whole(mesh, axis_name, (b, U), n)
    return b.T, U.permute(1, 2, 0)


@ieee
def sharded_parallel_affine_sqrt_smoother(Fs, bs, SQs, fi_mean, fi_sqrt, mesh,
                                          axis_name: str = "t"
                                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`~ssmtoybox_torch.parallel.sqrttime.parallel_affine_sqrt_smoother`
    with the time axis split over ``mesh``'s axis ``axis_name`` (a reverse
    scan); returns ``(sm_mean (D, N), sm_sqrt (D, D, N))``."""
    Fs, bs, SQs, fi_mean, fi_sqrt = as_tensors(Fs, bs, SQs, fi_mean, fi_sqrt)
    m, S = fi_mean.T, fi_sqrt.permute(2, 0, 1)
    n, d = m.shape
    start, stop, chunk = _chunk(n, mesh, axis_name)
    elems = (_smoother_chunk(_sqrt_smoother_elements, Fs, bs, SQs, m, S, start, stop, n)
             if stop > start else _empty(m, ((d, d), (d,), (d, d))))
    local = _pad(elems, _smoother_identity(d, m), chunk)
    _, g, D = _scan_chunk(_combine_sqrt_smoother, local, mesh, axis_name, reverse=True)
    g, D = _whole(mesh, axis_name, (g, D), n)
    return g.T, D.permute(1, 2, 0)
