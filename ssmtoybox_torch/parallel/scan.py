"""Associative scan over a time axis (counterpart of ``jax.lax.associative_scan``).

Torch has no associative scan.  This one follows the recursion of
``jax.lax.associative_scan``: combine adjacent pairs, scan the half-length
sequence, then combine its prefixes with the remaining even elements and
interleave.  Following it keeps JAX's association order, so a float32 scan
rounds as the JAX package's does.  Python loops over the ~2 log2 N levels
only; every combine is one batched call over all the pairs of a level.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch

__all__ = ["associative_scan"]


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """``[even[0], odd[0], even[1], odd[1], ...]`` along the first axis
    (``even`` as long as ``odd`` or one longer)."""
    out = even.new_empty((even.shape[0] + odd.shape[0],) + even.shape[1:])
    out[0::2] = even
    out[1::2] = odd
    return out


def _scan(fn, elems):
    n = elems[0].shape[0]
    if n < 2:
        return elems
    reduced = fn(tuple(e[0:-1:2] for e in elems), tuple(e[1::2] for e in elems))
    odd = _scan(fn, tuple(reduced))
    rest = tuple(e[2::2] for e in elems)
    if rest[0].shape[0]:
        head = odd if n % 2 else tuple(o[:-1] for o in odd)
        even = tuple(torch.cat([e[:1], r]) for e, r in zip(elems, fn(head, rest)))
    else:
        even = tuple(e[:1] for e in elems)
    return tuple(_interleave(e, o) for e, o in zip(even, odd))


def associative_scan(fn: Callable, elems: Sequence[torch.Tensor], reverse: bool = False):
    """All prefix combinations of ``elems``, a tuple of tensors with one
    leading time axis: element ``k`` of the result is ``fn`` applied left to
    right over ``elems[0..k]``.  ``fn(a, b)`` takes two such tuples, batched
    over their leading axis, and returns one.  ``reverse=True`` flips the
    time axis, scans with the same ``fn`` and flips back, as JAX does."""
    elems = tuple(elems)
    if not all(e.shape[0] == elems[0].shape[0] for e in elems):
        raise ValueError("associative_scan: the tensors must share their first dimension; "
                         f"got {[tuple(e.shape) for e in elems]}")
    if reverse:
        flip = lambda t: tuple(torch.flip(e, (0,)) for e in t)
        return flip(_scan(fn, flip(elems)))
    return _scan(fn, elems)
