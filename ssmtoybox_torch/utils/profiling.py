"""Tracing and timing (counterpart of :mod:`ssmtoybox_tpu.utils.profiling`):
a ``torch.profiler`` trace context for device timelines and a wall-clock
timer that forces completion by reading a checksum of the outputs back."""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable

import torch

__all__ = ["trace", "timeit", "sync"]


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the block into a trace in ``log_dir`` (Chrome / Perfetto JSON,
    TensorBoard's layout), the CUDA card's activities included when there
    is one; yields the profiler.

    >>> with trace("traces/study"):
    ...     run_study()
    """
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)) as prof:
        yield prof


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _leaves(getattr(tree, f.name))
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)


def sync(tree) -> float:
    """Force the computation of ``tree``'s tensors to complete; returns the
    sum of their absolute values (in float32) as a checksum."""
    return float(sum(float(t.detach().abs().to(torch.float32).sum()) for t in _leaves(tree)))


def timeit(fn: Callable, *args, repeats: int = 3, warmup: int = 1):
    """Median wall-clock seconds of ``fn(*args)`` over ``repeats`` calls after
    ``warmup`` calls, each call's outputs forced by :func:`sync`.  Returns
    ``(seconds, last_output)``."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
        sync(out)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn(*args)
        sync(out)
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], out
