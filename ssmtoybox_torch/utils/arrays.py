"""The port's device default and the conversion of array-likes to its
float64 tensors.

Every constructor of the port takes ``device=None``, which names
:func:`default_device`: the CUDA card, unless :func:`set_device` has named
another device.  Without a card and without ``set_device("cpu")`` it raises
instead of running on the CPU unnoticed.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

__all__ = ["f64", "default_device", "resolve_device", "set_device", "map_tensors"]

#: the device ``set_device`` named; None means the CUDA card
_device: torch.device | None = None

#: the error of asking for the card where there is none
NO_CARD = ("ssmtoybox_torch runs on the CUDA card by default and "
           "torch.cuda.is_available() is false; call "
           "ssmtoybox_torch.set_device('cpu') to run on the CPU")


def set_device(dev) -> None:
    """Make ``dev`` (``"cpu"``, ``"cuda:1"``, a ``torch.device``) the device
    that ``device=None`` names from now on; ``None`` restores the default,
    the CUDA card."""
    global _device
    _device = None if dev is None else torch.device(dev)


def default_device() -> torch.device:
    """The device named by ``device=None``: the one :func:`set_device` named,
    else the CUDA card; ``RuntimeError`` if there is no card and none was
    named."""
    if _device is not None:
        return _device
    if not torch.cuda.is_available():
        raise RuntimeError(NO_CARD)
    return torch.device("cuda")


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``, :func:`default_device` for None."""
    return default_device() if device is None else torch.device(device)


def f64(a, device=None) -> torch.Tensor:
    """``a`` as a float64 tensor on ``device``; a tensor stays on its own
    device when ``device`` is None, anything else is copied from NumPy to
    :func:`resolve_device` of ``device``."""
    if isinstance(a, torch.Tensor):
        return a.to(dtype=torch.float64, device=device)
    return torch.tensor(np.ascontiguousarray(a, dtype=np.float64), dtype=torch.float64,
                        device=resolve_device(device))


def map_tensors(obj, fn):
    """``obj`` with ``fn`` applied to each of its tensors: a tensor maps to
    ``fn(tensor)``; a list, tuple or dict, and an object of this package (a
    model, random variable, kernel, transform or filter), to a shallow copy
    whose members are mapped in turn; anything else is kept as it is."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if isinstance(obj, (list, tuple)):
        return type(obj)(map_tensors(v, fn) for v in obj)
    if isinstance(obj, dict):
        return {k: map_tensors(v, fn) for k, v in obj.items()}
    if type(obj).__module__.startswith("ssmtoybox_torch") and hasattr(obj, "__dict__"):
        out = copy.copy(obj)
        out.__dict__.update({k: map_tensors(v, fn) for k, v in vars(obj).items()})
        return out
    return obj
