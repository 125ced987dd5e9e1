"""Checkpoint and resume of filter states and results (counterpart of
:mod:`ssmtoybox_tpu.utils.checkpoint`, on ``torch.save`` / ``torch.load``).

A tree is a tensor, a dict, list or tuple of trees, or a dataclass of them
(:class:`~ssmtoybox_torch.online.OnlineState`, a stacked
:class:`~ssmtoybox_torch.ssinf.FilterResult`, fitted kernel parameters).  It
is saved as plain dicts and lists of CPU tensors, so loading needs no
unpickling of classes (``weights_only=True``).
"""
from __future__ import annotations

import dataclasses
import os

import torch

__all__ = ["save_pytree", "restore_pytree"]

_FILE = "tree.pt"


def _plain(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: _plain(getattr(tree, f.name)) for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_plain(v) for v in tree]
    return torch.as_tensor(tree)


def _like(plain, like):
    if isinstance(like, torch.Tensor):
        return plain.to(dtype=like.dtype, device=like.device)
    if dataclasses.is_dataclass(like):
        return type(like)(**{f.name: _like(plain[f.name], getattr(like, f.name))
                             for f in dataclasses.fields(like)})
    if isinstance(like, dict):
        return {k: _like(plain[k], v) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_like(p, v) for p, v in zip(plain, like))
    return plain


def save_pytree(path: str, tree, overwrite: bool = False) -> str:
    """Save ``tree`` as a checkpoint in the directory ``path``; returns the
    directory's absolute path.

    Refuses to replace an existing checkpoint unless ``overwrite=True``: a
    silent overwrite would turn a path mix-up into lost study results.
    """
    path = os.path.abspath(path)
    if os.path.exists(path) and not overwrite:
        raise FileExistsError(
            f"checkpoint already exists at {path}; pass overwrite=True to replace it")
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, _FILE + ".tmp")
    torch.save(_plain(tree), tmp)
    os.replace(tmp, os.path.join(path, _FILE))
    return path


def restore_pytree(path: str, like=None):
    """Restore the checkpoint in ``path``: nested dicts and lists of CPU
    tensors, or, given ``like`` (a tree of the same structure), a tree of
    ``like``'s types with its tensors' dtypes and devices."""
    plain = torch.load(os.path.join(os.path.abspath(path), _FILE), map_location="cpu",
                       weights_only=True)
    return plain if like is None else _like(plain, like)
