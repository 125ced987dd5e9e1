"""Meshes of ranks and Monte-Carlo studies over them (counterpart of
:mod:`ssmtoybox_tpu.parallel.mesh`).

The JAX package lays devices out on a ``jax.sharding.Mesh`` and lets XLA
insert the collectives.  Here a :class:`Mesh` is a grid of the ranks of a
``torch.distributed`` process group with named axes, and every collective is
one of its two methods, :meth:`Mesh.all_gather` and :meth:`Mesh.all_reduce`.
One code path serves three setups:

* one process a card, the default group (``init_process_group`` with NCCL on
  cards, gloo on the CPU, ``init_method="tcp://localhost:<port>"``);
* a gloo group built directly (``torch.distributed.ProcessGroupGloo`` over a
  store), e.g. several ranks as threads of one process
  (:func:`thread_ranks`), sharing one card or the CPU;
* a world of one rank, no group at all, where the collectives return their
  input.

Axes of the study meshes: ``dp`` splits the Monte-Carlo trajectories (they
are independent: the filters exchange nothing a step), ``fb`` the members
of a filter bank.  Every helper takes the whole batch on every rank, filters
this rank's rows and returns the whole result on every rank: one
``all_gather`` a call, which moves the result once.
"""
from __future__ import annotations

import datetime
import math
import socket
import threading
import time
from dataclasses import dataclass, fields
from typing import Optional, Sequence

import numpy as np
import torch

from ..ssinf import FilterResult, gaussian_filter_batch
from ..utils.arrays import f64, resolve_device

__all__ = ["make_mesh", "make_multihost_mesh", "shard_mc", "shard_mc_local",
           "filter_mc_sharded", "filter_bank_sharded", "mc_metrics_sharded"]


def _default_group():
    """The default process group when one is initialised, else None."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


class Mesh:
    """Ranks of a process group on a grid with named axes (counterpart of
    ``jax.sharding.Mesh``).

    ``shape`` maps axis names to sizes in order (``{"dp": 4, "fb": 2}``,
    ``{"t": 4}``); their product must be the group's size.  ``group`` is a
    process group (the default group, or a backend such as
    ``ProcessGroupGloo`` built directly); None takes the default group when
    one is initialised, else the mesh is a world of one rank.  ``grid``
    places the group's ranks on the axes (row-major ``arange`` by default);
    ``device`` is this rank's (the port's default device by default).

    ``stats`` counts the collectives of this rank: calls, the bytes this rank
    contributed, and the bytes staged through the host (a gloo group given
    CUDA tensors copies them to the host and back).
    """

    def __init__(self, shape: dict, group=None, device=None, grid=None):
        self.group = _default_group() if group is None else group
        self.rank = 0 if self.group is None else self.group.rank()
        self.size = 1 if self.group is None else self.group.size()
        sizes = tuple(int(s) for s in shape.values())
        if math.prod(sizes) != self.size:
            raise ValueError(
                f"mesh shape {dict(shape)} covers {math.prod(sizes)} ranks; the process group "
                f"has {self.size}: every rank of the group takes part in the collectives")
        self.axis_names = tuple(shape)
        self.grid = (np.arange(self.size) if grid is None else np.asarray(grid)).reshape(sizes)
        self.coords = dict(zip(self.axis_names, (int(i) for i in
                                                 np.argwhere(self.grid == self.rank)[0])))
        self.device = resolve_device(device)
        self.backend = None if self.group is None else self.group.name()
        self.stats = {"all_gather": 0, "all_reduce": 0, "bytes": 0, "host_bytes": 0}

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.grid.shape))

    def __repr__(self):
        where = ("a world of one rank, no process group" if self.group is None
                 else f"rank {self.rank} of {self.size} ({self.backend})")
        return f"Mesh({self.shape}, {where}, coordinates {self.coords}, device {self.device})"

    def _staged(self, t: torch.Tensor):
        """``t`` as the group's backend takes it: a CUDA tensor goes through
        the host for gloo."""
        if self.backend == "gloo" and t.device.type != "cpu":
            self.stats["host_bytes"] += t.numel() * t.element_size()
            return t.cpu()
        return t

    def all_gather(self, tensors: Sequence[torch.Tensor]):
        """Every rank's ``tensors`` (the same shapes and one dtype on every
        rank), each with a new leading axis over the ranks in rank order;
        one collective for all of them."""
        tensors = tuple(tensors)
        if len({t.dtype for t in tensors}) != 1:
            raise ValueError("Mesh.all_gather: the tensors must share one dtype; got "
                             f"{sorted(str(t.dtype) for t in tensors)}")
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self.stats["all_gather"] += 1
        self.stats["bytes"] += flat.numel() * flat.element_size()
        if self.group is None:
            rows = flat[None]
        else:
            send = self._staged(flat)
            outs = [torch.empty_like(send) for _ in range(self.size)]
            self.group.allgather([outs], [send]).wait()
            rows = torch.stack(outs)
            if rows.device != flat.device:
                self.stats["host_bytes"] += rows.numel() * rows.element_size()
                rows = rows.to(flat.device)
        out, start = [], 0
        for t in tensors:
            out.append(rows[:, start:start + t.numel()].reshape((self.size,) + t.shape))
            start += t.numel()
        return tuple(out)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (a new tensor); one collective."""
        self.stats["all_reduce"] += 1
        self.stats["bytes"] += t.numel() * t.element_size()
        if self.group is None:
            return t.clone()
        buf = self._staged(t).clone()
        self.group.allreduce([buf]).wait()
        if buf.device != t.device:
            self.stats["host_bytes"] += buf.numel() * buf.element_size()
            buf = buf.to(t.device)
        return buf

    def ranks_along(self, axis: str) -> np.ndarray:
        """The ranks that share this rank's other coordinates, in the order
        of ``axis``."""
        at = tuple(slice(None) if a == axis else self.coords[a] for a in self.axis_names)
        return self.grid[at]

    def gather_along(self, axis: str, tensors: Sequence[torch.Tensor]):
        """:meth:`all_gather`, keeping the ranks along ``axis`` that share
        this rank's other coordinates, in axis order."""
        idx = torch.as_tensor(self.ranks_along(axis))
        return tuple(g[idx.to(g.device)] for g in self.all_gather(tensors))

    def gather_grid(self, tensors: Sequence[torch.Tensor]):
        """:meth:`all_gather` with the rank axis laid out as the grid, one
        leading axis a mesh axis."""
        idx = torch.as_tensor(self.grid.reshape(-1))
        return tuple(g[idx.to(g.device)].reshape(self.grid.shape + g.shape[1:])
                     for g in self.all_gather(tensors))


def thread_ranks(fn, size: int, timeout: float = 300.0):
    """Run ``fn(group)`` on ``size`` threads of this process, one rank each,
    each with its own gloo group (``torch.distributed.ProcessGroupGloo``)
    over one in-memory ``HashStore``; returns the results in rank order.

    Raises the exception of the rank that failed first (a rank left waiting
    in a collective fails at the groups' ``timeout``), or ``TimeoutError``
    when a thread has not ended ``timeout`` seconds after the start.
    """
    dist = torch.distributed
    store = dist.HashStore()
    wait = datetime.timedelta(seconds=timeout)
    results, errors = [None] * size, []

    def run(rank):
        try:
            results[rank] = fn(dist.ProcessGroupGloo(dist.PrefixStore("ranks", store), rank,
                                                     size, wait))
        except Exception as e:  # noqa: BLE001 - raised again in the caller
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,), daemon=True) for r in range(size)]
    deadline = time.monotonic() + timeout
    for t in threads:
        t.start()
    for t in threads:
        t.join(max(deadline - time.monotonic(), 0.0))
    if errors:
        raise errors[0]
    late = [r for r, t in enumerate(threads) if t.is_alive()]
    if late:
        raise TimeoutError(f"thread_ranks: ranks {late} of {size} still running after {timeout} s")
    return results


def _resolve(group):
    group = _default_group() if group is None else group
    return group, (1 if group is None else group.size()), (0 if group is None else group.rank())


def make_mesh(dp: Optional[int] = None, fb: int = 1, devices: Optional[Sequence] = None,
              group=None) -> Mesh:
    """A (dp, fb) mesh of the group's ranks.

    ``devices`` lists a device for each rank of the group in rank order (each
    rank's own by default); ``dp`` defaults to ``len(devices) // fb``.  The
    mesh must take every rank of the group, and is a world of one rank when
    there is no group.
    """
    group, size, rank = _resolve(group)
    devices = [None] * size if devices is None else list(devices)
    if dp is None:
        dp = len(devices) // fb
    if dp <= 0 or fb <= 0 or dp * fb > len(devices):
        raise ValueError(
            f"mesh shape (dp={dp}, fb={fb}) needs {max(dp * fb, 1)} devices; "
            f"{len(devices)} available — a degenerate mesh would only fail "
            f"later with an opaque sharding error")
    return Mesh({"dp": dp, "fb": fb}, group, devices[rank] if rank < len(devices) else None)


def multihost_layout(hosts: Sequence, fb: int = 1, process_shape=None) -> np.ndarray:
    """The (dp, fb) grid of ranks laid out host-major: ``hosts[r]`` names
    the host of rank ``r``; each host's ranks fill ``per_host // fb``
    consecutive ``dp`` rows, so that an ``fb`` slice never leaves its host.
    ``process_shape=(num_hosts, per_host)`` groups the ranks in consecutive
    blocks instead (a virtual topology)."""
    n = len(hosts)
    if process_shape is not None:
        num_hosts, per_host = process_shape
        if num_hosts * per_host != n:
            raise ValueError(f"process_shape {process_shape} does not tile the {n} available "
                             "devices")
        groups = [list(range(i * per_host, (i + 1) * per_host)) for i in range(num_hosts)]
    else:
        by_host: dict = {}
        for r, h in enumerate(hosts):
            by_host.setdefault(h, []).append(r)
        groups = list(by_host.values())
        sizes = {len(g) for g in groups}
        if len(sizes) != 1:
            raise ValueError(f"hosts contribute unequal device counts {sorted(sizes)}; a "
                             "rectangular (dp, fb) mesh needs homogeneous hosts")
        per_host = len(groups[0])
    if fb < 1 or per_host % fb:
        raise ValueError(
            f"fb={fb} must divide the per-host device count {per_host}: an fb slice "
            "straddling hosts would put bank-weight broadcasts on the network between hosts")
    return np.concatenate([np.asarray(g).reshape(per_host // fb, fb) for g in groups], axis=0)


def _hosts(mesh_probe: Mesh):
    """Each rank's host name, gathered over the group (one collective)."""
    name = socket.gethostname().encode()[:64].ljust(64, b"\0")
    mine = torch.frombuffer(bytearray(name), dtype=torch.uint8).to(mesh_probe.device)
    (rows,) = mesh_probe.all_gather([mine])
    return [bytes(r.cpu().tolist()).rstrip(b"\0").decode() for r in rows]


def make_multihost_mesh(fb: int = 1, devices: Optional[Sequence] = None, process_shape=None,
                        group=None) -> Mesh:
    """A (dp, fb) mesh over every rank of the group laid out host-major by
    :func:`multihost_layout`: ``fb`` slices stay within a host, ``dp`` rows
    are host-local blocks.  The hosts come from the ranks' host names (one
    gather) unless ``process_shape`` lays out a virtual topology."""
    group, size, rank = _resolve(group)
    devices = [None] * size if devices is None else list(devices)
    device = devices[rank] if rank < len(devices) else None
    if process_shape is None and size > 1:
        hosts = _hosts(Mesh({"all": size}, group, device))
    else:
        hosts = [0] * len(devices)
    grid = multihost_layout(hosts, fb, process_shape)
    return Mesh({"dp": grid.shape[0], "fb": fb}, group, device, grid=grid)


@dataclass
class LocalShard:
    """This rank's rows of a batch whose trajectories are split over the
    ``dp`` axis of ``mesh``: the study helpers filter them as they are.  A
    plain tensor cannot say that it holds one rank's rows only, so
    :func:`shard_mc` and :func:`shard_mc_local` wrap them in this."""

    rows: torch.Tensor
    mesh: Mesh


def _dp_slice(mesh: Mesh, m: int):
    """This rank's rows ``[start, stop)`` of ``m`` split evenly over ``dp``."""
    per = m // mesh.shape["dp"]
    start = mesh.coords["dp"] * per
    return start, start + per


def shard_mc(data_batch, mesh: Mesh) -> LocalShard:
    """This rank's rows of a whole (M, ...) batch with the MC axis split over
    ``dp``; ``M`` must divide by ``dp`` (the study helpers pad for you)."""
    data_batch = torch.as_tensor(data_batch, device=mesh.device)
    dp = mesh.shape["dp"]
    if data_batch.shape[0] % dp:
        raise ValueError(
            f"MC axis of size {data_batch.shape[0]} is not divisible by dp={dp}; "
            f"pad the batch (see filter_mc_sharded, which does this for you) or "
            f"pick a compatible mesh")
    start, stop = _dp_slice(mesh, data_batch.shape[0])
    return LocalShard(data_batch[start:stop], mesh)


def shard_mc_local(local_batch, mesh: Mesh) -> LocalShard:
    """This rank's own trajectories (M / dp, ...), simulated or loaded by
    it, marked as its rows of the study; every rank passes as many."""
    return LocalShard(torch.as_tensor(local_batch, device=mesh.device), mesh)


def _pad_mc(data_batch: torch.Tensor, dp: int):
    """The MC axis padded up to a multiple of ``dp`` by repeating the last
    row; returns ``(padded, original_size)``."""
    m = data_batch.shape[0]
    pad = (-m) % dp
    if pad:
        data_batch = torch.cat([data_batch, data_batch[-1:].expand((pad,) + data_batch.shape[1:])])
    return data_batch, m


def _local_rows(data_batch, mesh: Mesh):
    """``(this rank's rows, the study's size)``: a :class:`LocalShard` as it
    is (every rank must hold as many rows), else the rank's rows of the
    padded batch."""
    if isinstance(data_batch, LocalShard):
        if data_batch.mesh is not mesh:
            raise ValueError("the batch was sharded over another mesh")
        rows = f64(data_batch.rows)
        (counts,) = mesh.all_gather([torch.tensor([rows.shape[0]], device=mesh.device)])
        if len(set(counts.reshape(-1).tolist())) != 1:
            raise ValueError(f"pre-sharded batch: the ranks hold {counts.reshape(-1).tolist()} "
                             "trajectories; pad per rank before shard_mc_local")
        return rows, None
    data, m = _pad_mc(f64(data_batch, mesh.device), mesh.shape["dp"])
    start, stop = _dp_slice(mesh, data.shape[0])
    return data[start:stop], m


def filter_mc_sharded(mod_dyn, mod_obs, tf_dyn, tf_obs, data_batch, mesh: Mesh) -> FilterResult:
    """Forward-filter an (M, dim_y, N) batch with the trajectories split over
    the mesh's ``dp`` axis (``gaussian_filter_batch``, its default engine).

    ``M`` that ``dp`` does not divide is padded by repeating the last
    trajectory and trimmed on return.  A :class:`LocalShard` is filtered as
    it is.  The whole result is on every rank (one ``all_gather``).
    """
    rows, m = _local_rows(data_batch, mesh)
    out = gaussian_filter_batch(mod_dyn, mod_obs, tf_dyn, tf_obs, rows)
    names = [f.name for f in fields(out)]
    parts = mesh.gather_along("dp", [getattr(out, k) for k in names])
    whole = {k: p.reshape((-1,) + p.shape[2:])[:m] for k, p in zip(names, parts)}
    return FilterResult(**whole)


def filter_bank_sharded(mod_dyn, mod_obs, tf_dyn_bank: Sequence, tf_obs_bank: Sequence,
                        data_batch, mesh: Mesh) -> FilterResult:
    """Run a bank of K filters over an MC batch on the (dp, fb) mesh.

    The port's transforms are objects, not stacked arrays: ``tf_dyn_bank``
    and ``tf_obs_bank`` are sequences of K transforms, member ``k`` pairing
    their ``k``-th.  ``fb`` splits the members (K that ``fb`` does not divide
    is padded with the last member), ``dp`` the trajectories, as in
    :func:`filter_mc_sharded`.  Returns (K, M, ...) moments, the whole result
    on every rank (one ``all_gather``).
    """
    bank = list(zip(tf_dyn_bank, tf_obs_bank))
    k, n_fb = len(bank), mesh.shape["fb"]
    if k == 0 or len(tf_dyn_bank) != len(tf_obs_bank):
        raise ValueError(f"the banks must hold as many transforms, at least one; got "
                         f"{len(tf_dyn_bank)} and {len(tf_obs_bank)}")
    bank += bank[-1:] * ((-k) % n_fb)
    per = len(bank) // n_fb
    mine = bank[mesh.coords["fb"] * per:(mesh.coords["fb"] + 1) * per]
    rows, m = _local_rows(data_batch, mesh)
    outs = [gaussian_filter_batch(mod_dyn, mod_obs, td, to, rows) for td, to in mine]
    names = [f.name for f in fields(outs[0])]
    parts = mesh.gather_grid([torch.stack([getattr(o, n) for o in outs]) for n in names])
    whole = {}
    for name, p in zip(names, parts):
        # (dp, fb, per, m_local, ...) -> (fb * per, dp * m_local, ...)
        p = p.permute((1, 2, 0, 3) + tuple(range(4, p.ndim)))
        whole[name] = p.reshape((len(bank), -1) + p.shape[4:])[:k, :m]
    return FilterResult(**whole)


def mc_metrics_sharded(x_true, result: FilterResult, mesh: Mesh) -> torch.Tensor:
    """The study RMSE, the mean over runs of each run's time-averaged RMSE:
    each rank sums its ``dp`` rows' RMSEs, one ``all_reduce`` adds the sums
    and counts.

    ``x_true`` is (M, D, N) (or a :class:`LocalShard` of this rank's rows)
    and ``result.fi_mean`` (M, D, N); bank results (K, M, D, N) are refused.
    """
    fm = result.fi_mean
    if isinstance(x_true, LocalShard):
        xt = f64(x_true.rows)
        per = xt.shape[0]
        start = mesh.coords["dp"] * per
        shape_ok = fm.ndim == 3 and fm.shape[0] == per * mesh.shape["dp"]
        fm_rows = fm[start:start + per]
    else:
        xt = f64(x_true, fm.device)
        shape_ok = tuple(xt.shape) == tuple(fm.shape)
        per = -(-xt.shape[0] // mesh.shape["dp"])
        start = mesh.coords["dp"] * per
        xt, fm_rows = xt[start:start + per], fm[start:start + per]
    if not shape_ok or xt.shape[1:] != fm_rows.shape[1:]:
        raise ValueError(
            f"x_true {tuple(xt.shape)} and fi_mean {tuple(fm.shape)} must match; "
            f"for filter_bank_sharded output compute metrics per bank member")
    run_rmse = torch.sqrt(torch.mean(torch.sum((xt - fm_rows) ** 2, dim=1), dim=1))
    mine = torch.stack([run_rmse.sum(), fm.new_tensor(float(run_rmse.shape[0]))])
    if mesh.coords.get("fb", 0):
        mine = torch.zeros_like(mine)          # fb replicas hold the same rows
    total = mesh.all_reduce(mine)
    return total[0] / total[1]
