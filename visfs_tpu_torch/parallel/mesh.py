"""Device groups for the sharded solvers (torch port of
visfs_tpu.parallel.mesh).

The reference shards over a 1-D ``jax.sharding.Mesh`` axis with shard_map
and reduces with ``psum``.  Here a ``Mesh`` is a ``torch.distributed``
process group (``None``: this process alone) and the name of the axis it
shards; each rank holds one shard and a psum is one
``all_reduce(SUM)``.  The group is gloo on the CPU and NCCL on the card;
nothing here starts a process: the caller brings the group up
(``initialize_multihost`` or ``torch.distributed.init_process_group``).
"""

from __future__ import annotations

import dataclasses
import os
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D axis of ranks: ``group`` None is this process alone."""

    group: Optional[dist.ProcessGroup] = None
    axis: str = "edges"

    @property
    def size(self) -> int:
        return 1 if self.group is None else dist.get_world_size(self.group)


def psum(x, group: Optional[dist.ProcessGroup]):
    """Sum ``x`` over the group's ranks in place (a no-op for None)."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def all_gather(x, group: Optional[dist.ProcessGroup]):
    """The ranks' shards of ``x`` concatenated along axis 0 in rank
    order (``x`` itself for None)."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def gather_stacked(tensors, group: Optional[dist.ProcessGroup]) -> list:
    """Each of ``tensors`` from every rank, stacked on a new axis 0 in rank
    order ([1, ...] for None), in one all_gather: the tensors travel packed
    into float64, which holds their float32, int32 and bool values
    exactly."""
    flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
    if group is None:
        rows = flat[None]
    else:
        parts = [torch.empty_like(flat)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, flat, group=group)
        rows = torch.stack(parts)
    out, at = [], 0
    for t in tensors:
        n = t.numel()
        out.append(rows[:, at:at + n].reshape(
            (rows.shape[0],) + tuple(t.shape)).to(t.dtype))
        at += n
    return out


def shard(x, group: Optional[dist.ProcessGroup], axis: int = 0):
    """This rank's contiguous block of ``x`` along ``axis``, as shard_map
    splits an axis (its size must divide evenly: ``pad_to_devices``)."""
    if group is None:
        return x
    size, n = dist.get_world_size(group), x.shape[axis]
    if n % size:
        raise ValueError(f"an axis of {n} does not split over {size} "
                         "ranks; pad_to_devices first")
    return x.narrow(axis, dist.get_rank(group) * (n // size), n // size)


def initialize_multihost(init_method: Optional[str] = None,
                         world_size: Optional[int] = None,
                         rank: Optional[int] = None,
                         backend: Optional[str] = None,
                         timeout_s: float = 300.0,
                         device_id: Optional[torch.device] = None) -> bool:
    """torch.distributed bring-up of the default process group.

    Returns True when the group is live after the call, including when it
    already was.  The one False return is an argless call that finds no
    cluster in the environment (MASTER_ADDR, MASTER_PORT, WORLD_SIZE and
    RANK, as torchrun sets them): a plain single-process run.  With
    EXPLICIT arguments a bad value or a failed bring-up raises instead of
    degrading to a single process (two ranks that quietly became two
    one-rank runs would diverge without an error).  ``backend`` defaults to
    NCCL when CUDA is available, else gloo.  ``device_id`` (this rank's
    card) binds the NCCL communicator to it at bring-up, so the first
    collective finds it made for the right device."""
    if dist.is_initialized():
        return True
    explicit = any(v is not None for v in (init_method, world_size, rank))
    if not explicit:
        env = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")
        if not all(k in os.environ for k in env):
            return False
        init_method = "env://"
    else:
        if init_method is None or world_size is None or rank is None:
            raise ValueError("initialize_multihost: an explicit bring-up "
                             "needs init_method, world_size and rank")
        if not init_method.startswith(("tcp://", "file://", "env://")):
            raise ValueError(f"initialize_multihost: init_method "
                             f"{init_method!r} is not tcp://, file:// or "
                             "env://")
        if int(world_size) < 1 or not 0 <= int(rank) < int(world_size):
            raise ValueError(f"initialize_multihost: rank {rank} is not in "
                             f"a world of {world_size}")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    kw = {} if not explicit else dict(world_size=int(world_size),
                                      rank=int(rank))
    if device_id is not None:
        kw["device_id"] = torch.device(device_id)
    try:
        dist.init_process_group(backend, init_method=init_method,
                                timeout=timedelta(seconds=timeout_s), **kw)
    except (RuntimeError, ValueError):
        if explicit:
            raise
        return False
    return True


def edge_mesh(group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """The constraint-edge axis of the pose-graph solve."""
    return Mesh(group, "edges")


def landmark_mesh(group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """The landmark axis of the distributed Schur BA."""
    return Mesh(group, "lm")


def fleet_mesh(group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """The data-parallel axis: one VO stream per rank (``slam.fleet.
    dp_fleet_step``, ``slam.multi_robot.FleetMapping``)."""
    return Mesh(group, "dp")


def pad_to_devices(x, mesh: Optional[Mesh], axis: int = 0, fill=0):
    """Pad ``axis`` of x to a multiple of the mesh's ranks (a shard each)."""
    n = 1 if mesh is None else mesh.size
    rem = (-x.shape[axis]) % n
    if rem == 0:
        return x
    shape = list(x.shape)
    shape[axis] = rem
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype,
                                    device=x.device)], dim=axis)
