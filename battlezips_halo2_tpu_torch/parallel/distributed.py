"""Runs over several processes: ``torch.distributed`` brought up from the
configuration, and meshes whose shards are the processes.

Process topology comes from the configuration (config.py):

    BZ_COORDINATOR  host:port of rank 0 (default 127.0.0.1:12807)
    BZ_NUM_PROCS    number of processes (default 1: nothing to bring up)
    BZ_PROC_ID      this process's rank

On cards the processes talk NCCL, rank r on its host's card r mod (the
cards that host sees): the ranks of each host are numbered one after
another, one a card (NCCL refuses two ranks on one card, so a host runs at
most as many ranks as it sees cards). The mesh names the device each rank
took, gathered from the ranks. On the CPU (``device="cpu"``) gloo. The sharded algorithms of parallel/ntt.py
and parallel/msm.py then run unchanged on a mesh of the processes
(:func:`global_mesh`), each rank driving its own shard.
Reference: ``battlezips_halo2_tpu/parallel/distributed.py``.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..config import config
from .collectives import AXIS, Mesh, mesh_from_devices


def initialize(coordinator: str | None = None, num_processes: int | None = None, process_id: int | None = None,
               device=None) -> None:
    """Bring up the process group (idempotent). The arguments default from
    BZ_COORDINATOR / BZ_NUM_PROCS / BZ_PROC_ID; one process is a no-op, so
    library code can call this unconditionally. ``device``: None for the
    cards (NCCL, and rank r makes its host's card r mod (visible cards) its
    current card), "cpu" for gloo."""
    if dist.is_initialized():
        return
    cfg = config()
    num_processes = num_processes or cfg.procs
    if num_processes <= 1:
        return
    coordinator = coordinator or cfg.coordinator
    rank = process_id if process_id is not None else cfg.proc_id
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        cards = torch.cuda.device_count()
        if not cards:
            raise RuntimeError(f"rank {rank} sees no card (NCCL takes one card a rank); pass device='cpu' for gloo")
        torch.cuda.set_device(rank % cards)
    dist.init_process_group("gloo" if cpu else "nccl", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=rank)


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def _rank_devices() -> list[torch.device]:
    """Every rank's device, in rank order, as each rank took it (a device
    of another host may bear the same name as one of this host's)."""
    mine = f"cuda:{torch.cuda.current_device()}" if dist.get_backend() == "nccl" else "cpu"
    names = [None] * dist.get_world_size()
    dist.all_gather_object(names, mine)
    return [torch.device(name) for name in names]


def global_mesh(axis: str = AXIS) -> Mesh:
    """A 1-D mesh with one shard a process, in rank order (one process: a
    mesh over this process's cards). Collective: every rank calls it."""
    if not is_multiprocess():
        return mesh_from_devices(axis=axis)
    return Mesh(_rank_devices(), (axis,), group=dist.group.WORLD)


def global_mesh_2d(dp: int, axis_names: tuple = ("dp", "tp")) -> Mesh:
    """A (dp, tp) mesh with one shard a process, tp the faster axis.
    Collective across processes, as :func:`global_mesh`."""
    devices = _rank_devices() if is_multiprocess() else mesh_from_devices().devices
    if len(devices) % dp:
        raise ValueError(f"{len(devices)} devices are not divisible by dp = {dp}")
    group = dist.group.WORLD if is_multiprocess() else None
    return Mesh(devices, axis_names, shape=(dp, len(devices) // dp), group=group)


def host_local_slice(global_len: int) -> slice:
    """The [start, stop) range of a length-global_len axis that this
    process owns under contiguous rank-major sharding."""
    world, rank = (dist.get_world_size(), dist.get_rank()) if is_multiprocess() else (1, 0)
    per = global_len // world
    return slice(per * rank, per * (rank + 1))
