"""The parallel layer's one place where data moves between shards.

A :class:`Mesh` is a list of torch devices, one per shard; several shards
may share a device (two shards on one card run every kernel at shard
shapes and every collective as a copy on that card). A mesh may also hold
a ``torch.distributed`` process group: then each rank drives one shard, the
one at its rank, and the device list names every rank's device.

The sharded algorithms (parallel/ntt.py, parallel/msm.py) are written once,
against the collectives below, on a list with one tensor per shard this
process drives (:meth:`Mesh.local`):

* in one process, data moves as device-to-device copies
  (``tensor.to(device, non_blocking=True)``; PyTorch orders a copy between
  two cards after the work queued on both cards' current streams, the
  streams the kernels launch on, ops/cuda.py::launch);
* over a process group, as ``all_gather_into_tensor``,
  ``all_to_all_single`` and ``all_reduce``: NCCL between cards, gloo on
  the CPU.

This stands for the reference's ``jax.lax`` collectives inside
``shard_map`` (``battlezips_halo2_tpu/parallel/collectives.py``); with one
shard there is nothing to move.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

AXIS = "shard"  # canonical 1-D mesh axis name


class Mesh:
    """Shards over torch devices, named by ``axis_names`` with sizes
    ``shape`` (default: one axis over every device). ``group``: a
    ``torch.distributed`` process group whose rank r drives shard r."""

    def __init__(self, devices, axis_names: tuple = (AXIS,), shape: tuple | None = None, group=None):
        self.devices = [torch.device(d) for d in devices]
        self.axis_names = tuple(axis_names)
        sizes = tuple(shape) if shape is not None else (len(self.devices),)
        if len(sizes) != len(self.axis_names) or math.prod(sizes) != len(self.devices) or not self.devices:
            raise ValueError(f"a mesh of shape {sizes} over axes {self.axis_names} needs {math.prod(sizes)} "
                             f"devices, got {len(self.devices)}")
        self.shape = dict(zip(self.axis_names, sizes))
        self.group = group
        if group is not None and dist.get_world_size(group) != len(self.devices):
            raise ValueError(f"{len(self.devices)} shards over a process group of {dist.get_world_size(group)}")
        self.rank = dist.get_rank(group) if group is not None else None
        self.cache: dict = {}  # per-mesh tables of the sharded algorithms (twiddles, scale vectors)
        self.unsharded: dict = {}  # transform size -> calls that the NTT's shape gate refused

    @property
    def size(self) -> int:
        return len(self.devices)

    def local(self) -> list[int]:
        """The shards this process drives: all of them, or its rank's."""
        return list(range(self.size)) if self.group is None else [self.rank]

    def local_devices(self) -> list[torch.device]:
        return [self.devices[i] for i in self.local()]

    @property
    def key(self) -> tuple:
        """Devices and local shards: two meshes with the same key hold the
        same shards, so tables cut for one serve the other."""
        return tuple(str(d) for d in self.devices), tuple(self.local())

    def require_axis(self, axis: str = AXIS) -> None:
        """Raise ValueError unless the mesh is 1-D over ``axis``, the axis
        the sharded MSM and NTT run over, as the reference's shard_map does
        for a mesh without it."""
        if self.axis_names != (axis,):
            raise ValueError(f"the sharded MSM and NTT shard over the mesh axis {axis!r}, "
                             f"but this mesh has the axes {self.axis_names} (shape {self.shape})")

    def __repr__(self) -> str:
        where = ", ".join(str(d) for d in self.devices)
        group = f", process group rank {self.rank}" if self.group is not None else ""
        return f"Mesh({self.shape}: {where}{group})"


def cuda_devices() -> list[torch.device]:
    """Every visible CUDA card."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def mesh_from_devices(devices=None, axis: str = AXIS) -> Mesh:
    """A 1-D mesh over ``devices`` (default: every visible CUDA card)."""
    devices = list(devices) if devices is not None else cuda_devices()
    if not devices:
        raise RuntimeError("no CUDA device is visible; name the mesh's devices (e.g. ['cpu'] * 4)")
    return Mesh(devices, (axis,))


def default_mesh(n: int | None = None) -> Mesh:
    """A 1-D mesh over the first n (default: all) CUDA cards; raises when
    fewer are visible."""
    cards = cuda_devices()
    if n is not None:
        if len(cards) < n:
            raise RuntimeError(f"need {n} CUDA devices, have {len(cards)}")
        cards = cards[:n]
    return mesh_from_devices(cards)


def shard(mesh: Mesh, t: torch.Tensor, dim: int) -> list[torch.Tensor]:
    """The local shards of ``t`` cut into mesh.size equal contiguous pieces
    along ``dim``, each on its shard's device."""
    if t.shape[dim] % mesh.size:
        raise ValueError(f"dim {dim} of {tuple(t.shape)} does not split into {mesh.size} shards")
    pieces = t.chunk(mesh.size, dim)
    return [pieces[i].to(mesh.devices[i], non_blocking=True).contiguous() for i in mesh.local()]


def unshard(mesh: Mesh, xs: list[torch.Tensor], dim: int, device) -> torch.Tensor:
    """The whole tensor of the shards ``xs`` (one per local shard), joined
    along ``dim`` on ``device``."""
    if mesh.group is not None:
        xs = list(all_gather(mesh, xs)[0].to(device))
    return torch.cat([x.to(device, non_blocking=True) for x in xs], dim)


def all_to_all(mesh: Mesh, xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """xs: one (D, ...) tensor per local shard, whose slice j goes to shard
    j -> one (D, ...) tensor per local shard, whose slice i came from shard
    i."""
    if mesh.group is not None:
        (x,) = xs
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=mesh.group)
        return [out]
    return [torch.stack([x[j].to(mesh.devices[j], non_blocking=True) for x in xs]) for j in mesh.local()]


def all_gather(mesh: Mesh, xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """xs: one tensor per local shard -> per local shard, the (D, ...)
    stack of every shard's tensor on that shard's device."""
    if mesh.group is not None:
        (x,) = xs
        x = x.contiguous().view((1,) + tuple(x.shape))
        out = torch.empty((mesh.size,) + tuple(x.shape[1:]), dtype=x.dtype, device=x.device)
        dist.all_gather_into_tensor(out, x, group=mesh.group)
        return [out]
    return [torch.stack([x.to(mesh.devices[j], non_blocking=True) for x in xs]) for j in mesh.local()]


def psum(mesh: Mesh, xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """xs: one tensor per local shard -> per local shard, the elementwise
    sum over every shard."""
    if mesh.group is not None:
        (x,) = xs
        out = x.clone()
        dist.all_reduce(out, group=mesh.group)
        return [out]
    return [sum(x.to(mesh.devices[j], non_blocking=True) for x in xs) for j in mesh.local()]
