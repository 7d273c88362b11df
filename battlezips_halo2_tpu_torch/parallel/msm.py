"""The MSM over a mesh: the point table partitioned over the shards, the
partial sums folded.

Each shard runs the whole local Pippenger pipeline of ops/msm.py
(``msm_wsums(..., complete=True)``: kernel K7's complete bucket pass and
K3's window kernel, or K7 and K6 under BZ_ROW_MSM) on its contiguous slice
of the points and scalars. The D window-sum partials are all-gathered to
the first local shard's device and folded there left to right, in one
launch of the lane-wise K3 (``curves/limb.py::point_fold``: each (MSM,
window) lane's D - 1 complete additions in one thread);
the host then converts the window sums to affine and folds the windows.
Moving one point per window and MSM is all the communication.

The mesh takes the complete law, as the reference does
(``battlezips_halo2_tpu/parallel/msm.py``): no collision flag, no redo. A
table is padded to ``max(64 D, next power of two)`` rows with the
generator, whose scalars are 0; a shard whose buckets are all empty
gives the identity, which the complete fold passes through.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..curves import limb as C
from ..curves.host import Curve
from ..fields import limb as L
from ..fields.limb import FieldSpec, ints_to_limbs
from ..ops.msm import auto_window, host_window_fold, msm_wsums
from .collectives import Mesh, all_gather, shard


@dataclass
class ShardedTable:
    """An affine point table cut over a mesh: ``shards`` the local
    (target / D, 2, 8) Montgomery tables, ``points`` the rows before
    padding, ``target`` after; ``c`` and ``signed`` the digits of the
    window chosen for the shard size."""

    shards: list
    points: int
    target: int
    c: int
    signed: bool


def shard_table(curve: Curve, table: torch.Tensor, mesh: Mesh, c: int | None = None,
                signed: bool | None = None) -> ShardedTable:
    """Cut an (N, 2, 8) affine table (curves/limb.py::affine_table) over
    the mesh, padded to target = max(64 D, next power of two of N) rows with
    the generator. The window is auto_window(target / D) unless ``c`` (and
    ``signed``, default unsigned) is given."""
    mesh.require_axis()
    d, n0 = mesh.size, table.shape[0]
    target = max(64 * d, 1 << (n0 - 1).bit_length())
    if target % d:
        target *= 2
    if c is None:
        c, auto_signed = auto_window(target // d)
        signed = auto_signed if signed is None else signed
    spec = FieldSpec.make(curve.base.modulus)
    pad = C.affine_table(spec, [curve.generator] * (target - n0), table.device)
    return ShardedTable(shard(mesh, torch.cat([table, pad]), 0), n0, target, c, bool(signed))


def sharded_msm_many_table(curve: Curve, sharded: ShardedTable, scalars: torch.Tensor, mesh: Mesh) -> list:
    """B MSMs over a sharded table: scalars (B, N, 8) canonical limbs (N =
    sharded.points, on any device) -> B affine points, replicated on every
    rank of a process group."""
    spec = FieldSpec.make(curve.base.modulus)
    b = scalars.shape[0]
    if scalars.shape[1:] != (sharded.points, L.NLIMBS):
        raise ValueError(f"expected ({b}, {sharded.points}, 8) scalars, got {tuple(scalars.shape)}")
    padded = torch.zeros(b, sharded.target, L.NLIMBS, dtype=torch.int32, device=scalars.device)
    padded[:, : sharded.points] = scalars
    partials = [
        msm_wsums(spec, table, part, sharded.c, sharded.signed, complete=True)[0]
        for table, part in zip(sharded.shards, shard(mesh, padded, 1))
    ]  # per shard (B, W, 3, 8) Jacobian window sums
    acc = C.point_fold(spec, all_gather(mesh, partials)[0])  # (D, B, W, 3, 8) -> (B, W, 3, 8)
    w = acc.shape[1]
    aff = C.jacobian_to_affine(spec, acc)
    return [host_window_fold(curve, aff[i * w : (i + 1) * w], sharded.c) for i in range(b)]


def _table(curve: Curve, points, mesh: Mesh) -> torch.Tensor:
    return C.affine_table(FieldSpec.make(curve.base.modulus), points, mesh.local_devices()[0])


def sharded_msm(curve: Curve, points, scalars, mesh: Mesh, c: int | None = None, signed: bool | None = None):
    """One MSM over the mesh: affine points (None = identity) x int scalars
    -> the affine result. The window is picked from the shard size unless
    ``c`` is given; ``signed`` picks the digits (with ``c``: default
    unsigned)."""
    if len(points) != len(scalars):
        raise ValueError(f"{len(points)} points but {len(scalars)} scalars")
    return sharded_msm_many(curve, points, [scalars], mesh, c, signed)[0]


def sharded_msm_many(curve: Curve, points, scalars_list, mesh: Mesh, c: int | None = None,
                     signed: bool | None = None) -> list:
    """Many MSMs over one list of affine points, over the mesh (the
    reference's sharded_msm_many, the backend of ``pcs/ipa.py``'s
    commitments under an active mesh) -> the affine results."""
    if not scalars_list:
        return []
    sharded = shard_table(curve, _table(curve, points, mesh), mesh, c, signed)
    m = curve.scalar.modulus
    flat = [s % m for sc in scalars_list for s in sc]
    scalars = ints_to_limbs(flat, mesh.local_devices()[0]).reshape(len(scalars_list), len(points), L.NLIMBS)
    return sharded_msm_many_table(curve, sharded, scalars, mesh)
