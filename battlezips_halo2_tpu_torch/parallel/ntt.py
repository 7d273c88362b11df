"""The 4-step (Bailey) NTT over a mesh, with three all-to-alls.

A length-n vector is sharded contiguously over D shards as a (D x C)
matrix (n = D C; rows j1 = shard, columns j2 local). With j = j1 C + j2 and
k = k1 + k2 D:

    X[k1 + k2 D] = NTT_C over j2 [ w^(j2 k1) * NTT_D over j1 [ a[j1, j2] ] ]

1. all-to-all so each shard owns whole columns, then NTT_D (short);
2. twiddle by w^(j2 k1) and all-to-all back, then NTT_C (the long one);
3. all-to-all from CRT order (k1 + k2 D) to natural order.

A shard computes NTT(n / D) + O(n / D) and sends n / D elements three
times. The local NTTs are ``ops/ntt.py::ntt`` (kernel K4, or K5 under
BZ_ROW_NTT) on each shard's device; the twiddle and the scalings are K1's
Montgomery product (``fields/limb.py::mont_mul``). The transposes around
the all-to-alls are torch copies, as the reference leaves them to XLA.
Bit-exact against poly/domain.py::ntt_host and the unsharded transforms of
poly/transforms.py. Reference: ``battlezips_halo2_tpu/parallel/ntt.py``.
"""

from __future__ import annotations

import sys

import torch

from ..fields import limb as L
from ..fields.host import FP
from ..fields.limb import FP_SPEC, ints_to_limbs
from ..ops import ntt as D_ntt
from .collectives import Mesh, all_to_all, shard, unshard

P = FP.modulus


def _twiddle_table(mesh: Mesh, n: int, omega: int) -> list[torch.Tensor]:
    """Per local shard i, the (D, C/D, 8) Montgomery twiddles
    tw[k1, j2] = omega^(j2 k1) for the j2 of its column chunk
    [i C/D, (i + 1) C/D), on its device; built once per (n, omega) and mesh."""
    key = ("twiddles", n, omega)
    if key not in mesh.cache:
        d = mesh.size
        w = n // d // d
        out = []
        for i, dev in zip(mesh.local(), mesh.local_devices()):
            vals = []
            for k1 in range(d):
                step = pow(omega, k1, P)
                acc = pow(step, i * w, P) * FP_SPEC.r_mod_p % P
                for _ in range(w):
                    vals.append(acc)
                    acc = acc * step % P
            out.append(ints_to_limbs(vals, dev).view(d, w, L.NLIMBS))
        mesh.cache[key] = out
    return mesh.cache[key]


def _geom_vector(mesh: Mesh, n: int, g: int, k: int) -> list[torch.Tensor]:
    """Per local shard i, the (C, 8) limbs of v[j] = k g^j for the j of its
    rows [i C, (i + 1) C), on its device (ops/ntt.py::geometric_limbs): the
    operand of a basis transform's scale. Built once per mesh."""
    key = ("geom", n, g, k)
    if key not in mesh.cache:
        c = n // mesh.size
        mesh.cache[key] = [D_ntt.geometric_limbs(P, k * pow(g, i * c, P), g, c, dev)
                           for i, dev in zip(mesh.local(), mesh.local_devices())]
    return mesh.cache[key]


def _plans(mesh: Mesh, n: int, omega: int) -> list[tuple]:
    """Per local shard, the (NTT_D, NTT_C) plans on its device."""
    d, c = mesh.size, n // mesh.size
    return [(D_ntt.plan_for(P, d, pow(omega, c, P), str(dev)), D_ntt.plan_for(P, c, pow(omega, d, P), str(dev)))
            for dev in mesh.local_devices()]


def _four_step(mesh: Mesh, n: int, omega: int, xs: list[torch.Tensor]) -> list[torch.Tensor]:
    """The 4-step NTT of local shards xs, each (B, C, 8) Montgomery rows
    j1 = its shard -> each (B, C, 8), natural-order evaluations k of its
    rows [i C, (i + 1) C)."""
    d = mesh.size
    b, c = xs[0].shape[:2]
    w = c // d
    plans = _plans(mesh, n, omega)
    # 1: all-to-all so each shard owns whole columns, then NTT_D along j1
    ys = all_to_all(mesh, [x.view(b, d, w, L.NLIMBS).movedim(1, 0) for x in xs])  # (D = j1, B, C/D = j2, 8)
    out = []
    for y, (plan_d, _), tw in zip(ys, plans, _twiddle_table(mesh, n, omega)):
        y = D_ntt.ntt(plan_d, y.permute(1, 2, 0, 3)).transpose(1, 2).contiguous()  # (B, D = k1, C/D, 8)
        L.mont_mul(FP_SPEC, y, tw, out=y)  # 2: twiddle w^(j2 k1)
        out.append(y.movedim(1, 0))
    # 2: all-to-all back, so each shard holds a whole row k1, then NTT_C along j2
    zs = all_to_all(mesh, out)  # (D = j2 chunk, B, C/D, 8)
    out = []
    for z, (_, plan_c) in zip(zs, plans):
        z = D_ntt.ntt(plan_c, z.movedim(0, 1).reshape(b, c, L.NLIMBS))  # X[k1 + k2 D], k2 = 0 .. C - 1
        out.append(z.view(b, d, w, L.NLIMBS).movedim(1, 0))
    # 3: all-to-all from CRT order to natural order: shard m holds k in
    # [m C, (m + 1) C), local index k2_local D + k1
    return [v.permute(1, 2, 0, 3).reshape(b, c, L.NLIMBS) for v in all_to_all(mesh, out)]


def distributed_ntt(mesh: Mesh, n: int, omega: int, a_mont: list[torch.Tensor]) -> list[torch.Tensor]:
    """NTT of a Montgomery-form length-n vector over the mesh: ``a_mont``
    holds the local shards, each (C, 8) or (B, C, 8) (shard i: rows
    [i C, (i + 1) C)); -> the natural-order evaluations, sharded alike."""
    mesh.require_axis()
    if not sharded_transform_supported(mesh, n):
        raise ValueError(f"the 4-step NTT needs D > 1 and n divisible by D^2: n = {n}, D = {mesh.size}")
    flat = [a.reshape(-1, n // mesh.size, L.NLIMBS) for a in a_mont]
    return [y.reshape(a.shape) for y, a in zip(_four_step(mesh, n, omega, flat), a_mont)]


def sharded_transform_batch(mesh: Mesh, n: int, omega: int, batch_plain: torch.Tensor, pre_g: int = 1,
                            post_g: int = 1, post_k: int = 1) -> torch.Tensor:
    """The basis transform of poly/transforms.py over the mesh, for a
    (B, n, 8) canonical batch -> (B, n, 8) canonical on the batch's device:

        lagrange_to_coeff: omega = w^-1,     pre = 1,    post = 1/n
        coeff_to_lagrange: omega = w,        pre = 1,    post = 1
        coeff_to_extended: omega = w_ext,    pre = g^i,  post = 1
        extended_to_coeff: omega = w_ext^-1, pre = 1,    post = g^-i / n

    The NTT multiplies only by Montgomery-form twiddles, so canonical rows
    stay canonical through it: pre and post are one K1 product each by k
    R (the Montgomery form of the scale), and a scale of 1 is no launch.
    The NTT is the 4-step one of :func:`distributed_ntt`."""
    mesh.require_axis()
    if batch_plain.dim() != 3 or batch_plain.shape[1:] != (n, L.NLIMBS):
        raise ValueError(f"expected a (B, {n}, 8) batch, got {tuple(batch_plain.shape)}")
    if not sharded_transform_supported(mesh, n):
        raise ValueError(f"the 4-step NTT needs D > 1 and n divisible by D^2: n = {n}, D = {mesh.size}")
    r = FP_SPEC.r_mod_p
    xs = shard(mesh, batch_plain, 1)
    if pre_g != 1:
        xs = [L.mont_mul(FP_SPEC, x, v) for x, v in zip(xs, _geom_vector(mesh, n, pre_g, r))]
    ys = _four_step(mesh, n, omega, xs)
    if post_g != 1 or post_k != 1:
        ys = [L.mont_mul(FP_SPEC, y, v, out=y) for y, v in zip(ys, _geom_vector(mesh, n, post_g, post_k * r))]
    return unshard(mesh, ys, 1, batch_plain.device)


def sharded_transform_supported(mesh: Mesh, n: int) -> bool:
    """The reference's shape gate: the 4-step layout needs D > 1 and n
    divisible by D^2. A size it refuses on a mesh of several shards is
    counted on the mesh (``mesh.unsharded[n]``) and named on stderr the
    first time: the transform then runs unsharded."""
    d = mesh.size
    if d > 1 and n % (d * d) == 0:
        return True
    if d > 1:
        if n not in mesh.unsharded:
            print(f"[parallel] a transform of size {n} is not a multiple of D^2 = {d * d}: it runs unsharded "
                  f"({mesh})", file=sys.stderr, flush=True)
        mesh.unsharded[n] = mesh.unsharded.get(n, 0) + 1
    return False
