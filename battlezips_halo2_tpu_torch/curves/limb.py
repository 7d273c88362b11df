"""Device Pasta curve arithmetic on limb tensors, Jacobian coordinates.

A Jacobian point batch is one ``(..., 3, 8)`` int32 tensor: X, Y, Z in
Montgomery form, Z = 0 for the identity (the identity is (1, 1, 0) as in
the reference's curves/limb.py). Affine point tables for the MSM are
``(N, 2, 8)``: (x, y) in Montgomery form, the all-zero row being the
identity ((0, 0) is never on y^2 = x^3 + 5).

Kernel K3 (``csrc/point_add.cu``) is the complete addition
:func:`point_add`. Kernel K6 (``csrc/point_add_planes.cu``),
:func:`point_add_planes`, is the same addition on points held as coordinate
planes, ``(3, ..., 8)`` with X, Y and Z each contiguous, as the reference's
``JacobianPoint`` rows are. Kernel K8 (``csrc/step_chain.cu``),
:func:`step_chain`, chains the bucket step of K2 over fixed points:
``acc = head ? lift(P) : acc + P`` by the incomplete law. The functions
named ``*_plain`` are the plain PyTorch versions of the formulas: they run
the same formulas, select their cases in the same order as the reference
and as the CUDA device functions of ``csrc/field.cuh``, and so give
bit-identical Jacobian coordinates.
"""

from __future__ import annotations

import torch

from ..fields import limb as L
from ..fields.limb import FieldSpec, ints_to_limbs, limbs_to_ints


def infinity(spec: FieldSpec, shape: tuple, device) -> torch.Tensor:
    one = spec.const("one_mont", device)[0]
    out = torch.zeros(tuple(shape) + (3, L.NLIMBS), dtype=torch.int32, device=device)
    out[..., 0, :] = one
    out[..., 1, :] = one
    return out


def infinity_planes(spec: FieldSpec, shape: tuple, device) -> torch.Tensor:
    """The identity as a (3, *shape, 8) batch of coordinate planes."""
    return infinity(spec, shape, device).movedim(-2, 0).contiguous()


def affine_table(spec: FieldSpec, points, device) -> torch.Tensor:
    """Affine points (None = identity) -> (N, 2, 8) Montgomery table with
    all-zero identity rows."""
    r, m = spec.r_mod_p, spec.modulus
    flat = []
    for p in points:
        flat += [0, 0] if p is None else [p[0] * r % m, p[1] * r % m]
    return ints_to_limbs(flat, device).reshape(len(points), 2, L.NLIMBS)


def affine_to_jacobian(spec: FieldSpec, points, device) -> torch.Tensor:
    """Affine points (None = identity) -> (N, 3, 8) Jacobian batch."""
    table = affine_table(spec, points, device)
    inf = (table == 0).flatten(-2).all(-1)
    z = spec.const("one_mont", device).expand(len(points), L.NLIMBS)
    z = torch.where(inf.unsqueeze(-1), torch.zeros_like(z), z)
    jac = torch.cat([table, z.unsqueeze(1)], dim=1)
    # the identity as the reference encodes it: (1, 1, 0)
    return torch.where(inf.view(-1, 1, 1), infinity(spec, (len(points),), device), jac)


def jacobian_to_affine(spec: FieldSpec, pts: torch.Tensor) -> list:
    """(..., 3, 8) Jacobian batch -> flat list of affine points / None (host)."""
    coords = limbs_to_ints(pts)
    m = spec.modulus
    r_inv = pow(spec.r_mod_p, -1, m)
    out = []
    for i in range(0, len(coords), 3):
        z = coords[i + 2] * r_inv % m
        if z == 0:
            out.append(None)
            continue
        zi = pow(z, -1, m)
        zi2 = zi * zi % m
        x = coords[i] * r_inv % m * zi2 % m
        y = coords[i + 1] * r_inv % m * zi2 % m * zi % m
        out.append((x, y))
    return out


# ------------------------------------------------------------ plain formulas


def _ops(spec: FieldSpec):
    return (
        lambda a, b: L.mont_mul_plain(spec, a, b),
        lambda a, b: L.add_plain(spec, a, b),
        lambda a, b: L.sub_plain(spec, a, b),
    )


def _select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """cond (...) bool over (..., 3, 8) points."""
    return torch.where(cond[..., None, None], a, b)


def _jac(x, y, z) -> torch.Tensor:
    return torch.stack((x, y, z), dim=-2)


def point_double_plain(spec: FieldSpec, p: torch.Tensor) -> torch.Tensor:
    """2P, a = 0 short Weierstrass ('dbl-2009-l'); the identity stays Z = 0."""
    mul, add, sub = _ops(spec)
    x, y, z = p.unbind(-2)
    a = mul(x, x)
    b = mul(y, y)
    c = mul(b, b)
    xb = add(x, b)
    t = sub(sub(mul(xb, xb), a), c)
    d = add(t, t)
    e = add(add(a, a), a)
    x3 = sub(mul(e, e), add(d, d))
    c8 = add(c, c)
    c8 = add(c8, c8)
    c8 = add(c8, c8)
    y3 = sub(mul(e, sub(d, x3)), c8)
    yz = mul(y, z)
    return _jac(x3, y3, add(yz, yz))


def point_add_plain(spec: FieldSpec, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Complete P + Q ('add-2007-bl'), cases selected as in the reference."""
    mul, add, sub = _ops(spec)
    x1, y1, z1 = p.unbind(-2)
    x2, y2, z2 = q.unbind(-2)
    z1z1 = mul(z1, z1)
    z2z2 = mul(z2, z2)
    u1 = mul(x1, z2z2)
    u2 = mul(x2, z1z1)
    s1 = mul(mul(y1, z2), z2z2)
    s2 = mul(mul(y2, z1), z1z1)
    h = sub(u2, u1)
    r = sub(s2, s1)
    hh = mul(h, h)
    hhh = mul(h, hh)
    v = mul(u1, hh)
    x3 = sub(sub(mul(r, r), hhh), add(v, v))
    y3 = sub(mul(r, sub(v, x3)), mul(s1, hhh))
    z3 = mul(mul(z1, z2), h)
    out = _jac(x3, y3, z3)
    h0, r0 = L.is_zero(h), L.is_zero(r)
    p_inf, q_inf = L.is_zero(z1), L.is_zero(z2)
    if bool((h0 & r0 & ~p_inf & ~q_inf).any()):  # doubling only where it is selected
        out = _select(h0 & r0, point_double_plain(spec, p), out)
    out = _select(h0 & ~r0, infinity(spec, h0.shape, p.device), out)
    out = _select(q_inf, p, out)
    return _select(p_inf, q, out)


def point_add_mixed_plain(spec: FieldSpec, p: torch.Tensor, qxy: torch.Tensor, complete: bool):
    """P + Q with Q affine ((..., 2, 8) Montgomery rows, all-zero = identity)
    ('madd-2007-bl'). -> (sum, needs_double). ``complete`` selects the
    doubling case; otherwise P == Q leaves the generic formula's output and
    sets needs_double, as the reference's point_add_mixed_incomplete does."""
    mul, add, sub = _ops(spec)
    x1, y1, z1 = p.unbind(-2)
    qx, qy = qxy.unbind(-2)
    q_inf = L.is_zero(qx) & L.is_zero(qy)
    z1z1 = mul(z1, z1)
    u2 = mul(qx, z1z1)
    s2 = mul(mul(qy, z1), z1z1)
    h = sub(u2, x1)
    r = sub(s2, y1)
    hh = mul(h, h)
    hhh = mul(h, hh)
    v = mul(x1, hh)
    x3 = sub(sub(mul(r, r), hhh), add(v, v))
    y3 = sub(mul(r, sub(v, x3)), mul(y1, hhh))
    out = _jac(x3, y3, mul(z1, h))
    p_inf, h0, r0 = L.is_zero(z1), L.is_zero(h), L.is_zero(r)
    needs_double = h0 & r0 & ~p_inf & ~q_inf
    if complete:
        if bool(needs_double.any()):  # doubling only where it is selected
            out = _select(h0 & r0, point_double_plain(spec, p), out)
        needs_double = torch.zeros_like(h0)
    out = _select(h0 & ~r0, infinity(spec, h0.shape, p.device), out)
    out = _select(q_inf, p, out)
    return _select(p_inf, lift_plain(spec, qxy), out), needs_double


def lift_plain(spec: FieldSpec, qxy: torch.Tensor) -> torch.Tensor:
    """Affine rows -> Jacobian (x, y, 1), the all-zero row -> (0, 0, 0)."""
    qx, qy = qxy.unbind(-2)
    q_inf = L.is_zero(qx) & L.is_zero(qy)
    one = spec.const("one_mont", qxy.device)[0].expand(qx.shape)
    return _jac(qx, qy, torch.where(q_inf.unsqueeze(-1), torch.zeros_like(qx), one))


# ------------------------------------------------------------------- K3


def point_add(spec: FieldSpec, p: torch.Tensor, q: torch.Tensor, out=None) -> torch.Tensor:
    """K3: complete Jacobian addition over lanes, (..., 3, 8) each; ``out``
    may be ``p`` or ``q``. A CUDA tensor launches the kernel; a CPU tensor
    runs :func:`point_add_plain`."""
    if p.shape != q.shape or p.shape[-2:] != (3, L.NLIMBS):
        raise ValueError(f"point batches must match as (..., 3, 8): {tuple(p.shape)}, {tuple(q.shape)}")
    if out is None:
        out = torch.empty_like(p)
    if not p.is_cuda:
        out.copy_(point_add_plain(spec, p, q))
        return out
    from ..ops import cuda

    for t in (p, q, out):
        cuda.require(t, torch.int32, "K3 point add")
    n = p.numel() // (3 * L.NLIMBS)
    if n:
        cuda.launch("K3", "bz_point_add", p, spec.kernel_consts, cuda.ptr(p), cuda.ptr(q), cuda.ptr(out), n)
    return out


# ------------------------------------------------------------------- K6


def point_add_planes_plain(spec: FieldSpec, p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K6: :func:`point_add_plain` on (3, ..., 8)
    coordinate planes."""
    return point_add_plain(spec, p.movedim(0, -2), q.movedim(0, -2)).movedim(-2, 0)


def point_add_planes(spec: FieldSpec, p: torch.Tensor, q: torch.Tensor, out=None) -> torch.Tensor:
    """K6: complete Jacobian addition over lanes of coordinate planes,
    (3, ..., 8) each; ``out`` may be ``p`` or ``q``. A CUDA tensor launches
    the kernel; a CPU tensor runs :func:`point_add_planes_plain`."""
    if p.shape != q.shape or p.shape[0] != 3 or p.shape[-1] != L.NLIMBS:
        raise ValueError(f"point planes must match as (3, ..., 8): {tuple(p.shape)}, {tuple(q.shape)}")
    if out is None:
        out = torch.empty_like(p)
    if not p.is_cuda:
        out.copy_(point_add_planes_plain(spec, p, q))
        return out
    from ..ops import cuda

    for t in (p, q, out):
        cuda.require(t, torch.int32, "K6 point add planes")
    n = p.numel() // (3 * L.NLIMBS)
    if n:
        cuda.launch("K6", "bz_point_add_planes", p, spec.kernel_consts, cuda.ptr(p), cuda.ptr(q), cuda.ptr(out), n)
    return out


# ------------------------------------------------------------------- K8


def plain_step_chain(spec: FieldSpec, acc: torch.Tensor, pxy: torch.Tensor, heads: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K8: for each step s,
    acc = heads[s] ? lift(P) : acc + P by the incomplete mixed law, whose
    P == P case (the first step after a head) gives the generic formula's
    (0, 0, 0), the identity of the next step."""
    lifted = lift_plain(spec, pxy)
    for head in heads:
        merged, _ = point_add_mixed_plain(spec, acc, pxy, complete=False)
        acc = _select(head, lifted, merged)
    return acc


def step_chain(
    spec: FieldSpec, acc: torch.Tensor, pxy: torch.Tensor, heads: torch.Tensor, steps_per_launch: int | None = None
) -> torch.Tensor:
    """K8: the chained bucket step over lanes. acc (N, 3, 8) Jacobian, pxy
    (N, 2, 8) affine Montgomery rows (all-zero = identity), heads (S, N)
    bool -> acc after the S steps (a new tensor). One thread holds a lane's
    acc across ``steps_per_launch`` steps (None: all S in one launch; 1:
    one launch per step, the reference's dataflow). A CUDA tensor launches
    the kernel; a CPU tensor runs :func:`plain_step_chain`."""
    n = acc.shape[0]
    if acc.shape != (n, 3, L.NLIMBS) or pxy.shape != (n, 2, L.NLIMBS):
        raise ValueError(f"expected acc (N, 3, 8) and pxy (N, 2, 8): {tuple(acc.shape)}, {tuple(pxy.shape)}")
    if heads.dim() != 2 or heads.shape[1] != n or heads.dtype != torch.bool:
        raise ValueError(f"heads must be (steps, {n}) bool, got {tuple(heads.shape)} {heads.dtype}")
    if steps_per_launch is not None and steps_per_launch < 1:
        raise ValueError(f"steps_per_launch must be >= 1, got {steps_per_launch}")
    if not acc.is_cuda:
        return plain_step_chain(spec, acc, pxy, heads)
    from ..ops import cuda

    out = acc.clone()
    for t, what in ((out, "acc"), (pxy, "pxy")):
        cuda.require(t, torch.int32, f"K8 step chain {what}")
    cuda.require(heads, torch.bool, "K8 step chain heads")
    steps = heads.shape[0]
    per = steps if steps_per_launch is None else steps_per_launch
    if n:
        for s0 in range(0, steps, per):
            cuda.launch(
                "K8", "bz_step_chain", out,
                spec.kernel_consts, cuda.ptr(out), cuda.ptr(pxy), cuda.ptr(heads), n, s0, min(s0 + per, steps),
            )
    return out
