"""Pippenger multi-scalar multiplication on device.

For a batch of B scalar vectors over one table of N affine points:

1. c-bit window digits are cut from the canonical scalar limbs on device
   (unsigned, or signed with a borrow chain, which halves the buckets);
2. every (MSM, window, digit) row gets a bucket id; one ``torch.sort`` of
   packed (bucket, point) keys groups the rows by bucket and
   ``searchsorted`` gives each bucket's run, digit-0 rows being left out;
3. kernel K2 (``csrc/msm_buckets.cu``) sums every bucket's run in one
   thread, with the incomplete mixed addition and its P == Q flag. If any
   live bucket raised the flag the batch is redone with the complete law
   (K7, the kernel's complete variant), which small MSMs run directly;
4. per window, T_w = sum_b b S_b by the reference's two-level running-sum
   decomposition over kernel K3 (complete Jacobian addition);
5. the host converts the B x W window sums to affine and folds them,
   sum_w 2^(c w) T_w (host_window_fold).

This replaces the reference's lax.scan over lane runs and its lane-boundary
repair: a thread walks a whole bucket, so no run is ever split.

Under ``BZ_ROW_MSM`` the MSM takes the route of the reference's row-layout
kernels: every bucket run goes through the complete law (K7), with no
collision flag and no redo, and step 4 runs on kernel K6 with the points
held as coordinate planes (3, ..., 8) from the bucket sums to the window
sums.
"""

from __future__ import annotations

import torch

from ..config import config
from ..curves import limb as C
from ..curves.host import Curve
from ..fields import limb as L
from ..fields.limb import FieldSpec, ints_to_limbs

SCALAR_BITS = 256


def auto_window(n: int) -> tuple[int, bool]:
    """(c, signed) for a problem of n points. Below 2^10 points the window
    shrinks with n so that buckets stay populated; signed digits halve the
    buckets, which makes the larger windows of large problems affordable."""
    if n <= (1 << 13):
        return max(2, min(8, n.bit_length() - 3)), False
    if n <= (1 << 15):
        return 10, True
    if n <= (1 << 17):
        return 12, True
    return 13, True


def signed_window_count(c: int, scalar_bits: int = 255) -> int:
    """Windows of signed c-bit digits for scalars < 2^scalar_bits (Pasta
    moduli < 2^255): one more iff the top window plus a carry can reach
    2^(c-1)."""
    w = (scalar_bits + c - 1) // c
    if 1 << (scalar_bits - c * (w - 1)) >= 1 << (c - 1):
        w += 1
    return w


def _words(scalars: torch.Tensor, pad: int) -> torch.Tensor:
    """(..., 8) int32 limbs -> (..., 8 + pad) int64 32-bit words."""
    w = scalars.to(torch.int64) & 0xFFFFFFFF
    return torch.cat([w, torch.zeros(w.shape[:-1] + (pad,), dtype=torch.int64, device=w.device)], -1)


def _window(words: torch.Tensor, bit: int, c: int) -> torch.Tensor:
    j, off = divmod(bit, 32)
    chunk = words[..., j] | (words[..., j + 1] << 32)
    return (chunk >> off) & ((1 << c) - 1)


def unsigned_digits(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """Canonical scalars (B, N, 8) -> (B, W, N) int64 digits in [0, 2^c),
    all windows at once."""
    bits = torch.arange(0, SCALAR_BITS, c, device=scalars.device)
    j, off = bits // 32, bits % 32
    words = _words(scalars, 2)
    chunk = words[..., j] | (words[..., j + 1] << 32)  # (B, N, W)
    return ((chunk >> off) & ((1 << c) - 1)).transpose(1, 2)


def signed_digits(scalars: torch.Tensor, c: int) -> torch.Tensor:
    """Canonical scalars (B, N, 8) -> (B, W, N) int64 digits in
    [-2^(c-1), 2^(c-1)] with value = sum_w d_w 2^(c w)."""
    w_count = signed_window_count(c)
    words = _words(scalars, 2 + (w_count * c - SCALAR_BITS + 31) // 32)
    half = 1 << (c - 1)
    digits = []
    carry = torch.zeros(scalars.shape[:-1], dtype=torch.int64, device=scalars.device)
    for w in range(w_count):
        t = _window(words, w * c, c) + carry
        hi = t >= half
        digits.append(torch.where(hi, t - (1 << c), t))
        carry = hi.to(torch.int64)
    return torch.stack(digits, dim=1)


# ------------------------------------------------------------- K2 / K7


def bucket_sums_plain(spec: FieldSpec, table, src, starts, complete: bool):
    """The plain PyTorch version of K2 (K7 when ``complete``): step s adds
    the s-th point of every run longer than s."""
    nb = starts.shape[0] - 1
    first = starts[:-1].to(torch.int64)
    lens = starts[1:].to(torch.int64) - first
    acc = C.infinity(spec, (nb,), table.device)
    flags = torch.zeros(nb, dtype=torch.int32, device=table.device)
    live = torch.nonzero(lens > 0).flatten()
    acc[live] = C.lift_plain(spec, table[src[first[live]].to(torch.int64)])
    for s in range(1, int(lens.max()) if nb else 0):
        live = torch.nonzero(lens > s).flatten()
        q = table[src[first[live] + s].to(torch.int64)]
        acc[live], nd = C.point_add_mixed_plain(spec, acc[live], q, complete)
        flags[live] |= nd.to(torch.int32)
    return acc, flags


def bucket_sums(spec: FieldSpec, table, src, starts, complete: bool):
    """K2 / K7: table (N', 2, 8) affine Montgomery rows, src (rows,) int32
    table rows sorted by bucket, starts (nb + 1,) int32 run offsets ->
    (bucket sums (nb, 3, 8), flags (nb,) int32: 1 where the incomplete law
    met P == Q; always 0 for the complete variant). A CUDA tensor launches
    the kernel; a CPU tensor runs the plain version."""
    if not table.is_cuda:
        return bucket_sums_plain(spec, table, src, starts, complete)
    from . import cuda

    cuda.require(table, torch.int32, "K2 point table")
    cuda.require(src, torch.int32, "K2 src")
    cuda.require(starts, torch.int32, "K2 starts")
    nb = starts.shape[0] - 1
    out = torch.empty(nb, 3, L.NLIMBS, dtype=torch.int32, device=table.device)
    flags = torch.empty(nb, dtype=torch.int32, device=table.device)
    if nb:
        cuda.launch(
            "K7" if complete else "K2", "bz_msm_buckets", table,
            spec.kernel_consts, int(complete), cuda.ptr(table), cuda.ptr(src), cuda.ptr(starts), cuda.ptr(out),
            cuda.ptr(flags), nb,
        )
    return out, flags


def _aggregate_windows(spec: FieldSpec, buckets: torch.Tensor, nbuck: int, planar: bool = False) -> torch.Tensor:
    """buckets (R, nbuck, 3, 8), bucket 0 unused -> (R, 3, 8) with
    T = sum_{b=1..m} b S_b, m = nbuck - 1, as two levels of running sums:
    b = k g + i (i in [1, g], k < G): T = sum_k (k g U_k + A_k) with
    U_k = sum_i S_{kg+i}, A_k = sum_i i S_{kg+i}. Level 1 runs g steps at
    width R G, level 2 G steps at width R: ~2 (g + G) additions deep.
    The additions run on K3, or with ``planar`` on K6 over coordinate
    planes (3, R, ..., 8), converted once here and once at the end."""
    r_count, dev = buckets.shape[0], buckets.device
    m = nbuck - 1
    gbits = max(1, ((m - 1).bit_length() + 1) // 2)
    g = 1 << gbits
    big_g = (m + g - 1) // g
    if planar:
        add, inf, axis = C.point_add_planes, C.infinity_planes, 2
        buckets = buckets.permute(2, 0, 1, 3).contiguous()
    else:
        add, inf, axis = C.point_add, C.infinity, 1

    def column(t: torch.Tensor, k: int) -> torch.Tensor:
        return t.select(axis, k).contiguous()

    # one identity column at index nbuck for ids past m
    padded = torch.cat([buckets, inf(spec, (r_count, 1), dev)], dim=axis)
    ids = torch.tensor(
        [[min(k * g + g - t, nbuck) for k in range(big_g)] for t in range(g)], dtype=torch.int64, device=dev
    )
    run = inf(spec, (r_count, big_g), dev)
    acc = inf(spec, (r_count, big_g), dev)
    for t in range(g):
        add(spec, run, padded.index_select(axis, ids[t]), out=run)
        add(spec, acc, run, out=acc)
    total = column(acc, 0)
    if big_g > 1:
        run2 = inf(spec, (r_count,), dev)
        acc2 = inf(spec, (r_count,), dev)
        for k in range(big_g - 1, 0, -1):
            add(spec, run2, column(run, k), out=run2)
            add(spec, acc2, run2, out=acc2)
            add(spec, total, column(acc, k), out=total)
        for _ in range(gbits):
            add(spec, acc2, acc2.clone(), out=acc2)
        total = add(spec, acc2, total)
    return total.movedim(0, -2).contiguous() if planar else total


def bucket_runs(spec: FieldSpec, table, scalars, c: int, signed: bool):
    """Group the rows of B MSMs by bucket.

    table (N, 2, 8) affine Montgomery rows (all-zero = identity), scalars
    (B, N, 8) canonical limbs -> (point table, src, starts, nbuck): src
    (rows,) int32 table rows sorted by bucket, starts (B W nbuck + 1,) int32
    run offsets of bucket (b, w, d) at index (b W + w) nbuck + d. Signed
    digits add the negated points to the table ([P | -P])."""
    b_count, n = scalars.shape[:2]
    dev = table.device
    if signed:
        digits = signed_digits(scalars, c)
        mag = digits.abs()
        src = torch.arange(n, device=dev) + n * (digits < 0).to(torch.int64)
        neg_y = L.neg(spec, table[:, 1].contiguous())
        table = torch.cat([table, torch.stack([table[:, 0], neg_y], dim=1)])
        nbuck = (1 << (c - 1)) + 1
    else:
        digits = unsigned_digits(scalars, c)
        mag = digits
        src = torch.arange(n, device=dev).expand(digits.shape)
        nbuck = 1 << c
    nb = b_count * digits.shape[1] * nbuck
    rows_per = table.shape[0]
    win = torch.arange(b_count * digits.shape[1], device=dev).view(b_count, -1, 1)
    bucket = torch.where(mag == 0, nb, win * nbuck + mag)  # digit 0: no bucket
    keys = torch.sort((bucket * rows_per + src).flatten()).values
    src_sorted = (keys % rows_per).to(torch.int32)
    starts = torch.searchsorted(keys // rows_per, torch.arange(nb + 1, device=dev)).to(torch.int32)
    return table.contiguous(), src_sorted, starts, nbuck


def msm_wsums(spec: FieldSpec, table, scalars, c: int, signed: bool, complete: bool = False):
    """Window sums of B MSMs over one point table -> (wsums (B, W, 3, 8)
    Jacobian, collision: True iff the incomplete law met P == Q in a live
    bucket). Under BZ_ROW_MSM the buckets always take the complete law and
    the aggregation runs on K6, so collision is False."""
    b_count = scalars.shape[0]
    row = config().row_msm
    complete = complete or row
    table, src, starts, nbuck = bucket_runs(spec, table, scalars, c, signed)
    sums, flags = bucket_sums(spec, table, src, starts, complete)
    collision = not complete and bool(flags.any())
    wsums = _aggregate_windows(spec, sums.view(-1, nbuck, 3, L.NLIMBS), nbuck, planar=row)
    return wsums.view(b_count, -1, 3, L.NLIMBS), collision


def host_window_fold(curve: Curve, wsum_points: list, c: int):
    """sum_w 2^(c w) T_w in exact host arithmetic (affine points)."""
    acc = None
    for wsum in reversed(wsum_points):
        for _ in range(c):
            acc = curve.add(acc, acc)
        acc = curve.add(acc, wsum)
    return acc


# Below this many points an MSM runs the complete law (K7) directly. Such
# small MSMs mostly take their points from a proof (the verifier's L_j, R_j
# and commitments), where a malicious prover could force the incomplete
# law's P == Q case and make every MSM run twice; at this size the complete
# law's extra case costs nothing.
COMPLETE_BELOW = 64


def msm_many_table(curve: Curve, table, scalars, c: int | None = None, signed: bool | None = None) -> list:
    """B MSMs over a prepared point table (curves/limb.py::affine_table):
    scalars (B, N, 8) canonical limbs -> B affine results. The window is
    auto-picked from N unless ``c`` (and ``signed``) is given."""
    spec = FieldSpec.make(curve.base.modulus)
    if c is None:
        c, auto_signed = auto_window(table.shape[0])
        signed = auto_signed if signed is None else signed
    signed = bool(signed)
    complete = table.shape[0] < COMPLETE_BELOW
    wsums, collision = msm_wsums(spec, table, scalars, c, signed, complete)
    if collision:
        wsums, _ = msm_wsums(spec, table, scalars, c, signed, complete=True)
    w_count = wsums.shape[1]
    aff = C.jacobian_to_affine(spec, wsums)
    return [host_window_fold(curve, aff[i : i + w_count], c) for i in range(0, len(aff), w_count)]


def msm_many(curve: Curve, points, scalars_list, device, c=None, signed=None) -> list:
    """Batched MSM: many scalar vectors over one list of affine points
    (None = identity) -> list of affine results."""
    if not scalars_list:
        return []
    if not points:
        return [None] * len(scalars_list)
    spec = FieldSpec.make(curve.base.modulus)
    table = C.affine_table(spec, points, device)
    m = curve.scalar.modulus
    flat = [s % m for sc in scalars_list for s in sc]
    scalars = ints_to_limbs(flat, device).reshape(len(scalars_list), len(points), L.NLIMBS)
    return msm_many_table(curve, table, scalars, c, signed)


def msm(curve: Curve, points, scalars, device, c=None, signed=None):
    """Host-facing MSM: affine points (None = identity) x int scalars ->
    affine result."""
    if len(points) != len(scalars):
        raise ValueError(f"{len(points)} points but {len(scalars)} scalars")
    return msm_many(curve, points, [scalars], device, c, signed)[0]
