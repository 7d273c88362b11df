"""Pippenger multi-scalar multiplication on device.

For a batch of B scalar vectors over one table of N affine points:

1. c-bit window digits are cut from the canonical scalar limbs on device
   (unsigned, or signed with a borrow chain, which halves the buckets);
2. every (MSM, window, digit) row gets a bucket id; one ``torch.sort`` of
   packed (bucket, point) keys groups the rows by bucket and
   ``searchsorted`` gives each bucket's run, digit-0 rows being left out;
3. kernel K2 (``csrc/msm_buckets.cu``; it replaces
   ``pallas_kernels.py:365`` msm_step_T, and its complete variant K7
   ``:227`` msm_step_rows) sums every bucket's run in one C call. Phase A
   cuts the sorted rows into equal chunks of L rows, one a thread, over
   one wave of resident threads (:func:`bucket_resident`, from the CUDA
   occupancy calculator; L is the shortest such chunk, or a quarter of
   the longest run if that is longer, :func:`bucket_layout`): a thread
   walks its chunk with the mixed addition, incomplete with its P == Q
   flag for K2, writes the runs that begin and end inside it, and carries
   the first and last segment when a run crosses its edges. Phase B gives
   every run that crosses a chunk boundary one thread, which adds its
   pieces in chunk order with the complete addition. With one thread per
   bucket a launch would wait for the longest run (and, at the board's
   commit batches, for a second wave); here it waits for L mixed and at
   most four complete additions. Its bound is the ~11 Montgomery products
   per row after its bucket's head, at the card's 32-bit multiply rate.
   If any live bucket raised the flag the batch is redone with the
   complete law (K7), which small MSMs run directly;
4. per window, T_w = sum_b b S_b in one launch of kernel K3
   (``csrc/window_sums.cu``) for every window of the batch: each row's
   buckets are split over the threads of a block, which combine their
   segment sums through shared memory (:func:`window_sums`; its plain
   version is the reference's two-level running-sum decomposition over
   the complete Jacobian addition, one addition per step);
5. the host converts the B x W window sums to affine and folds them,
   sum_w 2^(c w) T_w (host_window_fold; the native host engine's batched
   fold where BZ_PROOF_ENGINE selects that engine).

:func:`host_msm` is the native host engine's Pippenger; ``msm(...,
host=True)`` takes it for the small MSMs the reference keeps on the host
(the verifier's, when it runs on the native engine); the native IPA calls
it directly. Under ``device`` they run on K7.

This replaces the reference's lax.scan over lane runs, one launch per
step, and its lane-boundary repair: here a thread walks its whole chunk in
one launch, and the repair is phase B of the same C call.

Under ``BZ_ROW_MSM`` the MSM takes the route of the reference's row-layout
kernels: every bucket run goes through the complete law (K7), with no
collision flag and no redo, and step 4 runs on kernel K6 with the points
held as coordinate planes (3, ..., 8): one launch of its window kernel
(``csrc/point_add_planes.cu``, K3's body addressing planes) per bucket
pass (:func:`window_sums_planes`).
"""

from __future__ import annotations

import ctypes

import torch

from ..config import config
from ..curves import limb as C
from ..curves.host import Curve
from ..fields import limb as L
from ..fields.limb import FieldSpec, ints_to_limbs
from .dispatch import device_call

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


BUCKET_BLOCK = 128  # threads of a block of csrc/msm_buckets.cu
_bucket_resident: dict = {}


def bucket_resident(device: torch.device, complete: bool) -> int:
    """Threads of the bucket pass's phase A (K2, or K7 when ``complete``)
    that the card holds at once: its SMs x the blocks an SM keeps resident,
    from the CUDA occupancy calculator on the built kernel; asked once per
    card and variant."""
    from . import cuda

    key = (device, bool(complete))
    if key not in _bucket_resident:
        n = ctypes.c_longlong()
        with torch.cuda.device(device):
            status = cuda.library().bz_msm_bucket_resident(int(complete), ctypes.byref(n))
        cuda.check(status, "K2/K7 bz_msm_bucket_resident")
        if n.value < BUCKET_BLOCK:
            raise RuntimeError(f"the bucket kernel fits no block on {device}: {n.value} resident threads")
        _bucket_resident[key] = n.value
    return _bucket_resident[key]


# A run is cut into at most about this many chunks: the chunk length is
# at least ceil(longest run / BUCKET_SPAN) (csrc/msm_buckets.cu, BZ_MB_SPAN).
BUCKET_SPAN = 4


def bucket_layout(rows: int, resident: int, longest: int) -> tuple[int, int]:
    """(chunk length L, chunks) of a bucket pass over ``rows`` sorted rows
    with ``resident`` threads (:func:`bucket_resident`) and a longest run of
    ``longest`` rows: L = max(1, ceil(rows / resident), ceil(longest /
    BUCKET_SPAN)), the shortest chunks that one wave covers unless a run
    would cross more than BUCKET_SPAN chunk boundaries, and ceil(rows / L)
    <= resident chunks. csrc/msm_buckets.cu computes the same on the card
    from starts."""
    chunk = max(1, -(-rows // resident), -(-longest // BUCKET_SPAN))
    return chunk, -(-rows // chunk)


def bucket_sums_plain(spec: FieldSpec, table, src, starts, complete: bool, chunk: int | None = None):
    """The plain PyTorch version of K2 (K7 when ``complete``), on the
    kernel's schedule: the rows are cut into chunks of ``chunk`` rows, each
    walked with a lift at every bucket's segment head and the mixed
    addition after it (phase A, one lane per chunk and one step per row),
    then every run that crosses a chunk boundary adds its pieces in chunk
    order with the complete addition (phase B, one lane per such run). With
    the kernel's L it gives its Jacobian coordinates and flags exactly.
    ``chunk`` None: :func:`bucket_layout` with as many threads as
    non-empty buckets (on the CPU no card's wave applies)."""
    nb = starts.shape[0] - 1
    dev = table.device
    bounds = starts.to(torch.int64)
    rows = int(bounds[-1]) if nb else 0
    out = C.infinity(spec, (nb,), dev)
    flags = torch.zeros(nb, dtype=torch.int32, device=dev)
    if rows == 0:
        return out, flags
    lens = bounds.diff()
    if chunk is None:
        chunk = bucket_layout(rows, int((lens > 0).sum()), int(lens.max()))[0]
    chunks = -(-rows // chunk)
    bid = torch.repeat_interleave(torch.arange(nb, device=dev), lens)
    pts = table[src[:rows].to(torch.int64)]
    lo = torch.arange(chunks, device=dev) * chunk
    hi = torch.clamp(lo + chunk, max=rows)
    head_in = (lo > 0) & (bid[lo] == bid[(lo - 1).clamp(min=0)])
    tail_on = (hi < rows) & (bid[hi.clamp(max=rows - 1)] == bid[hi - 1])
    carry = C.infinity(spec, (2 * chunks,), dev)
    carry_flags = torch.zeros(2 * chunks, dtype=torch.int32, device=dev)
    acc = C.infinity(spec, (chunks,), dev)
    acc_flags = torch.zeros(chunks, dtype=torch.int32, device=dev)
    first = torch.ones(chunks, dtype=torch.bool, device=dev)
    # phase A: step j adds row lo + j of every chunk
    for j in range(min(chunk, rows)):
        i = lo + j
        live = i < hi
        at = i.clamp(max=rows - 1)
        head = live & ((j == 0) | (bid[at] != bid[(at - 1).clamp(min=0)]))
        if j:
            first &= ~head
        lift = torch.nonzero(head).flatten()
        acc[lift] = C.lift_plain(spec, pts[i[lift]])
        acc_flags[lift] = 0
        add = torch.nonzero(live & ~head).flatten()
        acc[add], nd = C.point_add_mixed_plain(spec, acc[add], pts[i[add]], complete)
        acc_flags[add] |= nd.to(torch.int32)
        # segments that end at this row: written out, or kept for phase B
        ends = live & ((i + 1 == hi) | (bid[at] != bid[(at + 1).clamp(max=rows - 1)]))
        as_head = ends & first & head_in
        as_tail = ends & ~as_head & (i + 1 == hi) & tail_on
        whole = torch.nonzero(ends & ~as_head & ~as_tail).flatten()
        out[bid[i[whole]]] = acc[whole]
        flags[bid[i[whole]]] = acc_flags[whole]
        for mask, slot in ((as_head, 0), (as_tail, 1)):
            lanes = torch.nonzero(mask).flatten()
            carry[2 * lanes + slot] = acc[lanes]
            carry_flags[2 * lanes + slot] = acc_flags[lanes]
    # phase B: a run's first boundary t (start in chunk t - 1) adds its pieces
    t = torch.arange(1, chunks, device=dev)
    b = bid[t * chunk]
    t = t[(bid[t * chunk - 1] == b) & (bounds[b] >= (t - 1) * chunk)]
    b = bid[t * chunk]
    run = carry[2 * t - 1]
    run_flags = carry_flags[2 * t - 1].clone()
    end, u = bounds[b + 1], t.clone()
    while True:
        more = torch.nonzero(u * chunk < end).flatten()
        if not more.numel():
            break
        run[more] = C.point_add_plain(spec, run[more], carry[2 * u[more]])
        run_flags[more] |= carry_flags[2 * u[more]]
        u += 1
    out[b] = run
    flags[b] = run_flags
    return out, flags


def bucket_sums(spec: FieldSpec, table, src, starts, bid, complete: bool):
    """K2 / K7: table (N', 2, 8) affine Montgomery rows, src (rows,) int32
    table rows sorted by bucket, starts (nb + 1,) int32 run offsets, bid
    (rows,) int32 the bucket of each sorted row -> (bucket sums (nb, 3, 8),
    flags (nb,) int32: 1 where the incomplete law met P == Q inside a
    chunk; always 0 for the complete variant). A CUDA tensor launches the
    kernel's phases in one C call, with the chunk length of
    :func:`bucket_layout` over one wave of threads (:func:`bucket_resident`);
    a CPU tensor runs the plain version, which takes its buckets from
    ``starts``."""
    if not table.is_cuda:
        return bucket_sums_plain(spec, table, src, starts, complete)
    from . import cuda

    cuda.require(table, torch.int32, "K2 point table")
    cuda.require(src, torch.int32, "K2 src")
    cuda.require(bid, torch.int32, "K2 bid")
    cuda.require(starts, torch.int32, "K2 starts")
    nb = starts.shape[0] - 1
    dev = table.device
    out = torch.empty(nb, 3, L.NLIMBS, dtype=torch.int32, device=dev)
    flags = torch.empty(nb, dtype=torch.int32, device=dev)
    if nb:
        resident = bucket_resident(dev, complete)
        threads = max(1, min(resident, src.shape[0]))  # no more chunks than sorted rows
        carry = torch.empty(2 * threads, 3, L.NLIMBS, dtype=torch.int32, device=dev)
        carry_flags = torch.empty(2 * threads, dtype=torch.int32, device=dev)
        layout = torch.empty(1, dtype=torch.int64, device=dev)
        cuda.launch(
            "K7" if complete else "K2", "bz_msm_buckets", table,
            spec.kernel_consts, int(complete), cuda.ptr(table), cuda.ptr(src), cuda.ptr(bid), cuda.ptr(starts),
            cuda.ptr(out), cuda.ptr(flags), cuda.ptr(carry), cuda.ptr(carry_flags), cuda.ptr(layout), nb, resident,
            threads,
        )
    return out, flags


def _aggregate_windows(
    spec: FieldSpec, buckets: torch.Tensor, nbuck: int, planar: bool = False, add=None
) -> torch.Tensor:
    """buckets (R, nbuck, 3, 8), bucket 0 unused -> (R, 3, 8) with
    T = sum_{b=1..m} b S_b, m = nbuck - 1, as two levels of running sums:
    b = k g + i (i in [1, g], k < G): T = sum_k (k g U_k + A_k) with
    U_k = sum_i S_{kg+i}, A_k = sum_i i S_{kg+i}. Level 1 runs g steps at
    width R G, level 2 G steps at width R: ~2 (g + G) additions deep.
    With ``planar`` the points are coordinate planes: (3, R, nbuck, 8) ->
    (3, R, 8). The additions are lane-wise calls of ``add``, by default
    ``curves/limb.py::point_add`` (K3's lane-wise kernel), or with
    ``planar`` ``point_add_planes`` (K6's)."""
    dev = buckets.device
    if planar:
        r_count, inf, axis = buckets.shape[1], C.infinity_planes, 2
        add = add or C.point_add_planes
    else:
        r_count, inf, axis = buckets.shape[0], C.infinity, 1
        add = add or C.point_add
    m = nbuck - 1
    gbits = max(1, ((m - 1).bit_length() + 1) // 2)
    g = 1 << gbits
    big_g = (m + g - 1) // g

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
    return total


def window_sums_plain(spec: FieldSpec, buckets: torch.Tensor, nbuck: int) -> torch.Tensor:
    """The plain PyTorch version of K3's window kernel, on any device: the
    reference's two-level running sums (:func:`_aggregate_windows`) over
    ``curves/limb.py::point_add_plain``."""
    return _aggregate_windows(spec, buckets, nbuck, add=C.point_add_plain)


def window_sums_planes_plain(spec: FieldSpec, planes: torch.Tensor, nbuck: int) -> torch.Tensor:
    """The plain PyTorch version of K6's window kernel, on any device: the
    reference's two-level running sums (:func:`_aggregate_windows`) over
    ``curves/limb.py::point_add_planes_plain``."""
    return _aggregate_windows(spec, planes, nbuck, planar=True, add=C.point_add_planes_plain)


WINDOW_BLOCK = 128  # threads of a block of csrc/window_body.cuh
_window_resident: dict = {}


def window_resident(device: torch.device, planar: bool = False) -> int:
    """Threads of K3's window kernel (K6's with ``planar``) that the card
    holds at once: its SMs x the blocks an SM keeps resident, from the CUDA
    occupancy calculator on the built kernel (so a change of its registers
    changes the split); asked once per card and kernel."""
    from . import cuda

    key = (device, bool(planar))
    if key not in _window_resident:
        name, entry = ("K6", "bz_window_planes_resident") if planar else ("K3", "bz_window_resident")
        n = ctypes.c_longlong()
        with torch.cuda.device(device):
            cuda.check(getattr(cuda.library(), entry)(ctypes.byref(n)), f"{name} {entry}")
        if n.value < WINDOW_BLOCK:
            raise RuntimeError(f"{name}'s window kernel fits no block on {device}: {n.value} resident threads")
        _window_resident[key] = n.value
    return _window_resident[key]


def window_layout(rows: int, m: int, resident: int) -> tuple[int, int]:
    """(threads per row, buckets per thread) of K3 or K6 for ``rows`` rows
    of m buckets: both powers of two, threads x segment >= m. A row takes up
    to a block, which keeps the serial depth lowest; when the rows would not
    all be resident at once (``resident`` threads, :func:`window_resident`),
    each takes fewer threads (down to 32): a second wave of blocks would
    cost more than the longer segments."""
    total = 1 << (m - 1).bit_length()
    threads = min(total, WINDOW_BLOCK)
    while threads > 32 and rows * threads > resident:
        threads //= 2
    return threads, total // threads


def window_sums(spec: FieldSpec, buckets: torch.Tensor, nbuck: int) -> torch.Tensor:
    """K3: buckets (R, nbuck, 3, 8) Jacobian Montgomery points, bucket 0
    unused -> (R, 3, 8) with T = sum_{b=1..m} b S_b, m = nbuck - 1, for
    every row in one launch. A CUDA tensor launches the kernel; a CPU tensor
    runs the plain version, :func:`window_sums_plain`. The two add in
    different orders: their Jacobian coordinates differ, their points are
    equal."""
    if buckets.dim() != 4 or buckets.shape[1:] != (nbuck, 3, L.NLIMBS) or nbuck < 2:
        raise ValueError(f"buckets must be (rows, {nbuck}, 3, 8) with nbuck >= 2: {tuple(buckets.shape)}")
    if not buckets.is_cuda:
        return window_sums_plain(spec, buckets, nbuck)
    out = torch.empty(buckets.shape[0], 3, L.NLIMBS, dtype=torch.int32, device=buckets.device)
    return _launch_windows(spec, buckets, out, buckets.shape[0], nbuck, planar=False)


def window_sums_planes(spec: FieldSpec, planes: torch.Tensor, nbuck: int) -> torch.Tensor:
    """K6: :func:`window_sums` on coordinate planes, (3, R, nbuck, 8) ->
    (3, R, 8), for every row in one launch. A CUDA tensor launches the
    kernel; a CPU tensor runs the plain version,
    :func:`window_sums_planes_plain`. Their points are equal, their
    Jacobian coordinates differ."""
    if planes.dim() != 4 or planes.shape[0] != 3 or planes.shape[2:] != (nbuck, L.NLIMBS) or nbuck < 2:
        raise ValueError(f"planes must be (3, rows, {nbuck}, 8) with nbuck >= 2: {tuple(planes.shape)}")
    if not planes.is_cuda:
        return window_sums_planes_plain(spec, planes, nbuck)
    out = torch.empty(3, planes.shape[1], L.NLIMBS, dtype=torch.int32, device=planes.device)
    return _launch_windows(spec, planes, out, planes.shape[1], nbuck, planar=True)


def _launch_windows(spec: FieldSpec, src: torch.Tensor, out: torch.Tensor, rows: int, nbuck: int, planar: bool):
    """One launch of K3's window kernel (K6's with ``planar``) from src into
    out, rows split by :func:`window_layout` over the kernel's resident
    threads."""
    from . import cuda

    name, entry = ("K6", "bz_window_sums_planes") if planar else ("K3", "bz_window_sums")
    cuda.require(src, torch.int32, f"{name} buckets")
    if rows:
        threads, seg = window_layout(rows, nbuck - 1, window_resident(src.device, planar))
        cuda.launch(
            name, entry, src, spec.kernel_consts, cuda.ptr(src), cuda.ptr(out), rows, nbuck,
            threads.bit_length() - 1, seg,
        )
    return out


def bucket_runs(spec: FieldSpec, table, scalars, c: int, signed: bool):
    """Group the rows of B MSMs by bucket.

    table (N, 2, 8) affine Montgomery rows (all-zero = identity), scalars
    (B, N, 8) canonical limbs -> (point table, src, starts, nbuck, bid):
    src (rows,) int32 table rows sorted by bucket, starts (B W nbuck + 1,)
    int32 run offsets of bucket (b, w, d) at index (b W + w) nbuck + d, bid
    (rows,) int32 the bucket of each sorted row (B W nbuck past the live
    rows, where the digit-0 rows sort). Signed digits add the negated points
    to the table ([P | -P])."""
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
    bid = keys // rows_per
    starts = torch.searchsorted(bid, torch.arange(nb + 1, device=dev)).to(torch.int32)
    return table.contiguous(), src_sorted, starts, nbuck, bid.to(torch.int32)


def msm_wsums(spec: FieldSpec, table, scalars, c: int, signed: bool, complete: bool = False):
    """Window sums of B MSMs over one point table -> (wsums (B, W, 3, 8)
    Jacobian, collision: True iff the incomplete law met P == Q in a live
    bucket). Under BZ_ROW_MSM the buckets always take the complete law, so
    collision is False, and the aggregation runs on K6's window kernel over
    coordinate planes."""
    b_count = scalars.shape[0]
    row = config().row_msm
    complete = complete or row
    table, src, starts, nbuck, bid = bucket_runs(spec, table, scalars, c, signed)
    sums, flags = bucket_sums(spec, table, src, starts, bid, complete)
    collision = not complete and bool(flags.any())
    buckets = sums.view(-1, nbuck, 3, L.NLIMBS)
    if row:
        wsums = window_sums_planes(spec, buckets.permute(2, 0, 1, 3).contiguous(), nbuck).movedim(0, -2)
    else:
        wsums = window_sums(spec, buckets, nbuck)
    return wsums.reshape(b_count, -1, 3, L.NLIMBS), collision


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
    auto-picked from N unless ``c`` (and ``signed``) is given. A pure
    function of its inputs, run again while the card is busy
    (ops/dispatch.py)."""
    return device_call(_msm_many_table, curve, table, scalars, c, signed, what="batched MSM")


def _msm_many_table(curve: Curve, table, scalars, c, signed) -> list:
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
    b_count = len(aff) // w_count
    if b_count > 1:
        from .. import native

        if native.enabled():
            return native.window_fold_batch(native.which_for(curve.base.modulus), aff, b_count, w_count, c)
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


def host_msm(curve: Curve, points, scalars):
    """The native host engine's Pippenger (``pasta_msm``: mixed affine bucket
    additions, OpenMP over windows); None for no points."""
    from .. import native

    if not points:
        return None
    return native.msm(native.which_for(curve.base.modulus), list(points),
                      [s % curve.scalar.modulus for s in scalars])


def msm(curve: Curve, points, scalars, device, c=None, signed=None, host: bool = False):
    """Host-facing MSM: affine points (None = identity) x int scalars ->
    affine result, on the device, or on :func:`host_msm` if ``host``."""
    if len(points) != len(scalars):
        raise ValueError(f"{len(points)} points but {len(scalars)} scalars")
    if host:
        return host_msm(curve, points, scalars)
    return msm_many(curve, points, [scalars], device, c, signed)[0]
