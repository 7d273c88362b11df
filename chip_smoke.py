#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (battlezips_halo2_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py

from the root of a checkout. In order, it

1. builds the CUDA kernels of ``battlezips_halo2_tpu_torch/csrc`` with nvcc,
   and reads the card's integer multiply rate (SMs, maximum SM clock) and
   the multiplies of one Montgomery product (SASS of the built library) for
   the operations bounds;
2. holds K1-K4, K6 and K7 bit-exact (tolerance 0) against their plain
   PyTorch versions on the same CUDA tensors, including the identity,
   P == Q and P == -Q cases of the point kernels, and times both;
3. drives the port's proof path through its public API, reading the
   kernels' launch counts around every phase:

   - the shot circuit (k = 11): keys, ``api.prove_shot`` with
     ``random.Random(7)`` on the inputs of the golden vector, whose bytes
     must equal ``tests/golden/shot_k11.json``, ``api.verify_shot`` (true),
     a tampered proof (false), and a second proof with fresh randomness;
   - the board circuit (k = 12) in the default configuration: keys (vk
     digest as in ``tests/golden/board_k12.json``), ``api.prove_board`` of
     the golden board, whose bytes and instance must equal the golden
     vector's, ``api.verify_board`` (true), a tampered proof (false), and a
     proof with fresh randomness;
   - the same board proofs under ``BZ_ROW_NTT=1 BZ_ROW_MSM=1`` (the
     reference's row-layout configuration): the same golden bytes, accepted
     by ``verify_board``, with K5, K6 and K7 launched and K2, K3 and K4 not;
   - a game session of one board and four shots (``api.prove_session``)
     sequential, batched (the batch prover), batched with two workers (two
     sub-batches), batched with the per-proof tail on two threads and with
     ``dp_devices=1``: equal bytes, each accepted by ``api.verify_session``.

   K1-K7 must each have launched on this path;
4. holds K5 bit-exact against its plain version at the board's own
   extended-domain shape (read from the board's vk), and times it;
5. drives the microbenchmark path, ``tools/torch_exp_step_t.py`` at the
   reference's shapes, which holds K8 (one launch, and one launch per
   step) and K9 (every op) bit-exact against their plain chains and times
   them; K8 and K9 must each have launched on this path;
6. prints a JSON line of per-kernel numbers, the card's name and power
   limit, and last ``{"ok": true, "device": {...}}``.

Without a CUDA card, or outside a checkout, it exits non-zero and prints
no result.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PACKAGE = ROOT / "battlezips_halo2_tpu_torch"
GOLDEN = ROOT / "tests" / "golden" / "shot_k11.json"
GOLDEN_BOARD = ROOT / "tests" / "golden" / "board_k12.json"
PALLAS_KERNELS = "battlezips_halo2_tpu/ops/pallas_kernels.py"
EXP_STEP_T = "tools/exp_step_t.py"
MICROBENCHMARK = ROOT / "tools" / "torch_exp_step_t.py"

# NVIDIA H100 SXM data sheet (dense, 700 W): the HBM rate. The field
# kernels are integer multiply chains: their operations bound is the card's
# 32-bit integer multiply-add rate, 64 results per SM per clock on compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput table), times the SMs and the maximum SM clock, both read from
# the card (card_int_rate). A 32 x 32 -> 64-bit limb product is two results,
# the low and the high word.
HBM_BYTES_PER_S = 3.35e12
INT_RESULTS_PER_SM_CLOCK = 64
MAD_PER_MONT_MUL = 2 * 8 * 8 + 8  # CIOS: a * b, m * p, m per word
# set by main() from the card and from the SASS of the built kernels
OPS_PER_S = None  # 32-bit integer results per second
MONT_MUL_RESULTS = None  # multiply results of one Montgomery product
# per element of K9's ops, beside mul: redc is mul without the 64 wide
# a * b products; add and sub are 8 limb adds, 8 limb subtracts and 8
# selects; raw is 8 limb adds; noop does nothing
CHAIN_OP_RESULTS = {"add": 24, "sub": 24, "raw": 8, "noop": 0}

KERNELS = {
    "K1": ("field_op (Montgomery mul / add / sub)", "csrc/field_ops.cu", f"{PALLAS_KERNELS}:263"),
    "K2": ("msm_buckets (incomplete mixed add)", "csrc/msm_buckets.cu", f"{PALLAS_KERNELS}:365"),
    "K3": ("point_add (complete Jacobian)", "csrc/point_add.cu", f"{PALLAS_KERNELS}:414"),
    "K4": ("ntt_stage (radix-2 DIT butterfly)", "csrc/ntt_stage.cu", f"{PALLAS_KERNELS}:454"),
    "K5": ("butterfly_rows (out-of-place butterfly, row layout)", "csrc/butterfly_rows.cu", f"{PALLAS_KERNELS}:121"),
    "K6": ("point_add_planes (complete Jacobian, coordinate planes)", "csrc/point_add_planes.cu",
           f"{PALLAS_KERNELS}:167"),
    "K7": ("msm_buckets complete variant", "csrc/msm_buckets.cu", f"{PALLAS_KERNELS}:227"),
    "K8": ("step_chain (chained incomplete bucket step)", "csrc/step_chain.cu", f"{EXP_STEP_T}:110"),
    "K9": ("op_chain (chained field ops)", "csrc/op_chain.cu", f"{EXP_STEP_T}:210"),
}
PROOF_PATH_KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7")
MICRO_PATH_KERNELS = ("K8", "K9")

GOLDEN_PLACEMENTS = [(3, 3, True), (5, 4, False), (0, 1, False), (0, 5, True), (6, 1, False)]
ROW_FLAGS = ("BZ_ROW_NTT", "BZ_ROW_MSM")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps launches (CUDA events), warmed up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def max_abs_err(a, b) -> int:
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0


def _rand_field(rng: random.Random, modulus: int, n: int, dev):
    from battlezips_halo2_tpu_torch.fields.limb import ints_to_limbs

    edge = [0, 1, modulus - 1, modulus - 2]
    return ints_to_limbs(edge + [rng.randrange(modulus) for _ in range(n - len(edge))], dev)


def _rand_canonical(rng: random.Random, n: int, dev):
    """n random canonical Fp / Fq elements as (n, 8) limbs, made in bulk:
    a top limb below 2^30 keeps every value under 2^254 < p, q."""
    import torch

    gen = torch.Generator().manual_seed(rng.randrange(1 << 62))
    limbs = torch.randint(-(1 << 31), 1 << 31, (n, 8), generator=gen, dtype=torch.int64)
    limbs[:, 7] &= (1 << 30) - 1
    return limbs.to(torch.int32).to(dev)


def check_k1(dev, rng: random.Random, rows: int, time_rows: int) -> dict:
    """K1 against its plain version over Fp and Fq, all three ops; times the
    Montgomery product at the quotient VM's register shape."""
    from battlezips_halo2_tpu_torch.fields import limb as L

    err = 0
    for spec in (L.FP_SPEC, L.FQ_SPEC):
        a, b = _rand_field(rng, spec.modulus, rows, dev), _rand_field(rng, spec.modulus, rows, dev)
        for op in (L.OP_MUL, L.OP_ADD, L.OP_SUB):
            got, want = L.field_op(op, spec, a, b), L.plain_field_op(op, spec, a, b)
            err = max(err, max_abs_err(got, want))
        # broadcast operand (one row), as to_mont / from_mont use it
        got = L.to_mont(spec, a)
        err = max(err, max_abs_err(got, L.plain_field_op(L.OP_MUL, spec, a, spec.const("r2", dev))))
    spec = L.FP_SPEC
    a, b = _rand_field(rng, spec.modulus, time_rows, dev), _rand_field(rng, spec.modulus, time_rows, dev)
    out = a.clone()
    ms = cuda_ms(lambda: L.field_op(L.OP_MUL, spec, a, b, out=out), 200)
    plain = cuda_ms(lambda: L.plain_field_op(L.OP_MUL, spec, a, b), 5)
    bms, by = bound_ms(time_rows * 3 * 32, time_rows * MONT_MUL_RESULTS)
    shape = f"mont_mul over ({time_rows}, 8) Fp"
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by, "shape": shape}


def check_k4(dev, rng: random.Random, sizes, time_batch: int, time_logn: int) -> dict:
    """K4: whole NTTs through the kernel against the same NTT through the
    plain stage; one row against the host NTT. Times one stage launch at
    the quotient's extension shape."""
    import torch

    from battlezips_halo2_tpu_torch.fields import limb as L
    from battlezips_halo2_tpu_torch.fields.host import FP
    from battlezips_halo2_tpu_torch.ops import ntt as D
    from battlezips_halo2_tpu_torch.poly.domain import ntt_host

    spec, p = L.FP_SPEC, FP.modulus
    err = 0
    for batch, logn in sizes:
        n = 1 << logn
        omega = pow(FP.root_of_unity, 1 << (FP.two_adicity - logn), p)
        plan = D.NttPlan(spec, n, omega, dev)
        x = L.to_mont(spec, _rand_field(rng, p, batch * n, dev).view(batch, n, 8))
        got = D.ntt(plan, x)
        want = x.index_select(1, plan.rev_idx)
        for s in range(logn):
            want = D.butterfly_stage_plain(spec, want, plan.stage_twiddles[s], s)
        err = max(err, max_abs_err(got, want))
        row = L.limbs_to_ints(L.from_mont(spec, x[0]))
        if L.limbs_to_ints(L.from_mont(spec, got[0])) != ntt_host(row, omega):
            raise AssertionError(f"K4 NTT disagrees with the host NTT at n = 2^{logn}")
    n = 1 << time_logn
    omega = pow(FP.root_of_unity, 1 << (FP.two_adicity - time_logn), p)
    plan = D.NttPlan(spec, n, omega, dev)
    x = _rand_field(rng, p, time_batch * n, dev).view(time_batch, n, 8)
    stage = time_logn - 1
    tw = plan.stage_twiddles[stage]
    ms = cuda_ms(lambda: D.butterfly_stage(spec, x, tw, stage), 50)
    plain = cuda_ms(lambda: D.butterfly_stage_plain(spec, x, tw, stage), 2)
    nbytes = 2 * time_batch * n * 32 + tw.shape[0] * 32
    bms, by = bound_ms(nbytes, time_batch * (n // 2) * MONT_MUL_RESULTS)
    shape = f"one stage of ({time_batch}, 2^{time_logn}) Fp"
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by, "shape": shape}


def _vesta_points(rng: random.Random, count: int) -> list:
    from battlezips_halo2_tpu_torch.curves.host import VESTA

    base = [VESTA.mul(VESTA.generator, rng.randrange(1, VESTA.scalar.modulus)) for _ in range(16)]
    pts = [base[0]]
    for i in range(1, count):  # cheap distinct points: a running sum of 16 bases
        pts.append(VESTA.add(pts[-1], base[i % 16]))
    return pts


def _point_pairs(dev, rng: random.Random, lanes: int):
    """Jacobian Vesta point pairs (P, Q) with non-trivial Z and identity,
    P == Q (same and different Z) and P == -Q lanes; -> (P, Q, first
    generic lane)."""
    from battlezips_halo2_tpu_torch.curves import limb as C
    from battlezips_halo2_tpu_torch.curves.host import VESTA
    from battlezips_halo2_tpu_torch.fields.limb import FQ_SPEC

    spec = FQ_SPEC
    pts = _vesta_points(rng, lanes)
    P = C.affine_to_jacobian(spec, pts, dev)
    Q = C.affine_to_jacobian(spec, pts[::-1], dev)
    # non-trivial Z: P' = P + P + ... as Jacobian sums of the kernel's own law
    P = C.point_add_plain(spec, P, Q)
    Q = C.point_add_plain(spec, Q, C.affine_to_jacobian(spec, pts[1:] + pts[:1], dev))
    k = lanes // 8
    Q[:k] = P[:k]  # P == Q, same coordinates
    Q[k : 2 * k] = C.point_add_plain(spec, P[k : 2 * k], C.infinity(spec, (k,), dev))  # same point
    neg = C.affine_to_jacobian(spec, [VESTA.neg(p) for p in C.jacobian_to_affine(spec, P[2 * k : 3 * k])], dev)
    Q[2 * k : 3 * k] = neg  # P == -Q
    P[3 * k : 4 * k] = C.infinity(spec, (k,), dev)
    Q[4 * k : 5 * k] = C.infinity(spec, (k,), dev)
    P[5 * k : 5 * k + 8] = C.infinity(spec, (8,), dev)
    Q[5 * k : 5 * k + 8] = C.infinity(spec, (8,), dev)
    return P, Q, 5 * k + 8


def check_k3(dev, rng: random.Random, lanes: int) -> dict:
    """K3 against point_add_plain over random Jacobian points with identity,
    P == Q (same and different Z), P == -Q lanes."""
    import torch

    from battlezips_halo2_tpu_torch.curves import limb as C
    from battlezips_halo2_tpu_torch.curves.host import VESTA
    from battlezips_halo2_tpu_torch.fields.limb import FQ_SPEC

    spec = FQ_SPEC
    P, Q, generic = _point_pairs(dev, rng, lanes)
    got = C.point_add(spec, P, Q)
    err = max_abs_err(got, C.point_add_plain(spec, P, Q))
    want = [VESTA.add(a, b) for a, b in zip(C.jacobian_to_affine(spec, P), C.jacobian_to_affine(spec, Q))]
    if C.jacobian_to_affine(spec, got) != want:
        raise AssertionError("K3 point_add disagrees with the host group law")
    out = torch.empty_like(P)
    R, S = P[generic:].contiguous(), Q[generic:].contiguous()  # generic lanes only
    ms = cuda_ms(lambda: C.point_add(spec, R, S, out=out[: R.shape[0]]), 100)
    plain = cuda_ms(lambda: C.point_add_plain(spec, R, S), 2)
    bms, by = bound_ms(R.shape[0] * 3 * 96, R.shape[0] * 16 * MONT_MUL_RESULTS)
    shape = f"{R.shape[0]} generic lanes, Vesta"
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by, "shape": shape}


def check_k6(dev, rng: random.Random, lanes: int) -> dict:
    """K6 against its plain version and against K3 (coordinate for
    coordinate) on the cases of check_k3, held as coordinate planes, also
    with the output in place of an input; times it at check_k3's shape."""
    import torch

    from battlezips_halo2_tpu_torch.curves import limb as C
    from battlezips_halo2_tpu_torch.fields.limb import FQ_SPEC

    spec = FQ_SPEC
    P, Q, generic = _point_pairs(dev, rng, lanes)
    Pp, Qp = P.movedim(-2, 0).contiguous(), Q.movedim(-2, 0).contiguous()
    got = C.point_add_planes(spec, Pp, Qp)
    err = max(max_abs_err(got, C.point_add_planes_plain(spec, Pp, Qp)),
              max_abs_err(got.movedim(0, -2), C.point_add(spec, P, Q)))
    into = Pp.clone()  # out aliasing p, as the aggregation runs it
    C.point_add_planes(spec, into, Qp, out=into)
    err = max(err, max_abs_err(into, got))
    R, S = Pp[:, generic:].contiguous(), Qp[:, generic:].contiguous()
    out = torch.empty_like(R)
    ms = cuda_ms(lambda: C.point_add_planes(spec, R, S, out=out), 100)
    plain = cuda_ms(lambda: C.point_add_planes_plain(spec, R, S), 2)
    bms, by = bound_ms(R.shape[1] * 3 * 96, R.shape[1] * 16 * MONT_MUL_RESULTS)
    shape = f"{R.shape[1]} generic lanes as (3, lanes, 8) planes, Vesta"
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by, "shape": shape}


def check_k5(dev, rng: random.Random, sizes, time_batch: int, time_logn: int) -> dict:
    """K5: whole NTTs through the row route (BZ_ROW_NTT) against the same NTT
    through K4 and, for one row, the host NTT; then one stage's operands at
    the shape (time_batch, 2^time_logn) against the plain version, timed."""
    import torch

    from battlezips_halo2_tpu_torch.fields import limb as L
    from battlezips_halo2_tpu_torch.fields.host import FP
    from battlezips_halo2_tpu_torch.ops import ntt as D
    from battlezips_halo2_tpu_torch.poly.domain import ntt_host

    spec, p = L.FP_SPEC, FP.modulus
    err = 0
    for batch, logn in sizes:
        n = 1 << logn
        omega = pow(FP.root_of_unity, 1 << (FP.two_adicity - logn), p)
        plan = D.NttPlan(spec, n, omega, dev)
        x = L.to_mont(spec, _rand_field(rng, p, batch * n, dev).view(batch, n, 8))
        want = D.ntt(plan, x)
        os.environ["BZ_ROW_NTT"] = "1"
        try:
            got = D.ntt(plan, x)
        finally:
            os.environ.pop("BZ_ROW_NTT")
        err = max(err, max_abs_err(got, want))
        row = L.limbs_to_ints(L.from_mont(spec, x[0]))
        if L.limbs_to_ints(L.from_mont(spec, got[0])) != ntt_host(row, omega):
            raise AssertionError(f"K5 row NTT disagrees with the host NTT at n = 2^{logn}")
    n = 1 << time_logn
    omega = pow(FP.root_of_unity, 1 << (FP.two_adicity - time_logn), p)
    idx_u, idx_v, _, tw = D.NttPlan(spec, n, omega, dev).row_tables()[time_logn - 1]
    x = _rand_canonical(rng, time_batch * n, dev).view(time_batch, n, 8)
    u, v = x.index_select(1, idx_u), x.index_select(1, idx_v)
    got = D.butterfly_rows(spec, u, v, tw)
    want = D.butterfly_rows_plain(spec, u, v, tw)
    err = max(err, max_abs_err(got[0], want[0]), max_abs_err(got[1], want[1]))
    ms = cuda_ms(lambda: D.butterfly_rows(spec, u, v, tw), 50)
    plain = cuda_ms(lambda: D.butterfly_rows_plain(spec, u, v, tw), 2)
    pairs = time_batch * (n // 2)
    bms, by = bound_ms(4 * pairs * 32 + tw.shape[0] * 32, pairs * MONT_MUL_RESULTS)
    shape = f"one stage of ({time_batch}, 2^{time_logn}) Fp: u, v ({time_batch}, 2^{time_logn - 1}, 8)"
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by, "shape": shape}


def check_k2_k7(dev, rng: random.Random, n_points: int, batch: int) -> tuple[dict, dict]:
    """K2 and K7 against bucket_sums_plain, on hand-made runs with identity
    points, P then P, and P then -P, and on the bucket runs of a batch of
    random MSMs over n_points SRS-like points (the commitment shape)."""
    import torch

    from battlezips_halo2_tpu_torch.curves import limb as C
    from battlezips_halo2_tpu_torch.curves.host import VESTA
    from battlezips_halo2_tpu_torch.fields.limb import FQ_SPEC, ints_to_limbs
    from battlezips_halo2_tpu_torch.ops import msm as M

    spec = FQ_SPEC
    pts = _vesta_points(rng, n_points)
    table = C.affine_table(spec, pts + [None] + [VESTA.neg(p) for p in pts[:64]], dev)
    ident, negs = n_points, n_points + 1
    src, starts = [], [0]
    for b in range(4096):
        kind, length = b % 8, rng.randrange(0, 7)
        run = [rng.randrange(n_points) for _ in range(length)]
        if kind == 1 and run:
            run.insert(1, run[0])  # P then P: the incomplete law's collision
        elif kind == 2 and run:
            j = rng.randrange(64)
            run[0:0] = [j, negs + j]  # P then -P
        elif kind == 3:
            run.insert(rng.randrange(len(run) + 1), ident)  # identity inside a run
        elif kind == 4:
            run = [ident] + run  # identity at the head
        src += run
        starts.append(len(src))
    src_t = torch.tensor(src, dtype=torch.int32, device=dev)
    starts_t = torch.tensor(starts, dtype=torch.int32, device=dev)
    errs, rows = {}, {}
    for name, complete in (("K2", False), ("K7", True)):
        out, flags = M.bucket_sums(spec, table, src_t, starts_t, complete)
        want, want_flags = M.bucket_sums_plain(spec, table, src_t, starts_t, complete)
        errs[name] = max(max_abs_err(out, want), max_abs_err(flags, want_flags))
        if complete:
            exp = []
            for b in range(len(starts) - 1):
                acc = None
                for i in src[starts[b] : starts[b + 1]]:
                    acc = VESTA.add(acc, None if i == ident else (pts[i] if i < ident else VESTA.neg(pts[i - negs])))
                exp.append(acc)
            if C.jacobian_to_affine(spec, out) != exp:
                raise AssertionError("K7 bucket sums disagree with the host group law")
        elif int(flags.sum()) == 0:
            raise AssertionError("K2 raised no collision flag on P then P runs")
    # the commitment shape: a batch of random scalar vectors over the points
    scalars = ints_to_limbs([rng.randrange(VESTA.scalar.modulus) for _ in range(batch * n_points)], dev)
    c, signed = M.auto_window(n_points)
    tab, src_t, starts_t, _ = M.bucket_runs(
        spec, table[:n_points].contiguous(), scalars.view(batch, n_points, 8), c, signed
    )
    live_rows = int(starts_t[-1])
    nb = starts_t.shape[0] - 1
    for name, complete in (("K2", False), ("K7", True)):
        out, flags = M.bucket_sums(spec, tab, src_t, starts_t, complete)
        want, want_flags = M.bucket_sums_plain(spec, tab, src_t, starts_t, complete)
        errs[name] = max(errs[name], max_abs_err(out, want), max_abs_err(flags, want_flags))
        ms = cuda_ms(lambda: M.bucket_sums(spec, tab, src_t, starts_t, complete), 20)
        plain = cuda_ms(lambda: M.bucket_sums_plain(spec, tab, src_t, starts_t, complete), 1)
        adds = live_rows - int((starts_t[1:] > starts_t[:-1]).sum())  # rows after each head
        nbytes = live_rows * (64 + 4) + nb * (4 + 96 + 4)
        bms, by = bound_ms(nbytes, adds * (11 if not complete else 12) * MONT_MUL_RESULTS)
        shape = f"{batch} MSMs x {n_points} points, c = {c}: {nb} buckets, {live_rows} rows"
        rows[name] = {
            "max_abs_err": errs[name], "ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by, "shape": shape
        }
    return rows["K2"], rows["K7"]


class Phases:
    """Runs the main path's phases: wall seconds (ending in a device
    synchronize) and kernel launch deltas of each."""

    def __init__(self):
        self.seconds, self.launches = {}, {}

    def __call__(self, name, fn):
        import torch

        from battlezips_halo2_tpu_torch.ops import cuda

        before = dict(cuda.launches)
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        self.seconds[name] = time.time() - t
        self.launches[name] = {k: cuda.launches[k] - before[k] for k in before}
        log(f"phase {name}: {self.seconds[name]:.3f} s, launches {self.launches[name]}")
        return out


def _tampered(proof: bytes) -> bytes:
    mid = len(proof) // 2
    return proof[:mid] + bytes([proof[mid] ^ 1]) + proof[mid + 1 :]


def run_shot(dev, timed: Phases) -> None:
    """The shot circuit (k = 11) through the public API."""
    from battlezips_halo2_tpu_torch import api
    from battlezips_halo2_tpu_torch.utils import Board, Deck

    golden = json.loads(GOLDEN.read_text())
    board = Board.from_deck(Deck.from_placements(GOLDEN_PLACEMENTS))
    params, pk = timed("shot keys (Params.new(11) + keygen)", lambda: api.shot_keys(dev))
    os.environ["BZ_TORCH_TRACE"] = "1"
    try:
        proof = timed(
            "prove_shot (golden rng, first proof)",
            lambda: api.prove_shot(board.state(), 0xBEEF, (3, 3), True, rng=random.Random(golden["seed"]), device=dev),
        )
    finally:
        os.environ.pop("BZ_TORCH_TRACE")
    if proof.proof.hex() != golden["proof_hex"]:
        raise AssertionError("shot proof bytes differ from tests/golden/shot_k11.json")
    want_instance = [[int(v, 16) for v in col] for col in golden["instance"]]
    if [[proof.commitment[0], proof.commitment[1], proof.shot, proof.hit]] != want_instance:
        raise AssertionError("shot instance differs from the golden vector")
    if hex(pk.vk.digest) != golden["vk_digest"]:
        raise AssertionError("shot vk digest differs from the golden vector")
    log(f"golden shot proof bytes equal ({len(proof.proof)} bytes), vk digest equal")
    if not timed("verify_shot", lambda: api.verify_shot(proof, device=dev)):
        raise AssertionError("verify_shot rejected the golden proof")
    tampered = api.ShotProof(proof.commitment, proof.shot, proof.hit, _tampered(proof.proof))
    if timed("verify_shot (tampered)", lambda: api.verify_shot(tampered, device=dev)):
        raise AssertionError("verify_shot accepted a tampered proof")
    second = timed(
        "prove_shot (fresh rng, steady state)",
        lambda: api.prove_shot(board.state(), 0xBEEF, (3, 3), True, rng=random.Random(8), device=dev),
    )
    if not timed("verify_shot (fresh proof)", lambda: api.verify_shot(second, device=dev)):
        raise AssertionError("verify_shot rejected a fresh proof")


def run_board(dev, timed: Phases, tag: str) -> None:
    """The board circuit (k = 12) through the public API, in the
    configuration the environment selects (``tag`` names it)."""
    from battlezips_halo2_tpu_torch import api

    golden = json.loads(GOLDEN_BOARD.read_text())
    params, pk = timed(f"board keys (Params.new(12) + keygen) [{tag}]", lambda: api.board_keys(dev))
    if hex(pk.vk.digest) != golden["vk_digest"]:
        raise AssertionError("board vk digest differs from tests/golden/board_k12.json")
    os.environ["BZ_TORCH_TRACE"] = "1"
    try:
        proof = timed(
            f"prove_board (golden rng, first proof) [{tag}]",
            lambda: api.prove_board(GOLDEN_PLACEMENTS, 0xBEEF, rng=random.Random(golden["seed"]), device=dev),
        )
    finally:
        os.environ.pop("BZ_TORCH_TRACE")
    if proof.proof.hex() != golden["proof_hex"]:
        raise AssertionError(f"board proof bytes differ from tests/golden/board_k12.json [{tag}]")
    if [list(proof.commitment)] != [[int(v, 16) for v in col] for col in golden["instance"]]:
        raise AssertionError(f"board instance differs from the golden vector [{tag}]")
    log(f"golden board proof bytes equal ({len(proof.proof)} bytes), instance and vk digest equal [{tag}]")
    if not timed(f"verify_board [{tag}]", lambda: api.verify_board(proof, device=dev)):
        raise AssertionError(f"verify_board rejected the golden proof [{tag}]")
    tampered = api.BoardProof(proof.commitment, _tampered(proof.proof))
    if timed(f"verify_board (tampered) [{tag}]", lambda: api.verify_board(tampered, device=dev)):
        raise AssertionError(f"verify_board accepted a tampered proof [{tag}]")
    second = timed(
        f"prove_board (fresh rng, steady state) [{tag}]",
        lambda: api.prove_board(GOLDEN_PLACEMENTS, 0xBEEF, rng=random.Random(8), device=dev),
    )
    if not timed(f"verify_board (fresh proof) [{tag}]", lambda: api.verify_board(second, device=dev)):
        raise AssertionError(f"verify_board rejected a fresh proof [{tag}]")


def run_board_rows(dev, timed: Phases) -> dict:
    """run_board under BZ_ROW_NTT=1 BZ_ROW_MSM=1; -> its launch deltas,
    which must show K5, K6 and K7 and no K2, K3 or K4."""
    from battlezips_halo2_tpu_torch.ops import cuda

    before = dict(cuda.launches)
    for flag in ROW_FLAGS:
        os.environ[flag] = "1"
    try:
        run_board(dev, timed, "row")
    finally:
        for flag in ROW_FLAGS:
            os.environ.pop(flag)
    delta = {k: cuda.launches[k] - before[k] for k in before}
    log(f"row configuration launches: {delta}")
    if min(delta["K5"], delta["K6"], delta["K7"]) <= 0 or delta["K2"] or delta["K3"] or delta["K4"]:
        raise AssertionError(f"the row configuration took the wrong kernels: {delta}")
    return delta


def _session_bytes(session) -> list:
    return [p.proof for p in session.board_proofs + session.shot_proofs]


def run_sessions(dev, timed: Phases) -> dict:
    """One game of four shots through api.prove_session: sequential, batched
    (the batch prover), batched with two workers (two sub-batches of two
    shots), batched with the per-proof tail on two threads
    (BZ_BATCH_TAIL_WORKERS=2), and sequential with dp_devices=1 (the first
    card). Every run must give the sequential run's bytes, and
    verify_session must accept each. -> the session launches, by run."""
    import torch

    from battlezips_halo2_tpu_torch import api

    if api._dp_devices(1) != [torch.device("cuda", 0)]:
        raise AssertionError(f"dp_devices=1 resolved to {api._dp_devices(1)}, not the first card")
    runs = {  # tag: (prove_session options, environment for the run)
        "sequential": (dict(batched=False, workers=1), {}),
        "batched": (dict(batched=True, workers=1), {"BZ_TORCH_TRACE": "1"}),  # the batch prover's spans
        "batched, workers=2": (dict(batched=True, workers=2), {}),
        "batched, tail workers=2": (dict(batched=True, workers=1), {"BZ_BATCH_TAIL_WORKERS": "2"}),
        "dp_devices=1": (dict(batched=False, workers=1, dp_devices=1), {}),
    }
    want, launches = None, {}
    for tag, (opts, env) in runs.items():
        name = f"prove_session (1 game, 4 shots, {tag})"
        os.environ.update(env)
        try:
            session = timed(name, lambda: api.prove_session(
                [GOLDEN_PLACEMENTS], shots_per_game=4, trapdoors=[0xBEEF], seed=5, device=dev, **opts))
        finally:
            for key in env:
                os.environ.pop(key)
        launches[tag] = timed.launches[name]
        if (len(session.board_proofs), len(session.shot_proofs)) != (1, 4):
            raise AssertionError(f"prove_session made the wrong number of proofs [{tag}]")
        want = want or _session_bytes(session)
        if _session_bytes(session) != want:
            raise AssertionError(f"session proofs differ from the sequential session's [{tag}]")
        if not timed(f"verify_session [{tag}]", lambda: api.verify_session(session, device=dev)):
            raise AssertionError(f"verify_session rejected the session [{tag}]")
    log(f"session bytes equal across {', '.join(runs)}")
    return launches


def run_main_path(dev) -> tuple[Phases, dict, dict]:
    timed = Phases()
    run_shot(dev, timed)
    run_board(dev, timed, "default")
    rows = run_board_rows(dev, timed)
    sessions = run_sessions(dev, timed)
    return timed, rows, sessions


def _load_microbenchmark():
    import importlib.util

    spec = importlib.util.spec_from_file_location("torch_exp_step_t", MICROBENCHMARK)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_microbenchmark(dev) -> tuple[dict, dict]:
    """The K8 / K9 path: tools/torch_exp_step_t.py at the reference's
    shapes, every K9 op. The tool holds each kernel bit for bit against its
    plain chain and times both. -> rows for K8 and K9."""
    from battlezips_halo2_tpu_torch.fields.limb import CHAIN_OPS

    micro = _load_microbenchmark()
    cfg = micro.settings()
    chain = micro.run_chain(dev, cfg["n"], cfg["steps"])
    kmicro = micro.run_kmicro(dev, cfg["n"], cfg["reps"], list(CHAIN_OPS))
    n, steps, reps = chain["n"], chain["steps"], kmicro["reps"]
    bms, by = bound_ms(n * (96 + 96 + 64) + steps * n, chain["additions"] * 11 * MONT_MUL_RESULTS)
    k8 = {
        "max_abs_err": chain["max_abs_err"], "ms": chain["one_launch"]["ms"], "plain_ms": chain["plain_ms"],
        "bound_ms": bms, "bound_by": by, "ms_launch_per_step": chain["launch_per_step"]["ms"],
        "shape": f"{n} lanes x {steps} steps, Vesta, {chain['additions']} additions; one launch",
    }
    op_results = {"mul": MONT_MUL_RESULTS, "redc": MONT_MUL_RESULTS - 128, **CHAIN_OP_RESULTS}
    per_op = {}
    for op, r in kmicro["ops"].items():
        obms, oby = bound_ms(n * 3 * 32, n * reps * op_results[op])
        per_op[op] = {"ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": obms, "bound_by": oby,
                      "max_abs_err": r["max_abs_err"]}
    mul = per_op["mul"]
    k9 = {
        "max_abs_err": max(r["max_abs_err"] for r in per_op.values()), "ms": mul["ms"], "plain_ms": mul["plain_ms"],
        "bound_ms": mul["bound_ms"], "bound_by": mul["bound_by"], "per_op": per_op,
        "shape": f"mul x {reps} over {n} Fq elements (per_op: every op)",
    }
    return k8, k9


def card_int_rate() -> tuple[float, int, float]:
    """(32-bit integer results per second, SMs, max SM clock in Hz): 64 per
    SM per clock times the SMs times nvidia-smi's clocks.max.sm."""
    import torch

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    clock = float(out.stdout.strip().splitlines()[0]) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT_RESULTS_PER_SM_CLOCK * sms * clock, sms, clock


def _sass_multiplies(sass: str, function: str) -> tuple[int, int]:
    """(multiply instructions, 32-bit results) of one function's SASS:
    IMAD.WIDE is a 64-bit product (two results), IMAD.HI and IMAD one;
    IMAD.X (add with carry), IMAD.MOV, IMAD.SHL and IMAD.IADD multiply
    nothing."""
    import re

    body = sass.split(f"Function : {function}", 1)[1].split("Function : ", 1)[0]
    instrs = results = 0
    for op in re.findall(r"\b(IMAD(?:\.[A-Z0-9]+)*)\b", body):
        if op.startswith("IMAD.WIDE"):
            instrs, results = instrs + 1, results + 2
        elif op == "IMAD" or op.startswith("IMAD.HI"):
            instrs, results = instrs + 1, results + 1
    return instrs, results


def sass_mont_mul(lib: Path) -> tuple[int, int]:
    """Multiply instructions and results of one Montgomery product in the
    built library: K1's multiply kernel minus its add kernel, which share
    every instruction but the product's."""
    from battlezips_halo2_tpu_torch.ops import cuda

    cuobjdump = Path(cuda._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    mul = _sass_multiplies(sass, "_Z15field_op_kernelILi0EEv11FieldConstsPKjS2_Pjxx")
    add = _sass_multiplies(sass, "_Z15field_op_kernelILi1EEv11FieldConstsPKjS2_Pjxx")
    return mul[0] - add[0], mul[1] - add[1]


def report_rows(rows: dict) -> None:
    for name, r in rows.items():
        log(f"  {name} {r['shape']}: max_abs_err {r['max_abs_err']}, kernel {r['ms']:.4f} ms, "
            f"plain {r['plain_ms']:.3f} ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']})")
        if r["max_abs_err"] != 0:
            raise AssertionError(f"{name} disagrees with its plain version")


def card_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=False, timeout=60,
        )
    except OSError as e:
        return f"nvidia-smi: {e}"
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else f"nvidia-smi: exit {out.returncode}"


def main() -> int:
    if not PACKAGE.is_dir() or not GOLDEN.is_file() or not GOLDEN_BOARD.is_file():
        print("chip_smoke: run from the root of a battlezips checkout", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from battlezips_halo2_tpu_torch.ops import cuda

    dev = torch.device("cuda")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t = time.time()
    lib = cuda.build()
    cuda.library()
    log(f"phase build: {time.time() - t:.3f} s ({lib})")
    entry = None
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "Used" in line and "registers" in line and entry:
            log(f"  ptxas {entry}: {line.split(':', 1)[1].strip()}")

    global OPS_PER_S, MONT_MUL_RESULTS
    OPS_PER_S, sms, clock = card_int_rate()
    instrs, MONT_MUL_RESULTS = sass_mont_mul(lib)
    log(f"operations bound: {INT_RESULTS_PER_SM_CLOCK} results/SM/clock x {sms} SMs x {clock / 1e6:.0f} MHz = "
        f"{OPS_PER_S:.4g}/s; Montgomery product in SASS: {instrs} multiply instructions "
        f"(CIOS count {MAD_PER_MONT_MUL}), {MONT_MUL_RESULTS} results")

    rng = random.Random(2024)
    t = time.time()
    rows = {"K1": check_k1(dev, rng, 1 << 13, 1 << 14)}
    rows["K4"] = check_k4(dev, rng, [(4, 11), (2, 13)], 44, 14)
    rows["K3"] = check_k3(dev, rng, 4096)
    rows["K2"], rows["K7"] = check_k2_k7(dev, rng, 2049, 11)
    rows["K6"] = check_k6(dev, rng, 4096)
    log(f"phase kernels vs plain: {time.time() - t:.3f} s")
    report_rows(rows)

    # the proof path: K1-K7
    cuda.reset_launches()
    timed, row_launches, session_launches = run_main_path(dev)
    launches = dict(cuda.launches)
    log(f"proof path launches: {launches}")
    missing = [k for k in PROOF_PATH_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the proof path: {missing}")

    # K5 at the board's own extended-domain shape: every polynomial the
    # quotient extends, at the vk's extended domain
    from battlezips_halo2_tpu_torch import api
    from battlezips_halo2_tpu_torch.ops.gate_eval import quotient_poly_keys
    from battlezips_halo2_tpu_torch.plonk.arguments import ProofSchedule

    vk = api.board_keys(dev)[1].vk
    batch = len(quotient_poly_keys(vk.cs, ProofSchedule.build(vk.cs).num_perm_chunks))
    rows["K5"] = check_k5(dev, rng, [(4, 11), (2, 13)], batch, vk.domain.extended_n.bit_length() - 1)
    report_rows({"K5": rows["K5"]})

    # the microbenchmark path: K8 and K9
    cuda.reset_launches()
    t = time.time()
    rows["K8"], rows["K9"] = run_microbenchmark(dev)
    log(f"phase microbenchmark (tools/torch_exp_step_t.py): {time.time() - t:.3f} s")
    for name in MICRO_PATH_KERNELS:
        launches[name] = cuda.launches[name]
    log(f"microbenchmark path launches: { {k: cuda.launches[k] for k in MICRO_PATH_KERNELS} }")
    missing = [k for k in MICRO_PATH_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the microbenchmark path: {missing}")
    report_rows({"K8": rows["K8"], "K9": rows["K9"]})

    kernels = []
    for name, (fn, src, replaces) in KERNELS.items():
        r = rows[name]
        extra = {k: r[k] for k in ("ms_launch_per_step", "per_op") if k in r}
        kernels.append({
            "name": f"{name} {fn}", "route": "cuda", "source": f"battlezips_halo2_tpu_torch/{src}",
            "replaces": replaces, "launches": launches[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None, "shape": r["shape"], **extra,
        })
    print(json.dumps({"kernels": kernels, "phases_s": timed.seconds, "row_configuration_launches": row_launches,
                      "session_launches": session_launches, "ops_per_s": OPS_PER_S,
                      "mont_mul_results": MONT_MUL_RESULTS}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
