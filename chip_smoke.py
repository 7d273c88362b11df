#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port (battlezips_halo2_tpu_torch) on one
NVIDIA card.

    python3 chip_smoke.py

from the root of a checkout. In order, it

1. builds the CUDA kernels of ``battlezips_halo2_tpu_torch/csrc`` with nvcc
   and, beside them, the old build (``csrc/previous/``: K1's elementwise
   and K3's and K6's lane-wise kernels before their redesign, on the 64-bit
   product), and reads the card's integer multiply rate (SMs, maximum SM
   clock) and the multiplies of one Montgomery product, 64-bit and carry
   chain (SASS of the built libraries), for the operations bounds;
1b. drives the serving path (``run_serving``), its counts set to 0 before it
   and read after: with no port artifact yet (``.artifacts/torch/``), a
   cold ``tools/torch_serve.py --bench-cold`` (a fresh server process
   derives the SRS and keys and writes them) and a warm one (it loads them;
   no file is rewritten), then the server in this process (keys loaded
   from the files, vk digests equal to the golden ones): a shot, a board, a
   batched session of one game and two shots, verify_board on a good and a
   tampered proof, and status, under ``BZ_PROOF_ENGINE=device`` and then
   ``auto``, twice each; every returned proof verifies here, the tampered
   one is refused, a board proof launches K1, K2, K3, K4 and K7 under
   device and nothing under auto. It prints cold-to-ready, cold-to-first-
   proof, warm-to-ready, each op's seconds and launches on each engine and
   each artifact's size. The main path below then proves on keys loaded
   afresh from those files, so its golden bytes are the full-size check of
   persistence;
2. holds K1-K4, K6 and K7 bit-exact (tolerance 0) against their plain
   PyTorch versions on the same CUDA tensors, including the identity,
   P == Q and P == -Q cases of the point kernels, and times both. K2 and
   K7 (the bucket pass: equal chunks, then a complete merge of the runs
   that cross a chunk boundary) are held against their plain version at
   the kernel's chunk length, in Jacobian coordinates and flags, and on
   affine points against the host group law: hand-made runs (P then P
   inside a chunk and across a chunk boundary), all-equal scalars, the
   board's commit batch, an IPA round and the IPA's 3-point MSM. K3's
   window kernel and K6's (the same body on coordinate planes) are held,
   on affine points, against their plain versions at the proof path's
   shapes (a board commitment's 32 and 352 rows of 256 buckets, an IPA
   round's 2 rows of 4, signed c = 10's 104 rows of 513), and timed beside
   the old route (the two-level running sums, one lane-wise K3, or K6,
   launch per addition). K3's lane-wise addition (1528 generic lanes) is
   timed beside the old build's, and its fold (``bz_point_fold``) is held
   against its plain version and the old route (D - 1 launches of the old
   build's addition) coordinate for coordinate at D = 2, 3, 4 with the
   special cases, and timed against that old route at D = 2 and 4 over a
   board commit batch's 352 lanes, and at D = 4 for each block size. K6's
   lane-wise addition (coordinate planes, csrc/point_add.cu) is held
   against its plain version, K3's and the old build's, and timed beside
   the old build's in turns at 1528, 1 and 2^17 generic lanes. The
   launch-bound rows (K4, K5, the lane-wise K3 and K6, K7's 3-point MSM,
   and elementwise K1 below) are timed with the card setting the pace
   (``ops/timing.py::device_paced_ms``), the host-paced time or the old
   build's beside each;
3. drives the port's proof path through its public API, reading the
   kernels' launch counts around every phase:

   - the shot circuit (k = 11): keys (from the artifact store), ``api.prove_shot`` with
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

   K1-K7 must each have launched on this path. In the default
   configuration every phase must launch K3 exactly as often as K2 and K7
   together (one window aggregation per bucket pass), in the row
   configuration K6 exactly as often as K7, and a steady proof
   at most 7 K1 (the quotient program in one launch, one elementwise scale
   per commitment batch's iNTT and two for the quotient's extensions); the
   steady proofs also print their spans (``BZ_TORCH_TRACE=1``);
3b. the native engine phase (``run_native_engine``), its counts set to 0
   before it and read after: builds the native host library with g++ and
   prints the command and the build time; proves the golden shot and board
   under ``BZ_PROOF_ENGINE=auto`` (golden bytes, no kernel launched,
   accepted under auto and device, a tampered copy refused); times steady
   shot and board proofs and board verifies under device and auto in
   turns; proves the same session batched under the reference's hybrid
   (``BZ_BATCH_ENGINE=device BZ_PROOF_ENGINE=auto``: K1-K4, no K7, K3 as
   often as K2), also with two tail workers, under ``BZ_BATCH_ENGINE=host``
   and sequentially under auto (no kernel launched), each with the device
   routes' bytes and verified; profiles the hybrid session
   (``tools/torch_profile_shot.py``'s ``profiled``) for its device idle
   share, and times the IPA's 3-point MSM on K7 and natively. Every time
   prints beside the card's name and power limit;
3c. the parallel phase (``run_parallel``), on a mesh of one shard a
   card, or of two shards on ``cuda:0`` when one card is visible (the
   mesh is printed on a line of its own): the golden board proof under ``use_mesh`` in the default and
   the row configuration (golden bytes, accepted, a tampered copy
   refused; a steady sharded proof beside a one-card one, equal bytes;
   device busy per card of each through ``tools/torch_profile_shot.py``),
   the board domain's four basis transforms (n = 2^12 and 2^15) and an
   11-column commit batch over its [G | W] sharded against the unsharded
   kernels, bit for bit. It counts the launches of each configuration's
   steady sharded proof from 0 (the ``parallel_launches`` of the kernels
   line) and holds them against a one-card proof's: K3's fold must add
   the partials in one launch a commit batch (no lane-wise addition), K2
   never launch in the sharded commitments, and the
   NTT stages must grow; no transform may be refused by the NTT's shape
   gate. With two cards visible it also runs
   ``tools/torch_multihost_ntt.py --procs 2`` over NCCL; with one it says
   so and runs nothing in its place. Every time prints beside the card's
   name and power limit;
4. holds K5 bit-exact against its plain version at the board's own
   extended-domain shape (read from the board's vk), and times it; holds
   K1's VM kernel bit-exact against the plain executor on the card (one
   elementwise K1 launch per instruction, the old route) and against its
   plain version, on the board's program and keys (one proof) and the
   shot's (four proofs), and times all three; holds K1's elementwise
   kernel bit-exact against its plain version (Fp and Fq, every op, b
   broadcast) and, at the board's shapes (the quotient's extension batch
   (K, 2^15, 8) by its coset vector, the unpadded (K, 2^12, 8), h's
   (1, 2^15, 8), a commit batch's (11, 2^12, 8) by one row, and the
   (16384, 8) of earlier runs), checks and times the product device-paced
   beside the old build's in turns, with its bytes bound and the share of
   it, and at the first shape each block size;
5. drives the microbenchmark path, ``tools/torch_exp_step_t.py`` at the
   reference's shapes, which holds K8 (one launch, and one launch per
   step) and K9 (every op) bit-exact against their plain chains and times
   them with the card setting the pace (the host-paced times beside), and
   K9's raw and noop as their one PyTorch call; K8 and K9 must each have
   launched on this path;
5b. the matrix-product NTT (``ops/ntt_mm.py``, ``BZ_NTT_MM=on``), its
   counts set to 0 before it and read after: the golden board proof under
   ``BZ_NTT_MM=on`` (bytes must equal ``tests/golden/board_k12.json``,
   accepted, then a steady proof), which must launch M1
   (``csrc/fp_matmul.cu``) and no K4 or K5; then M1 held bit-exact against
   its plain version (a batch by a (12, 16) matrix in Montgomery form and
   as given, the all-(p - 1) matrix, the (17, 2^15) batch's row product)
   and timed at both products of that NTT, and the NTT held bit-exact
   against the K4 route at n = 2^16, 2^18, 2^20 and the (17, 2^15) batch,
   both timed device-paced in turns;
6. prints the script's total seconds, a JSON line of per-kernel numbers,
   the card's name and power limit, and last ``{"ok": true, "device":
   {...}}``.

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PACKAGE = ROOT / "battlezips_halo2_tpu_torch"
GOLDEN = ROOT / "tests" / "golden" / "shot_k11.json"
GOLDEN_BOARD = ROOT / "tests" / "golden" / "board_k12.json"
PALLAS_KERNELS = "battlezips_halo2_tpu/ops/pallas_kernels.py"
EXP_STEP_T = "tools/exp_step_t.py"
MICROBENCHMARK = ROOT / "tools" / "torch_exp_step_t.py"
SERVER = ROOT / "tools" / "torch_serve.py"
PREVIOUS = PACKAGE / "csrc" / "previous"  # K1 elementwise, K3 and K6 lane-wise before their redesign
T_START = time.time()

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
MONT_MUL_RESULTS = None  # multiply results of one Montgomery product (the 64-bit one of K2-K7)
CC_MONT_MUL_RESULTS = None  # the same of the carry-chain product (K1 elementwise, K3 lane-wise)
# per element of K9's ops, beside mul: redc is mul without the 64 wide
# a * b products; add and sub are 8 limb adds, 8 limb subtracts and 8
# selects; raw is 8 limb adds; noop does nothing
CHAIN_OP_RESULTS = {"add": 24, "sub": 24, "raw": 8, "noop": 0}
WIDE_PRODUCT_RESULTS = 2 * 8 * 8  # the 64 32 x 32 -> 64-bit limb products of a * b
# the reference's exact matrix product splits W R and a into 32 8-bit chunk
# planes each; on the H100 those pairs would run on the int8 tensor cores,
# 1,979e12 operations a second dense at 700 W (NVIDIA's data sheet)
REFERENCE_CHUNK_PAIRS = 32 * 32
INT8_MMA_OPS_PER_S = 1.979e15

KERNELS = {
    "K1": ("quotient_vm (the quotient program in one launch; elementwise field_op beside it)",
           "csrc/quotient_vm.cu", f"{PALLAS_KERNELS}:263"),
    "K2": ("msm_buckets (chunked walk, incomplete mixed add; boundary merge)", "csrc/msm_buckets.cu",
           f"{PALLAS_KERNELS}:365"),
    "K3": ("window_sums (window aggregation in one launch; lane-wise point_add beside it)",
           "csrc/window_sums.cu", f"{PALLAS_KERNELS}:414"),
    "K4": ("ntt_stage (radix-2 DIT butterfly)", "csrc/ntt_stage.cu", f"{PALLAS_KERNELS}:454"),
    "K5": ("butterfly_rows (out-of-place butterfly, row layout)", "csrc/butterfly_rows.cu", f"{PALLAS_KERNELS}:121"),
    "K6": ("window_sums_planes (window aggregation in one launch, coordinate planes; lane-wise point_add_planes "
           "beside it, csrc/point_add.cu)", "csrc/point_add_planes.cu", f"{PALLAS_KERNELS}:167"),
    "K7": ("msm_buckets complete variant", "csrc/msm_buckets.cu", f"{PALLAS_KERNELS}:227"),
    "K8": ("step_chain (chained incomplete bucket step)", "csrc/step_chain.cu", f"{EXP_STEP_T}:110"),
    "K9": ("op_chain (chained field ops)", "csrc/op_chain.cu", f"{EXP_STEP_T}:210"),
    # no Pallas kernel: the reference's constant Fp matrix product on the MXU
    "M1": ("fp_const_matmul (the matrix-product NTT's constant Fp matrix product, BZ_NTT_MM=on)", "csrc/fp_matmul.cu",
           "battlezips_halo2_tpu/ops/ntt_mm.py:108"),
}
PROOF_PATH_KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7")
# the kernels of a sharded board proof, per configuration
PARALLEL_PATH_KERNELS = {"default": ("K1", "K3", "K4", "K7"), "row": ("K5", "K6", "K7")}
MICRO_PATH_KERNELS = ("K8", "K9")
NTT_MM_PATH_KERNELS = ("M1",)  # a board proof under BZ_NTT_MM=on

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


def paced(fn, reps: int) -> tuple[float, float]:
    """(device-paced, host-paced) mean ms of fn() over reps calls
    (battlezips_halo2_tpu_torch/ops/timing.py): the first with the card
    setting the pace, the second with the host's launch loop setting it."""
    from battlezips_halo2_tpu_torch.ops.timing import device_paced_ms, host_paced_ms

    return device_paced_ms(fn, reps), host_paced_ms(fn, reps)


def once_ms(fn):
    """(fn(), device time of that one call in ms): for plain versions that
    take seconds."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


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


def build_previous() -> Path:
    """The old build: K1's elementwise and K3's and K6's lane-wise kernels
    as they were before their redesign (``csrc/previous/*.cu``, the 64-bit
    product), beside copies of ``csrc/field.cuh`` and
    ``csrc/window_body.cuh``, built apart from the port's library; -> the
    library's path."""
    import shutil

    from battlezips_halo2_tpu_torch.ops import cuda

    dst = cuda.BUILD_ROOT / "copies" / "previous"
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    for src in sorted(PREVIOUS.glob("*.cu")) + [cuda.CSRC / "field.cuh", cuda.CSRC / "window_body.cuh"]:
        shutil.copy(src, dst / src.name)
    return cuda.build(dst)


def load_previous(path: Path):
    """The old build, bound: its bz_field_op, bz_point_add and
    bz_point_add_planes take no block size."""
    import ctypes

    from battlezips_halo2_tpu_torch.ops import cuda

    lib = cuda.load(path)
    p, i64 = ctypes.c_void_p, ctypes.c_longlong
    lib.bz_field_op.argtypes = (ctypes.c_int, p, p, p, p, i64, i64, p)
    lib.bz_point_add.argtypes = lib.bz_point_add_planes.argtypes = (p, p, p, p, i64, p)
    return lib


def in_turns(cases: dict, reps: int) -> dict:
    """{name: fn} timed device-paced in turns, each name in order and then
    in reverse (tree, old, old, tree): -> {name: [ms, ms]}."""
    from battlezips_halo2_tpu_torch.ops.timing import device_paced_ms

    out = {name: [] for name in cases}
    for name in list(cases) + list(cases)[::-1]:
        out[name].append(device_paced_ms(cases[name], reps))
    return out


def _mean(xs) -> float:
    return sum(xs) / len(xs)


K1_THREADS = (64, 128, 256, 512, 1024)  # block sizes timed at every shape


def check_k1(dev, rng: random.Random, rows: int, old, shapes: dict) -> dict:
    """K1's elementwise kernel against its plain version over Fp and Fq, all
    three ops, with b full, one row (nb = 1) and one batch row long; then at
    each of ``shapes`` ({name: (batch, rows, b rows)}: the proof path's),
    the Montgomery product checked bit-exact and timed device-paced beside
    the old build's (``old``, csrc/previous/field_ops.cu) in turns, and
    every block size of K1_THREADS. The first shape is the row's."""
    import torch

    from battlezips_halo2_tpu_torch.fields import limb as L
    from battlezips_halo2_tpu_torch.ops import cuda
    from battlezips_halo2_tpu_torch.ops.timing import device_paced_ms

    err = 0
    for spec in (L.FP_SPEC, L.FQ_SPEC):
        a, b = _rand_field(rng, spec.modulus, rows, dev), _rand_field(rng, spec.modulus, rows, dev)
        for op in (L.OP_MUL, L.OP_ADD, L.OP_SUB):
            for bb in (b, b[:1], b[: rows // 8]):
                got, want = L.field_op(op, spec, a, bb), L.plain_field_op(op, spec, a, bb)
                err = max(err, max_abs_err(got, want))
    spec = L.FP_SPEC
    consts = spec.kernel_consts

    def raw(lib, a, b, out, threads=None):
        n, nb = a.numel() // 8, b.numel() // 8
        args = (L.OP_MUL, consts, cuda.ptr(a), cuda.ptr(b), cuda.ptr(out), n, nb)
        cuda.check(lib.bz_field_op(*args, *(() if threads is None else (threads,)), cuda.stream(a)), "K1 bz_field_op")

    per_shape = []
    for name, (batch, nrows, nb) in shapes.items():
        a = _rand_canonical(rng, batch * nrows, dev).view(batch, nrows, 8)
        b = _rand_canonical(rng, nb, dev)
        want, plain = once_ms(lambda: L.plain_field_op(L.OP_MUL, spec, a, b))
        out, old_out = L.field_op(L.OP_MUL, spec, a, b), torch.empty_like(a)
        raw(old, a, b, old_out)
        shape_err = max(max_abs_err(out, want), max_abs_err(old_out, want))
        err = max(err, shape_err)
        reps = 100 if batch * nrows >= 1 << 18 else 200
        turns = in_turns({"tree": lambda: L.field_op(L.OP_MUL, spec, a, b, out=out),
                          "old": lambda: raw(old, a, b, old_out)}, reps)
        n = batch * nrows
        bms, by = bound_ms((2 * n + nb) * 32, n * CC_MONT_MUL_RESULTS)
        row = {"shape": f"{name}: ({batch}, {nrows}, 8) by ({nb}, 8) Fp", "rows": n, "b_rows": nb,
               "ms": _mean(turns["tree"]), "old_build_ms": _mean(turns["old"]), "turns": turns, "plain_ms": plain,
               "bound_ms": bms, "bound_by": by, "share_of_bound": bms / _mean(turns["tree"]), "max_abs_err": shape_err}
        row["threads_ms"] = {t: device_paced_ms(lambda t=t: raw(cuda.library(), a, b, out, t), reps)
                             for t in K1_THREADS}
        row["threads"] = L.FIELD_OP_THREADS
        per_shape.append(row)
        log(f"  K1 elementwise {row['shape']}: {row['ms']:.4f} ms (turns {turns['tree']}), old build "
            f"{row['old_build_ms']:.4f} ms (turns {turns['old']}), plain {plain:.1f} ms, bound {bms:.6f} ms ({by}), "
            f"{100 * row['share_of_bound']:.0f} % of it; max_abs_err {shape_err}; block sizes {row['threads_ms']}")
    first = per_shape[0]
    return {"max_abs_err": err, "ms": first["ms"], "old_build_ms": first["old_build_ms"],
            "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"], "bound_by": first["bound_by"],
            "library_ms": None, "shape": f"{first['shape']}, device-paced (per_shape: every shape)",
            "per_shape": per_shape}


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
    ms, host = paced(lambda: D.butterfly_stage(spec, x, tw, stage), 50)
    plain = cuda_ms(lambda: D.butterfly_stage_plain(spec, x, tw, stage), 2)
    nbytes = 2 * time_batch * n * 32 + tw.shape[0] * 32
    bms, by = bound_ms(nbytes, time_batch * (n // 2) * MONT_MUL_RESULTS)
    shape = f"one stage of ({time_batch}, 2^{time_logn}) Fp, device-paced"
    return {"max_abs_err": err, "ms": ms, "host_paced_ms": host, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "shape": shape}


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


def check_k3(dev, rng: random.Random, lanes: int, old) -> dict:
    """K3 against point_add_plain over random Jacobian points with identity,
    P == Q (same and different Z), P == -Q lanes; times it on the generic
    lanes beside the old build's (``old``, csrc/previous/point_add.cu) in
    turns."""
    import torch

    from battlezips_halo2_tpu_torch.curves import limb as C
    from battlezips_halo2_tpu_torch.curves.host import VESTA
    from battlezips_halo2_tpu_torch.fields.limb import FQ_SPEC
    from battlezips_halo2_tpu_torch.ops import cuda
    from battlezips_halo2_tpu_torch.ops.timing import host_paced_ms

    spec = FQ_SPEC
    P, Q, generic = _point_pairs(dev, rng, lanes)
    got = C.point_add(spec, P, Q)
    err = max_abs_err(got, C.point_add_plain(spec, P, Q))
    want = [VESTA.add(a, b) for a, b in zip(C.jacobian_to_affine(spec, P), C.jacobian_to_affine(spec, Q))]
    if C.jacobian_to_affine(spec, got) != want:
        raise AssertionError("K3 point_add disagrees with the host group law")
    out, old_out = torch.empty_like(P), torch.empty_like(P)
    R, S = P[generic:].contiguous(), Q[generic:].contiguous()  # generic lanes only
    n = R.shape[0]

    def old_add():
        cuda.check(old.bz_point_add(spec.kernel_consts, cuda.ptr(R), cuda.ptr(S), cuda.ptr(old_out), n,
                                    cuda.stream(R)), "K3 bz_point_add (old build)")

    old_add()
    err = max(err, max_abs_err(old_out[:n], C.point_add(spec, R, S)))

    def tree_add():
        C.point_add(spec, R, S, out=out[:n])

    turns = in_turns({"tree": tree_add, "old": old_add}, 100)
    ms, host = _mean(turns["tree"]), host_paced_ms(tree_add, 100)
    plain = cuda_ms(lambda: C.point_add_plain(spec, R, S), 2)
    bms, by = bound_ms(n * 3 * 96, n * 16 * CC_MONT_MUL_RESULTS)
    shape = f"{n} generic lanes, Vesta, device-paced"
    log(f"  K3 lane-wise point_add, {shape}: {ms:.4f} ms; in turns tree {turns['tree']}, old build {turns['old']}")
    return {"max_abs_err": err, "ms": ms, "host_paced_ms": host, "old_build_ms": _mean(turns["old"]),
            "turns": turns, "plain_ms": plain, "bound_ms": bms, "bound_by": by, "library_ms": None, "shape": shape}


FOLD_LANES = 11 * 32  # a board commit batch's (MSM, window) lanes: 11 columns x 32 windows (c = 8)
FOLD_DEPTHS = (2, 4)  # shards of the fold: two shards on one card, one shard a card on four
FOLD_THREADS = (32, 64, 128, 256)  # block sizes timed at D = 4


def _generic_stack(dev, rng: random.Random, d: int, lanes: int):
    """(d, lanes, 3, 8) Vesta points with non-trivial Z, no two equal."""
    from battlezips_halo2_tpu_torch.curves import limb as C
    from battlezips_halo2_tpu_torch.fields.limb import FQ_SPEC

    pts = _vesta_points(rng, 2 * d * lanes)
    jac = C.affine_to_jacobian(FQ_SPEC, pts, dev).view(2, d * lanes, 3, 8)
    return C.point_add_plain(FQ_SPEC, jac[0], jac[1]).view(d, lanes, 3, 8).contiguous()


def check_k3_fold(dev, rng: random.Random, old) -> dict:
    """K3's fold (bz_point_fold) against its plain version and against the
    old route, D - 1 launches of the old build's bz_point_add, coordinate
    for coordinate: at D = 2, 3 and 4 over FOLD_LANES lanes whose first two
    layers hold the identity, P == Q and P == -Q cases, and on 1 and 1528
    lanes. Then at each D of FOLD_DEPTHS over FOLD_LANES generic lanes, the
    fold and the old route timed device-paced in turns, and at D = 4 every
    block size of FOLD_THREADS."""
    import torch

    from battlezips_halo2_tpu_torch.curves import limb as C
    from battlezips_halo2_tpu_torch.fields.limb import FQ_SPEC
    from battlezips_halo2_tpu_torch.ops import cuda
    from battlezips_halo2_tpu_torch.ops.timing import device_paced_ms

    spec = FQ_SPEC

    def old_route(stack, accs):
        """acc = s[0]; acc = acc + s[k] by one old-build launch each, into
        the preallocated (D - 1, lanes, 3, 8) ``accs``."""
        lanes, prev = stack.shape[1], stack[0]
        for k in range(1, stack.shape[0]):
            cuda.check(old.bz_point_add(spec.kernel_consts, cuda.ptr(prev), cuda.ptr(stack[k]), cuda.ptr(accs[k - 1]),
                                        lanes, cuda.stream(stack)), "K3 bz_point_add (old build)")
            prev = accs[k - 1]
        return prev

    err = 0
    for d, lanes in ((2, FOLD_LANES), (3, FOLD_LANES), (4, FOLD_LANES), (4, 1), (3, 1528)):
        P, Q, _ = _point_pairs(dev, rng, max(lanes, 64))
        layers = [P, Q] + (list(_generic_stack(dev, rng, d - 2, P.shape[0])) if d > 2 else [])
        stack = torch.stack(layers)[:, :lanes].contiguous()
        got = C.point_fold(spec, stack)
        accs = torch.empty((d - 1,) + tuple(stack.shape[1:]), dtype=torch.int32, device=dev)
        err = max(err, max_abs_err(got, C.point_fold_plain(spec, stack)), max_abs_err(got, old_route(stack, accs)))
    per_depth = []
    for d in FOLD_DEPTHS:
        stack = _generic_stack(dev, rng, d, FOLD_LANES)
        accs = torch.empty((d - 1,) + tuple(stack.shape[1:]), dtype=torch.int32, device=dev)
        err = max(err, max_abs_err(C.point_fold(spec, stack), old_route(stack, accs)))
        turns = in_turns({"fold": lambda: C.point_fold(spec, stack), "old": lambda: old_route(stack, accs)}, 100)
        plain = cuda_ms(lambda: C.point_fold_plain(spec, stack), 2)
        bms, by = bound_ms((d + 1) * FOLD_LANES * 96, (d - 1) * FOLD_LANES * 16 * CC_MONT_MUL_RESULTS)
        row = {"d": d, "lanes": FOLD_LANES, "threads": cuda.chain_grid(FOLD_LANES, cuda.sm_count(stack.device))[0],
               "ms": _mean(turns["fold"]), "old_route_ms": _mean(turns["old"]), "turns": turns, "plain_ms": plain,
               "bound_ms": bms, "bound_by": by}
        if d == max(FOLD_DEPTHS):
            out = torch.empty_like(stack[0])

            def fold_with(threads):
                cuda.check(cuda.library().bz_point_fold(spec.kernel_consts, cuda.ptr(stack), cuda.ptr(out), d,
                                                        FOLD_LANES, threads, cuda.stream(stack)), "K3 bz_point_fold")

            row["threads_ms"] = {t: device_paced_ms(lambda t=t: fold_with(t), 100) for t in FOLD_THREADS}
        per_depth.append(row)
        log(f"  K3 fold D = {d} over {FOLD_LANES} lanes ({row['threads']} threads a block): {row['ms']:.4f} ms "
            f"(turns {turns['fold']}), old route ({d - 1} launches, old build) {row['old_route_ms']:.4f} ms (turns "
            f"{turns['old']}), {row['ms'] / row['old_route_ms']:.2f}x; plain {plain:.1f} ms, bound {bms:.6f} ms ({by})"
            + (f"; block sizes {row['threads_ms']}" if "threads_ms" in row else ""))
    return {"max_abs_err": err, "per_depth": per_depth}


def _bucket_rows(dev, rng: random.Random, rows: int, nbuck: int):
    """(rows, nbuck, 3, 8) Vesta bucket sums drawn from a pool of 96 points,
    each held with two Z, their negations and the identity, with a bucket
    equal to, or the negation of, the one before it forced in every few
    buckets."""
    import torch

    from battlezips_halo2_tpu_torch.curves import limb as C
    from battlezips_halo2_tpu_torch.curves.host import VESTA
    from battlezips_halo2_tpu_torch.fields.limb import FQ_SPEC, ints_to_limbs

    q, r = FQ_SPEC.modulus, FQ_SPEC.r_mod_p
    pts = _vesta_points(rng, 96)
    words = []
    for p in pts + pts + [VESTA.neg(p) for p in pts]:
        lam = rng.randrange(1, q)
        words += [p[0] * lam**2 * r % q, p[1] * lam**3 * r % q, lam * r % q]
    pool = torch.cat([ints_to_limbs(words, dev).view(-1, 3, 8), C.infinity(FQ_SPEC, (1,), dev)])
    gen = torch.Generator().manual_seed(rng.randrange(1 << 62))
    idx = torch.randint(0, pool.shape[0], (rows, nbuck), generator=gen)
    kind = torch.randint(0, 8, (rows, nbuck), generator=gen)
    for b in range(2, nbuck):  # equal (other Z) and opposite neighbours
        prev = idx[:, b - 1]
        idx[:, b] = torch.where(kind[:, b] == 0, (prev + 96) % 192, idx[:, b])
        idx[:, b] = torch.where((kind[:, b] == 1) & (prev < 96), prev + 192, idx[:, b])
    return pool[idx.to(dev)].contiguous()


def _affine_err(spec, got, want) -> int:
    """max |a - b| over the affine coordinates of two Jacobian batches (the
    identity as (0, 0), which is on neither curve)."""
    from battlezips_halo2_tpu_torch.curves import limb as C

    pairs = zip(C.jacobian_to_affine(spec, got), C.jacobian_to_affine(spec, want))
    return max((abs(x - y) for a, b in pairs for x, y in zip(a or (0, 0), b or (0, 0))), default=0)


def _check_windows(dev, rng: random.Random, shapes, planar: bool) -> dict:
    """K3's window kernel (K6's with ``planar``, on coordinate planes)
    against its plain version on affine points (the two add in different
    orders), at every (rows, nbuck) of ``shapes``; times the kernel, its
    plain version and the old route (the two-level running sums over the
    lane-wise K3, or K6, one launch per addition) at each. The first shape
    is the row's."""
    from battlezips_halo2_tpu_torch.fields.limb import FQ_SPEC
    from battlezips_halo2_tpu_torch.ops import msm as M

    spec, err, per_shape = FQ_SPEC, 0, []
    if planar:
        kernel, plain_fn = M.window_sums_planes, M.window_sums_planes_plain
    else:
        kernel, plain_fn = M.window_sums, M.window_sums_plain
    for rows, nbuck in shapes:
        buckets = _bucket_rows(dev, rng, rows, nbuck)
        src = buckets.permute(2, 0, 1, 3).contiguous() if planar else buckets
        got = kernel(spec, src, nbuck)
        want, plain = once_ms(lambda: plain_fn(spec, src, nbuck))
        if planar:
            got, want = got.movedim(0, -2), want.movedim(0, -2)
        err = max(err, _affine_err(spec, got, want))
        ms = cuda_ms(lambda: kernel(spec, src, nbuck), 20)
        old = cuda_ms(lambda: M._aggregate_windows(spec, src, nbuck, planar=planar), 5)
        m = nbuck - 1
        bms, by = bound_ms(rows * (nbuck + 1) * 96, rows * 2 * m * 16 * MONT_MUL_RESULTS)
        threads, seg = M.window_layout(rows, m, M.window_resident(buckets.device, planar))
        per_shape.append({"rows": rows, "nbuck": nbuck, "threads_per_row": threads, "segment": seg, "ms": ms,
                          "old_route_ms": old, "plain_ms": plain, "bound_ms": bms, "bound_by": by})
    first = per_shape[0]
    return {"max_abs_err": err, "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "old_route_ms": first["old_route_ms"], "per_shape": per_shape,
            "shape": f"{first['rows']} rows x {first['nbuck']} buckets, Vesta{' planes' if planar else ''} "
                     "(per_shape: every shape)",
            "resident_threads": M.window_resident(buckets.device, planar)}


def check_k3_windows(dev, rng: random.Random, shapes) -> dict:
    return _check_windows(dev, rng, shapes, planar=False)


def check_k6_windows(dev, rng: random.Random, shapes) -> dict:
    return _check_windows(dev, rng, shapes, planar=True)


def _vm_case(dev, rng: random.Random, vk, nb: int) -> dict:
    """K1's VM kernel on a key's program at nb proofs of random polynomials
    and challenges, against the kernel's plain version and the stepwise
    route (the old route: the plain version's loop over the elementwise K1
    kernel, one launch per instruction); all three timed."""
    from battlezips_halo2_tpu_torch.fields import limb as L
    from battlezips_halo2_tpu_torch.fields.host import FP
    from battlezips_halo2_tpu_torch.fields.limb import FP_SPEC
    from battlezips_halo2_tpu_torch.ops import gate_eval as G
    from battlezips_halo2_tpu_torch.plonk.arguments import ProofSchedule

    ev = G.BatchQuotientEvaluator(vk, ProofSchedule.build(vk.cs), dev)
    p, n, ext = FP.modulus, vk.domain.n, vk.domain.extended_n
    polys = [{k: [rng.randrange(p) for _ in range(n)] for k in ev.keys} for _ in range(nb)]
    per, ch = ev.inputs(polys, [tuple(rng.randrange(p) for _ in range(4)) for _ in range(nb)])
    srcs = ev.sources(per, ch)

    def run():
        return G.quotient_vm(FP_SPEC, ev.prog_t, ev.desc, srcs, ev.t_inv, nb, ev.n_regs)

    def stepwise():
        return G.quotient_vm_plain(FP_SPEC, ev.prog_t, ev.desc, srcs, ev.t_inv, nb, ev.n_regs, op=L.field_op)

    got = run()
    err = max_abs_err(got, stepwise())
    want, plain = once_ms(lambda: G.quotient_vm_plain(FP_SPEC, ev.prog_t, ev.desc, srcs, ev.t_inv, nb, ev.n_regs))
    err = max(err, max_abs_err(got, want))
    ms = cuda_ms(run, 20)
    old = cuda_ms(stepwise, 3)
    lanes, n_instr = nb * ext, ev.vm_size[0]
    muls = int((ev.prog_t[:, 0] == G.OP_MUL).sum())
    ops = lanes * ((muls + 1) * MONT_MUL_RESULTS + (n_instr - muls) * CHAIN_OP_RESULTS["add"])
    polys_read = {(s, row0): sb for s, row0, sb, sl, _ in ev.desc.tolist() if sl}
    nbytes = sum(ext * 32 * (nb if sb else 1) for sb in polys_read.values()) + ext * 32 + lanes * 32
    bms, by = bound_ms(nbytes, ops)
    n_temps = ev.n_regs - 1 - len(ev.pin_keys)
    shape = (f"B={nb} x ext {ext}: {n_instr} instructions ({muls} mul), {len(ev.pin_keys)} pins, "
             f"{n_temps} temporaries")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain, "old_route_ms": old, "bound_ms": bms, "bound_by": by,
            "shape": shape}


def check_k1_vm(dev, rng: random.Random, board_vk, shot_vk) -> dict:
    """K1's VM at the proof path's shapes: the board's program (one proof)
    and the shot's (four proofs, a batched session's shots)."""
    board = _vm_case(dev, rng, board_vk, 1)
    shot = _vm_case(dev, rng, shot_vk, 4)
    return {**board, "max_abs_err": max(board["max_abs_err"], shot["max_abs_err"]),
            "shape": f"board {board['shape']} (shot: {shot['shape']})", "shot": shot}


K6_LANES = (1528, 1, 1 << 17)  # the row's shape (K3's lane-wise row), one lane's chain, a card's worth
K6_THREADS = (32, 64, 128, 256)  # block sizes timed at the most lanes


def check_k6(dev, rng: random.Random, lanes: int, old) -> dict:
    """K6's lane-wise kernel against its plain version and against K3's
    (coordinate for coordinate) on the cases of check_k3, held as
    coordinate planes, also with the output in place of an input; then at
    each lane count of K6_LANES over generic lanes (repeated past the
    generated ones), against the old build's kernel (``old``,
    csrc/previous/point_add_planes.cu) and its plain version, and timed
    device-paced in turns with the old build, and at the most lanes at
    each block size of K6_THREADS. The first shape is the row's."""
    import torch

    from battlezips_halo2_tpu_torch.curves import limb as C
    from battlezips_halo2_tpu_torch.fields.limb import FQ_SPEC
    from battlezips_halo2_tpu_torch.ops import cuda
    from battlezips_halo2_tpu_torch.ops.timing import device_paced_ms, host_paced_ms

    spec = FQ_SPEC
    P, Q, generic = _point_pairs(dev, rng, lanes)
    Pp, Qp = P.movedim(-2, 0).contiguous(), Q.movedim(-2, 0).contiguous()
    got = C.point_add_planes(spec, Pp, Qp)
    err = max(max_abs_err(got, C.point_add_planes_plain(spec, Pp, Qp)),
              max_abs_err(got.movedim(0, -2), C.point_add(spec, P, Q)))
    into = Pp.clone()  # out aliasing p, as the aggregation runs it
    C.point_add_planes(spec, into, Qp, out=into)
    err = max(err, max_abs_err(into, got))
    base_p, base_q = Pp[:, generic:], Qp[:, generic:]
    per_shape = []
    for n in K6_LANES:
        reps = -(-n // base_p.shape[1])
        R, S = (t.repeat(1, reps, 1)[:, :n].contiguous() for t in (base_p, base_q))
        out, old_out = torch.empty_like(R), torch.empty_like(R)

        def old_add():
            cuda.check(old.bz_point_add_planes(spec.kernel_consts, cuda.ptr(R), cuda.ptr(S), cuda.ptr(old_out), n,
                                               cuda.stream(R)), "K6 bz_point_add_planes (old build)")

        def tree_add():
            C.point_add_planes(spec, R, S, out=out)

        want, plain = once_ms(lambda: C.point_add_planes_plain(spec, R, S))
        tree_add()
        old_add()
        err = max(err, max_abs_err(out, want), max_abs_err(old_out, want))
        turns = in_turns({"tree": tree_add, "old": old_add}, 100)
        bms, by = bound_ms(n * 3 * 96, n * 16 * CC_MONT_MUL_RESULTS)
        row = {"lanes": n, "threads": cuda.chain_grid(n, cuda.sm_count(R.device))[0], "ms": _mean(turns["tree"]),
               "host_paced_ms": host_paced_ms(tree_add, 100), "old_build_ms": _mean(turns["old"]), "turns": turns,
               "plain_ms": plain, "bound_ms": bms, "bound_by": by}
        if n == max(K6_LANES):

            def add_with(threads):
                cuda.check(cuda.library().bz_point_add_planes(spec.kernel_consts, cuda.ptr(R), cuda.ptr(S),
                                                              cuda.ptr(out), n, threads, cuda.stream(R)),
                           "K6 bz_point_add_planes")

            row["threads_ms"] = {t: device_paced_ms(lambda t=t: add_with(t), 100) for t in K6_THREADS}
        per_shape.append(row)
        log(f"  K6 lane-wise point_add_planes, {n} generic lanes ({row['threads']} threads a block): "
            f"{row['ms']:.4f} ms device-paced (turns {turns['tree']}), old build {row['old_build_ms']:.4f} ms (turns "
            f"{turns['old']}), {row['ms'] / row['old_build_ms']:.2f}x; host-paced {row['host_paced_ms']:.4f} ms; "
            f"plain {plain:.1f} ms; bound {bms:.6f} ms ({by}), {100 * bms / row['ms']:.1f} % of it"
            + (f"; block sizes {row['threads_ms']}" if "threads_ms" in row else ""))
    first = per_shape[0]
    shape = (f"{first['lanes']} generic lanes as (3, lanes, 8) planes, Vesta, device-paced (per_shape: "
             f"{', '.join(str(r['lanes']) for r in per_shape)} lanes)")
    return {"max_abs_err": err, "ms": first["ms"], "host_paced_ms": first["host_paced_ms"],
            "old_build_ms": first["old_build_ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "library_ms": None, "shape": shape, "per_shape": per_shape}


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
    ms, host = paced(lambda: D.butterfly_rows(spec, u, v, tw), 50)
    plain = cuda_ms(lambda: D.butterfly_rows_plain(spec, u, v, tw), 2)
    pairs = time_batch * (n // 2)
    bms, by = bound_ms(4 * pairs * 32 + tw.shape[0] * 32, pairs * MONT_MUL_RESULTS)
    shape = f"one stage of ({time_batch}, 2^{time_logn}) Fp: u, v ({time_batch}, 2^{time_logn - 1}, 8), device-paced"
    return {"max_abs_err": err, "ms": ms, "host_paced_ms": host, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "shape": shape}


BOARD_COMMIT_BATCH = 11  # columns of the board's largest commit pass (K3's 352 rows = 11 x 32 windows)
HAND_CHUNK = 3  # the chunk length the hand-made runs are laid out for


def _hand_runs(rng: random.Random, n_points: int, chunk: int, chunks: int):
    """Hand-made bucket runs over table rows [0, n_points) (points),
    n_points (the identity) and n_points + 1 + j (the negation of point j),
    filling exactly chunk x chunks rows, so that K2 / K7 splits them into
    ``chunks`` chunks of ``chunk`` rows. Kinds, by bucket index mod 8: 1 P
    then P from a chunk's first row (the incomplete law's collision inside
    a chunk), 2 P then -P, 3 an identity inside the run, 4 an identity at
    the head, 5 P then P alone, straddling a chunk boundary, others random; empty
    runs among them. -> (src, starts, kind of each bucket)."""
    ident, negs, total = n_points, n_points + 1, chunk * chunks
    src, starts, kinds = [], [0], []

    def close(run, kind):
        src.extend(run)
        starts.append(len(src))
        kinds.append(kind)

    while len(src) < total:
        kind = len(kinds) % 8
        run = [rng.randrange(n_points) for _ in range(rng.randrange(0, 7))]
        if kind in (1, 5):
            align = 0 if kind == 1 else chunk - 1
            if len(src) % chunk != align:  # a filler bucket puts the pair's first P at row align mod chunk
                close([rng.randrange(n_points) for _ in range((align - len(src)) % chunk)], 0)
            p = rng.randrange(n_points)
            run = [p, p] + ([i for i in run if i != p] if kind == 1 else [])
        elif kind == 2:
            j = rng.randrange(64)
            run[0:0] = [j, negs + j]
        elif kind == 3:
            run.insert(rng.randrange(len(run) + 1), ident)
        elif kind == 4:
            run = [ident] + run
        close(run, kind)
    if len(src) > total:  # cut the last run to fill exactly chunk x chunks rows
        del src[total:]
        starts[-1], kinds[-1] = total, 0
    return src, starts, kinds


def _run_stats(starts) -> dict:
    """Rows, buckets and run lengths of a sorted bucket layout."""
    import torch

    lens = (starts[1:] - starts[:-1]).to(torch.int64)
    live = lens[lens > 0]
    return {"rows": int(starts[-1]), "buckets": int(lens.numel()), "live_buckets": int(live.numel()),
            "mean_run": float(live.double().mean()) if live.numel() else 0.0,
            "longest_run": int(live.max()) if live.numel() else 0}


def _host_bucket_sums(points: list, src: list, starts: list, buckets) -> dict:
    """{bucket: host sum of its run} for the given buckets; points maps a
    table row to its affine point (None: the identity)."""
    from battlezips_halo2_tpu_torch.curves.host import VESTA

    sums = {}
    for b in buckets:
        acc = None
        for i in src[starts[b] : starts[b + 1]]:
            acc = VESTA.add(acc, points[i])
        sums[b] = acc
    return sums


def _check_host_law(spec, name: str, out, flags, points, src, starts, buckets) -> int:
    """Affine bucket sums (where the flag is 0) against the host group law
    on the given buckets; -> how many were checked."""
    import torch

    from battlezips_halo2_tpu_torch.curves import limb as C

    buckets = [b for b in buckets if not int(flags[b])]
    if not buckets:
        return 0
    idx = torch.tensor(buckets, device=out.device)
    got = C.jacobian_to_affine(spec, out.index_select(0, idx))
    want = _host_bucket_sums(points, src, starts, buckets)
    if got != [want[b] for b in buckets]:
        raise AssertionError(f"{name} bucket sums disagree with the host group law")
    return len(buckets)


def _k2_layout(dev, stats: dict, complete: bool) -> tuple[int, int, int]:
    """(chunk length L, chunks, resident threads) of a bucket pass."""
    from battlezips_halo2_tpu_torch.ops import msm as M

    resident = M.bucket_resident(dev, complete)
    return (*M.bucket_layout(stats["rows"], resident, stats["longest_run"]), resident)


def check_k2_k7(dev, rng: random.Random, n_points: int = 2049) -> tuple[dict, dict]:
    """K2 and K7 against bucket_sums_plain at the same chunk length, in
    Jacobian coordinates and flags, on

    - hand-made runs laid out for chunks of HAND_CHUNK rows: identity
      heads and identity rows, P then -P, P then P inside a chunk (K2 must
      flag it) and straddling a chunk boundary (merged by the complete
      law: no flag);
    - all-equal scalars: one bucket of n_points rows in every window;
    - the proof path's shapes: the board's commit batch
      (BOARD_COMMIT_BATCH x 4097 points, c = 8), an IPA round (2 x 4096,
      half of the scalars zero), and for K7 the IPA's 3-point MSM (c = 2)
      and the commit batch (its shape under BZ_ROW_MSM).

    Affine sums are held against the host group law (all of the hand-made
    special buckets and samples elsewhere; K2 where its flag is 0). Every
    shape prints its rows, buckets, run lengths, chunk length L and
    threads, and is timed with its plain version."""
    import torch

    from battlezips_halo2_tpu_torch.curves import limb as C
    from battlezips_halo2_tpu_torch.curves.host import VESTA
    from battlezips_halo2_tpu_torch.fields.limb import FQ_SPEC, ints_to_limbs
    from battlezips_halo2_tpu_torch.ops import msm as M

    spec, p_mod = FQ_SPEC, VESTA.scalar.modulus
    pts = _vesta_points(rng, 4097)
    errs = {"K2": 0, "K7": 0}
    per_shape = {"K2": [], "K7": []}

    def runs_of(points: list, scalars: list, batch: int, c: int):
        table = C.affine_table(spec, points, dev)
        lim = ints_to_limbs(scalars, dev).view(batch, len(points), 8)
        tab, src_t, starts_t, _, bid = M.bucket_runs(spec, table, lim, c, False)
        return tab, src_t, starts_t, bid

    def case(shape: str, name: str, tab, src_t, starts_t, bid, reps: int, host_points=None, host_buckets=(),
             device_paced: bool = False):
        complete = name == "K7"
        stats = _run_stats(starts_t)
        chunk, chunks, resident = _k2_layout(dev, stats, complete)
        out, flags = M.bucket_sums(spec, tab, src_t, starts_t, bid, complete)
        (want, want_flags), plain = once_ms(
            lambda: M.bucket_sums_plain(spec, tab, src_t, starts_t, complete, chunk=chunk))
        err = max(max_abs_err(out, want), max_abs_err(flags, want_flags))
        errs[name] = max(errs[name], err)
        if complete and int(flags.sum()):
            raise AssertionError(f"K7 raised a collision flag [{shape}]")
        checked = 0
        if host_points is not None:
            checked = _check_host_law(spec, f"{name} [{shape}]", out, flags.cpu(), host_points, src_t.tolist(),
                                      starts_t.tolist(), host_buckets)
        if device_paced:  # launch-bound: the card sets the pace, the host-paced time beside it
            ms, host = paced(lambda: M.bucket_sums(spec, tab, src_t, starts_t, bid, complete), reps)
        else:
            ms, host = cuda_ms(lambda: M.bucket_sums(spec, tab, src_t, starts_t, bid, complete), reps), None
        adds = stats["rows"] - stats["live_buckets"]  # every row after its bucket's head
        nbytes = stats["rows"] * (64 + 4 + 4) + stats["buckets"] * (4 + 96 + 4)
        bms, by = bound_ms(nbytes, adds * (12 if complete else 11) * MONT_MUL_RESULTS)
        lens = (starts_t[1:] - starts_t[:-1]).to(torch.int64)
        first, last = starts_t[:-1].to(torch.int64), starts_t[1:].to(torch.int64) - 1
        pieces = int(((last // chunk) - (first // chunk) + 1)[lens > 0].max()) if stats["rows"] else 0
        row = {"shape": shape, **stats, "chunk": chunk, "chunks": chunks, "resident_threads": resident,
               "max_pieces": pieces, "flags": int(flags.sum()), "host_checked": checked, "max_abs_err": err,
               "ms": ms, "host_paced_ms": host, "plain_ms": plain, "bound_ms": bms, "bound_by": by}
        per_shape[name].append(row)
        log(f"  {name} {shape}: {stats['rows']} rows, {stats['buckets']} buckets ({stats['live_buckets']} live), "
            f"mean run {stats['mean_run']:.2f}, longest {stats['longest_run']}, L = {chunk} over {chunks} of "
            f"{resident} threads, a bucket in at most {pieces} chunks; max_abs_err {err}, {row['flags']} flags, "
            f"{checked} host-checked; kernel {ms:.4f} ms, plain {plain:.1f} ms, bound {bms:.6f} ms ({by})")
        return out, flags

    # hand-made runs, laid out for chunks of HAND_CHUNK rows
    hand_points = pts[:n_points] + [None] + [VESTA.neg(p) for p in pts[:64]]
    hand_table = C.affine_table(spec, hand_points, dev)
    for name in ("K2", "K7"):
        resident = M.bucket_resident(dev, name == "K7")
        src, starts, kinds = _hand_runs(rng, n_points, HAND_CHUNK, resident)
        src_t = torch.tensor(src, dtype=torch.int32, device=dev)
        starts_t = torch.tensor(starts, dtype=torch.int32, device=dev)
        bid = torch.repeat_interleave(torch.arange(len(kinds), device=dev, dtype=torch.int32),
                                      (starts_t[1:] - starts_t[:-1]).to(torch.int64))
        special = [b for b, k in enumerate(kinds) if k in (1, 2, 3, 4, 5)]
        sample = special[:: max(1, len(special) // 1500)] + rng.sample(range(len(kinds)), 500)
        out, flags = case(f"hand-made runs (L = {HAND_CHUNK})", name, hand_table, src_t, starts_t, bid, 5,
                          hand_points, sample)
        flags = flags.cpu()
        if name == "K2":
            if not all(int(flags[b]) for b, k in enumerate(kinds) if k == 1):
                raise AssertionError("K2 did not flag P then P inside a chunk")
            if any(int(flags[b]) for b, k in enumerate(kinds) if k == 5):
                raise AssertionError("K2 flagged P then P across a chunk boundary, which the complete merge adds")
    # all-equal scalars: every window one bucket of n_points rows
    s = rng.randrange(1, p_mod)
    runs = runs_of(pts[:n_points], [s] * n_points, 1, 8)
    for name in ("K2", "K7"):
        case(f"all-equal scalars, 1 x {n_points} points, c = 8", name, *runs, 2, pts[:n_points],
             torch.nonzero(runs[2].diff()).flatten().tolist())
    # the board's commit batch (K2; K7 under BZ_ROW_MSM)
    batch = BOARD_COMMIT_BATCH
    scalars = [rng.randrange(p_mod) for _ in range(batch * 4097)]
    commit = runs_of(pts, scalars, batch, 8)
    sample = rng.sample(range(commit[2].shape[0] - 1), 256)
    for name in ("K2", "K7"):
        case(f"board commit batch, {batch} x 4097 points, c = 8", name, *commit, 20, pts, sample)
    # an IPA round: two MSMs over the 4096 G points, each with half of its scalars zero
    ipa = [rng.randrange(p_mod) if i < 2048 else 0 for i in range(4096)]
    ipa += [0] * 2048 + [rng.randrange(p_mod) for _ in range(2048)]
    ipa_runs = runs_of(pts[:4096], ipa, 2, 8)
    case("IPA round, 2 x 4096 points (half zero), c = 8", "K2", *ipa_runs, 20, pts[:4096],
         rng.sample(range(ipa_runs[2].shape[0] - 1), 256))
    # the IPA's 3-point MSM [base, u, w] x [1, v z, r] (complete, c = 2)
    three = runs_of(pts[:3], [1, rng.randrange(p_mod), rng.randrange(p_mod)], 1, 2)
    case("IPA 3-point MSM, 1 x 3 points, c = 2 (device-paced)", "K7", *three, 50, pts[:3],
         range(three[2].shape[0] - 1), device_paced=True)
    rows = {}
    for name in ("K2", "K7"):
        head = next(r for r in per_shape[name] if r["shape"].startswith("board commit"))
        rows[name] = {"max_abs_err": errs[name], "ms": head["ms"], "plain_ms": head["plain_ms"],
                      "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
                      "shape": f"{head['shape']} (per_shape: every shape)", "per_shape": per_shape[name]}
    three_row = per_shape["K7"][-1]
    rows["K7"]["three_point"] = {k: three_row[k] for k in ("ms", "host_paced_ms", "plain_ms", "bound_ms", "bound_by")}
    return rows["K2"], rows["K7"]


def _entry_delta(before: dict) -> dict:
    """Launches per C entry since the counts ``before``
    (ops/cuda.py::entry_launches)."""
    from battlezips_halo2_tpu_torch.ops import cuda

    return {k: v - before.get(k, 0) for k, v in cuda.entry_launches.items() if v != before.get(k, 0)}


class Phases:
    """Runs the main path's phases: wall seconds (ending in a device
    synchronize) and kernel launch deltas of each, per kernel and per C
    entry. Every bucket pass must be followed by one window aggregation:
    K3's window kernel (K6's under the row flags)."""

    def __init__(self):
        self.seconds, self.launches, self.entries = {}, {}, {}

    def __call__(self, name, fn):
        import torch

        from battlezips_halo2_tpu_torch.ops import cuda

        before, before_entries = dict(cuda.launches), dict(cuda.entry_launches)
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        self.seconds[name] = time.time() - t
        delta = self.launches[name] = {k: cuda.launches[k] - before[k] for k in before}
        entries = self.entries[name] = _entry_delta(before_entries)
        log(f"phase {name}: {self.seconds[name]:.3f} s, launches {delta}")
        if any(os.environ.get(flag) for flag in ROW_FLAGS):
            if entries.get("bz_window_sums_planes", 0) != delta["K7"]:
                raise AssertionError(f"{name}: {entries} K6 window launches, not one per bucket pass (K7)")
        elif entries.get("bz_window_sums", 0) != delta["K2"] + delta["K7"]:
            raise AssertionError(f"{name}: {entries} K3 window launches, not one per bucket pass (K2 + K7)")
        return out


def _tampered(proof: bytes) -> bytes:
    mid = len(proof) // 2
    return proof[:mid] + bytes([proof[mid] ^ 1]) + proof[mid + 1 :]


# the quotient program in one launch + one elementwise scale per commitment
# batch's iNTT and per quotient extension (poly/transforms.py)
STEADY_K1_MAX = 7


def _steady(timed: Phases, name: str, prove):
    """A steady-state proof with its spans printed (BZ_TORCH_TRACE=1); it
    must launch K1 at most STEADY_K1_MAX times."""
    os.environ["BZ_TORCH_TRACE"] = "1"
    try:
        proof = timed(name, prove)
    finally:
        os.environ.pop("BZ_TORCH_TRACE")
    k1 = timed.launches[name]["K1"]
    log(f"K1 launches in {name}: {k1} ({timed.entries[name].get('bz_field_op', 0)} elementwise)")
    if k1 > STEADY_K1_MAX:
        raise AssertionError(f"{name}: {k1} K1 launches, more than {STEADY_K1_MAX}")
    return proof


def run_shot(dev, timed: Phases) -> None:
    """The shot circuit (k = 11) through the public API."""
    from battlezips_halo2_tpu_torch import api
    from battlezips_halo2_tpu_torch.utils import Board, Deck

    golden = json.loads(GOLDEN.read_text())
    board = Board.from_deck(Deck.from_placements(GOLDEN_PLACEMENTS))
    params, pk = timed("shot keys (loaded from the artifact store)", lambda: api.shot_keys(dev))
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
    second = _steady(timed, "prove_shot (fresh rng, steady state)",
                     lambda: api.prove_shot(board.state(), 0xBEEF, (3, 3), True, rng=random.Random(8), device=dev))
    if not timed("verify_shot (fresh proof)", lambda: api.verify_shot(second, device=dev)):
        raise AssertionError("verify_shot rejected a fresh proof")


def run_board(dev, timed: Phases, tag: str) -> None:
    """The board circuit (k = 12) through the public API, in the
    configuration the environment selects (``tag`` names it)."""
    from battlezips_halo2_tpu_torch import api

    golden = json.loads(GOLDEN_BOARD.read_text())
    params, pk = timed(f"board keys (loaded from the artifact store) [{tag}]", lambda: api.board_keys(dev))
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
    second = _steady(timed, f"prove_board (fresh rng, steady state) [{tag}]",
                     lambda: api.prove_board(GOLDEN_PLACEMENTS, 0xBEEF, rng=random.Random(8), device=dev))
    if not timed(f"verify_board (fresh proof) [{tag}]", lambda: api.verify_board(second, device=dev)):
        raise AssertionError(f"verify_board rejected a fresh proof [{tag}]")


def run_board_rows(dev, timed: Phases) -> dict:
    """run_board under BZ_ROW_NTT=1 BZ_ROW_MSM=1; -> its launch deltas,
    which must show K5, K6 and K7, K6 as often as K7, and no K2, K3 or
    K4."""
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
    if (min(delta["K5"], delta["K6"], delta["K7"]) <= 0 or delta["K6"] != delta["K7"] or delta["K2"] or delta["K3"]
            or delta["K4"]):
        raise AssertionError(f"the row configuration took the wrong kernels: {delta}")
    return delta


def _session_bytes(session) -> list:
    return [p.proof for p in session.board_proofs + session.shot_proofs]


def run_sessions(dev, timed: Phases) -> tuple[dict, list]:
    """One game of four shots through api.prove_session: sequential, batched
    (the batch prover), batched with two workers (two sub-batches of two
    shots), batched with the per-proof tail on two threads
    (BZ_BATCH_TAIL_WORKERS=2), and sequential with dp_devices=1 (the first
    card). Every run must give the sequential run's bytes, and
    verify_session must accept each. -> (the session launches by run, the
    session's proof bytes)."""
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
    return launches, want


def run_main_path(dev) -> tuple[Phases, dict, dict, list]:
    timed = Phases()
    run_shot(dev, timed)
    run_board(dev, timed, "default")
    rows = run_board_rows(dev, timed)
    sessions, session_bytes = run_sessions(dev, timed)
    return timed, rows, sessions, session_bytes


NATIVE_REPS = 3  # steady-state proofs, verifies and sessions per engine
HYBRID = {"BZ_BATCH_ENGINE": "device", "BZ_PROOF_ENGINE": "auto"}  # the reference's batched route


def _with_env(env: dict, fn):
    """fn() with ``env`` set, the environment restored after."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return fn()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _no_launches(timed: Phases, name: str) -> None:
    if any(timed.launches[name].values()):
        raise AssertionError(f"{name} launched kernels on the native host engine: {timed.launches[name]}")


def _load_tool(path: Path, name: str):
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_native_engine(dev, timed: Phases, session_want: list) -> dict:
    """The native host engine (battlezips_halo2_tpu_torch/native) and its
    routing. Builds the library (g++); proves the one-game session under
    BZ_BATCH_ENGINE=host with the default proof engine while nothing native
    is cached on the keys (the route's cold first session: device bytes,
    no launch); proves the golden shot and board under BZ_PROOF_ENGINE=auto (golden bytes, no kernel launched, accepted
    by verify under auto and under device, a tampered proof refused);
    times steady proofs of both circuits and the board's verify under
    device and auto (same bytes for the same rng; the last proof of each
    prints its spans); proves the one-game session batched under the
    reference's hybrid (BZ_BATCH_ENGINE=device + BZ_PROOF_ENGINE=auto:
    K1-K4 for the commitments and the quotient, no K7, K3 == K2), also
    with BZ_BATCH_TAIL_WORKERS=2, under
    BZ_BATCH_ENGINE=host (no launch) and sequentially under auto, each
    with the device routes' bytes and verified; profiles the hybrid
    session for its device idle share; times the IPA's 3-point MSM on K7
    and on the native Pippenger. -> the phase's numbers."""
    import statistics

    import torch

    from battlezips_halo2_tpu_torch import api, native
    from battlezips_halo2_tpu_torch.curves.host import VESTA
    from battlezips_halo2_tpu_torch.ops.msm import host_msm, msm
    from battlezips_halo2_tpu_torch.utils import Board, Deck

    card = card_line()
    report = {"card": card}
    t = time.time()
    lib = native.build()
    native.load()
    report["build_s"] = time.time() - t
    report["build_command"] = " ".join(native.build_command(lib))
    log(f"phase native build: {report['build_s']:.3f} s: {report['build_command']}")

    # BZ_BATCH_ENGINE=host's first session under the default proof engine:
    # the native quotient constants, wrapped fixed / sigma polys and SRS
    # buffers are built inside it
    keys = [api.board_keys(dev), api.shot_keys(dev)]
    if any("_native_quotient_evaluator" in pk.vk.__dict__ for _, pk in keys):
        raise AssertionError("a native quotient evaluator was built before the cold host session")
    name = "prove_session (1 game, 4 shots, host, batched, cold)"
    session = _with_env({"BZ_BATCH_ENGINE": "host", "BZ_PROOF_ENGINE": "device"}, lambda: timed(
        name, lambda: api.prove_session([GOLDEN_PLACEMENTS], shots_per_game=4, trapdoors=[0xBEEF], seed=5,
                                        device=dev, workers=1, batched=True)))
    _no_launches(timed, name)
    if _session_bytes(session) != session_want:
        raise AssertionError("the cold BZ_BATCH_ENGINE=host session differs from the device routes'")
    report["host_batched_cold_s"] = timed.seconds[name]

    golden = {"shot": json.loads(GOLDEN.read_text()), "board": json.loads(GOLDEN_BOARD.read_text())}
    board = Board.from_deck(Deck.from_placements(GOLDEN_PLACEMENTS))
    prove = {
        "shot": lambda seed: api.prove_shot(board.state(), 0xBEEF, (3, 3), True, rng=random.Random(seed), device=dev),
        "board": lambda seed: api.prove_board(GOLDEN_PLACEMENTS, 0xBEEF, rng=random.Random(seed), device=dev),
    }
    verify = {"shot": lambda p: api.verify_shot(p, device=dev), "board": lambda p: api.verify_board(p, device=dev)}
    tamper = {"shot": lambda p: api.ShotProof(p.commitment, p.shot, p.hit, _tampered(p.proof)),
              "board": lambda p: api.BoardProof(p.commitment, _tampered(p.proof))}
    auto = {"BZ_PROOF_ENGINE": "auto"}
    for circuit in ("shot", "board"):
        name = f"prove_{circuit} (golden rng) [auto]"
        proof = _with_env(auto, lambda: timed(name, lambda: prove[circuit](golden[circuit]["seed"])))
        _no_launches(timed, name)
        if proof.proof.hex() != golden[circuit]["proof_hex"]:
            raise AssertionError(f"{circuit} proof bytes under BZ_PROOF_ENGINE=auto differ from the golden vector")
        for engine in ("auto", "device"):
            name = f"verify_{circuit} [{engine}]"
            if not _with_env({"BZ_PROOF_ENGINE": engine}, lambda: timed(name, lambda: verify[circuit](proof))):
                raise AssertionError(f"verify_{circuit} under {engine} rejected the golden proof")
            if engine == "auto":
                _no_launches(timed, name)
            name = f"verify_{circuit} (tampered) [{engine}]"
            if _with_env({"BZ_PROOF_ENGINE": engine}, lambda: timed(name, lambda: verify[circuit](tamper[circuit](proof)))):
                raise AssertionError(f"verify_{circuit} under {engine} accepted a tampered proof")
        log(f"golden {circuit} proof bytes equal under BZ_PROOF_ENGINE=auto, no kernel launched; verified under "
            f"auto and device")

    # steady state: the same fresh rngs under device and auto, in turns
    steady = {}
    for circuit in ("shot", "board"):
        for i in range(NATIVE_REPS):
            proofs = {}
            for engine in ("device", "auto"):
                env = {"BZ_PROOF_ENGINE": engine}
                if i == NATIVE_REPS - 1:  # the last proof of each engine prints its spans
                    env["BZ_TORCH_TRACE"] = "1"
                name = f"prove_{circuit} (steady #{i}) [{engine}]"
                proofs[engine] = _with_env(env, lambda: timed(name, lambda: prove[circuit](9 + i)))
                steady.setdefault(f"prove_{circuit}", {}).setdefault(engine, []).append(timed.seconds[name])
                if circuit == "board":
                    name = f"verify_board (steady #{i}) [{engine}]"
                    if not _with_env(env, lambda: timed(name, lambda: verify["board"](proofs[engine]))):
                        raise AssertionError(f"verify_board under {engine} rejected a steady proof")
                    steady.setdefault("verify_board", {}).setdefault(engine, []).append(timed.seconds[name])
                if engine == "auto":
                    _no_launches(timed, f"prove_{circuit} (steady #{i}) [auto]")
            if proofs["device"].proof != proofs["auto"].proof:
                raise AssertionError(f"{circuit} proofs differ between the device and auto engines")

    # sessions: the device routes' bytes on every route
    routes = {  # tag: (environment, prove_session options)
        "device, batched": ({"BZ_BATCH_ENGINE": "device"}, dict(batched=True)),
        "hybrid, batched": (HYBRID, dict(batched=True)),
        "hybrid, batched, tail workers=2": ({**HYBRID, "BZ_BATCH_TAIL_WORKERS": "2"}, dict(batched=True)),
        "host, batched": ({"BZ_BATCH_ENGINE": "host"}, dict(batched=True)),
        "auto, sequential": ({"BZ_PROOF_ENGINE": "auto"}, dict(batched=False)),
    }
    sessions = {}
    for tag, (env, opts) in routes.items():
        for i in range(NATIVE_REPS):
            name = f"prove_session (1 game, 4 shots, {tag}) #{i}"
            session = _with_env(env, lambda: timed(name, lambda: api.prove_session(
                [GOLDEN_PLACEMENTS], shots_per_game=4, trapdoors=[0xBEEF], seed=5, device=dev, workers=1, **opts)))
            sessions.setdefault(tag, {"seconds": [], "launches": timed.launches[name]})["seconds"].append(
                timed.seconds[name])
            if _session_bytes(session) != session_want:
                raise AssertionError(f"session proofs differ from the device routes' [{tag}]")
            launched = timed.launches[name]
            if tag.startswith("hybrid"):
                if launched["K7"] or not launched["K2"] or launched["K3"] != launched["K2"]:
                    raise AssertionError(f"the hybrid took the wrong kernels: {launched}")
                if not (launched["K1"] and launched["K4"]):
                    raise AssertionError(f"the hybrid ran its quotient or NTTs off the card: {launched}")
            elif tag.startswith(("host", "auto")):
                _no_launches(timed, name)
        if not _with_env(env, lambda: timed(f"verify_session [{tag}]", lambda: api.verify_session(session, device=dev))):
            raise AssertionError(f"verify_session rejected the session [{tag}]")
    log(f"session bytes equal to the device routes' across {', '.join(routes)}; each verified")

    # the hybrid session's device idle share
    profile = _load_tool(ROOT / "tools" / "torch_profile_shot.py", "torch_profile_shot")
    hybrid_profile = _with_env(HYBRID, lambda: profile.profiled(lambda: api.prove_session(
        [GOLDEN_PLACEMENTS], shots_per_game=4, trapdoors=[0xBEEF], seed=5, device=dev, batched=True)))
    report["hybrid_session_profile"] = {k: hybrid_profile[k] for k in ("wall_s", "device_busy_ms", "device_idle_share")}

    # the IPA's 3-point MSM [base, u, w] x [1, v z, r]: K7 (device) against the native Pippenger (auto)
    rng = random.Random(3)
    pts = [VESTA.mul(VESTA.generator, rng.randrange(1, VESTA.scalar.modulus)) for _ in range(3)]
    scalars = [1] + [rng.randrange(VESTA.scalar.modulus) for _ in range(2)]
    msm3 = {}
    for engine, fn in (("device", lambda: msm(VESTA, pts, scalars, dev)), ("auto", lambda: host_msm(VESTA, pts, scalars))):
        fn()
        times = []
        for _ in range(50):
            torch.cuda.synchronize()
            t = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t) * 1e3)
        msm3[engine] = {"median_ms": statistics.median(times), "min_ms": min(times)}
    if msm(VESTA, pts, scalars, dev) != host_msm(VESTA, pts, scalars):
        raise AssertionError("the 3-point MSM differs between K7 and the native Pippenger")
    report.update(steady_s=steady, sessions=sessions, msm_3_point=msm3)

    for key, by_engine in steady.items():
        log(f"native engine [{card}]: {key} steady seconds " + "; ".join(
            f"{e} {statistics.median(v):.4f} (runs {', '.join(f'{x:.4f}' for x in v)})" for e, v in by_engine.items()))
    for tag, r in sessions.items():
        log(f"native engine [{card}]: prove_session ({tag}) seconds median {statistics.median(r['seconds']):.4f} "
            f"(runs {', '.join(f'{x:.4f}' for x in r['seconds'])}), launches {r['launches']}")
    hp = report["hybrid_session_profile"]
    log(f"native engine [{card}]: hybrid session under torch.profiler: {hp['wall_s']:.4f} s, device busy "
        f"{hp['device_busy_ms']:.3f} ms, idle share {hp['device_idle_share']}")
    log(f"native engine [{card}]: cold first BZ_BATCH_ENGINE=host session (BZ_PROOF_ENGINE=device) "
        f"{report['host_batched_cold_s']:.4f} s")
    log(f"native engine [{card}]: IPA 3-point MSM, host clock: K7 (device) median {msm3['device']['median_ms']:.4f} "
        f"ms, native (auto) median {msm3['auto']['median_ms']:.4f} ms")
    return report


PARALLEL_REPS = 3  # timed calls of each sharded transform and commit batch, and of their unsharded versions


def parallel_mesh():
    """The parallel phase's mesh: one shard a card, or two shards on
    cuda:0 when one card is visible."""
    import torch

    from battlezips_halo2_tpu_torch.parallel import mesh_from_devices

    cards = torch.cuda.device_count()
    return mesh_from_devices([torch.device("cuda", i) for i in range(cards)] if cards > 1
                             else [torch.device("cuda", 0)] * 2)


def _host_s(fn, reps: int) -> tuple[object, list]:
    """(fn(), host seconds of each of ``reps`` calls ending in a synchronize
    of every card), after one warm-up call."""
    import torch

    out = fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.time()
        fn()
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        times.append(time.time() - t)
    return out, times


def _check_sharded_launches(tag: str, d: int, entry: dict) -> int:
    """Hold a sharded board proof's launches (``entry["launches"]`` and
    ``["entries"]``, per kernel and per C entry) against the one-card
    proof's of the same configuration; -> the sharded commit batches.
    Each sharded commit batch runs one complete bucket pass (K7) a shard
    where one card runs one pass (K2 in the default configuration, K7 in
    the row one), and folds the D partials in one launch of K3's fold,
    which nothing else of a proof calls; the IPA's MSMs stay as on one
    card. So the bucket passes (K2 + K7) grow by D - 1 a batch, and K2
    falls by the batches in the default configuration: no K2 inside the
    sharded commitments. The sharded NTTs launch more NTT stages (K4, or
    K5 in the row configuration) than one card's."""
    sharded, one = entry["launches"], entry["one_card_launches"]
    passes = sharded["K2"] + sharded["K7"] - one.get("K2", 0) - one.get("K7", 0)
    batches, rest = divmod(passes, d - 1)
    fold = entry["entries"].get("bz_point_fold", 0)
    k2 = one.get("K2", 0) - (batches if tag == "default" else 0)
    stage = "K5" if tag == "row" else "K4"
    faults = [f"kernel {k} not launched" for k in PARALLEL_PATH_KERNELS[tag] if sharded[k] <= 0]
    window = "bz_window_sums_planes" if tag == "row" else "bz_window_sums"
    if entry["entries"].get(window, 0) <= 0:  # K3's count alone would pass on the lane-wise fold
        faults.append(f"no {window} launch: the shards' window sums did not run")
    if rest or batches < 1:
        faults.append(f"{passes} more bucket passes than one card, not a positive multiple of D - 1 = {d - 1}")
    if fold != batches:
        faults.append(f"{fold} K3 fold launches, not one for each of {batches} batches")
    if entry["entries"].get("bz_point_add", 0):
        faults.append("the sharded proof launched K3's lane-wise addition")
    if any(entry["one_card_entries"].get(e, 0) for e in ("bz_point_add", "bz_point_fold")):
        faults.append("the one-card proof launched the lane-wise K3")
    if sharded["K2"] != k2:
        faults.append(f"K2 {sharded['K2']}, not {k2}: K2 launched inside the sharded commitments")
    if sharded[stage] <= one.get(stage, 0):
        faults.append(f"{stage} {sharded[stage]} against {one.get(stage, 0)} on one card: the NTTs did not shard")
    if faults:
        raise AssertionError(f"sharded board proof [{tag}]: {'; '.join(faults)}")
    return batches


def run_parallel(dev, timed: Phases) -> dict:
    """The parallel layer (battlezips_halo2_tpu_torch/parallel) on the
    card(s): (a) the golden k = 12 board proof under use_mesh, in the
    default and the row configuration (golden bytes, accepted, a tampered
    copy refused; a steady sharded proof beside a one-card one, and device
    busy per card of each); (b) the four basis transforms of the board's
    domain (n = 2^12 and the extended 2^15) sharded against the unsharded
    ``*_limbs`` transforms; (c) the sharded MSM of an 11-column commit
    batch over the board's [G | W] (4097 points) against
    ``msm_many_table``; (d) the launches of a steady sharded proof, the
    slice's main path, counted from 0, against a one-card proof's
    (:func:`_check_sharded_launches`: the lane-wise K3 folds the partials,
    K2 never launches in the sharded commitments; the IPA rounds' MSMs stay
    unsharded, on K2, as in the reference), and every transform of the
    sharded proofs through the 4-step NTT (no size refused by its shape
    gate, twiddles on the mesh for the board's n); (e) tools/torch_multihost_ntt.py over NCCL
    when two cards are visible. -> the phase's numbers."""
    import torch

    from battlezips_halo2_tpu_torch import api
    from battlezips_halo2_tpu_torch.curves.host import VESTA
    from battlezips_halo2_tpu_torch.ops import cuda
    from battlezips_halo2_tpu_torch.fields.host import FP
    from battlezips_halo2_tpu_torch.ops.msm import msm_many_table
    from battlezips_halo2_tpu_torch.parallel.context import use_mesh
    from battlezips_halo2_tpu_torch.parallel.msm import shard_table, sharded_msm_many_table
    from battlezips_halo2_tpu_torch.parallel.ntt import sharded_transform_batch
    from battlezips_halo2_tpu_torch.poly import transforms as T

    mesh = parallel_mesh()
    log(f"parallel mesh: {mesh}")
    card = card_line()
    golden = json.loads(GOLDEN_BOARD.read_text())
    profile = _load_tool(ROOT / "tools" / "torch_profile_shot.py", "torch_profile_shot")
    report = {"mesh": repr(mesh), "shards": mesh.size, "card": card, "proofs": {}}

    def sharded(fn):
        with use_mesh(mesh):
            return fn()

    # (a) and (d): the board proof under the mesh, in both configurations
    for tag, env in (("default", {}), ("row", {flag: "1" for flag in ROW_FLAGS})):

        def prove(seed, on_mesh=True):
            def run():
                return api.prove_board(GOLDEN_PLACEMENTS, 0xBEEF, rng=random.Random(seed), device=dev)

            return sharded(run) if on_mesh else run()

        def one_config():
            proof = timed(f"sharded prove_board (golden rng) [{tag}]", lambda: prove(golden["seed"]))
            if proof.proof.hex() != golden["proof_hex"]:
                raise AssertionError(f"sharded board proof bytes differ from tests/golden/board_k12.json [{tag}]")
            if not timed(f"sharded verify_board [{tag}]", lambda: sharded(lambda: api.verify_board(proof, dev))):
                raise AssertionError(f"verify_board rejected the sharded golden proof [{tag}]")
            bad = api.BoardProof(proof.commitment, _tampered(proof.proof))
            if timed(f"sharded verify_board (tampered) [{tag}]", lambda: sharded(lambda: api.verify_board(bad, dev))):
                raise AssertionError(f"verify_board accepted a tampered sharded proof [{tag}]")
            name = f"sharded prove_board (fresh rng, steady state) [{tag}]"
            one = f"prove_board (fresh rng, one card) [{tag}]"
            cuda.reset_launches()  # the slice's main path: its counts from 0 just before it, read just after
            steady = timed(name, lambda: prove(8))
            path, path_entries = dict(cuda.launches), dict(cuda.entry_launches)
            single = timed(one, lambda: prove(8, on_mesh=False))
            if steady.proof != single.proof:
                raise AssertionError(f"the sharded proof differs from the one-card proof [{tag}]")
            entry = {"golden_bytes_equal": True, "verified": True, "tampered_refused": True,
                     "sharded_s": timed.seconds[name], "one_card_s": timed.seconds[one],
                     "launches": path, "entries": path_entries,
                     "one_card_launches": {k: v for k, v in timed.launches[one].items() if v},
                     "one_card_entries": timed.entries[one]}
            entry["commit_batches"] = _check_sharded_launches(tag, mesh.size, entry)
            if tag == "default":
                entry["profile_sharded"] = profile.profiled(lambda: prove(9))
                entry["profile_one_card"] = profile.profiled(lambda: prove(9, on_mesh=False))
                for key in ("profile_sharded", "profile_one_card"):
                    entry[key].pop("kernels")
            return entry

        entry = report["proofs"][tag] = _with_env(env, one_config)
        launches, entries = entry["launches"], entry["entries"]
        log(f"sharded board proof [{tag}] on {card}: {entry['sharded_s']:.3f} s against {entry['one_card_s']:.3f} s "
            f"on one card; launches K1 {launches['K1']}, K3 window {entries.get('bz_window_sums', 0)}, K3 lane-wise "
            f"{entries.get('bz_point_fold', 0)} (fold), K4 {launches['K4']}, K5 {launches['K5']}, K6 {launches['K6']}, K7 "
            f"{launches['K7']}, K2 {launches['K2']}; {entry['commit_batches']} sharded commit batches; one card: "
            f"{entry['one_card_launches']}")
        for key in ("profile_sharded", "profile_one_card"):
            if key in entry:
                log(f"  {key}: {entry[key]}")
    # every transform of the sharded proofs went through the 4-step NTT
    sizes = sorted({key[1] for key in mesh.cache if key[0] == "twiddles"})
    log(f"sharded transform sizes (twiddle tables on the mesh): {sizes}; refused by the shape gate: {mesh.unsharded}")
    if mesh.unsharded or api.board_keys(dev)[1].vk.domain.n not in sizes:
        raise AssertionError(f"the sharded proofs' transforms did not all run sharded: twiddles for {sizes}, "
                             f"refused {mesh.unsharded}")
    report["sharded_sizes"] = sizes

    # (b) the board domain's four basis transforms, sharded against unsharded
    p = FP.modulus
    dom = api.board_keys(dev)[1].vk.domain
    rng = random.Random(13)
    vals = _rand_canonical(rng, 4 * dom.n, dev).view(4, dom.n, 8)
    coeff = T.lagrange_to_coeff_limbs(dom, vals)
    ext_n = dom.extended_n
    padded = torch.cat([coeff, torch.zeros(4, ext_n - dom.n, 8, dtype=torch.int32, device=dev)], 1)
    ext = T.coeff_to_extended_limbs(dom, padded)
    cases = {
        "lagrange_to_coeff": (lambda: T.lagrange_to_coeff_limbs(dom, vals),
                              lambda: sharded_transform_batch(mesh, dom.n, pow(dom.omega, -1, p), vals,
                                                              post_k=pow(dom.n, -1, p))),
        "coeff_to_lagrange": (lambda: T.coeff_to_lagrange_limbs(dom, coeff),
                              lambda: sharded_transform_batch(mesh, dom.n, dom.omega, coeff)),
        "coeff_to_extended": (lambda: T.coeff_to_extended_limbs(dom, padded),
                              lambda: sharded_transform_batch(mesh, ext_n, dom.extended_omega, padded,
                                                              pre_g=dom.g_coset)),
        "extended_to_coeff": (lambda: T.extended_to_coeff_limbs(dom, ext),
                              lambda: sharded_transform_batch(mesh, ext_n, pow(dom.extended_omega, -1, p), ext,
                                                              post_g=dom.g_coset_inv, post_k=pow(ext_n, -1, p))),
    }
    report["transforms"] = {}
    for name, (plain_fn, sharded_fn) in cases.items():
        want, one_s = _host_s(plain_fn, PARALLEL_REPS)
        before = dict(cuda.launches)
        sharded_fn()
        calls = {k: v - before[k] for k, v in cuda.launches.items() if v != before[k]}
        got, sharded_s = _host_s(sharded_fn, PARALLEL_REPS)
        if got.device != want.device or not torch.equal(got, want):
            raise AssertionError(f"the sharded {name} differs from the unsharded transform")
        size = ext_n if "extended" in name else dom.n
        report["transforms"][name] = {"n": size, "batch": 4, "sharded_s": sharded_s, "one_card_s": one_s,
                                      "launches": calls}
        log(f"sharded {name} (n = {size}, batch 4) bit-exact; {min(sharded_s) * 1e3:.3f} ms sharded, "
            f"{min(one_s) * 1e3:.3f} ms one card (best of {PARALLEL_REPS}, host clock); launches {calls}")

    # (c) an 11-column commit batch over the board's [G | W]
    params = api.board_keys(dev)[0]
    table = params.gw_table()
    scalars = _rand_canonical(rng, BOARD_COMMIT_BATCH * table.shape[0], dev).view(BOARD_COMMIT_BATCH, -1, 8)
    cut = shard_table(VESTA, table, mesh)
    want, one_s = _host_s(lambda: msm_many_table(VESTA, table, scalars), PARALLEL_REPS)
    got, sharded_s = _host_s(lambda: sharded_msm_many_table(VESTA, cut, scalars, mesh), PARALLEL_REPS)
    if got != want:
        raise AssertionError("the sharded commit batch differs from msm_many_table")
    report["commit_batch"] = {"points": table.shape[0], "columns": BOARD_COMMIT_BATCH, "c": cut.c,
                              "sharded_s": sharded_s, "one_card_s": one_s}
    log(f"sharded MSM of {BOARD_COMMIT_BATCH} columns over {table.shape[0]} points (c = {cut.c} a shard) equals "
        f"msm_many_table; {min(sharded_s) * 1e3:.3f} ms sharded, {min(one_s) * 1e3:.3f} ms one card")

    # (e) the NTT across processes, one card a rank
    if torch.cuda.device_count() >= 2:
        t = time.time()
        out = subprocess.run([sys.executable, str(ROOT / "tools" / "torch_multihost_ntt.py"), "--procs", "2",
                              "--logn", "16", "--timeout", "300"], capture_output=True, text=True, timeout=400,
                             cwd=ROOT)
        for line in out.stdout.splitlines():
            log(f"  multihost: {line}")
        if out.returncode != 0 or "torch_multihost_ntt: OK" not in out.stdout:
            raise AssertionError(f"tools/torch_multihost_ntt.py --procs 2 failed: {out.stderr[-2000:]}")
        report["multihost_s"] = time.time() - t
    else:
        log("multihost: 1 card visible, needs 2")
        report["multihost_s"] = None
    return report


SERVE_KERNELS = ("K1", "K2", "K3", "K4", "K7")  # a default board proof on the device engine
SERVE_ROUNDS = 2  # each op twice on each engine: the first request, then a steady one


def _bench_cold(tag: str) -> dict:
    """``tools/torch_serve.py --bench-cold`` in a fresh process (its
    server's stderr passes through); -> its JSON line's object."""
    out = subprocess.run([sys.executable, str(SERVER), "--bench-cold"], cwd=ROOT, stdout=subprocess.PIPE, text=True,
                         timeout=600, check=False)
    if out.returncode != 0:
        raise AssertionError(f"torch_serve.py --bench-cold ({tag}) exited {out.returncode}: {out.stdout[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def _serve_requests(tampered_board) -> list:
    """(name, request) of one round of the in-process server: a shot, a
    board, a batched session of one game and two shots, verify_board on a
    good and a tampered proof, status."""
    from battlezips_halo2_tpu_torch.utils import Board, Deck

    state = Board.from_deck(Deck.from_placements(GOLDEN_PLACEMENTS)).state()
    ships = [list(p) for p in GOLDEN_PLACEMENTS]
    return [
        ("prove_shot", {"op": "prove_shot", "state_hex": hex(state.value), "trapdoor": 0xBEEF, "shot": [3, 3],
                        "hit": True}),
        ("prove_board", {"op": "prove_board", "ships": ships, "trapdoor": 0xBEEF}),
        ("prove_session", {"op": "prove_session", "games": [ships], "shots_per_game": 2, "batched": True}),
        ("verify_board", lambda board: {"op": "verify_board", "commitment": board["commitment"],
                                        "proof_hex": board["proof_hex"]}),
        ("verify_board (tampered)", lambda board: {"op": "verify_board", "commitment": board["commitment"],
                                                   "proof_hex": tampered_board(board["proof_hex"])}),
        ("status", {"op": "status"}),
    ]


def _check_served(api, dev, name: str, resp: dict) -> None:
    """Every proof the server returned verifies in this process; verify_board
    answers True for the good proof and False for the tampered one."""
    from battlezips_halo2_tpu_torch.utils import Board, Deck

    if not resp.get("ok"):
        raise AssertionError(f"the server refused {name}: {resp}")
    if name == "prove_shot":
        proof = api.ShotProof(tuple(resp["commitment"]), resp["shot"], resp["hit"], bytes.fromhex(resp["proof_hex"]))
        valid = api.verify_shot(proof, device=dev)
    elif name == "prove_board":
        valid = api.verify_board(api.BoardProof(tuple(resp["commitment"]), bytes.fromhex(resp["proof_hex"])), device=dev)
    elif name == "prove_session":
        commitment = tuple(resp["commitments"][0])
        state = Board.from_deck(Deck.from_placements(GOLDEN_PLACEMENTS)).state()
        cells = [(i * 3 % 10) * 10 + i for i in range(len(resp["shot_proofs"]))]  # shot i at (i, 3 i): api's layout
        shots = [api.ShotProof(commitment, 1 << cell, int(state.bit(cell)), bytes.fromhex(h))
                 for cell, h in zip(cells, resp["shot_proofs"])]
        boards = [api.BoardProof(commitment, bytes.fromhex(resp["board_proofs"][0]))]
        valid = len(shots) == 2 and api.verify_session(api.GameSession(boards, shots), device=dev)
    elif name.startswith("verify_board"):
        valid = resp["valid"] is (name == "verify_board")
    else:
        valid = resp["proofs_served"] > 0 and resp["device_error"] is None
    if not valid:
        raise AssertionError(f"the server's {name} did not check out: {json.dumps(resp)[:400]}")


def run_serving(dev, timed: Phases) -> dict:
    """The serving path (tools/torch_serve.py) on the artifact store: a cold
    start (no port artifact yet: it derives the SRS and keys and writes
    them), a warm start (it loads them; no file is rewritten), then the
    server in this process: every op under BZ_PROOF_ENGINE=device, then
    under auto, SERVE_ROUNDS times each, every returned proof verified
    here. The loaded keys' vk digests must be the golden ones; a board proof
    launches K1, K2, K3, K4 and K7 under device and nothing under auto.
    -> the phase's numbers."""
    from battlezips_halo2_tpu_torch import api, artifacts, native

    card = card_line()
    store = artifacts.directory()
    if store.exists() and any(store.iterdir()):
        raise AssertionError(f"port artifacts exist before the cold start: {sorted(p.name for p in store.iterdir())}")
    report = {"card": card, "cold": _bench_cold("cold")}
    files = {p.name: p.stat() for p in sorted(store.iterdir())}
    report["artifact_bytes"] = {name: st.st_size for name, st in files.items()}
    if len(files) != 4:
        raise AssertionError(f"the cold start wrote {sorted(files)}, not the two SRS and the two keys")
    report["warm"] = _bench_cold("warm")
    if {p.name: p.stat().st_mtime_ns for p in store.iterdir()} != {n: st.st_mtime_ns for n, st in files.items()}:
        raise AssertionError("the warm start rewrote an artifact instead of loading it")
    for tag in ("cold", "warm"):
        r = report[tag]
        log(f"serving [{card}]: {tag} start: ready {r['detail']['cold_to_ready_s']:.3f} s, first proof (shot) "
            f"{r['value']:.3f} s (its latency {r['detail']['shot_latency_s']:.3f}), board "
            f"{r['detail']['board_latency_s']:.3f} s")
    for name, size in report["artifact_bytes"].items():
        log(f"serving: artifact {name}: {size} bytes")

    serve = _load_tool(SERVER, "torch_serve")
    name = "serve: Server() in process (keys from the artifact store)"
    server = timed(name, lambda: serve.Server())
    report["in_process_ready_s"] = timed.seconds[name]
    for circuit, keys, golden in (("shot", api.shot_keys(dev), GOLDEN), ("board", api.board_keys(dev), GOLDEN_BOARD)):
        if hex(keys[1].vk.digest) != json.loads(golden.read_text())["vk_digest"]:
            raise AssertionError(f"the loaded {circuit} key's vk digest differs from {golden.name}")
    log("serving: the loaded shot and board keys' vk digests equal the golden ones")
    t = time.time()
    native.build()
    native.load()
    log(f"serving: native host library built for the auto engine in {time.time() - t:.3f} s")

    ops = {}
    for engine in ("device", "auto"):
        for i in range(SERVE_ROUNDS):
            board = None
            for name, req in _serve_requests(_tampered_hex):
                req = req(board) if callable(req) else req
                phase = f"serve {name} #{i} [{engine}]"
                resp = _with_env({"BZ_PROOF_ENGINE": engine}, lambda: timed(phase, lambda: server.handle(req)))
                board = resp if name == "prove_board" else board
                _check_served(api, dev, name, resp)
                entry = ops.setdefault(engine, {}).setdefault(name, {"seconds": [], "latency_s": [], "launches": []})
                entry["seconds"].append(timed.seconds[phase])
                entry["latency_s"].append(resp.get("latency_s"))
                entry["launches"].append({k: v for k, v in timed.launches[phase].items() if v})
            launched = timed.launches[f"serve prove_board #{i} [{engine}]"]
            if engine == "device" and any(launched[k] <= 0 for k in SERVE_KERNELS):
                raise AssertionError(f"prove_board on the device engine did not launch all of {SERVE_KERNELS}: {launched}")
            if engine == "auto" and any(launched.values()):
                raise AssertionError(f"prove_board under auto launched kernels: {launched}")
    report["ops"] = ops
    for engine, by_op in ops.items():
        for name, r in by_op.items():
            log(f"serving [{card}] [{engine}]: {name}: seconds {', '.join(f'{x:.4f}' for x in r['seconds'])}; "
                f"launches {r['launches']}")
    log("serving: every server proof verified here, the tampered board refused; prove_board launched "
        f"{', '.join(SERVE_KERNELS)} under device and nothing under auto")
    # the main path proves on fresh keys, loaded from the files, with no cache of this phase attached
    artifacts.forget()
    api._shot_keys.cache_clear()
    api._board_keys.cache_clear()
    return report


def _tampered_hex(proof_hex: str) -> str:
    return _tampered(bytes.fromhex(proof_hex)).hex()


NTT_MM_LOGNS = (16, 18, 20)  # the reference's auto range on a TPU (2^16-2^21; 2^21 exceeds its limit)
BOARD_EXT_BATCH, BOARD_EXT_LOGN = 17, 15  # the per-proof polynomials the board's quotient extends, to 2^15


def _m1_bound(batch: int, kp: int, k: int, m: int) -> tuple[float, str]:
    """M1's bound, what the function needs at the integer rate: W, a and
    out each moved once; a term's 64 wide limb products and one Montgomery
    reduction an output (the sum kept wide, reduced once), additions folded
    into the multiply-adds."""
    terms, outputs = batch * kp * k * m, batch * kp * m
    return bound_ms(32 * (kp * k + batch * k * m + batch * kp * m),
                    terms * WIDE_PRODUCT_RESULTS + outputs * (CC_MONT_MUL_RESULTS - WIDE_PRODUCT_RESULTS))


def _m1_int8_bound(batch: int, kp: int, k: int, m: int) -> float:
    """ms of the reference's chunk-plane form of the same product on the
    int8 tensor cores: every pair of W R's and a's 32 8-bit chunks a
    multiply-add (two operations) a term, at the dense int8 peak, or the
    bytes, whichever is longer."""
    nbytes = 32 * (kp * k + batch * k * m + batch * kp * m)
    ops = 2 * REFERENCE_CHUNK_PAIRS * batch * kp * k * m
    return max(nbytes / HBM_BYTES_PER_S, ops / INT8_MMA_OPS_PER_S) * 1e3


def run_board_ntt_mm(dev, timed: Phases) -> dict:
    """The golden board proof under BZ_NTT_MM=on (every NTT on the matrix
    product), its verify and a steady proof; the bytes must be
    tests/golden/board_k12.json's, M1 must launch and K4 / K5 must not.
    -> the launches of the three phases."""
    from battlezips_halo2_tpu_torch import api
    from battlezips_halo2_tpu_torch.ops import cuda

    golden = json.loads(GOLDEN_BOARD.read_text())
    before = dict(cuda.launches)
    caller = os.environ.get("BZ_NTT_MM")
    os.environ["BZ_NTT_MM"] = "on"
    try:
        proof = timed("prove_board (golden rng) [BZ_NTT_MM=on]",
                      lambda: api.prove_board(GOLDEN_PLACEMENTS, 0xBEEF, rng=random.Random(golden["seed"]), device=dev))
        accepted = timed("verify_board [BZ_NTT_MM=on]", lambda: api.verify_board(proof, device=dev))
        timed("prove_board (fresh rng, steady state) [BZ_NTT_MM=on]",
              lambda: api.prove_board(GOLDEN_PLACEMENTS, 0xBEEF, rng=random.Random(8), device=dev))
    finally:
        if caller is None:
            os.environ.pop("BZ_NTT_MM")
        else:
            os.environ["BZ_NTT_MM"] = caller
    delta = {k: cuda.launches[k] - before[k] for k in before}
    if proof.proof.hex() != golden["proof_hex"]:
        raise AssertionError("board proof bytes under BZ_NTT_MM=on differ from tests/golden/board_k12.json")
    if not accepted:
        raise AssertionError("verify_board rejected the golden proof made under BZ_NTT_MM=on")
    if delta["M1"] <= 0 or delta["K4"] or delta["K5"]:
        raise AssertionError(f"the BZ_NTT_MM=on board proofs took the wrong kernels: {delta}")
    log(f"golden board proof bytes equal under BZ_NTT_MM=on, accepted; launches {delta}")
    return delta


def check_m1(dev, rng: random.Random) -> dict:
    """M1 against its plain version, bit for bit: a batch of 3 by a (12, 16)
    matrix in Montgomery form and as given (mont=False), the all-(p - 1)
    matrix, and the board's (17, 2^15) batch's row product (17 rows of
    (256, 128) by the (256, 256) DFT matrix of its plan), which is timed
    device-paced (one launch) beside the plain version; the column product
    of that NTT is timed too."""
    from battlezips_halo2_tpu_torch.fields.host import FP
    from battlezips_halo2_tpu_torch.fields.limb import FP_SPEC
    from battlezips_halo2_tpu_torch.ops import ntt_mm as MM
    from battlezips_halo2_tpu_torch.ops.timing import device_paced_ms

    spec, p = FP_SPEC, FP.modulus
    err = 0
    a = _rand_field(rng, p, 3 * 16 * 5, dev).view(3, 16, 5, 8)
    w_ints = [[rng.randrange(p) for _ in range(16)] for _ in range(12)]
    for w, mont in ((w_ints, True), (w_ints, False), ([[p - 1] * 16] * 12, True)):
        err = max(err, max_abs_err(MM.fp_const_matmul(spec, w, a, mont=mont),
                                   MM.fp_const_matmul_plain(spec, w, a, mont=mont)))
    logn = BOARD_EXT_LOGN
    omega = pow(FP.root_of_unity, 1 << (FP.two_adicity - logn), p)
    plan = MM.mm_plan_for(p, 1 << logn, omega, str(dev))
    per_shape = []
    for name, w, k, m in (("row product", plan.w1, plan.n1, plan.n2), ("column product", plan.w2, plan.n2, plan.n1)):
        x = _rand_canonical(rng, BOARD_EXT_BATCH * k * m, dev).view(BOARD_EXT_BATCH, k, m, 8)
        got = MM.fp_const_matmul(spec, w, x)
        ms = device_paced_ms(lambda: MM.fp_const_matmul(spec, w, x), 20)
        row = {"shape": f"{name} of the ({BOARD_EXT_BATCH}, 2^{logn}) batch: ({BOARD_EXT_BATCH}, {k}, {m}, 8) by "
                        f"({k}, {k})", "ms": ms}
        row["bound_ms"], row["bound_by"] = _m1_bound(BOARD_EXT_BATCH, k, k, m)
        row["int8_mma_bound_ms"] = _m1_int8_bound(BOARD_EXT_BATCH, k, k, m)
        if not per_shape:
            want, row["plain_ms"] = once_ms(lambda: MM.fp_const_matmul_plain(spec, w, x))
            err = max(err, max_abs_err(got, want))
        per_shape.append(row)
        log(f"  M1 {row['shape']}: {ms:.4f} ms device-paced, bound {row['bound_ms']:.4f} ms ({row['bound_by']}), "
            f"{100 * row['bound_ms'] / ms:.1f} % of it; the chunk-plane form on the int8 tensor cores "
            f"{row['int8_mma_bound_ms']:.4f} ms" + (f"; plain {row['plain_ms']:.1f} ms" if "plain_ms" in row
                                                          else ""))
    first = per_shape[0]
    return {"max_abs_err": err, "ms": first["ms"], "plain_ms": first["plain_ms"], "bound_ms": first["bound_ms"],
            "bound_by": first["bound_by"], "int8_mma_bound_ms": first["int8_mma_bound_ms"], "library_ms": None,
            "shape": f"{first['shape']}, Fp, device-paced (per_shape: both products)", "per_shape": per_shape}


def check_ntt_mm(dev, rng: random.Random) -> list:
    """The matrix-product NTT (ops/ntt_mm.py: two M1 launches and a K1
    twiddle) against the K4 route, bit for bit, at n = 2^16, 2^18, 2^20 and
    the board's (17, 2^15) batch, both timed device-paced in turns, with the
    plan's build seconds."""
    from battlezips_halo2_tpu_torch.fields.host import FP
    from battlezips_halo2_tpu_torch.ops import ntt as D
    from battlezips_halo2_tpu_torch.ops import ntt_mm as MM

    p, rows = FP.modulus, []
    for batch, logn in [(1, logn) for logn in NTT_MM_LOGNS] + [(BOARD_EXT_BATCH, BOARD_EXT_LOGN)]:
        n = 1 << logn
        omega = pow(FP.root_of_unity, 1 << (FP.two_adicity - logn), p)
        x = _rand_canonical(rng, batch * n, dev).view(batch, n, 8)
        plan = D.plan_for(p, n, omega, str(dev))
        t = time.time()
        mm_plan = MM.mm_plan_for(p, n, omega, str(dev))
        plan_s = time.time() - t
        err = max_abs_err(MM.ntt_mm(mm_plan, x), D.ntt(plan, x))
        if err:
            raise AssertionError(f"ntt_mm differs from the K4 route at ({batch}, 2^{logn})")
        turns = in_turns({"ntt_mm": lambda: MM.ntt_mm(mm_plan, x), "K4": lambda: D.ntt(plan, x)},
                         3 if logn >= 20 else 10)
        bounds = [_m1_bound(batch, k, k, m) for k, m in ((mm_plan.n2, mm_plan.n1), (mm_plan.n1, mm_plan.n2))]
        bms, by = sum(b for b, _ in bounds), "/".join(sorted({by for _, by in bounds}))
        int8_ms = sum(_m1_int8_bound(batch, k, k, m) for k, m in ((mm_plan.n2, mm_plan.n1), (mm_plan.n1, mm_plan.n2)))
        row = {"batch": batch, "logn": logn, "n1": mm_plan.n1, "n2": mm_plan.n2, "max_abs_err": err,
               "ntt_mm_ms": _mean(turns["ntt_mm"]), "k4_ms": _mean(turns["K4"]), "turns": turns,
               "m1_bound_ms": bms, "m1_int8_mma_bound_ms": int8_ms, "plan_s": plan_s}
        rows.append(row)
        log(f"  ntt_mm ({batch}, 2^{logn}) [n1 {mm_plan.n1}, n2 {mm_plan.n2}]: {row['ntt_mm_ms']:.4f} ms against the "
            f"K4 route's {row['k4_ms']:.4f} ms ({row['ntt_mm_ms'] / row['k4_ms']:.1f}x; turns {turns}), bit-exact; "
            f"its two M1 launches' bound {bms:.6f} ms ({by}), {int8_ms:.6f} ms as int8 chunk planes; "
            f"plan built in {plan_s:.2f} s")
    return rows


def run_microbenchmark(dev) -> tuple[dict, dict]:
    """The K8 / K9 path: tools/torch_exp_step_t.py at the reference's
    shapes, every K9 op. The tool holds each kernel bit for bit against its
    plain chain and times both. -> rows for K8 and K9."""
    from battlezips_halo2_tpu_torch.fields.limb import CHAIN_OPS

    micro = _load_tool(MICROBENCHMARK, "torch_exp_step_t")
    cfg = micro.settings()
    chain = micro.run_chain(dev, cfg["n"], cfg["steps"])
    kmicro = micro.run_kmicro(dev, cfg["n"], cfg["reps"], list(CHAIN_OPS))
    n, steps, reps = chain["n"], chain["steps"], kmicro["reps"]
    bms, by = bound_ms(n * (96 + 96 + 64) + steps * n, chain["additions"] * 11 * MONT_MUL_RESULTS)
    k8 = {
        "max_abs_err": chain["max_abs_err"], "ms": chain["one_launch"]["ms"], "plain_ms": chain["plain_ms"],
        "bound_ms": bms, "bound_by": by, "ms_launch_per_step": chain["launch_per_step"]["ms"],
        "host_paced_ms": chain["one_launch"]["host_paced_ms"],
        "host_paced_ms_launch_per_step": chain["launch_per_step"]["host_paced_ms"],
        "shape": f"{n} lanes x {steps} steps, Vesta, {chain['additions']} additions; one launch, device-paced",
    }
    op_results = {"mul": MONT_MUL_RESULTS, "redc": MONT_MUL_RESULTS - 128, **CHAIN_OP_RESULTS}
    per_op = {}
    for op, r in kmicro["ops"].items():
        obms, oby = bound_ms(n * 3 * 32, n * reps * op_results[op])
        per_op[op] = {"ms": r["ms"], "host_paced_ms": r["host_paced_ms"], "plain_ms": r["plain_ms"],
                      "bound_ms": obms, "bound_by": oby, "max_abs_err": r["max_abs_err"],
                      "library_ms": r.get("library_ms"), "library_max_abs_err": r.get("library_max_abs_err")}
        if r.get("library_max_abs_err"):
            raise AssertionError(f"K9 {op}'s library call differs from the plain chain")
    mul = per_op["mul"]
    k9 = {
        "max_abs_err": max(r["max_abs_err"] for r in per_op.values()), "ms": mul["ms"], "plain_ms": mul["plain_ms"],
        "bound_ms": mul["bound_ms"], "bound_by": mul["bound_by"], "host_paced_ms": mul["host_paced_ms"],
        "launch_floor_ms": kmicro["launch_floor_ms"], "per_op": per_op,
        "shape": f"mul x {reps} over {n} Fq elements, device-paced (per_op: every op)",
    }
    log(f"  launch floor (K9 noop, device-paced): {kmicro['launch_floor_ms']:.4f} ms a launch")
    for op, r in per_op.items():
        lib = "" if r["library_ms"] is None else f", library {r['library_ms']:.4f} ms"
        log(f"  K9 {op}: {r['ms']:.4f} ms device-paced, {r['host_paced_ms']:.4f} host-paced, bound "
            f"{r['bound_ms']:.6f} ({r['bound_by']}), floor + bound {kmicro['launch_floor_ms'] + r['bound_ms']:.4f}{lib}")
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


def sass_mont_mul(lib: Path, old_lib: Path) -> dict:
    """Multiply instructions and results of one Montgomery product, a
    kernel's multiply variant minus its add variant, which share every
    instruction but the product's: K1's elementwise kernel in the old build
    (the 64-bit product, which K2-K7 still use), in the tree's build and
    K9's (the carry-chain product of K1 elementwise, K3 lane-wise, K8 and
    K9). -> {name: (instructions, results)}."""
    from battlezips_halo2_tpu_torch.ops import cuda

    out = {}
    for name, path, kernel in (("64-bit", old_lib, "_Z15field_op_kernelILi"),
                               ("carry chain, K1", lib, "_Z15field_op_kernelILi"),
                               ("carry chain, K9", lib, "_Z15op_chain_kernelILi")):
        counts = cuda.sass_counts(path)
        (mul,), (add,) = ([v for k, v in counts.items() if k.startswith(f"{kernel}{op}E")] for op in (0, 1))
        out[name] = (mul[1] - add[1], mul[2] - add[2])
    return out


def report_rows(rows: dict) -> None:
    for name, r in rows.items():
        host = f" ({r['host_paced_ms']:.4f} ms host-paced)" if r.get("host_paced_ms") is not None else ""
        log(f"  {name} {r['shape']}: max_abs_err {r['max_abs_err']}, kernel {r['ms']:.4f} ms{host}, "
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
    with ThreadPoolExecutor(max_workers=1) as pool:  # the old build beside the port's, each nvcc in parallel
        previous = pool.submit(build_previous)
        lib = cuda.build()
        old_lib = previous.result()
    cuda.library()
    old = load_previous(old_lib)
    log(f"phase build: {time.time() - t:.3f} s ({lib}; old build of csrc/previous/ {old_lib})")
    for line in cuda.ptxas_report(lib):
        log(f"  ptxas {line}")
    for line in cuda.ptxas_report(old_lib):
        log(f"  ptxas [old build] {line}")

    global OPS_PER_S, MONT_MUL_RESULTS, CC_MONT_MUL_RESULTS
    OPS_PER_S, sms, clock = card_int_rate()
    products = sass_mont_mul(lib, old_lib)
    MONT_MUL_RESULTS, CC_MONT_MUL_RESULTS = products["64-bit"][1], products["carry chain, K1"][1]
    log(f"operations bound: {INT_RESULTS_PER_SM_CLOCK} results/SM/clock x {sms} SMs x {clock / 1e6:.0f} MHz = "
        f"{OPS_PER_S:.4g}/s; Montgomery product in SASS (CIOS count {MAD_PER_MONT_MUL}): "
        + "; ".join(f"{k} {i} multiply instructions, {r} results" for k, (i, r) in products.items())
        + f" (the bounds count {MONT_MUL_RESULTS} for the 64-bit kernels, {CC_MONT_MUL_RESULTS} for K1 elementwise "
        "and K3 lane-wise)")

    # the serving path: tools/torch_serve.py cold and warm, then in process on both engines
    cuda.reset_launches()
    t = time.time()
    serving = run_serving(dev, Phases())
    serving["launches"] = dict(cuda.launches)
    log(f"phase serving: {time.time() - t:.3f} s, launches {serving['launches']}")

    rng = random.Random(2024)
    t = time.time()
    lane_wise, rows = {}, {}
    rows["K4"] = check_k4(dev, rng, [(4, 11), (2, 13)], 44, 14)
    lane_wise["K3"] = check_k3(dev, rng, 4096, old)
    lane_wise["K3"]["fold"] = check_k3_fold(dev, rng, old)
    lane_wise["K3"]["max_abs_err"] = max(lane_wise["K3"]["max_abs_err"], lane_wise["K3"]["fold"]["max_abs_err"])
    # a board commit batch's window sums (c = 8: 32 windows of 256 buckets, one
    # column and 11 columns), an IPA round's (c = 2), signed c = 10 (26 windows x 4)
    window_shapes = [(352, 256), (32, 256), (2, 4), (104, 513)]
    rows["K3"] = check_k3_windows(dev, rng, window_shapes)
    rows["K2"], rows["K7"] = check_k2_k7(dev, rng)
    rows["K6"] = check_k6_windows(dev, rng, window_shapes)
    lane_wise["K6"] = check_k6(dev, rng, 4096, old)
    log(f"phase kernels vs plain: {time.time() - t:.3f} s")
    report_rows({**rows, "K3 lane-wise point_add and fold": lane_wise["K3"],
                 "K6 lane-wise point_add_planes": lane_wise["K6"]})
    for name in ("K3", "K6"):
        for r in rows[name]["per_shape"]:
            log(f"  {name} window kernel {r['rows']} x {r['nbuck']} ({r['threads_per_row']} threads x "
                f"{r['segment']}): {r['ms']:.4f} ms, old route {r['old_route_ms']:.4f} ms, plain "
                f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.6f} ms ({r['bound_by']})")

    # the proof path: K1-K7
    cuda.reset_launches()
    timed, row_launches, session_launches, session_bytes = run_main_path(dev)
    launches = dict(cuda.launches)
    log(f"proof path launches: {launches}")
    missing = [k for k in PROOF_PATH_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the proof path: {missing}")

    # the native host engine and its routes: auto (no kernel), the hybrid (K1-K4), host (no kernel)
    cuda.reset_launches()
    t = time.time()
    native_report = run_native_engine(dev, timed, session_bytes)
    native_report["launches"] = dict(cuda.launches)
    log(f"phase native engine: {time.time() - t:.3f} s, launches {native_report['launches']}")
    missing = [k for k in ("K1", "K2", "K3", "K4") if native_report["launches"][k] <= 0]
    if missing:  # the hybrid's kernels (its sessions' own counts are checked in the phase)
        raise AssertionError(f"kernels not launched in the native engine phase: {missing}")

    # the parallel layer: the board proof under a mesh (its launches counted
    # from 0 around each configuration's steady sharded proof), sharded
    # transforms and commitments
    t = time.time()
    parallel = run_parallel(dev, timed)
    parallel["launches"] = {tag: entry["launches"] for tag, entry in parallel["proofs"].items()}
    log(f"phase parallel: {time.time() - t:.3f} s on {card_line()}, sharded board proof launches "
        f"{parallel['launches']}")

    # K5 at the board's own extended-domain shape: every polynomial the
    # quotient extends, at the vk's extended domain
    from battlezips_halo2_tpu_torch import api
    from battlezips_halo2_tpu_torch.ops.gate_eval import quotient_poly_keys
    from battlezips_halo2_tpu_torch.plonk.arguments import ProofSchedule

    vk = api.board_keys(dev)[1].vk
    keys = quotient_poly_keys(vk.cs, ProofSchedule.build(vk.cs).num_perm_chunks)
    rows["K5"] = check_k5(dev, rng, [(4, 11), (2, 13)], len(keys), vk.domain.extended_n.bit_length() - 1)
    # K1's elementwise product at the board's shapes: the polynomials each
    # proof's quotient extends (K), the domain n and the extended domain
    per_proof = sum(k[0] not in ("fixed", "sigma") for k in keys)
    n, ext = vk.domain.n, vk.domain.extended_n
    lane_wise["K1"] = check_k1(dev, rng, 1 << 13, old, {
        "quotient extension batch (the coset pre-scale's shape while it ran on the padded batch)": (per_proof, ext, ext),
        "quotient coset pre-scale (unpadded coefficients)": (per_proof, n, n),
        "h's coset and 1/n post-scale": (1, ext, ext),
        "2^20 rows by a coset vector (the block size's reference shape)": (32, ext, ext),
        "commit group's iNTT 1/n scale": (BOARD_COMMIT_BATCH, n, 1),
        "the shape of earlier timings": (1, 1 << 14, 1 << 14),
    })
    report_rows({"K1 elementwise field_op": lane_wise["K1"]})
    # K1's VM on the board's program (one proof) and the shot's (four proofs)
    t = time.time()
    rows["K1"] = check_k1_vm(dev, rng, vk, api.shot_keys(dev)[1].vk)
    log(f"phase K1 VM vs plain: {time.time() - t:.3f} s")
    report_rows({"K5": rows["K5"], "K1": rows["K1"], "K1 (shot, B=4)": rows["K1"]["shot"]})
    for name in ("K1", "K3", "K6"):
        log(f"  {name} old route: {rows[name]['old_route_ms']:.4f} ms against {rows[name]['ms']:.4f} ms")

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

    # the matrix-product NTT: the golden board proof under BZ_NTT_MM=on (M1,
    # no K4 / K5), then M1 against its plain version and the NTT against K4
    cuda.reset_launches()
    t = time.time()
    ntt_mm_report = {"launches": run_board_ntt_mm(dev, timed)}
    for name in NTT_MM_PATH_KERNELS:
        launches[name] = cuda.launches[name]
    missing = [k for k in NTT_MM_PATH_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the BZ_NTT_MM=on path: {missing}")
    rows["M1"] = check_m1(dev, rng)
    ntt_mm_report["ntt"] = check_ntt_mm(dev, rng)
    log(f"phase matrix-product NTT: {time.time() - t:.3f} s on {card_line()}")
    report_rows({"M1": rows["M1"]})

    kernels = []
    for name, (fn, src, replaces) in KERNELS.items():
        r = rows[name]
        extra = {k: r[k] for k in ("ms_launch_per_step", "host_paced_ms", "host_paced_ms_launch_per_step",
                                   "launch_floor_ms", "per_op", "old_route_ms", "per_shape", "resident_threads",
                                   "shot", "three_point", "int8_mma_bound_ms") if k in r}
        if name in lane_wise:  # the elementwise kernel beside the new entry, under the same name
            extra["elementwise_kernel"] = {**lane_wise[name], "source": {
                "K1": "battlezips_halo2_tpu_torch/csrc/field_ops.cu",
                "K3": "battlezips_halo2_tpu_torch/csrc/point_add.cu",
                "K6": "battlezips_halo2_tpu_torch/csrc/point_add.cu"}[name]}
        kernels.append({
            "name": f"{name} {fn}", "route": "cuda", "source": f"battlezips_halo2_tpu_torch/{src}",
            "replaces": replaces, "launches": launches[name],
            "parallel_launches": {tag: counts[name] for tag, counts in parallel["launches"].items()},
            "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r.get("library_ms"), "shape": r["shape"], **extra,
        })
    log(f"chip_smoke total: {time.time() - T_START:.1f} s")
    print(json.dumps({"kernels": kernels, "phases_s": timed.seconds, "row_configuration_launches": row_launches,
                      "session_launches": session_launches, "native_engine": native_report, "serving": serving,
                      "parallel": parallel, "ntt_mm": ntt_mm_report,
                      "ops_per_s": OPS_PER_S, "mont_mul_results": MONT_MUL_RESULTS}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
