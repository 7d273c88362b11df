#!/usr/bin/env python3
"""End-to-end drive of battlezips_halo2_tpu_torch's public API on an NVIDIA
card: the verify recipe, one counterpart of the reference's three drive scripts
(tools/drive_e2e.py, tools/drive_verify.py, tools/verify_drive.py), with
the union of their checks:

1. domain flow (deck -> board -> state -> Pedersen commitment) and the
   commitment against the raw generator arithmetic, on two boards;
2. malicious-witness probes: an OVERSIZED witness option changes the
   witness, and an overlapping BinaryValue.zip raises;
3. device kernels against host ints: the Montgomery product (raw, and
   through to_mont / from_mont), an MSM and a batch of MSMs against the
   host Pippenger, and the fused commit_lagrange_many against the iNTT on
   the host followed by commit_many;
4. a shot proof round trip (prove_shot -> verify_shot), and the rejection
   of a tampered proof byte and of a flipped public hit.

    python3 tools/torch_drive_e2e.py [--device cpu]

from the repo root. The default device is the card; ``--device cpu`` runs
the plain PyTorch versions for a look on the CPU (set
``BZ_PROOF_ENGINE=host`` there for a proof in seconds). The engine
configuration is the environment's. Prints one line per check and ends with
"DRIVE OK"; any failed check raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import random
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

T0 = time.time()


def ok(name: str) -> None:
    print(f"  ok: {name}  [{time.time() - T0:.1f}s]", flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def domain_flow():
    from battlezips_halo2_tpu_torch.curves.host import PALLAS
    from battlezips_halo2_tpu_torch.utils import Board, Deck, pedersen_commit
    from battlezips_halo2_tpu_torch.utils.constants import BOARD_COMMIT_R_GENERATOR, BOARD_COMMIT_V_GENERATOR

    boards = {
        "five ships in rows 0-4": [(0, 0, False), (0, 1, False), (0, 2, False), (0, 3, False), (0, 4, False)],
        "the demo's board": [(3, 3, True), (5, 4, False), (0, 1, False), (0, 5, True), (6, 1, False)],
    }
    for (name, placements), trapdoor in zip(boards.items(), (12345678901234567890, 0x1234_5678_9ABC)):
        board = Board.from_deck(Deck.from_placements(placements))
        state = board.state()
        com = pedersen_commit(state.to_fp(), trapdoor)
        raw = PALLAS.add(PALLAS.mul(BOARD_COMMIT_V_GENERATOR, state.to_fp()), PALLAS.mul(BOARD_COMMIT_R_GENERATOR, trapdoor))
        check(com == raw, f"pedersen_commit differs from the raw generator arithmetic ({name})")
    ok("domain flow + Pedersen commitment against the raw generator arithmetic (two boards)")
    return board, state, trapdoor


def witness_probes(board):
    from battlezips_halo2_tpu_torch.utils import DEFAULT_WITNESS_OPTIONS, BinaryValue, WitnessOption

    good = board.witness(DEFAULT_WITNESS_OPTIONS)
    for options in ([WitnessOption.OVERSIZED] * 5, [WitnessOption.OVERSIZED] + list(DEFAULT_WITNESS_OPTIONS[1:])):
        bad = board.witness(options)
        check(any(a.value != b.value for a, b in zip(good, bad)), f"witness options {options} changed nothing")
    ok("malicious witness options change the witness")
    for a, b in ((BinaryValue(0b11), BinaryValue(0b10)), (BinaryValue.from_fp(1), BinaryValue.from_fp(1)),
                 (BinaryValue.empty().with_bit(0, True), BinaryValue.empty().with_bit(0, True))):
        try:
            a.zip(b)
        except ValueError:
            continue
        raise AssertionError("an overlapping BinaryValue.zip did not raise")
    ok("overlapping BinaryValue.zip raises")


def device_kernels(dev):
    from battlezips_halo2_tpu_torch.curves.host import VESTA
    from battlezips_halo2_tpu_torch.fields import limb as L
    from battlezips_halo2_tpu_torch.fields.host import FP
    from battlezips_halo2_tpu_torch.fields.limb import FP_SPEC, ints_to_limbs, limbs_to_ints
    from battlezips_halo2_tpu_torch.ops.msm import msm, msm_many
    from battlezips_halo2_tpu_torch.pcs.ipa import Params, commit_lagrange_many, commit_many
    from battlezips_halo2_tpu_torch.poly.domain import EvaluationDomain

    rng = random.Random(7)
    p = FP.modulus
    xs = [rng.randrange(p) for _ in range(1024)]
    ys = [rng.randrange(p) for _ in range(1024)]
    a, b = ints_to_limbs(xs, dev), ints_to_limbs(ys, dev)
    r_inv = pow(1 << 256, -1, p)
    check(limbs_to_ints(L.mont_mul(FP_SPEC, a, b)) == [x * y * r_inv % p for x, y in zip(xs, ys)],
          "the device Montgomery product differs from the host's")
    prod = L.from_mont(FP_SPEC, L.mont_mul(FP_SPEC, L.to_mont(FP_SPEC, a), L.to_mont(FP_SPEC, b)))
    check(limbs_to_ints(prod) == [x * y % p for x, y in zip(xs, ys)], "the device field product differs from the host's")
    ok(f"device Montgomery product bit-exact against host ints (1024 lanes, {dev})")

    pts = [VESTA.mul(VESTA.generator, rng.randrange(1, VESTA.scalar.modulus)) for _ in range(256)]
    sc = [rng.randrange(VESTA.scalar.modulus) for _ in range(256)]
    check(msm(VESTA, pts, sc, dev) == VESTA.pippenger(pts, sc), "the device MSM differs from the host Pippenger")
    ok("device MSM (2^8 points) bit-exact against the host Pippenger")
    sc_list = [[rng.randrange(VESTA.scalar.modulus) for _ in range(256)] for _ in range(5)]
    got = msm_many(VESTA, pts, sc_list, dev)
    check(got == [VESTA.pippenger(pts, s) for s in sc_list], "the batched device MSM differs from the host Pippenger")
    ok("batched device MSM (5 x 2^8) bit-exact against the host Pippenger")

    params = Params.new(8, dev)
    domain = EvaluationDomain(8, 2)
    vals = [[rng.randrange(p) for _ in range(domain.n)] for _ in range(3)]
    blinds = [rng.randrange(p) for _ in range(3)]
    polys, points = commit_lagrange_many(params, domain, vals, blinds)
    want = [domain.lagrange_to_coeff(v) for v in vals]
    check([list(q) for q in polys] == want and points == commit_many(params, want, blinds),
          "commit_lagrange_many differs from the host iNTT + commit_many")
    ok("fused commit_lagrange_many bit-identical to the host iNTT + commit_many")


def shot_round_trip(dev, state, trapdoor):
    from battlezips_halo2_tpu_torch import api

    t = time.time()
    api.shot_keys(dev)
    ok(f"shot keys (artifact store) in {time.time() - t:.1f}s")
    hit = bool(state.bit(3 * 10 + 3))
    t = time.time()
    proof = api.prove_shot(state, trapdoor, (3, 3), hit, device=dev)
    t_prove = time.time() - t
    t = time.time()
    check(api.verify_shot(proof, device=dev), "a valid shot proof did not verify")
    ok(f"prove_shot (hit={hit}) {t_prove:.2f}s -> verify_shot {time.time() - t:.2f}s (k=11)")
    bad = bytearray(proof.proof)
    bad[len(bad) // 2] ^= 1
    check(not api.verify_shot(dataclasses.replace(proof, proof=bytes(bad)), device=dev), "a tampered proof verified")
    ok("tampered proof byte rejected")
    check(not api.verify_shot(dataclasses.replace(proof, hit=1 - proof.hit), device=dev), "a flipped public hit verified")
    ok("flipped public hit rejected")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card)")
    args = ap.parse_args()
    import torch

    from battlezips_halo2_tpu_torch.ops.cuda import resolve_device

    dev = resolve_device(args.device)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"[drive] torch {torch.__version__}, device {dev} ({name})", flush=True)
    board, state, trapdoor = domain_flow()
    witness_probes(board)
    device_kernels(dev)
    shot_round_trip(dev, state, trapdoor)
    print(f"DRIVE OK [{time.time() - T0:.1f}s]", flush=True)


if __name__ == "__main__":
    main()
