#!/usr/bin/env python3
"""A game session proved across processes with the port
(battlezips_halo2_tpu_torch), proof-batch data parallelism over
torch.distributed ranks.

Each rank proves the board and shot jobs whose index lands on it (job i on
rank i mod N), on its own card (NCCL, rank r on cuda:r) or on the CPU
(gloo, ``--device cpu``). The proof bytes then go through the collective
itself: a proof's length is fixed by its circuit
(plonk/format.py::proof_size), each job is one fixed-size uint8 row (proof
and instance), a rank's rows for the jobs it did not prove are zero, and one
all-reduce (parallel/collectives.py::psum) sums the ranks' rows into every
proof. Rank 0 then verifies every proof and prints the session's proofs per
second. The jobs and their seeded rngs are those of ``api.prove_session``;
with ``--check-identity`` rank 0 also proves the same session alone, in one
process, and requires the same bytes.

    python3 tools/torch_multihost_session.py [--procs 2] [--games 2] [--shots 4] [--check-identity] [--device cpu]

On the CPU, ``BZ_PROOF_ENGINE=host`` proves on the native host engine in
seconds; the plain versions take many minutes a proof.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

PLACEMENTS = [
    [(0, 0, False), (0, 1, False), (0, 2, False), (0, 3, False), (0, 4, False)],
    [(3, 3, True), (5, 4, False), (0, 1, False), (5, 6, True), (6, 1, False)],
    [(1, 8, False), (2, 2, True), (7, 0, True), (4, 5, False), (9, 3, True)],
    [(5, 0, False), (0, 5, True), (2, 7, False), (8, 4, True), (3, 1, False)],
]


def _words(values) -> bytes:
    return b"".join(int(v).to_bytes(32, "little") for v in values)


def _int(raw) -> int:
    return int.from_bytes(bytes(raw), "little")


def worker(games: int, shots: int, seed: int, check_identity: bool, device: str | None) -> None:
    import torch
    import torch.distributed as dist

    from battlezips_halo2_tpu_torch import api
    from battlezips_halo2_tpu_torch.parallel import distributed
    from battlezips_halo2_tpu_torch.parallel.collectives import psum
    from battlezips_halo2_tpu_torch.plonk.format import proof_size
    from battlezips_halo2_tpu_torch.utils import Board, Deck

    distributed.initialize(device=device)
    try:
        mesh = distributed.global_mesh()
        if mesh.group is None:
            raise SystemExit("needs at least two processes")
        rank, nproc = mesh.rank, mesh.size
        dev = mesh.devices[rank]

        game_list = [PLACEMENTS[g % len(PLACEMENTS)] for g in range(games)]
        trapdoors = [random.Random(f"bz-mh-td:{seed}:{g}").randrange(1, 1 << 254) for g in range(games)]

        def job_rng(idx: int):  # api.prove_session's derivation
            return random.Random(f"bz-session:{seed}:{idx}")

        board_jobs, shot_jobs = [], []
        for gi, ships in enumerate(game_list):
            board_jobs.append((ships, trapdoors[gi]))
            state = Board.from_deck(Deck.from_placements(ships)).state()
            for si in range(shots):
                x, y = si % 10, (si * 3 + gi) % 10
                shot_jobs.append((state, trapdoors[gi], (x, y), bool(state.bit(y * 10 + x))))

        bparams, bpk = api.board_keys(dev)
        sparams, spk = api.shot_keys(dev)
        b_len, s_len = proof_size(bpk.vk, bparams), proof_size(spk.vk, sparams)
        dist.barrier()
        t0 = time.time()
        boards = {i: api.prove_board(*job, rng=job_rng(i), device=dev)
                  for i, job in enumerate(board_jobs) if i % nproc == rank}
        shots_by = {i: api.prove_shot(*job, rng=job_rng(1_000_000 + i), device=dev)
                    for i, job in enumerate(shot_jobs) if (len(board_jobs) + i) % nproc == rank}
        prove_s = time.time() - t0
        print(f"[rank {rank}/{nproc}] proved {len(boards)} boards + {len(shots_by)} shots on {dev} in "
              f"{prove_s:.3f} s", flush=True)

        def rows(proofs: dict, count: int, length: int, words: int, instance) -> torch.Tensor:
            out = torch.zeros(count, length + 32 * words, dtype=torch.uint8)
            for i, pr in proofs.items():
                if len(pr.proof) != length:
                    raise AssertionError(f"proof {i}: {len(pr.proof)} bytes, expected {length}")
                out[i] = torch.frombuffer(bytearray(pr.proof + _words(instance(pr))), dtype=torch.uint8)
            (total,) = psum(mesh, [out.to(dev)])
            return total.cpu()

        board_rows = rows(boards, len(board_jobs), b_len, 2, lambda p: p.commitment)
        shot_rows = rows(shots_by, len(shot_jobs), s_len, 4, lambda p: [*p.commitment, p.shot, p.hit])
        wall = time.time() - t0

        if rank == 0:
            board_proofs = [api.BoardProof((_int(r[b_len : b_len + 32]), _int(r[b_len + 32 :])), bytes(r[:b_len]))
                            for r in board_rows.numpy()]
            shot_proofs = []
            for r in shot_rows.numpy():
                w = [_int(r[s_len + 32 * k : s_len + 32 * (k + 1)]) for k in range(4)]
                shot_proofs.append(api.ShotProof((w[0], w[1]), w[2], w[3], bytes(r[:s_len])))
            t = time.time()
            if not api.verify_session(api.GameSession(board_proofs, shot_proofs), device=dev):
                raise AssertionError("a gathered proof failed verification on rank 0")
            verify_s = time.time() - t
            identity = None
            if check_identity:
                one = api.prove_session(game_list, shots_per_game=shots, trapdoors=trapdoors, seed=seed, device=dev)
                got = [p.proof for p in board_proofs + shot_proofs]
                want = [p.proof for p in one.board_proofs + one.shot_proofs]
                if got != want:
                    raise AssertionError("the gathered proofs differ from a one-process session's")
                identity = True
                print(f"[rank 0] identity check ok: {len(want)} proofs equal a one-process session's", flush=True)
            n_proofs = len(board_proofs) + len(shot_proofs)
            card = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
            print(json.dumps({"metric": f"multihost_session_proofs_per_s_{games}g{shots}s_{nproc}p",
                              "value": n_proofs / wall, "unit": "proofs/s",
                              "detail": {"processes": nproc, "n_proofs": n_proofs, "wall_s": wall,
                                         "rank0_prove_s": prove_s, "verify_s": verify_s,
                                         "backend": dist.get_backend(), "device": card,
                                         "engine": os.environ.get("BZ_PROOF_ENGINE", "device"),
                                         "all_verified": True, "identity_checked": identity}}), flush=True)
        dist.barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def main() -> int:
    from torch_multihost_ntt import run_workers

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--games", type=int, default=2)
    ap.add_argument("--shots", type=int, default=4)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--check-identity", action="store_true")
    ap.add_argument("--device", choices=["cpu"], default=None, help="gloo on the CPU (default: NCCL on the cards)")
    ap.add_argument("--timeout", type=int, default=3600, help="seconds before the workers are killed")
    args = ap.parse_args()
    if args.worker:
        worker(args.games, args.shots, args.seed, args.check_identity, args.device)
        return 0
    argv = ["--games", str(args.games), "--shots", str(args.shots), "--seed", str(args.seed)]
    argv += ["--check-identity"] * args.check_identity + (["--device", args.device] if args.device else [])
    rc = run_workers(os.path.abspath(__file__), args.procs, argv, args.timeout)
    print("torch_multihost_session:", "OK" if rc == 0 else f"FAILED rc={rc}", flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main())
