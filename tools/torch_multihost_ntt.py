#!/usr/bin/env python3
"""The port's 4-step NTT across processes (battlezips_halo2_tpu_torch/
parallel/ntt.py over torch.distributed).

Spawns N worker processes; each brings up the process group
(parallel/distributed.py: NCCL with rank r on cuda:r, or gloo on the CPU
with ``--device cpu``) and owns one shard of a global mesh, so the NTT's
three all-to-alls cross the process boundary. Every rank builds the same
seeded input, transforms its shard, and checks its output shard bit for bit
against poly/domain.py's host NTT; then a sharded MSM of MSM_POINTS Vesta
points (parallel/msm.py, its partials all-gathered across the processes)
must equal the host Pippenger on every rank. On cards, rank 0 also prints the
distributed NTT's seconds (host clock around work that ends in a
synchronize and a barrier) beside one card's unsharded ops/ntt.py NTT of
the same n.

    python3 tools/torch_multihost_ntt.py [--procs 2] [--logn 10] [--device cpu]

NCCL takes one card a rank: on cards it needs --procs visible cards.
"""

from __future__ import annotations

import argparse
import json
import os
import random
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TIMED_REPS = 5
MSM_POINTS = 64


def worker(logn: int, device: str | None) -> None:
    import torch
    import torch.distributed as dist

    from battlezips_halo2_tpu_torch.curves.host import VESTA
    from battlezips_halo2_tpu_torch.fields import limb as L
    from battlezips_halo2_tpu_torch.fields.host import FP
    from battlezips_halo2_tpu_torch.fields.limb import FP_SPEC
    from battlezips_halo2_tpu_torch.ops import ntt as D
    from battlezips_halo2_tpu_torch.parallel import distributed
    from battlezips_halo2_tpu_torch.parallel.msm import sharded_msm
    from battlezips_halo2_tpu_torch.parallel.ntt import distributed_ntt
    from battlezips_halo2_tpu_torch.poly.domain import EvaluationDomain, ntt_host

    if device == "cpu":  # the ranks share this host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(os.environ["BZ_NUM_PROCS"])))
    distributed.initialize(device=device)
    try:
        mesh = distributed.global_mesh()
        rank, d, n = mesh.rank, mesh.size, 1 << logn
        if mesh.group is None or n % (d * d):
            raise SystemExit(f"needs a process group and n divisible by D^2: n = {n}, D = {d}")
        dev = mesh.devices[rank]
        c = n // d
        rng = random.Random(42)  # the same seed on every rank: one shared input
        vals = [rng.randrange(FP.modulus) for _ in range(n)]
        omega = EvaluationDomain(logn, 2).omega
        mine = L.to_mont(FP_SPEC, L.ints_to_limbs(vals[rank * c : (rank + 1) * c], dev))
        (out,) = distributed_ntt(mesh, n, omega, [mine])
        got = L.limbs_to_ints(L.from_mont(FP_SPEC, out))
        want = ntt_host(vals, omega)[rank * c : (rank + 1) * c]
        if got != want:
            raise AssertionError(f"rank {rank}: output rows [{rank * c}, {(rank + 1) * c}) differ from the host NTT")
        print(f"[rank {rank}/{d}] distributed NTT n = {n} on {dev} ({dist.get_backend()}): {c} rows bit-exact",
              flush=True)
        pts = [VESTA.mul(VESTA.generator, rng.randrange(1, 1 << 64)) for _ in range(MSM_POINTS)]
        scalars = [rng.randrange(VESTA.scalar.modulus) for _ in range(MSM_POINTS)]
        if sharded_msm(VESTA, pts, scalars, mesh) != VESTA.pippenger(pts, scalars):
            raise AssertionError(f"rank {rank}: the sharded MSM differs from the host Pippenger")
        print(f"[rank {rank}/{d}] sharded MSM of {MSM_POINTS} points equals the host Pippenger", flush=True)
        if dev.type != "cuda":
            return
        sharded_s = []
        for _ in range(TIMED_REPS):
            dist.barrier()
            torch.cuda.synchronize(dev)
            t = time.time()
            distributed_ntt(mesh, n, omega, [mine])
            torch.cuda.synchronize(dev)
            dist.barrier()
            sharded_s.append(time.time() - t)
        if rank == 0:
            whole = L.to_mont(FP_SPEC, L.ints_to_limbs(vals, dev))
            plan = D.plan_for(FP.modulus, n, omega, str(dev))
            one_card_s = []
            for _ in range(TIMED_REPS + 1):
                torch.cuda.synchronize(dev)
                t = time.time()
                D.ntt(plan, whole)
                torch.cuda.synchronize(dev)
                one_card_s.append(time.time() - t)
            print(json.dumps({"metric": "multihost_ntt", "n": n, "procs": d, "backend": dist.get_backend(),
                              "card": torch.cuda.get_device_name(dev), "distributed_ntt_s": sharded_s,
                              "one_card_ntt_s": one_card_s[1:]}), flush=True)
        dist.barrier()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(script: str, procs: int, argv: list, timeout_s: float) -> int:
    """Run ``script --worker *argv`` as ranks 0 .. procs - 1 of one process
    group (BZ_COORDINATOR on a free local port, BZ_NUM_PROCS, BZ_PROC_ID);
    kill every worker still running after ``timeout_s``; -> the OR of their
    exit codes (1 for a killed one)."""
    env_base = {**os.environ, "BZ_COORDINATOR": f"127.0.0.1:{free_port()}", "BZ_NUM_PROCS": str(procs)}
    cmd = [sys.executable, script, "--worker", *argv]
    children = [subprocess.Popen(cmd, env={**env_base, "BZ_PROC_ID": str(rank)}) for rank in range(procs)]
    deadline = time.time() + timeout_s
    rc = 0
    try:
        for p in children:
            try:
                rc |= p.wait(timeout=max(1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                rc |= 1
    finally:
        for p in children:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rc


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--logn", type=int, default=10)
    ap.add_argument("--device", choices=["cpu"], default=None, help="gloo on the CPU (default: NCCL on the cards)")
    ap.add_argument("--timeout", type=int, default=900, help="seconds before the workers are killed")
    args = ap.parse_args()
    if args.worker:
        worker(args.logn, args.device)
        sys.exit(0)
    argv = ["--logn", str(args.logn)] + (["--device", args.device] if args.device else [])
    rc = run_workers(os.path.abspath(__file__), args.procs, argv, args.timeout)
    print("torch_multihost_ntt:", "OK" if rc == 0 else f"FAILED rc={rc}", flush=True)
    sys.exit(rc)
