#!/usr/bin/env python3
"""Persistent proving server of battlezips_halo2_tpu_torch, the counterpart
of tools/serve.py, on an NVIDIA card.

    python3 tools/torch_serve.py --stdio [--warm-device] [--device cpu]
    python3 tools/torch_serve.py --bench-cold [--device cpu]

from the repo root. The reference's wasm layer rebuilds params and keys on
every call; a server keeps one warm process, and its keys come from the
port's artifact store (``battlezips_halo2_tpu_torch/artifacts.py``,
``.artifacts/torch/``): the first start on a checkout derives the SRS, runs
keygen and writes both; every later start loads them.

Protocol: newline-delimited JSON on stdin / stdout. Requests:

  {"op": "prove_board", "ships": [[x, y, z] * 5], "trapdoor": int?}
  {"op": "prove_shot", "state_hex": str, "trapdoor": int, "shot": [x, y],
   "hit": bool}
  {"op": "prove_session", "games": [[[x, y, z] * 5] ...], "shots_per_game": N,
   "batched": bool?}
  {"op": "verify_board", "proof_hex": str, "commitment": [x, y]}
  {"op": "status"}   -> uptime, proofs served, mean latency per op, the
                        device and the warm thread's state
  {"op": "shutdown"}

Responses: ``{"ok": true, ...}`` with ``latency_s``; a session's carries
each game's board commitment, which its proofs are verified against. A
request that raises gets ``{"ok": false, "error": ...}`` and the server
keeps serving.

The server runs on the card; ``--device cpu`` (for tests) runs the plain
PyTorch versions. The engine is the environment's (``BZ_PROOF_ENGINE``,
``BZ_BATCH_ENGINE``), as everywhere in the port, and the server never
switches it. ``--warm-device`` proves one batched session on the card in a
background thread, so the kernels' first use is off the request path; if
it fails, the server keeps the error: ``status`` reports it and the next
request that needs the card raises it.

``--bench-cold`` starts a fresh server process and prints one JSON line:
``serving_cold_to_first_proof_s`` (process start to the first shot proof's
response, by this process's clock), with ``cold_to_ready_s``, the board
proof's latency and the server's status.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

WARM_PLACEMENTS = [(3, 3, True), (5, 4, False), (0, 1, False), (0, 5, True), (6, 1, False)]


class Server:
    def __init__(self, device=None, warm_device: bool = False):
        t0 = time.time()
        from battlezips_halo2_tpu_torch import api
        from battlezips_halo2_tpu_torch.ops.cuda import resolve_device

        self.api = api
        self.device = resolve_device(device)
        # the SRS and keys from the artifact store (derived and written on a cold checkout)
        api.board_keys(self.device)
        api.shot_keys(self.device)
        self.ready_s = time.time() - t0
        self.t_start = t0
        self.count = 0
        self.latencies: dict = {}
        self.device_ready = False
        self.device_error: BaseException | None = None
        self.ops = {
            "prove_board": self._prove_board,
            "prove_shot": self._prove_shot,
            "prove_session": self._prove_session,
            "verify_board": self._verify_board,
        }
        if warm_device:
            threading.Thread(target=self._warm_device, daemon=True).start()

    def _warm_device(self):
        """One batched session on the card off the request path. Its error
        is kept, never replaced by another engine."""
        try:
            self.api.prove_session([WARM_PLACEMENTS], shots_per_game=1, seed=0, batched=True,
                                   batch_engine="device", device=self.device)
            self.device_ready = True
        except Exception as exc:  # kept: status reports it, the next request on the card raises it
            self.device_error = exc

    def _needs_card(self, op: str, req: dict) -> bool:
        """Whether ``op`` runs on the card under the environment's engines."""
        from battlezips_halo2_tpu_torch.circuits import BoardCircuit, ShotCircuit
        from battlezips_halo2_tpu_torch.config import config
        from battlezips_halo2_tpu_torch.ops.engine import use_host_engine

        if self.device.type != "cuda":
            return False
        if op == "prove_session" and req.get("batched", False):
            return config().batch_engine != "host"
        return not use_host_engine(1 << (ShotCircuit.K if op == "prove_shot" else BoardCircuit.K))

    def status(self) -> dict:
        return {
            "ok": True,
            "uptime_s": time.time() - self.t_start,
            "startup_s": self.ready_s,
            "proofs_served": self.count,
            "latency_s": {k: sum(v) / len(v) for k, v in self.latencies.items()},
            "device": str(self.device),
            "device_ready": self.device_ready,
            "device_error": None if self.device_error is None else repr(self.device_error),
        }

    def handle(self, req: dict) -> dict:
        op = req.get("op")
        if op == "status":
            return self.status()
        if op == "shutdown":
            return {"ok": True, "bye": True}
        if op not in self.ops:
            return {"ok": False, "error": f"unknown op {op!r}"}
        if self.device_error is not None and self._needs_card(op, req):
            raise RuntimeError(f"the card failed in the warm-up: {self.device_error!r}") from self.device_error
        t0 = time.time()
        resp = self.ops[op](req)
        dt = time.time() - t0
        resp["latency_s"] = dt
        self.latencies.setdefault(op, []).append(dt)
        return resp

    def _prove_board(self, req: dict) -> dict:
        out = self.api.prove_board([tuple(s) for s in req["ships"]], trapdoor=req.get("trapdoor"), device=self.device)
        self.count += 1
        return {"ok": True, "commitment": list(out.commitment), "proof_hex": out.proof.hex()}

    def _prove_shot(self, req: dict) -> dict:
        from battlezips_halo2_tpu_torch.utils import BinaryValue

        out = self.api.prove_shot(BinaryValue(int(req["state_hex"], 16)), req["trapdoor"], tuple(req["shot"]),
                                  bool(req["hit"]), device=self.device)
        self.count += 1
        return {"ok": True, "commitment": list(out.commitment), "shot": out.shot, "hit": out.hit,
                "proof_hex": out.proof.hex()}

    def _prove_session(self, req: dict) -> dict:
        session = self.api.prove_session([[tuple(s) for s in g] for g in req["games"]],
                                         shots_per_game=req.get("shots_per_game", 8),
                                         batched=req.get("batched", False), device=self.device)
        self.count += len(session.board_proofs) + len(session.shot_proofs)
        return {
            "ok": True,
            "commitments": [list(p.commitment) for p in session.board_proofs],
            "board_proofs": [p.proof.hex() for p in session.board_proofs],
            "shot_proofs": [p.proof.hex() for p in session.shot_proofs],
        }

    def _verify_board(self, req: dict) -> dict:
        proof = self.api.BoardProof(commitment=tuple(req["commitment"]), proof=bytes.fromhex(req["proof_hex"]))
        return {"ok": True, "valid": self.api.verify_board(proof, device=self.device)}


def run_stdio(server: Server, inp, out) -> None:
    """Serve newline-delimited JSON requests from ``inp`` to ``out`` until
    shutdown or the end of the input."""
    print(json.dumps({"ok": True, "ready": True, "startup_s": server.ready_s}), file=out, flush=True)
    for line in inp:
        line = line.strip()
        if not line:
            continue
        try:
            resp = server.handle(json.loads(line))
        except Exception as exc:  # one failed request must not end the server
            traceback.print_exc(file=sys.stderr)
            resp = {"ok": False, "error": f"{type(exc).__name__}: {exc}"}
        print(json.dumps(resp), file=out, flush=True)
        if resp.get("bye"):
            break


BENCH_REQUESTS = [
    {"op": "prove_shot", "state_hex": hex(sum(1 << i for i in range(5)))[2:], "trapdoor": 777, "shot": [0, 0],
     "hit": True},
    {"op": "prove_board", "ships": [[0, 0, 0], [9, 1, 1], [2, 2, 0], [3, 4, 1], [5, 5, 0]]},
    {"op": "status"},
    {"op": "shutdown"},
]


def bench_cold(device: str | None = None) -> dict:
    """Start a fresh server process and time it to ready and to its first
    proof (a shot), then a board proof; -> the JSON line's object."""
    cmd = [sys.executable, str(Path(__file__).resolve()), "--stdio"] + (["--device", device] if device else [])
    t0 = time.time()
    with subprocess.Popen(cmd, stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=ROOT) as proc:
        try:
            ready_line = proc.stdout.readline()
            t_ready = time.time() - t0
            if not ready_line:
                raise RuntimeError(f"the server exited before it was ready (exit {proc.wait(timeout=60)})")
            outs, t_first = [], None
            for req in BENCH_REQUESTS:
                proc.stdin.write(json.dumps(req) + "\n")
                proc.stdin.flush()
                outs.append(json.loads(proc.stdout.readline()))
                if t_first is None:
                    t_first = time.time() - t0
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
    bad = [o for o in outs if not o.get("ok")]
    if bad:
        raise RuntimeError(f"the server refused a request: {bad[0]}")
    return {
        "metric": "serving_cold_to_first_proof_s",
        "value": t_first,
        "unit": "s",
        "detail": {
            "cold_to_ready_s": t_ready,
            "ready_line": json.loads(ready_line),
            "shot_latency_s": outs[0]["latency_s"],
            "board_latency_s": outs[1]["latency_s"],
            "status": outs[2],
        },
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stdio", action="store_true", help="serve on stdin / stdout (the default)")
    ap.add_argument("--warm-device", action="store_true", help="prove one batched session on the card in the "
                    "background")
    ap.add_argument("--bench-cold", action="store_true", help="start a fresh server and time it to its first proof")
    ap.add_argument("--device", default=None, help="torch device (default: the CUDA card; cpu for tests)")
    args = ap.parse_args()
    if args.bench_cold:
        print(json.dumps(bench_cold(args.device)), flush=True)
    else:
        run_stdio(Server(args.device, args.warm_device), sys.stdin, sys.stdout)


if __name__ == "__main__":
    main()
