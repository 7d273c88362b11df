#!/usr/bin/env python3
"""Where the time of one k=11 shot proof (or, with ``--board``, one k=12
board proof, or with ``--session``, one batched game session of a board
and four shots) of battlezips_halo2_tpu_torch goes on an NVIDIA card.

    python3 tools/torch_profile_shot.py [--board | --session] [--out PATH]

from the repo root, on a machine with a card. After the keys and one
warm-up proof it proves and verifies once more under ``torch.profiler``
and prints one JSON object: wall seconds, device busy milliseconds (the
sum of the kernels' own device time, in all and per card), the device's
idle share, and the kernels ordered by device time. The card's name and power limit come
first. ``--out`` also writes the JSON to a file. The engine configuration
is the environment's: ``BZ_ROW_NTT`` / ``BZ_ROW_MSM``, ``BZ_PROOF_ENGINE``
and ``BZ_BATCH_ENGINE`` (``BZ_BATCH_ENGINE=device BZ_PROOF_ENGINE=auto
--session`` profiles the reference's hybrid: commitments and quotient on
the card, the proof tail on the native host engine).
"""

from __future__ import annotations

import argparse
import json
import random
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def _device_self_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def profiled(fn) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t
    kernels = []
    for evt in prof.key_averages():
        us = _device_self_us(evt)
        if us > 0 and getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            kernels.append({"name": evt.key[:120], "count": evt.count, "device_ms": us / 1e3})
    kernels.sort(key=lambda k: -k["device_ms"])
    busy = sum(k["device_ms"] for k in kernels)
    by_card: dict = {}  # the kernels' device time on each card (a sharded proof runs on several)
    for evt in prof.events():
        if getattr(evt, "device_type", None) == torch.autograd.DeviceType.CUDA:
            by_card[evt.device_index] = by_card.get(evt.device_index, 0.0) + _device_self_us(evt) / 1e3
    return {
        "wall_s": wall,
        "device_busy_ms": busy,
        "device_idle_share": 1 - busy / (wall * 1e3) if kernels else None,
        "device_busy_ms_by_card": {f"cuda:{i}": ms for i, ms in sorted(by_card.items())},
        "kernels": kernels[:25],
    }


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--out", type=Path, default=None)
    what = parser.add_mutually_exclusive_group()
    what.add_argument("--board", action="store_true", help="profile a board proof instead of a shot proof")
    what.add_argument("--session", action="store_true", help="profile a batched session of a board and four shots")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_profile_shot: no CUDA device", file=sys.stderr)
        return 2
    from battlezips_halo2_tpu_torch import api
    from battlezips_halo2_tpu_torch.utils import Board, Deck

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False,
    )
    print(smi.stdout.strip(), flush=True)
    placements = [(3, 3, True), (5, 4, False), (0, 1, False), (0, 5, True), (6, 1, False)]
    board = Board.from_deck(Deck.from_placements(placements))
    name = "board" if args.board else "session" if args.session else "shot"
    verify = api.verify_board if args.board else api.verify_session if args.session else api.verify_shot

    def prove(seed: int):
        if args.session:
            return api.prove_session([placements], shots_per_game=4, trapdoors=[0xBEEF], seed=seed, batched=True)
        if args.board:
            return api.prove_board(placements, 0xBEEF, rng=random.Random(seed))
        return api.prove_shot(board.state(), 0xBEEF, (3, 3), True, rng=random.Random(seed))

    verify(prove(7))
    box = {}
    report = {f"prove_{name}": profiled(lambda: box.update(p=prove(8)))}
    report[f"verify_{name}"] = profiled(lambda: box.update(ok=verify(box["p"])))
    if not box["ok"]:
        print("torch_profile_shot: the profiled proof did not verify", file=sys.stderr)
        return 1
    report["card"] = smi.stdout.strip()
    text = json.dumps(report)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
