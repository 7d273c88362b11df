#!/usr/bin/env python3
"""End-to-end BattleZips demo on an NVIDIA card, through the PyTorch / CUDA
port: commit a board, prove its legality, then prove hits and misses
against the commitment, all through the public API
(battlezips_halo2_tpu_torch.api). The counterpart of examples/demo.py.

Run:  python3 examples/torch_demo.py   (from the repo root, on a machine
with a card; the first run on a checkout derives the SRS and keys and
writes them to .artifacts/torch/, later runs load them)
"""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from battlezips_halo2_tpu_torch import api
from battlezips_halo2_tpu_torch.fields.host import FQ
from battlezips_halo2_tpu_torch.utils import Board, Deck


def main(device=None):
    ships = [(3, 3, True), (5, 4, False), (0, 1, False), (0, 5, True), (6, 1, False)]
    board = Board.from_deck(Deck.from_placements(ships))
    print("Player one's secret board:")
    print(board.render())

    trapdoor = FQ.random()

    print("\nProving board legality (k=12 PLONK proof over the IPA PCS)...")
    t0 = time.time()
    board_proof = api.prove_board(ships, trapdoor, device=device)
    print(f"  proved in {time.time() - t0:.1f}s, proof = {len(board_proof.proof)} bytes")
    print(f"  commitment = ({hex(board_proof.commitment[0])[:18]}..., ...)")

    t0 = time.time()
    assert api.verify_board(board_proof, device=device)
    print(f"  verified in {time.time() - t0:.1f}s")

    state = board.state()
    for x, y in [(3, 3), (9, 9)]:
        hit = state.bit(y * 10 + x)
        print(f"\nOpponent fires at ({x}, {y}) — proving {'HIT' if hit else 'MISS'}...")
        t0 = time.time()
        shot_proof = api.prove_shot(state, trapdoor, (x, y), hit, device=device)
        print(f"  proved in {time.time() - t0:.1f}s")
        assert api.verify_shot(shot_proof, device=device)
        print("  verified — the assertion is cryptographically binding to the committed board")

    print("\nDemo complete.")


if __name__ == "__main__":
    main()
