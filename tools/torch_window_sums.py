#!/usr/bin/env python3
"""Time the MSM's window kernels of battlezips_halo2_tpu_torch on an NVIDIA
card: K3's window kernel (``csrc/window_sums.cu``, interleaved points), K6's
(``csrc/point_add_planes.cu``, the same body on coordinate planes) and K6's
lane-wise point add, at the proof path's shapes.

    python3 tools/torch_window_sums.py [--reps N] [--out PATH]

from the root of a checkout, on a machine with a card. On the same buckets
K3's and K6's window kernels must give the same points (the same
coordinates too where both split the rows alike): the tool checks that on
affine points at every shape (it fails otherwise) and times each kernel
with CUDA events. It prints the
card's name and power limit, then one JSON object (``--out`` also writes it
to a file). To compare two builds of the kernels (for example the
Montgomery product inlined or out of line in one source), run it from two
copies of the tree in one session, in turns.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import random
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

# (rows, nbuck): a board commit batch's 352 rows (11 columns x 32 windows of
# c = 8) and one column's 32, an IPA round's 2 rows of c = 2, signed c = 10's
# 104 rows (4 MSMs x 26 windows); chip_smoke.py checks the same shapes
SHAPES = [(352, 256), (32, 256), (2, 4), (104, 513)]
LANES = 1528  # points of the lane-wise add, as chip_smoke.py times it


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--reps", type=int, default=50, help="launches per timing")
    parser.add_argument("--out", type=Path, default=None)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_window_sums: no CUDA device", file=sys.stderr)
        return 2
    from battlezips_halo2_tpu_torch.curves import limb as C
    from battlezips_halo2_tpu_torch.fields.limb import FQ_SPEC
    from battlezips_halo2_tpu_torch.ops import cuda
    from battlezips_halo2_tpu_torch.ops import msm as M

    smoke = _smoke()
    card = smoke.card_line()
    print(card, flush=True)
    dev, spec, rng = torch.device("cuda"), FQ_SPEC, random.Random(9)
    report = {"card": card, "shapes": [], "build": cuda.build().parent.name}
    for rows, nbuck in SHAPES:
        buckets = smoke._bucket_rows(dev, rng, rows, nbuck)
        planes = buckets.permute(2, 0, 1, 3).contiguous()
        k3 = M.window_sums(spec, buckets, nbuck)
        k6 = M.window_sums_planes(spec, planes, nbuck)
        err = smoke._affine_err(spec, k6.movedim(0, -2), k3)
        if err:
            print(f"torch_window_sums: K6 differs from K3 at {rows} x {nbuck}: {err}", file=sys.stderr)
            return 1
        split = {name: M.window_layout(rows, nbuck - 1, M.window_resident(dev, name == "K6")) for name in ("K3", "K6")}
        report["shapes"].append({
            "rows": rows, "nbuck": nbuck, "threads_x_segment": split,
            "equal_coordinates": bool(torch.equal(k6.movedim(0, -2), k3)),
            "k3_window_ms": smoke.cuda_ms(lambda: M.window_sums(spec, buckets, nbuck), args.reps),
            "k6_window_ms": smoke.cuda_ms(lambda: M.window_sums_planes(spec, planes, nbuck), args.reps),
        })
    pts = smoke._bucket_rows(dev, rng, 8, LANES // 8 + 2)[:, 1:].reshape(-1, 3, 8)
    p, q = (t[:LANES].movedim(-2, 0).contiguous() for t in (pts, pts.roll(1, 0)))
    out = torch.empty_like(p)
    report["k6_lane_wise_ms"] = smoke.cuda_ms(lambda: C.point_add_planes(spec, p, q, out=out), 4 * args.reps)
    report["resident_threads"] = {"K3": M.window_resident(dev), "K6": M.window_resident(dev, True)}
    text = json.dumps(report)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(text)
    print(text, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
