#!/usr/bin/env python3
"""Microbenchmark of the chained MSM bucket step (kernel K8) and of chained
field ops (kernel K9) of battlezips_halo2_tpu_torch on an NVIDIA card: the
port's counterpart of tools/exp_step_t.py.

    python3 tools/torch_exp_step_t.py [chain] [kmicro]

from the repo root, on a machine with a card (no argument runs both).

``chain`` runs the reference's shapes: N lanes (``PROF_N``, 2^15), STEPS
steps (``PROF_STEPS``, 64) of ``acc = head ? lift(P) : acc + P`` over
Vesta's base field, heads drawn with probability 0.02, P from 256 multiples
of the Vesta generator, acc0 the lanes' P in reverse order with Z = 1. It
times K8 with all steps in one launch and with one launch per step (the
reference's dataflow under lax.scan), and holds both bit for bit against
the plain chain.

``kmicro`` runs ``x = op(x, b)`` ``PROF_REPS`` (32) times per element over
N canonical Fq elements for each op of ``PROF_OPS`` (mul,add,sub): K9 timed
and held bit for bit against its plain chain. The ops are mul (Montgomery),
add, sub, redc (x R^-1), raw (a wrapping limb-wise 32-bit add: the memory
floor) and noop (the launch floor). The reference's mul32, mul32raw, redc32,
c16, csub, mulraw and rawi32 time its 16-bit limb mechanics, which 8 x
32-bit limbs do not have: mul32 has mul's value, redc32 is redc here.
Unlike the reference, whose inputs are non-canonical 16-bit limbs, the
inputs are canonical.

It prints ns per row (chain) or per op (kmicro), timed with CUDA events,
and last one JSON object. It runs on a card only and exits non-zero
without one.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from battlezips_halo2_tpu_torch.curves import limb as C  # noqa: E402
from battlezips_halo2_tpu_torch.curves.host import VESTA  # noqa: E402
from battlezips_halo2_tpu_torch.fields import limb as L  # noqa: E402

SPEC = L.FQ_SPEC  # Vesta's base field, as exp_step_t.py:46
HEAD_P = 0.02


def settings() -> dict:
    """The reference's knobs, read when a run starts."""
    return {
        "n": int(os.environ.get("PROF_N", str(1 << 15))),
        "steps": int(os.environ.get("PROF_STEPS", "64")),
        "reps": int(os.environ.get("PROF_REPS", "32")),
        "ops": os.environ.get("PROF_OPS", "mul,add,sub").split(","),
    }


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of fn() over reps calls (CUDA events), warmed up."""
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


def chain_inputs(n: int, steps: int, device):
    """(acc0 (N, 3, 8), pxy (N, 2, 8), heads (steps, N) bool) as
    exp_step_t.py:160-170 draws them (numpy RandomState(0))."""
    rng = np.random.RandomState(0)
    pts = [VESTA.mul(VESTA.generator, int(s)) for s in rng.randint(1, 1 << 62, size=256)]
    heads = torch.from_numpy(rng.rand(steps, n) < HEAD_P).to(device)
    lane = torch.arange(n, device=device) % len(pts)
    pxy = C.affine_table(SPEC, pts, device)[lane].contiguous()
    acc0 = C.affine_to_jacobian(SPEC, pts, device)[lane.flip(0)].contiguous()
    return acc0, pxy, heads


def plain_chain_counted(acc, pxy, heads):
    """The plain chain one step at a time -> (acc, additions): the lanes and
    steps that ran the addition formula (no head, acc not the identity),
    which is the work this run's data needs."""
    adds = 0
    for s in range(heads.shape[0]):
        adds += int((~heads[s] & ~L.is_zero(acc[:, 2])).sum())
        acc = C.plain_step_chain(SPEC, acc, pxy, heads[s : s + 1])
    return acc, adds


def _max_abs_err(a, b) -> int:
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max()) if a.numel() else 0


def run_chain(device, n: int, steps: int) -> dict:
    """K8 in both launch modes against the plain chain, timed."""
    acc0, pxy, heads = chain_inputs(n, steps, device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want, adds = plain_chain_counted(acc0, pxy, heads)
    end.record()
    torch.cuda.synchronize()
    out = {"n": n, "steps": steps, "additions": adds, "plain_ms": start.elapsed_time(end), "max_abs_err": 0}
    for mode, per in (("one_launch", None), ("launch_per_step", 1)):
        got = C.step_chain(SPEC, acc0, pxy, heads, steps_per_launch=per)
        err = _max_abs_err(got, want)
        ms = cuda_ms(lambda: C.step_chain(SPEC, acc0, pxy, heads, steps_per_launch=per), 20)
        out[mode] = {"ms": ms, "ns_per_row": ms * 1e6 / (n * steps), "max_abs_err": err}
        out["max_abs_err"] = max(out["max_abs_err"], err)
        print(f"K8 step chain [{mode}] ({n} lanes x {steps} steps): {ms:9.4f} ms  "
              f"{ms * 1e6 / (n * steps):7.3f} ns/row  max_abs_err {err}", flush=True)
    return out


def kmicro_inputs(n: int, device):
    """Two (N, 8) tensors of canonical random Fq elements (RandomState(1))."""
    rng = np.random.RandomState(1)
    limbs = rng.randint(0, 1 << 32, size=(2, n, L.NLIMBS), dtype=np.uint64)
    limbs[..., 7] &= (1 << 30) - 1  # below 2^254 < q
    t = torch.from_numpy(limbs.astype(np.uint32).view(np.int32)).to(device)
    return t[0].contiguous(), t[1].contiguous()


def run_kmicro(device, n: int, reps: int, ops) -> dict:
    """K9 for each op against its plain chain, timed."""
    a, b = kmicro_inputs(n, device)
    out = {"n": n, "reps": reps, "ops": {}}
    for op in ops:
        got = L.op_chain(op, SPEC, a, b, reps)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want = L.plain_op_chain(op, SPEC, a, b, reps)
        end.record()
        torch.cuda.synchronize()
        err = _max_abs_err(got, want)
        ms = cuda_ms(lambda: L.op_chain(op, SPEC, a, b, reps), 50)
        out["ops"][op] = {
            "ms": ms, "ns_per_op": ms * 1e6 / (n * reps) if reps else None,
            "plain_ms": start.elapsed_time(end), "max_abs_err": err,
        }
        per = f"{ms * 1e6 / (n * reps):7.4f} ns/op" if reps else ""
        print(f"K9 op chain {op} ({n}) x{reps}: {ms:9.4f} ms  {per}  max_abs_err {err}", flush=True)
    return out


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=False, timeout=60,
    )
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else f"nvidia-smi: exit {out.returncode}"


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("torch_exp_step_t: no CUDA device", file=sys.stderr)
        return 2
    which = argv or ["chain", "kmicro"]
    unknown = [w for w in which if w not in ("chain", "kmicro")]
    if unknown:
        print(f"torch_exp_step_t: unknown argument(s) {unknown}", file=sys.stderr)
        return 2
    cfg = settings()
    dev = torch.device("cuda")
    card = card_line()
    print(f"{torch.cuda.get_device_name(0)} ({card}) N={cfg['n']} steps={cfg['steps']} reps={cfg['reps']}",
          flush=True)
    result = {"device": torch.cuda.get_device_name(0), "card": card}
    if "chain" in which:
        result["chain"] = run_chain(dev, cfg["n"], cfg["steps"])
    if "kmicro" in which:
        result["kmicro"] = run_kmicro(dev, cfg["n"], cfg["reps"], cfg["ops"])
    errs = [result["chain"]["max_abs_err"]] if "chain" in result else []
    errs += [r["max_abs_err"] for r in result.get("kmicro", {}).get("ops", {}).values()]
    print(json.dumps(result), flush=True)
    return 1 if any(errs) else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
