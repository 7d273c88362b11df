#!/usr/bin/env python3
"""Microbenchmark of the chained MSM bucket step (kernel K8) and of chained
field ops (kernel K9) of battlezips_halo2_tpu_torch on an NVIDIA card: the
port's counterpart of tools/exp_step_t.py.

    python3 tools/torch_exp_step_t.py [chain] [kmicro] [compare]

from the repo root, on a machine with a card (no argument runs chain and
kmicro).

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
inputs are canonical. raw and noop are also timed as the one PyTorch call
that computes them (``torch.add(a, b, alpha=reps)`` on the int32 limbs,
``a.clone()``), checked bit for bit against the plain chain.

``compare`` builds copies of K8's and K9's sources (``BUILDS``: the old
route is the copy without ``#define BZ_FE_CARRY_CHAIN``, so its field ops
are the 64-bit ones that K1-K7 use; "out of line" calls one copy of the
product, ``BZ_FE_MUL_CALL``) and times them against the tree's build in
one process, in turns (tree, copies, copies in reverse, tree), each held
bit for bit against the plain chains first; the tree's K9 also runs in
the 256-thread blocks it had before its grid plan.

Kernel times are device-paced (``ops/timing.py::device_paced_ms``): a wait on the
card lets the host queue every timed launch before the first one runs, so
the host's launch rate cannot set them. The host-paced time (CUDA events
around a Python loop of calls, as earlier runs timed) is kept beside it
under ``host_paced_ms``. It prints ns per row (chain) or per op (kmicro)
and last one JSON object. It runs on a card only and exits non-zero
without one.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from battlezips_halo2_tpu_torch.curves import limb as C  # noqa: E402
from battlezips_halo2_tpu_torch.curves.host import VESTA  # noqa: E402
from battlezips_halo2_tpu_torch.fields import limb as L  # noqa: E402
from battlezips_halo2_tpu_torch.ops import cuda  # noqa: E402
from battlezips_halo2_tpu_torch.ops.timing import device_paced_ms, host_paced_ms  # noqa: E402

SPEC = L.FQ_SPEC  # Vesta's base field, as exp_step_t.py:46
HEAD_P = 0.02
CARRY_CHAIN = "#define BZ_FE_CARRY_CHAIN\n"
CHAIN_SOURCES = ("field.cuh", "step_chain.cu", "op_chain.cu")
# the builds `compare` times against the tree's: name -> (drop the
# carry-chain define, extra nvcc flags)
BUILDS = {
    "old route": (True, ()),
    "out of line": (False, ("-DBZ_FE_MUL_CALL",)),
}
# K9's blocks before the grid plan: 128 blocks for 2^15 elements
OLD_K9_BLOCK = 256


def settings() -> dict:
    """The reference's knobs, read when a run starts."""
    return {
        "n": int(os.environ.get("PROF_N", str(1 << 15))),
        "steps": int(os.environ.get("PROF_STEPS", "64")),
        "reps": int(os.environ.get("PROF_REPS", "32")),
        "ops": os.environ.get("PROF_OPS", "mul,add,sub").split(","),
    }


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


class InPlaceCalls:
    """Calls of an in-place chain on a pool of copies of acc0, one copy a
    call: ``restore()`` copies acc0 back into every copy (the setup of
    :func:`device_paced_ms`), so each timed call does this run's work."""

    def __init__(self, acc0, count: int, call):
        self.acc0, self.copies, self.call, self.next = acc0, [acc0.clone() for _ in range(count)], call, 0

    def restore(self):
        for c in self.copies:
            c.copy_(self.acc0)
        self.next = 0

    def __call__(self):
        self.call(self.copies[self.next % len(self.copies)])
        self.next += 1


# timed calls a window: K8's one launch per step is 64 launches a call, and
# the card queues a limited number of launches before the host waits
CHAIN_REPS = {"one_launch": 20, "launch_per_step": 6}
MODES = (("one_launch", None), ("launch_per_step", 1))


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
    for mode, per in MODES:
        got = C.step_chain(SPEC, acc0, pxy, heads, steps_per_launch=per)
        err = _max_abs_err(got, want)
        reps = CHAIN_REPS[mode]
        calls = InPlaceCalls(acc0, reps, lambda acc: C.step_chain_(SPEC, acc, pxy, heads, steps_per_launch=per))
        ms = device_paced_ms(calls, reps, setup=calls.restore)
        host = host_paced_ms(lambda: C.step_chain(SPEC, acc0, pxy, heads, steps_per_launch=per), reps)
        out[mode] = {"ms": ms, "ns_per_row": ms * 1e6 / (n * steps), "host_paced_ms": host, "max_abs_err": err}
        out["max_abs_err"] = max(out["max_abs_err"], err)
        print(f"K8 step chain [{mode}] ({n} lanes x {steps} steps): {ms:9.4f} ms device-paced "
              f"({ms * 1e6 / (n * steps):7.3f} ns/row), {host:9.4f} ms host-paced, max_abs_err {err}", flush=True)
    return out


def kmicro_inputs(n: int, device):
    """Two (N, 8) tensors of canonical random Fq elements (RandomState(1))."""
    rng = np.random.RandomState(1)
    limbs = rng.randint(0, 1 << 32, size=(2, n, L.NLIMBS), dtype=np.uint64)
    limbs[..., 7] &= (1 << 30) - 1  # below 2^254 < q
    t = torch.from_numpy(limbs.astype(np.uint32).view(np.int32)).to(device)
    return t[0].contiguous(), t[1].contiguous()


# the one PyTorch call that computes an op's whole chain, where there is one
LIBRARY_CALLS = {
    "raw": lambda a, b, reps: torch.add(a, b, alpha=reps),
    "noop": lambda a, b, reps: a.clone(),
}


def run_kmicro(device, n: int, reps: int, ops) -> dict:
    """K9 for each op against its plain chain, timed; raw and noop also as
    their library call. noop's time is the card's launch floor."""
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
        ms = device_paced_ms(lambda: L.op_chain(op, SPEC, a, b, reps), 50)
        host = host_paced_ms(lambda: L.op_chain(op, SPEC, a, b, reps), 50)
        row = {
            "ms": ms, "ns_per_op": ms * 1e6 / (n * reps) if reps else None, "host_paced_ms": host,
            "plain_ms": start.elapsed_time(end), "max_abs_err": err,
        }
        per = f"{ms * 1e6 / (n * reps):7.4f} ns/op, " if reps else ""
        line = f"K9 op chain {op} ({n}) x{reps}: {ms:9.4f} ms device-paced ({per}{host:.4f} ms host-paced)"
        if op in LIBRARY_CALLS:
            call = LIBRARY_CALLS[op]
            row["library_max_abs_err"] = _max_abs_err(call(a, b, reps), want)
            row["library_ms"] = device_paced_ms(lambda: call(a, b, reps), 50)
            line += f", library {row['library_ms']:.4f} ms (max_abs_err {row['library_max_abs_err']})"
        out["ops"][op] = row
        print(f"{line}, max_abs_err {err}", flush=True)
    if "noop" in out["ops"]:
        out["launch_floor_ms"] = out["ops"]["noop"]["ms"]
        print(f"launch floor (noop, device-paced): {out['launch_floor_ms']:.4f} ms a launch", flush=True)
    return out


# ------------------------------------------------------------- compare


def build_copy(tag: str, drop_carry_chain: bool, flags: tuple) -> Path:
    """A copy of K8's and K9's sources under the build directory, built with
    ``flags``; ``drop_carry_chain`` takes out the define that gives them the
    carry-chain field ops. -> the library's path."""
    dst = cuda.BUILD_ROOT / "copies" / re.sub(r"\W+", "_", tag)
    shutil.rmtree(dst, ignore_errors=True)
    dst.mkdir(parents=True)
    for name in CHAIN_SOURCES:
        text = (cuda.CSRC / name).read_text()
        if drop_carry_chain and name.endswith(".cu"):
            if CARRY_CHAIN not in text:
                raise RuntimeError(f"{name} has no carry-chain define to drop")
            text = text.replace(CARRY_CHAIN, "")
        (dst / name).write_text(text)
    return cuda.build(dst, flags)


def _k8_raw(lib, acc, pxy, heads, per):
    n = acc.shape[0]
    block, _ = cuda.chain_grid(n, cuda.sm_count(acc.device))
    for s0, s1 in C.launch_ranges(heads.shape[0], per):
        cuda.check(lib.bz_step_chain(SPEC.kernel_consts, cuda.ptr(acc), cuda.ptr(pxy), cuda.ptr(heads), n, s0, s1,
                                     block, cuda.stream(acc)), "K8 bz_step_chain")


def _k9_raw(lib, op, a, b, out, reps, block=None):
    n = a.shape[0]
    block = block or cuda.chain_grid(n, cuda.sm_count(a.device))[0]
    cuda.check(lib.bz_op_chain(L.CHAIN_OPS[op], SPEC.kernel_consts, cuda.ptr(a), cuda.ptr(b), cuda.ptr(out), n,
                               reps, block, cuda.stream(a)), "K9 bz_op_chain")


def run_compare(device, n: int, steps: int, reps: int, builds: dict) -> dict:
    """The tree's build and each copy of ``builds`` in turns (tree, copies,
    copies reversed, tree): K8 in both modes and K9 per op, device-paced,
    each build first held bit for bit against the plain chains."""
    with ThreadPoolExecutor(max_workers=len(builds)) as pool:
        jobs = {name: pool.submit(build_copy, name, drop, flags) for name, (drop, flags) in builds.items()}
        paths = {"tree": cuda.build(), **{name: job.result() for name, job in jobs.items()}}
    libs = {name: cuda.load(path) for name, path in paths.items()}
    report = {"builds": {}, "turns": list(libs) + list(libs)[::-1], "ms": {}}
    for name, path in paths.items():
        ptxas = [line for line in cuda.ptxas_report(path) if "chain_kernel" in line]
        sass = {k: v for k, v in cuda.sass_counts(path).items() if "chain_kernel" in k}
        report["builds"][name] = {"ptxas": ptxas, "sass": sass}
        for line in ptxas:
            print(f"  [{name}] ptxas {line}", flush=True)
        for fn, (instrs, mults, _) in sass.items():
            print(f"  [{name}] SASS {fn}: {instrs} instructions, {mults} multiply", flush=True)

    acc0, pxy, heads = chain_inputs(n, steps, device)
    want8, _ = plain_chain_counted(acc0, pxy, heads)
    a, b = kmicro_inputs(n, device)
    want9 = {op: L.plain_op_chain(op, SPEC, a, b, reps) for op in L.CHAIN_OPS}
    out9 = torch.empty_like(a)
    cases = {}
    for name, lib in libs.items():
        for mode, per in MODES:
            acc = acc0.clone()
            _k8_raw(lib, acc, pxy, heads, per)
            if _max_abs_err(acc, want8):
                raise AssertionError(f"K8 [{name}, {mode}] differs from the plain chain")
        for op in L.CHAIN_OPS:
            _k9_raw(lib, op, a, b, out9, reps)
            if _max_abs_err(out9, want9[op]):
                raise AssertionError(f"K9 [{name}, {op}] differs from the plain chain")
        for mode, per in MODES:
            calls = InPlaceCalls(acc0, CHAIN_REPS[mode], lambda acc, lib=lib, per=per: _k8_raw(lib, acc, pxy, heads, per))
            cases[(name, f"K8 {mode}")] = (calls, CHAIN_REPS[mode], calls.restore)
        for op in L.CHAIN_OPS:
            cases[(name, f"K9 {op}")] = (lambda lib=lib, op=op: _k9_raw(lib, op, a, b, out9, reps), 50, None)
            if name == "tree":
                cases[(name, f"K9 {op}, {OLD_K9_BLOCK}-thread blocks")] = (
                    lambda lib=lib, op=op: _k9_raw(lib, op, a, b, out9, reps, OLD_K9_BLOCK), 50, None)
    print(f"compare: every build bit-exact against the plain chains; turns {report['turns']}", flush=True)
    for name in report["turns"]:
        for (build, case), (fn, count, setup) in cases.items():
            if build == name:
                report["ms"].setdefault(case, {}).setdefault(name, []).append(device_paced_ms(fn, count, setup))
    for case, by_build in report["ms"].items():
        print(f"  {case}: " + "; ".join(f"{k} {' / '.join(f'{t:.4f}' for t in v)}" for k, v in by_build.items()),
              flush=True)
    return report


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
    unknown = [w for w in which if w not in ("chain", "kmicro", "compare")]
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
    if "compare" in which:
        result["compare"] = run_compare(dev, cfg["n"], cfg["steps"], cfg["reps"], BUILDS)
    errs = [result["chain"]["max_abs_err"]] if "chain" in result else []
    errs += [r["max_abs_err"] for r in result.get("kmicro", {}).get("ops", {}).values()]
    print(json.dumps(result), flush=True)
    return 1 if any(errs) else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
