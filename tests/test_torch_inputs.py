"""Inputs shared by the port's CPU tests and its card tests
(tests/test_torch_kernels.py, which run on a machine without JAX), made
without JAX: ``MulCircuit`` is tests/test_prover.py::MulCircuit and
``LookupCircuit`` tests/test_prover.py::LookupCircuit on the port's plonk
layer; ``bucket_rows`` makes rows of MSM bucket sums with the identity,
equal and opposite buckets forced in; ``hand_bucket_runs`` makes sorted
bucket runs laid out on chunk boundaries and ``host_bucket_walk`` their
sums and collision flags by the host group law; ``fold_stack`` makes the
layers of partial sums that K3's fold adds, with its special cases. The tests here check the inputs'
shape: the pins of the circuits' quotient programs, and the buckets' value.
"""

import random

import numpy as np
import pytest
import torch

from battlezips_halo2_tpu_torch.curves import limb as C
from battlezips_halo2_tpu_torch.curves.host import VESTA
from battlezips_halo2_tpu_torch.fields import limb as L
from battlezips_halo2_tpu_torch.fields.limb import FP_SPEC, FQ_SPEC, ints_to_limbs
from battlezips_halo2_tpu_torch.ops import gate_eval as G
from battlezips_halo2_tpu_torch.gadgets.common import with_selector
from battlezips_halo2_tpu_torch.pcs.ipa import Params
from battlezips_halo2_tpu_torch.plonk import Circuit, keygen
from battlezips_halo2_tpu_torch.plonk.arguments import ProofSchedule


class MulCircuit(Circuit):
    """tests/test_prover.py::MulCircuit on the port's plonk layer."""

    def __init__(self, a, b, c):
        self.a, self.b, self.c = a, b, c

    @classmethod
    def configure(cls, cs):
        a, b, c = cs.advice_column(), cs.advice_column(), cs.advice_column()
        inst = cs.instance_column()
        s = cs.selector()
        for col in (a, b, c):
            cs.enable_equality(col)
        cs.enable_equality(inst)
        cs.create_gate("mul", with_selector(s.expr(), [("a*b=c", a.cur() * b.cur() - c.cur())]))
        return (a, b, c, inst, s)

    def synthesize(self, config, layouter):
        a, b, c, inst, s = config

        def region(r):
            r.enable_selector("mul", s, 0)
            r.assign_advice("a", a, 0, self.a)
            r.assign_advice("b", b, 0, self.b)
            return r.assign_advice("c", c, 0, self.c)

        out = layouter.assign_region("mul", region)
        layouter.constrain_instance(out, inst, 0)

    def without_witnesses(self):
        return MulCircuit(1, 1, 1)


class LookupCircuit(Circuit):
    """tests/test_prover.py::LookupCircuit on the port's plonk layer."""

    def __init__(self, values):
        self.values = values

    @classmethod
    def configure(cls, cs):
        a = cs.advice_column()
        cs.enable_equality(a)
        table = cs.lookup_table_column()
        s = cs.selector()
        cs.lookup("in-table", [(s.expr() * a.cur(), table.inner.cur())])
        return (a, table, s)

    def synthesize(self, config, layouter):
        a, table, s = config

        def table_fn(t):
            for i in range(16):
                t.assign_cell(f"t{i}", table, i, i)

        layouter.assign_table("table", table_fn)

        def region(r):
            for i, v in enumerate(self.values):
                r.enable_selector("lk", s, i)
                r.assign_advice("a", a, i, v)

        layouter.assign_region("values", region)

    def without_witnesses(self):
        return LookupCircuit([0] * len(self.values))


def port_vk(name: str, device):
    """The verifying key of the k=5 MulCircuit ("mul") or the k=6
    LookupCircuit ("lookup") from the port's own SRS and keygen."""
    k, circuit = {"mul": (5, MulCircuit(1, 1, 1)), "lookup": (6, LookupCircuit([0] * 4))}[name]
    return keygen(Params.new(k, device=device), circuit).vk


def bucket_rows(rows: int, nbuck: int, seed: int, device):
    """Rows of Vesta bucket sums -> ((rows, nbuck, 3, 8) Jacobian Montgomery
    limbs with random Z, the host's affine points (None = identity)). About
    one bucket in eight is the identity, one equals the bucket before it,
    one is its negation; bucket 0 is the identity (unused by the MSM)."""
    rng = random.Random(seed)
    base = [VESTA.mul(VESTA.generator, rng.randrange(1, VESTA.scalar.modulus)) for _ in range(8)]
    pts = []
    for _ in range(rows):
        row = [None]
        for _ in range(1, nbuck):
            kind, prev = rng.randrange(8), row[-1]
            if kind == 0:
                row.append(None)
            elif kind == 1:
                row.append(prev)
            elif kind == 2:
                row.append(VESTA.neg(prev))
            else:
                row.append(VESTA.add(base[rng.randrange(8)], base[kind]))
        pts.append(row)
    q, r = FQ_SPEC.modulus, FQ_SPEC.r_mod_p
    words = []
    for p in (p for row in pts for p in row):
        if p is None:
            words += [r, r, 0]
        else:
            lam = rng.randrange(1, q)
            words += [p[0] * lam**2 * r % q, p[1] * lam**3 * r % q, lam * r % q]
    return ints_to_limbs(words, device).view(rows, nbuck, 3, 8), pts


def host_window_sum(row: list):
    """sum_{b >= 1} b S_b by the host group law, as running sums."""
    run = acc = None
    for p in reversed(row[1:]):
        run = VESTA.add(run, p)
        acc = VESTA.add(acc, run)
    return acc


def hand_bucket_runs(n_points: int, chunk: int, chunks: int, seed: int, device):
    """Hand-made sorted bucket runs for K2 / K7 over a Vesta table of
    n_points random points, the identity (row n_points) and the negations
    of the first 8 (rows n_points + 1 + j), filling exactly chunk x chunks
    rows, so that a pass with chunk length ``chunk`` cuts them into
    ``chunks`` chunks. By bucket index mod 8: 0 empty, 1 P then P from a
    chunk's first row (inside a chunk when chunk >= 2), 2 P then -P, 3 an
    identity inside the run, 4 an identity at the head, 5 P then P
    straddling a chunk boundary, 6 a run over about three chunks, 7
    random. -> (table, src, starts, bid, the point of each table row, the
    kind of each bucket)."""
    rng = random.Random(seed)
    pts = [VESTA.mul(VESTA.generator, rng.randrange(1, VESTA.scalar.modulus)) for _ in range(n_points)]
    points = pts + [None] + [VESTA.neg(p) for p in pts[:8]]
    ident, negs, total = n_points, n_points + 1, chunk * chunks
    src, starts, kinds = [], [0], []

    def close(run, kind):
        src.extend(run)
        starts.append(len(src))
        kinds.append(kind)

    while len(src) < total:
        kind = len(kinds) % 8
        run = [rng.randrange(n_points) for _ in range(rng.randrange(1, 5))]
        if kind == 0:
            run = []
        elif kind in (1, 5):
            align = 0 if kind == 1 else chunk - 1
            if len(src) % chunk != align:
                close([rng.randrange(n_points) for _ in range((align - len(src)) % chunk)], 7)
            p = rng.randrange(n_points)
            run = [p, p] + [i for i in run if i != p]
        elif kind == 2:
            j = rng.randrange(8)
            run[0:0] = [j, negs + j]
        elif kind == 3:
            run.insert(rng.randrange(1, len(run) + 1), ident)
        elif kind == 4:
            run = [ident] + run
        elif kind == 6:
            run = [rng.randrange(n_points) for _ in range(3 * chunk + 2)]
        close(run, kind)
    if len(src) > total:  # the last run, cut to fill exactly chunk x chunks rows
        del src[total:]
        starts[-1], kinds[-1] = total, 7
    table = C.affine_table(FQ_SPEC, points, device)
    lens = torch.tensor(starts).diff()
    bid = torch.repeat_interleave(torch.arange(len(kinds), dtype=torch.int32), lens).to(device)
    as_tensor = lambda v: torch.tensor(v, dtype=torch.int32, device=device)  # noqa: E731
    return table, as_tensor(src), as_tensor(starts), bid, points, kinds


def host_bucket_walk(curve, points: list, src: list, starts: list, chunk: int, complete: bool):
    """Bucket sums by the host group law and the flags of a pass with chunk
    length ``chunk``: a bucket is flagged (incomplete law only) iff inside
    one chunk its running sum met the next point, P == Q, which the
    incomplete mixed addition leaves to the complete redo. -> (sums, flags)."""
    sums, flags = [], []
    for b in range(len(starts) - 1):
        acc, seg, flag = None, None, False
        for i in range(starts[b], starts[b + 1]):
            q = points[src[i]]
            same_chunk = i > starts[b] and (i - 1) // chunk == i // chunk
            if same_chunk and seg is not None and seg == q:
                flag = True
            seg = curve.add(seg, q) if same_chunk else q
            acc = curve.add(acc, q)
        sums.append(acc)
        flags.append(int(flag and not complete))
    return sums, flags


def in_place_program(device):
    """A hand-made VM program whose destinations are also its operands
    (t = u + v; t = t * t; agg = agg * y + t; agg = agg * y - t) over two
    proofs of 8 lanes, u read at rotation +1 -> (the arguments of
    ops/gate_eval.py::quotient_vm after ``spec``, h as canonical ints)."""
    p, r, ext, nb = FP_SPEC.modulus, FP_SPEC.r_mod_p, 8, 2
    rng = random.Random(5)
    u, v = ([rng.randrange(p) for _ in range(ext)] for _ in range(2))
    ys = [rng.randrange(p) for _ in range(nb)]
    per = ints_to_limbs([x * r % p for _ in range(nb) for col in (u, v) for x in col], device).view(nb, 2, ext, 8)
    empty = torch.zeros(0, 8, dtype=torch.int32, device=device)
    sources = (empty, per, empty, ints_to_limbs([y * r % p for y in ys], device))
    # registers: 0 agg, 1-3 the pins u (rotation +1), v, y, 4 the temporary t
    desc = torch.tensor([[G.SRC_PER, 0, 2 * ext, 1, 1], [G.SRC_PER, ext, 2 * ext, 1, 0], [G.SRC_SCALARS, 0, 1, 0, 0]],
                        device=device)
    prog = torch.tensor([[G.OP_ADD, 1, 2, 4], [G.OP_MUL, 4, 4, 4], [G.OP_MUL, 0, 3, 0], [G.OP_ADD, 0, 4, 0],
                         [G.OP_MUL, 0, 3, 0], [G.OP_SUB, 0, 4, 0]], dtype=torch.int32, device=device)
    t_inv = ints_to_limbs([r] * ext, device)  # 1 in Montgomery form
    want = []
    for y in ys:
        for i in range(ext):
            t = (u[(i + 1) % ext] + v[i]) ** 2 % p
            want.append((t * y - t) % p)
    return (prog, desc, sources, t_inv, nb, 5), want


def _rescaled(spec, jac: torch.Tensor, lam: int) -> torch.Tensor:
    """The same points with Z multiplied by lam: (X lam^2, Y lam^3, Z lam)."""
    lam_m = ints_to_limbs([lam * spec.r_mod_p % spec.modulus], jac.device)
    lam2 = L.mont_mul_plain(spec, lam_m, lam_m)
    lam3 = L.mont_mul_plain(spec, lam2, lam_m)
    x, y, z = jac.unbind(-2)
    return torch.stack((L.mont_mul_plain(spec, x, lam2), L.mont_mul_plain(spec, y, lam3),
                        L.mont_mul_plain(spec, z, lam_m)), dim=-2)


def _negated(curve, spec, jac: torch.Tensor) -> torch.Tensor:
    return C.affine_to_jacobian(spec, [curve.neg(p) for p in C.jacobian_to_affine(spec, jac)], jac.device)


def fold_stack(curve, spec, d: int, seed: int, lanes: int = 12) -> torch.Tensor:
    """(d, lanes, 3, 8) Jacobian points from a numpy seed, with non-trivial
    Z (on the CPU): lane 0 starts at the identity; the second layer holds
    the identity (lane 1), P == Q in equal (2) and unequal Z (3) and
    P == -Q (4, so the third layer adds to the identity); from the third
    layer on, lanes 5 and 6 hold the running sum (unequal Z) and its
    negation. The points are running sums of 16 seeded multiples of the
    generator, so no two are equal."""
    rng = np.random.default_rng(seed)
    base = [curve.mul(curve.generator, int(s)) for s in rng.integers(1, 1 << 62, size=16)]
    pts = [base[0]]
    for i in range(1, 2 * d * lanes):
        pts.append(curve.add(pts[-1], base[i % 16]))
    jac = C.affine_to_jacobian(spec, pts, "cpu").view(2, d, lanes, 3, 8)
    stack = C.point_add_plain(spec, jac[0], jac[1])
    if lanes < 7:
        return stack.contiguous()
    stack[0, 0] = C.infinity(spec, (), "cpu")
    stack[1, 1] = C.infinity(spec, (), "cpu")
    stack[1, 2] = stack[0, 2]
    stack[1, 3] = _rescaled(spec, stack[0, 3:4], int(rng.integers(2, 1 << 62)))[0]
    stack[1, 4] = _negated(curve, spec, stack[0, 4:5])[0]
    acc = C.point_add_plain(spec, stack[0], stack[1])
    for k in range(2, d):
        stack[k, 5] = _rescaled(spec, acc[5:6], int(rng.integers(2, 1 << 62)))[0]
        stack[k, 6] = _negated(curve, spec, acc[6:7])[0]
        acc = C.point_add_plain(spec, acc, stack[k])
    return stack.contiguous()


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name,rotations", [("mul", {0, 1, "usable"}), ("lookup", {0, 1, -1})])
def test_quotient_programs_pin_the_rotations(name, rotations):
    """The MulCircuit's program reads rotations 0 and +1 and the usable row
    (permutation chunks), the LookupCircuit's also -1 (lk_a at -1); only
    temporaries and agg are written."""
    vk = port_vk(name, "cpu")
    prog, pins, n_regs = G.emit_vm(vk, ProofSchedule.build(vk.cs))
    usable = vk.cs.usable_rows(vk.domain.n)
    rots = {("usable" if key[3] == usable else key[3]) for key in pins if key[0] == "inp"}
    assert rots >= rotations
    dst = prog[:, 3]
    assert ((dst == 0) | (dst > len(pins))).all() and int(prog[:, 1:].max()) < n_regs


def test_bucket_rows_hold_their_points():
    """The limbs of bucket_rows are its host points (random Z, identity
    (1, 1, 0)); equal and opposite neighbours occur."""
    buckets, pts = bucket_rows(2, 40, 1, "cpu")
    assert C.jacobian_to_affine(FQ_SPEC, buckets) == [p for row in pts for p in row]
    flat = [p for row in pts for p in row[1:]]
    pairs = list(zip(flat, flat[1:]))
    assert any(a == b and a is not None for a, b in pairs)
    assert any(a is not None and b == VESTA.neg(a) for a, b in pairs)
    assert None in flat
