"""The port's CUDA kernels against their plain PyTorch versions on the card,
bit for bit (tolerance 0). Marked ``gpu``: without a CUDA card they skip;
on the card run ``python -m pytest tests/test_torch_kernels.py -m gpu``
(chip_smoke.py makes the same checks at the main path's shapes)."""

import random

import pytest
import torch

from battlezips_halo2_tpu_torch.curves import limb as C
from battlezips_halo2_tpu_torch.curves.host import VESTA
from battlezips_halo2_tpu_torch.fields import limb as L
from battlezips_halo2_tpu_torch.fields.host import FP
from battlezips_halo2_tpu_torch.ops import gate_eval as G
from battlezips_halo2_tpu_torch.ops import msm as M
from battlezips_halo2_tpu_torch.ops import ntt as D
from battlezips_halo2_tpu_torch.plonk.arguments import ProofSchedule
from test_torch_inputs import (
    bucket_rows, fold_stack, hand_bucket_runs, host_bucket_walk, host_window_sum, in_place_program, port_vk,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _field(rng, p, n, dev):
    return L.ints_to_limbs([0, 1, p - 1] + [rng.randrange(p) for _ in range(n - 3)], dev)


@pytest.mark.parametrize("op", [L.OP_MUL, L.OP_ADD, L.OP_SUB])
@pytest.mark.parametrize("spec", [L.FP_SPEC, L.FQ_SPEC], ids=["Fp", "Fq"])
def test_k1_field_op(cuda, spec, op):
    rng = random.Random(op)
    a, b = _field(rng, spec.modulus, 1000, cuda), _field(rng, spec.modulus, 1000, cuda)
    assert torch.equal(L.field_op(op, spec, a, b), L.plain_field_op(op, spec, a, b))
    row = b[:4].contiguous()
    assert torch.equal(L.field_op(op, spec, a, row), L.plain_field_op(op, spec, a, row))


def _edge_field(rng, p, n, dev):
    """n elements: runs of 0, 1, p - 1, p - 2 between random values."""
    return L.ints_to_limbs([(0, 1, p - 1, p - 2)[i % 4] if i % 8 < 4 else rng.randrange(p) for i in range(n)], dev)


@pytest.mark.parametrize("batch, rows, nb", [(1, 1000, 1000), (3, 1000, 1), (3, 1000, 1000), (7, 333, 333),
                                             (2, 4103, 1), (1, 1, 1)],
                         ids=["nb=n", "nb=1", "nb=row", "ragged-row", "ragged-nb=1", "one"])
@pytest.mark.parametrize("op", [L.OP_MUL, L.OP_ADD, L.OP_SUB], ids=["mul", "add", "sub"])
@pytest.mark.parametrize("spec", [L.FP_SPEC, L.FQ_SPEC], ids=["Fp", "Fq"])
def test_k1_field_op_edges_and_broadcast(cuda, spec, op, batch, rows, nb):
    """K1 on edge values (0, 1, p - 1, p - 2) with b broadcast over a's
    batch (nb = 1, nb = a row) and rows that are no multiple of the block,
    also with the output in place of a, and of b where b is as long as a."""
    rng = random.Random(rows + op)
    a = _edge_field(rng, spec.modulus, batch * rows, cuda).view(batch, rows, 8)
    b = _edge_field(rng, spec.modulus, nb, cuda)
    want = L.plain_field_op(op, spec, a, b)
    assert torch.equal(L.field_op(op, spec, a, b), want)
    into = a.clone()
    assert torch.equal(L.field_op(op, spec, into, b, out=into), want)
    if batch * rows == nb:
        into = b.clone()
        assert torch.equal(L.field_op(op, spec, a, into, out=into.view(a.shape)).view(b.shape), want.view(b.shape))


@pytest.mark.parametrize("threads", [32, 64, 128, 256, 512, 1024])
def test_k1_field_op_block_sizes(cuda, threads):
    """The entry at every block size chip_smoke.py times, for nb = 1, a
    ragged row and a full b."""
    from battlezips_halo2_tpu_torch.ops import cuda as K

    rng = random.Random(threads)
    spec = L.FP_SPEC
    for batch, rows, nb in ((5, 777, 1), (5, 777, 777), (1, 3000, 3000)):
        a = _edge_field(rng, spec.modulus, batch * rows, cuda).view(batch, rows, 8)
        b = _edge_field(rng, spec.modulus, nb, cuda)
        out = torch.empty_like(a)
        K.check(K.library().bz_field_op(L.OP_MUL, spec.kernel_consts, K.ptr(a), K.ptr(b), K.ptr(out), batch * rows,
                                        nb, threads, K.stream(a)), "K1 bz_field_op")
        assert torch.equal(out, L.plain_field_op(L.OP_MUL, spec, a, b))


def test_k4_ntt_stage(cuda):
    rng = random.Random(4)
    n = 1 << 9
    plan = D.NttPlan(L.FP_SPEC, n, pow(FP.root_of_unity, 1 << 23, FP.modulus), cuda)
    x = _field(rng, FP.modulus, 3 * n, cuda).view(3, n, 8)
    want = x.index_select(1, plan.rev_idx)
    for s in range(plan.logn):
        want = D.butterfly_stage_plain(L.FP_SPEC, want, plan.stage_twiddles[s], s)
    assert torch.equal(D.ntt(plan, x), want)


def test_k3_point_add(cuda):
    rng = random.Random(3)
    pts = [VESTA.mul(VESTA.generator, rng.randrange(1, 1 << 64)) for _ in range(12)]
    ps = pts[:8] + [None, pts[0], pts[1], None]
    qs = pts[4:] + [pts[2], None, VESTA.neg(pts[1]), None]
    spec = L.FQ_SPEC
    p, q = C.affine_to_jacobian(spec, ps, cuda), C.affine_to_jacobian(spec, qs, cuda)
    p = C.point_add_plain(spec, p, q)
    q[0] = p[0]
    assert torch.equal(C.point_add(spec, p, q), C.point_add_plain(spec, p, q))


@pytest.mark.parametrize("lanes", [1, 352, 1528])
@pytest.mark.parametrize("d", [2, 3, 4])
def test_k3_point_fold(cuda, d, lanes):
    """K3's fold against its plain version and the host group law: the
    identity, P == Q (equal and unequal Z) and P == -Q in the first lanes
    (tests/test_torch_inputs.py::fold_stack), one launch a call."""
    from battlezips_halo2_tpu_torch.ops import cuda as K

    spec = L.FQ_SPEC
    stack = fold_stack(VESTA, spec, d, seed=d * 10_000 + lanes, lanes=lanes).to(cuda)
    before = K.entry_launches.get("bz_point_fold", 0)
    got = C.point_fold(spec, stack)
    assert K.entry_launches.get("bz_point_fold", 0) == before + 1
    assert torch.equal(got, C.point_fold_plain(spec, stack))
    sample = range(min(lanes, 16))
    want = []
    for i in sample:
        acc = None
        for p in C.jacobian_to_affine(spec, stack[:, i]):
            acc = VESTA.add(acc, p)
        want.append(acc)
    assert C.jacobian_to_affine(spec, got[: len(sample)]) == want


@pytest.mark.parametrize("complete", [False, True], ids=["K2", "K7"])
def test_k2_k7_bucket_sums(cuda, complete):
    """The bucket pass against its plain version at the kernel's chunk
    length, in Jacobian coordinates and flags: a few short runs (L = 1)
    and hand-made runs laid out for L = 3 over one wave of threads (P then
    P inside a chunk and across a boundary, identity rows, a run over
    several chunks), whose affine sums equal the host group law wherever
    the flag is 0."""
    rng = random.Random(7)
    spec = L.FQ_SPEC
    pts = [VESTA.mul(VESTA.generator, rng.randrange(1, 1 << 64)) for _ in range(16)]
    table = C.affine_table(spec, pts + [None, VESTA.neg(pts[0])], cuda)
    runs = [[0, 0, 3], [0, 17, 2], [16, 5], [], [1, 16, 1], [4, 5, 6, 7]]
    src = torch.tensor(sum(runs, []), dtype=torch.int32, device=cuda)
    starts = torch.tensor([0] + [sum(map(len, runs[: i + 1])) for i in range(len(runs))], dtype=torch.int32, device=cuda)
    bid = torch.repeat_interleave(torch.arange(len(runs), dtype=torch.int32, device=cuda), starts.diff())
    resident = M.bucket_resident(cuda, complete)
    assert M.bucket_layout(int(starts[-1]), resident, int(starts.diff().max()))[0] == 1
    got = M.bucket_sums(spec, table, src, starts, bid, complete)
    want = M.bucket_sums_plain(spec, table, src, starts, complete, chunk=1)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert not got[1].any()  # P then P at a run's head meets the complete merge when every row is a chunk

    table, src, starts, bid, points, kinds = hand_bucket_runs(40, 3, resident, 11, cuda)
    assert M.bucket_layout(int(starts[-1]), resident, int(starts.diff().max())) == (3, resident)
    got = M.bucket_sums(spec, table, src, starts, bid, complete)
    want = M.bucket_sums_plain(spec, table, src, starts, complete, chunk=3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    sums, flags = host_bucket_walk(VESTA, points, src.tolist(), starts.tolist(), 3, complete)
    assert got[1].tolist() == flags
    check = [b for b in range(0, len(kinds), 7) if not flags[b]]
    idx = torch.tensor(check, device=cuda)
    assert C.jacobian_to_affine(spec, got[0].index_select(0, idx)) == [sums[b] for b in check]
    assert complete or any(flags)


@pytest.mark.parametrize(
    "rows,nbuck,tile", [(2, 4, 1), (32, 256, 1), (3, 513, 1), (5, 6, 1), (10, 64, 110)],
    ids=["ipa_c2", "board_c8", "signed_c10", "m5", "narrow_rows"],
)
def test_k3_window_sums(cuda, rows, nbuck, tile):
    """The window kernel against window_sums' plain version and the host
    group law, on affine points (the two add in different orders); with
    1100 rows (10 repeated) of 63 buckets a row takes 32 threads."""
    spec = L.FQ_SPEC
    buckets, pts = bucket_rows(rows, nbuck, 30 + nbuck, cuda)
    got = C.jacobian_to_affine(spec, M.window_sums(spec, buckets.repeat(tile, 1, 1, 1), nbuck))
    assert got[:rows] == C.jacobian_to_affine(spec, M.window_sums_plain(spec, buckets, nbuck))
    assert got == [host_window_sum(row) for row in pts] * tile


@pytest.mark.parametrize("name,nb", [("mul", 1), ("mul", 2), ("lookup", 2)])
def test_k1_quotient_vm(cuda, name, nb):
    """The VM kernel on the k=5 MulCircuit's and the k=6 LookupCircuit's
    programs (rotations 0, +1, -1, the usable row) equals the stepwise
    route on the card (the plain version's loop over the elementwise K1
    kernel, one launch per instruction) and the kernel's plain version,
    bit for bit."""
    vk = port_vk(name, cuda)
    ev = G.BatchQuotientEvaluator(vk, ProofSchedule.build(vk.cs), cuda)
    rng = random.Random(nb)
    p, n = FP.modulus, vk.domain.n
    polys = [{k: [rng.randrange(p) for _ in range(n)] for k in ev.keys} for _ in range(nb)]
    per, ch = ev.inputs(polys, [tuple(rng.randrange(p) for _ in range(4)) for _ in range(nb)])
    got = ev.h_ext(per, ch)
    args = (L.FP_SPEC, ev.prog_t, ev.desc, ev.sources(per, ch), ev.t_inv, nb, ev.n_regs)
    assert torch.equal(got, G.quotient_vm_plain(*args, op=L.field_op))
    assert torch.equal(got, G.quotient_vm_plain(*args))


def test_k1_quotient_vm_in_place(cuda):
    """A destination register that is also an operand, in the kernel."""
    args, want = in_place_program(cuda)
    got = G.quotient_vm(L.FP_SPEC, *args)
    assert L.limbs_to_ints(L.from_mont(L.FP_SPEC, got)) == want
    assert torch.equal(got, G.quotient_vm_plain(L.FP_SPEC, *args))


def test_k5_butterfly_rows(cuda):
    rng = random.Random(5)
    n = 1 << 9
    plan = D.NttPlan(L.FP_SPEC, n, pow(FP.root_of_unity, 1 << 23, FP.modulus), cuda)
    idx_u, idx_v, _, tw = plan.row_tables()[plan.logn - 2]
    x = _field(rng, FP.modulus, 3 * n, cuda).view(3, n, 8)
    u, v = x.index_select(1, idx_u), x.index_select(1, idx_v)
    got, want = D.butterfly_rows(L.FP_SPEC, u, v, tw), D.butterfly_rows_plain(L.FP_SPEC, u, v, tw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_k5_row_ntt(cuda, monkeypatch):
    rng = random.Random(55)
    n = 1 << 10
    plan = D.NttPlan(L.FP_SPEC, n, pow(FP.root_of_unity, 1 << 22, FP.modulus), cuda)
    x = _field(rng, FP.modulus, 2 * n, cuda).view(2, n, 8)
    want = D.ntt(plan, x)
    monkeypatch.setenv("BZ_ROW_NTT", "1")
    assert torch.equal(D.ntt(plan, x), want)


def test_k6_point_add_planes(cuda):
    rng = random.Random(6)
    pts = [VESTA.mul(VESTA.generator, rng.randrange(1, 1 << 64)) for _ in range(12)]
    ps = pts[:8] + [None, pts[0], pts[1], None]
    qs = pts[4:] + [pts[2], None, VESTA.neg(pts[1]), None]
    spec = L.FQ_SPEC
    p, q = C.affine_to_jacobian(spec, ps, cuda), C.affine_to_jacobian(spec, qs, cuda)
    p = C.point_add_plain(spec, p, q)
    q[0] = p[0]
    planes = [t.movedim(-2, 0).contiguous() for t in (p, q)]
    got = C.point_add_planes(spec, *planes)
    assert torch.equal(got, C.point_add_planes_plain(spec, *planes))
    assert torch.equal(got.movedim(0, -2), C.point_add(spec, p, q))


@pytest.mark.parametrize("rows,nbuck", [(2, 4), (32, 256)], ids=["ipa_c2", "board_c8"])
def test_k6_window_sums_planes(cuda, rows, nbuck):
    """K6's window kernel against its plain version and the host group law,
    on affine points (the two add in different orders), in one launch."""
    from battlezips_halo2_tpu_torch.ops import cuda as K

    spec = L.FQ_SPEC
    buckets, pts = bucket_rows(rows, nbuck, 60 + nbuck, cuda)
    planes = buckets.permute(2, 0, 1, 3).contiguous()
    before = K.launches["K6"]
    got = M.window_sums_planes(spec, planes, nbuck)
    assert K.launches["K6"] == before + 1
    affine = C.jacobian_to_affine(spec, got.movedim(0, -2))
    assert affine == C.jacobian_to_affine(spec, M.window_sums_planes_plain(spec, planes, nbuck).movedim(0, -2))
    assert affine == [host_window_sum(row) for row in pts]


@pytest.mark.parametrize("lanes", [1, 31, 1528, (1 << 16) + 3])
def test_k6_point_add_planes_lanes(cuda, lanes):
    """K6's lane-wise kernel at ragged lane counts against its plain version
    and K3's lane-wise kernel, coordinate for coordinate, also with the
    output in place of p and of q: the identity, P == Q (equal and unequal
    Z) and P == -Q lanes of tests/test_torch_inputs.py::fold_stack, repeated
    past its 1528 lanes. One launch a call."""
    from battlezips_halo2_tpu_torch.ops import cuda as K

    spec = L.FQ_SPEC
    base = fold_stack(VESTA, spec, 2, seed=6_000 + min(lanes, 1528), lanes=min(lanes, 1528))
    p, q = base.repeat(1, -(-lanes // base.shape[1]), 1, 1)[:, :lanes].to(cuda).unbind(0)
    planes = [t.movedim(-2, 0).contiguous() for t in (p, q)]
    before = K.entry_launches.get("bz_point_add_planes", 0)
    got = C.point_add_planes(spec, *planes)
    assert K.entry_launches.get("bz_point_add_planes", 0) == before + 1
    assert torch.equal(got, C.point_add_planes_plain(spec, *planes))
    assert torch.equal(got.movedim(0, -2), C.point_add(spec, p.contiguous(), q.contiguous()))
    for i in range(2):
        into = [t.clone() for t in planes]
        assert torch.equal(C.point_add_planes(spec, *into, out=into[i]), got)
        assert torch.equal(into[i], got)


def _launches(name: str) -> int:
    from battlezips_halo2_tpu_torch.ops import cuda as K

    return K.launches[name]


def _mm_operand(rng, spec, shape, dev):
    """Random canonical limbs of ``shape`` + (8,), with 0, 1 and p - 1 first."""
    count = 1
    for d in shape:
        count *= d
    vals = [0, 1, spec.modulus - 1] + [rng.randrange(spec.modulus) for _ in range(count - 3)]
    return L.ints_to_limbs(vals[:count], dev).view(*shape, 8)


@pytest.mark.parametrize("batch, kp, k, m", [((), 12, 16, 5), ((3,), 12, 16, 5), ((2,), 33, 17, 40),
                                              ((1,), 64, 64, 64), ((2, 2), 8, 8, 16), ((), 1, 1024, 1)],
                         ids=["K'<K", "batch", "ragged", "64^3", "2-d batch", "1024 terms"])
def test_m1_fp_const_matmul(cuda, batch, kp, k, m):
    """M1 against its plain version, with the matrix in Montgomery limbs and
    as given (mont=False), one launch a call; the all-(p - 1) matrix too."""
    from battlezips_halo2_tpu_torch.ops import ntt_mm as MM

    spec = L.FP_SPEC
    rng = random.Random(kp * k + m)
    a = _mm_operand(rng, spec, batch + (k, m), cuda)
    w_ints = [[rng.randrange(spec.modulus) for _ in range(k)] for _ in range(kp)]
    for w, mont in ((MM.matrix_limbs(spec, w_ints, cuda), True), (w_ints, False),
                    ([[spec.modulus - 1] * k] * kp, True)):
        before = _launches("M1")
        got = MM.fp_const_matmul(spec, w, a, mont=mont)
        assert _launches("M1") == before + 1
        assert got.shape == batch + (kp, m, 8)
        assert torch.equal(got, MM.fp_const_matmul_plain(spec, w, a, mont=mont))


@pytest.mark.parametrize("logn", [1, 5, 10, 12])
def test_ntt_mm_on_the_card(cuda, monkeypatch, logn):
    """The matrix-product NTT equals the K4 route bit for bit, directly and
    through ops/ntt.py::ntt under BZ_NTT_MM=on: two M1 launches, no K4."""
    from battlezips_halo2_tpu_torch.ops import ntt_mm as MM

    n = 1 << logn
    omega = pow(FP.root_of_unity, 1 << (FP.two_adicity - logn), FP.modulus)
    x = _field(random.Random(logn), FP.modulus, 3 * n, cuda).view(3, n, 8)
    plan = D.plan_for(FP.modulus, n, omega, str(cuda))
    want = D.ntt(plan, x)
    assert torch.equal(MM.ntt_mm(MM.mm_plan_for(FP.modulus, n, omega, str(cuda)), x), want)
    monkeypatch.setenv("BZ_NTT_MM", "on")
    before = (_launches("M1"), _launches("K4"))
    assert torch.equal(D.ntt(plan, x), want)
    assert (_launches("M1"), _launches("K4")) == (before[0] + 2, before[1])


def test_row_msm(cuda, monkeypatch):
    rng = random.Random(66)
    pts = [VESTA.mul(VESTA.generator, rng.randrange(1, 1 << 64)) for _ in range(300)]
    scalars = [rng.randrange(VESTA.scalar.modulus) for _ in pts]
    monkeypatch.setenv("BZ_ROW_MSM", "1")
    assert M.msm(VESTA, pts, scalars, cuda) == VESTA.msm(pts, scalars)


def _chain_inputs(cuda, lanes, steps, seed):
    """Random heads over P reversed, plus lanes 0-7 a head then adds (the
    incomplete law's P == P case, then the identity), lane 8 P the
    identity and lane 9 acc0 the identity."""
    rng = random.Random(seed)
    pts = [VESTA.mul(VESTA.generator, rng.randrange(1, 1 << 62)) for _ in range(lanes)]
    pts[8] = None
    acc_pts = pts[::-1]
    acc_pts[9] = None
    heads = torch.tensor([[rng.random() < 0.1 for _ in range(lanes)] for _ in range(steps)])
    heads[:, :8] = False
    heads[0, :8] = True
    spec = L.FQ_SPEC
    acc0 = C.affine_to_jacobian(spec, acc_pts, cuda)
    return acc0, C.affine_table(spec, pts, cuda), heads.to(cuda)


@pytest.mark.parametrize("per", [None, 1, 5], ids=["one_launch", "launch_per_step", "five_per_launch"])
def test_k8_step_chain(cuda, per):
    acc0, pxy, heads = _chain_inputs(cuda, 300, 12, seed=8)
    got = C.step_chain(L.FQ_SPEC, acc0, pxy, heads, steps_per_launch=per)
    assert torch.equal(got, C.plain_step_chain(L.FQ_SPEC, acc0, pxy, heads))
    two = C.step_chain(L.FQ_SPEC, acc0, pxy, heads[:2].contiguous(), steps_per_launch=per)
    assert int(two[:8].abs().sum()) == 0  # head then add: the generic formula's (0, 0, 0)


@pytest.mark.parametrize("op", list(L.CHAIN_OPS))
def test_k9_op_chain(cuda, op):
    rng = random.Random(9)
    spec = L.FQ_SPEC
    a, b = _field(rng, spec.modulus, 1000, cuda), _field(rng, spec.modulus, 1000, cuda)
    for reps in (0, 1, 32):
        assert torch.equal(L.op_chain(op, spec, a, b, reps), L.plain_op_chain(op, spec, a, b, reps))


def _edge_values(spec) -> list[int]:
    """0, 1, p - 1, R mod p and values whose limbs are all ones below p
    (2^(32 k) - 1, 2^254 - 1), then p - 2^(32 k)."""
    p = spec.modulus
    ones = [(1 << (32 * k)) - 1 for k in range(1, 8)] + [(1 << 254) - 1]
    return [0, 1, p - 1, spec.r_mod_p, p - 2] + ones + [p - (1 << (32 * k)) for k in range(1, 8)]


@pytest.mark.parametrize("spec", [L.FP_SPEC, L.FQ_SPEC], ids=["Fp", "Fq"])
def test_carry_chain_product_at_edge_values(cuda, spec):
    """K9's one-step chains run the carry-chain product, add, sub and
    reduction: every pair of edge values, against mont_mul_plain and the
    plain ops."""
    edge = _edge_values(spec)
    a = L.ints_to_limbs([x for x in edge for _ in edge], cuda)
    b = L.ints_to_limbs([y for _ in edge for y in edge], cuda)
    assert torch.equal(L.op_chain("mul", spec, a, b, 1), L.mont_mul_plain(spec, a, b))
    for op in L.VALUED_CHAIN_OPS:
        assert torch.equal(L.op_chain(op, spec, a, b, 1), L.plain_op_chain(op, spec, a, b, 1)), op


@pytest.mark.parametrize("per", [None, 1], ids=["one_launch", "launch_per_step"])
@pytest.mark.parametrize("lanes", [1, 31, 33, (1 << 15) + 1])
def test_k8_step_chain_ragged_lanes(cuda, lanes, per):
    acc0, pxy, heads = _chain_inputs(cuda, 64, 6, seed=lanes)
    reps = -(-lanes // acc0.shape[0])
    acc0, pxy = acc0.repeat(reps, 1, 1)[:lanes].contiguous(), pxy.repeat(reps, 1, 1)[:lanes].contiguous()
    heads = heads.repeat(1, reps)[:, :lanes].contiguous()
    got = C.step_chain(L.FQ_SPEC, acc0, pxy, heads, steps_per_launch=per)
    assert torch.equal(got, C.plain_step_chain(L.FQ_SPEC, acc0, pxy, heads))


@pytest.mark.parametrize("n", [33, (1 << 15) + 1])
@pytest.mark.parametrize("op", list(L.CHAIN_OPS))
def test_k9_op_chain_ragged(cuda, op, n):
    rng = random.Random(n)
    spec = L.FQ_SPEC
    a, b = _field(rng, spec.modulus, n, cuda), _field(rng, spec.modulus, n, cuda)
    for reps in (0, 1):
        assert torch.equal(L.op_chain(op, spec, a, b, reps), L.plain_op_chain(op, spec, a, b, reps))


@pytest.fixture
def second_card(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    return torch.device("cuda", 1)


def test_kernels_launch_on_the_second_card_from_a_new_thread(second_card):
    """A new thread's current device is cuda:0; a wrapper makes its
    tensors' card current for the launch (ops/cuda.py::launch)."""
    from concurrent.futures import ThreadPoolExecutor

    rng = random.Random(12)
    spec = L.FP_SPEC
    a, b = _field(rng, spec.modulus, 1000, second_card), _field(rng, spec.modulus, 1000, second_card)
    plan = D.NttPlan(spec, 1 << 9, pow(FP.root_of_unity, 1 << 23, FP.modulus), second_card)
    x = _field(rng, FP.modulus, 2 << 9, second_card).view(2, 1 << 9, 8)

    def run():
        before = torch.cuda.current_device()
        got = L.field_op(L.OP_MUL, spec, a, b), D.ntt(plan, x)
        torch.cuda.synchronize(second_card)
        return before, torch.cuda.current_device(), got

    with ThreadPoolExecutor(max_workers=1) as pool:
        before, after, (k1, k4) = pool.submit(run).result()
    assert before == after == 0
    assert k1.device == k4.device == second_card
    assert torch.equal(k1, L.plain_field_op(L.OP_MUL, spec, a, b))
    want = x.index_select(1, plan.rev_idx)
    for s in range(plan.logn):
        want = D.butterfly_stage_plain(spec, want, plan.stage_twiddles[s], s)
    assert torch.equal(k4, want)


@pytest.mark.parametrize("batched", [False, True], ids=["sequential", "batched"])
def test_session_on_two_cards_gives_the_one_card_bytes(second_card, batched):
    """prove_session(dp_devices=2) proves jobs (or shot sub-batches) on
    cuda:0 and cuda:1 with the bytes of the session on one card."""
    from battlezips_halo2_tpu_torch import api

    placements = [(3, 3, True), (5, 4, False), (0, 1, False), (0, 5, True), (6, 1, False)]
    kw = dict(shots_per_game=4, trapdoors=[0xBEEF], seed=5, batched=batched)
    one = api.prove_session([placements], device="cuda:0", **kw)
    two = api.prove_session([placements], dp_devices=2, **kw)
    proofs = [[p.proof for p in s.board_proofs + s.shot_proofs] for s in (one, two)]
    assert proofs[0] == proofs[1]
    assert torch.cuda.memory_allocated(second_card) > 0
    assert api.verify_session(two, device=second_card)


# ---------------------------------------------------------------- parallel


def _sharded_cases(mesh, dev):
    """The four sharded basis transforms at EvaluationDomain(10, 3) and a
    sharded MSM batch over 257 points (one vector zero past the first
    shard), each against the unsharded kernels on ``dev``."""
    from battlezips_halo2_tpu_torch.parallel.msm import shard_table, sharded_msm_many_table
    from battlezips_halo2_tpu_torch.parallel.ntt import sharded_transform_batch
    from battlezips_halo2_tpu_torch.poly import transforms as T
    from battlezips_halo2_tpu_torch.poly.domain import EvaluationDomain

    p = FP.modulus
    rng = random.Random(13)
    dom = EvaluationDomain(10, 3)
    vals = _field(rng, p, 3 * dom.n, dev).view(3, dom.n, 8)
    coeff = T.lagrange_to_coeff_limbs(dom, vals)
    ext = T.coeff_to_extended_limbs(dom, coeff)
    ext_n = dom.extended_n
    padded = torch.cat([coeff, torch.zeros(3, ext_n - dom.n, 8, dtype=torch.int32, device=dev)], 1)
    cases = [
        (sharded_transform_batch(mesh, dom.n, pow(dom.omega, -1, p), vals, post_k=pow(dom.n, -1, p)), coeff),
        (sharded_transform_batch(mesh, dom.n, dom.omega, coeff), T.coeff_to_lagrange_limbs(dom, coeff)),
        (sharded_transform_batch(mesh, ext_n, dom.extended_omega, padded, pre_g=dom.g_coset), ext),
        (sharded_transform_batch(mesh, ext_n, pow(dom.extended_omega, -1, p), ext, post_g=dom.g_coset_inv,
                                 post_k=pow(ext_n, -1, p)), T.extended_to_coeff_limbs(dom, ext)),
    ]
    for got, want in cases:
        assert got.device == dev and torch.equal(got, want)
    pts = [VESTA.mul(VESTA.generator, rng.randrange(1, 1 << 64)) for _ in range(257)]
    table = C.affine_table(L.FQ_SPEC, pts, dev)
    scalars = L.ints_to_limbs([rng.randrange(VESTA.scalar.modulus) for _ in range(2 * 257)] + [5] * 3 + [0] * 254,
                              dev).view(3, 257, 8)
    got = sharded_msm_many_table(VESTA, shard_table(VESTA, table, mesh), scalars, mesh)
    assert got == M.msm_many_table(VESTA, table, scalars)
    return cases, got


def test_sharded_ntt_and_msm_two_shards_on_one_card(cuda):
    """Two shards on one card: every kernel at shard shapes, every
    collective a copy on the card; bit-exact against the unsharded kernels,
    K3's fold adding the partials in one launch a commit batch (not the
    lane-wise addition) and no K2."""
    from battlezips_halo2_tpu_torch.ops import cuda as K
    from battlezips_halo2_tpu_torch.parallel import mesh_from_devices

    K.reset_launches()
    _sharded_cases(mesh_from_devices([cuda, cuda]), torch.device("cuda", torch.cuda.current_device()))
    assert K.entry_launches["bz_point_fold"] == 1 and "bz_point_add" not in K.entry_launches
    assert K.launches["K7"] > 0


def test_sharded_ntt_and_msm_on_two_cards(second_card, monkeypatch):
    """One shard a card: the copies between cards are ordered after the
    kernels on both cards' streams: the same values as with every card
    synchronized around each collective, and as one card alone."""
    from battlezips_halo2_tpu_torch.parallel import collectives, mesh_from_devices

    first = torch.device("cuda", 0)
    mesh = mesh_from_devices([first, second_card])
    cases, points = _sharded_cases(mesh, first)
    for name in ("all_to_all", "all_gather"):
        fn = getattr(collectives, name)

        def synced(m, xs, fn=fn):
            for d in m.local_devices():
                torch.cuda.synchronize(d)
            out = fn(m, xs)
            for d in m.local_devices():
                torch.cuda.synchronize(d)
            return out

        monkeypatch.setattr(collectives, name, synced)
        for module in ("ntt", "msm"):
            monkeypatch.setattr(f"battlezips_halo2_tpu_torch.parallel.{module}.{name}", synced, raising=False)
    synced_cases, synced_points = _sharded_cases(mesh_from_devices([first, second_card]), first)
    assert synced_points == points
    assert all(torch.equal(a[0], b[0]) for a, b in zip(cases, synced_cases))
