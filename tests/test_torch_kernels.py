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
from battlezips_halo2_tpu_torch.ops import msm as M
from battlezips_halo2_tpu_torch.ops import ntt as D

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


@pytest.mark.parametrize("complete", [False, True], ids=["K2", "K7"])
def test_k2_k7_bucket_sums(cuda, complete):
    rng = random.Random(7)
    spec = L.FQ_SPEC
    pts = [VESTA.mul(VESTA.generator, rng.randrange(1, 1 << 64)) for _ in range(16)]
    table = C.affine_table(spec, pts + [None, VESTA.neg(pts[0])], cuda)
    runs = [[0, 0, 3], [0, 17, 2], [16, 5], [], [1, 16, 1], [4, 5, 6, 7]]
    src = torch.tensor(sum(runs, []), dtype=torch.int32, device=cuda)
    starts = torch.tensor([0] + [sum(map(len, runs[: i + 1])) for i in range(len(runs))], dtype=torch.int32, device=cuda)
    got = M.bucket_sums(spec, table, src, starts, complete)
    want = M.bucket_sums_plain(spec, table, src, starts, complete)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert bool(got[1][0]) == (not complete)


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
