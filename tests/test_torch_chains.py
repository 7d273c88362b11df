"""The plain versions of kernels K8 (chained bucket step) and K9 (chained
field ops) of battlezips_halo2_tpu_torch against the bodies of the Pallas
kernels they replace (tools/exp_step_t.py's _step_T_call and
_op_chain_call), run through the JAX package's transposed-layout
arithmetic (curves/limb_t.py, fields/limb_t.py) on the CPU, and against
the host group law and host ints. All comparisons are exact (tolerance 0),
as integers. tools/exp_step_t.py itself is not imported: at import it
configures a JAX compilation cache and reads its PROF_* settings."""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from battlezips_halo2_tpu.curves import limb_t as CT
from battlezips_halo2_tpu.fields import limb_t as T
from battlezips_halo2_tpu.fields.limb import FieldSpec as RefFieldSpec
from battlezips_halo2_tpu_torch.curves import limb as C
from battlezips_halo2_tpu_torch.curves.host import VESTA
from battlezips_halo2_tpu_torch.fields import limb as L

SPEC = L.FQ_SPEC  # Vesta's base field, as the microbenchmark uses
Q = SPEC.modulus
CST = T.consts_t(RefFieldSpec.make(VESTA.base.modulus))


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def to_t(x: torch.Tensor) -> np.ndarray:
    """(N, 8) int32 limbs -> the reference's (16, N) uint32 16-bit limbs."""
    halves = x.reshape(-1, L.NLIMBS).numpy().astype("<i4").view("<u2")
    return np.ascontiguousarray(halves.T.astype(np.uint32))


def from_t(a) -> torch.Tensor:
    """(16, N) 16-bit limbs -> (N, 8) int32 limbs."""
    halves = np.ascontiguousarray(np.asarray(a).T.astype("<u2"))
    return torch.from_numpy(halves.view("<i4").reshape(-1, L.NLIMBS).copy())


@jax.jit
def _ref_step(ax, ay, az, px, py, pinf, head):
    """The body of exp_step_t.py's _step_T_call kernel."""
    merged, _flag = CT.point_add_mixed_incomplete(CST, CT.JacobianPointT(ax, ay, az), px, py, pinf)
    one = jnp.broadcast_to(jnp.asarray(CST["one_col"]), px.shape).astype(jnp.uint32)
    qz = jnp.where(pinf, jnp.zeros_like(px), one)
    r = CT.select_point(head, CT.JacobianPointT(px, py, qz), merged)
    return r.x, r.y, r.z


def _chain_case(lanes: int, steps: int, seed: int):
    """acc0, pxy, heads with the cases the chain must get right: lanes 0-7
    a head then adds (the incomplete law's P == P case, then the identity),
    lanes 8-11 acc0 == P (P == P at the first step), lane 12 P the identity,
    lane 13 acc0 the identity, the rest random heads over P reversed."""
    rng = random.Random(seed)
    pts = [VESTA.mul(VESTA.generator, rng.randrange(1, 1 << 62)) for _ in range(lanes)]
    pts[12] = None
    acc_pts = pts[::-1]
    acc_pts[8:12] = pts[8:12]
    acc_pts[13] = None
    heads = torch.tensor([[rng.random() < 0.2 for _ in range(lanes)] for _ in range(steps)])
    heads[:, :8] = False
    heads[0, :8] = True
    heads[0, 8:14] = False
    return C.affine_to_jacobian(SPEC, acc_pts, "cpu"), C.affine_table(SPEC, pts, "cpu"), heads, pts, acc_pts


def _host_chain(pts, acc_pts, heads):
    """The chain's semantics on host points: a head lifts P; acc + P is the
    group law except where acc == P, which the incomplete law sends to the
    identity."""
    out = []
    for i, (p, acc) in enumerate(zip(pts, acc_pts)):
        for s in range(heads.shape[0]):
            if bool(heads[s, i]):
                acc = p
            elif acc is not None and p is not None and acc == p:
                acc = None
            else:
                acc = VESTA.add(acc, p)
        out.append(acc)
    return out


def test_plain_step_chain_matches_jax_kernel_body_and_host():
    acc0, pxy, heads, pts, acc_pts = _chain_case(96, 6, seed=8)
    got = C.plain_step_chain(SPEC, acc0, pxy, heads)

    px, py = to_t(pxy[:, 0]), to_t(pxy[:, 1])
    pinf = (L.is_zero(pxy[:, 0]) & L.is_zero(pxy[:, 1])).numpy()[None, :]
    acc = tuple(to_t(acc0[:, k]) for k in range(3))
    for s in range(heads.shape[0]):
        acc = _ref_step(*acc, px, py, pinf, heads[s].numpy()[None, :])
    want = torch.stack([from_t(a) for a in acc], dim=1)
    assert torch.equal(got, want)
    assert C.jacobian_to_affine(SPEC, got) == _host_chain(pts, acc_pts, heads)


def test_step_chain_head_then_add_gives_generic_zero():
    """After a head, acc + P hits the excluded P == P case: the generic
    formula's (0, 0, 0), not 2P; the next step lifts P again."""
    acc0, pxy, heads, _, _ = _chain_case(64, 3, seed=9)
    two = C.plain_step_chain(SPEC, acc0, pxy, heads[:2])
    assert int(two[:8].abs().sum()) == 0
    three = C.plain_step_chain(SPEC, acc0, pxy, heads[:3])
    assert torch.equal(three[:8], C.lift_plain(SPEC, pxy[:8]))


def test_step_chain_wrapper_on_cpu_runs_the_plain_chain():
    acc0, pxy, heads, _, _ = _chain_case(64, 4, seed=10)
    want = C.plain_step_chain(SPEC, acc0, pxy, heads)
    for per in (None, 1, 3):
        assert torch.equal(C.step_chain(SPEC, acc0, pxy, heads, steps_per_launch=per), want)
    with pytest.raises(ValueError):
        C.step_chain(SPEC, acc0, pxy, heads.to(torch.uint8))
    with pytest.raises(ValueError):
        C.step_chain(SPEC, acc0, pxy, heads, steps_per_launch=0)


def _ref_op(op):
    if op == "mul":
        return jax.jit(lambda x, b: T.mont_mul(CST, x, b))
    if op == "add":
        return jax.jit(lambda x, b: T.add(CST, x, b))
    if op == "sub":
        return jax.jit(lambda x, b: T.sub(CST, x, b))
    # redc32 of exp_step_t.py: REDC of x with a zero 17th limb, x R^-1
    return jax.jit(lambda x, b: T.redc_i32(CST, jnp.concatenate([x, jnp.zeros_like(x[0:1])], axis=0)))


def _host_op(op, x, b, r_inv):
    return {"mul": x * b * r_inv, "add": x + b, "sub": x - b, "redc": x * r_inv}[op] % Q


@pytest.mark.parametrize("op", L.VALUED_CHAIN_OPS)
def test_plain_op_chain_matches_jax_kernel_body_and_host(op):
    rng = random.Random(len(op))
    lanes, reps = 128, 3
    xs = [0, 1, Q - 1, Q - 2] + [rng.randrange(Q) for _ in range(lanes - 4)]
    bs = [Q - 1, 0, Q - 1, 1] + [rng.randrange(Q) for _ in range(lanes - 4)]
    a, b = L.ints_to_limbs(xs, "cpu"), L.ints_to_limbs(bs, "cpu")
    got = L.plain_op_chain(op, SPEC, a, b, reps)

    step, x, bt = _ref_op(op), to_t(a), to_t(b)
    for _ in range(reps):
        x = step(x, bt)
    assert torch.equal(got, from_t(x))

    r_inv = pow(SPEC.r_mod_p, -1, Q)
    want = []
    for v, w in zip(xs, bs):
        for _ in range(reps):
            v = _host_op(op, v, w, r_inv)
        want.append(v)
    assert L.limbs_to_ints(got) == want
    assert torch.equal(L.op_chain(op, SPEC, a, b, reps), got)


def test_op_chain_raw_and_noop():
    rng = np.random.RandomState(3)
    words = rng.randint(0, 1 << 32, size=(2, 64, L.NLIMBS), dtype=np.uint64)
    a, b = (torch.from_numpy(w.astype(np.uint32).view(np.int32)) for w in words)
    want = (words[0] + 5 * words[1]) % (1 << 32)
    assert torch.equal(L.op_chain("raw", SPEC, a, b, 5), torch.from_numpy(want.astype(np.uint32).view(np.int32)))
    assert torch.equal(L.op_chain("noop", SPEC, a, b, 7), a)
    with pytest.raises(ValueError):
        L.op_chain("mul32", SPEC, a, b)
