"""Port curve layer (battlezips_halo2_tpu_torch/curves/limb.py) against the
host group law of curves/host.py and the JAX package's Jacobian formulas
(curves/limb_t.py, curves/limb.py) and its Pallas row-layout point add
(interpret mode), coordinate for coordinate.

Inputs cover generic points, the identity, P == Q (same and different Z)
and P == -Q. Exact comparisons (tolerance 0)."""

import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from battlezips_halo2_tpu.curves import limb as JC
from battlezips_halo2_tpu.curves import limb_t as JCT
from battlezips_halo2_tpu.fields import limb as JL
from battlezips_halo2_tpu.fields import limb_t as JT
from battlezips_halo2_tpu.ops import pallas_kernels as PK
from battlezips_halo2_tpu_torch.curves import limb as C
from battlezips_halo2_tpu_torch.curves.host import PALLAS, VESTA
from battlezips_halo2_tpu_torch.fields import limb as L
from test_torch_inputs import fold_stack

CURVES = {"vesta": VESTA, "pallas": PALLAS}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cases(curve, seed):
    """Pairs (P, Q) of affine points: generic, identity, P == Q, P == -Q."""
    rng = random.Random(seed)
    pts = [curve.mul(curve.generator, rng.randrange(1, 1 << 64)) for _ in range(10)]
    ps = pts[:6] + [None, pts[0], None, pts[1], pts[2]]
    qs = pts[4:] + [pts[3], None, None, pts[1], curve.neg(pts[2])]
    return ps, qs


def _jax_t(coords: list[int]):
    """Montgomery ints -> JAX (16, N) transposed limbs."""
    return np.asarray(JL.ints_to_limbs(coords)).T.copy()


def _jax_point_t(spec, jac: torch.Tensor):
    x, y, z = (L.limbs_to_ints(jac[:, i]) for i in range(3))
    return JCT.JacobianPointT(_jax_t(x), _jax_t(y), _jax_t(z))


def _ints_t(p) -> list[list[int]]:
    """JAX (16, N) point -> [x ints, y ints, z ints]."""
    return [JL.limbs_to_ints(np.asarray(c).T.copy()) for c in (p.x, p.y, p.z)]


def _ints(jac: torch.Tensor) -> list[list[int]]:
    return [L.limbs_to_ints(jac[:, i]) for i in range(3)]


@pytest.mark.parametrize("name", sorted(CURVES))
def test_point_add_matches_host_and_jax(name):
    curve = CURVES[name]
    spec = L.FieldSpec.make(curve.base.modulus)
    ps, qs = _cases(curve, 1)
    p, q = C.affine_to_jacobian(spec, ps, "cpu"), C.affine_to_jacobian(spec, qs, "cpu")
    # second round with non-trivial Z, and a lane with P == Q in different Z
    p2, q2 = C.point_add(spec, p, q), C.point_add(spec, q, p)
    q2[0] = C.point_add(spec, p2[:1], C.infinity(spec, (1,), "cpu"))[0]
    for a, b in ((p, q), (p2, q2)):
        got = C.point_add(spec, a, b)
        want = [curve.add(x, y) for x, y in zip(C.jacobian_to_affine(spec, a), C.jacobian_to_affine(spec, b))]
        assert C.jacobian_to_affine(spec, got) == want
        cst = JT.consts_t(JL.FieldSpec.make(curve.base.modulus))
        ref = JCT.point_add(cst, _jax_point_t(spec, a), _jax_point_t(spec, b))
        assert _ints(got) == _ints_t(ref)


@pytest.mark.parametrize("name", sorted(CURVES))
def test_mixed_incomplete_and_flag_match_jax(name):
    curve = CURVES[name]
    spec = L.FieldSpec.make(curve.base.modulus)
    ps, qs = _cases(curve, 2)
    ps[0] = qs[0]  # P == Q: the incomplete law's excluded case
    acc = C.affine_to_jacobian(spec, ps, "cpu")
    table = C.affine_table(spec, qs, "cpu")
    got, flag = C.point_add_mixed_plain(spec, acc, table, complete=False)
    cst = JT.consts_t(JL.FieldSpec.make(curve.base.modulus))
    qx, qy = (L.limbs_to_ints(table[:, i]) for i in range(2))
    q_inf = jnp.asarray(np.array([[q is None for q in qs]]))
    ref, ref_flag = JCT.point_add_mixed_incomplete(cst, _jax_point_t(spec, acc), _jax_t(qx), _jax_t(qy), q_inf)
    equal = [a is not None and a == b for a, b in zip(ps, qs)]
    assert flag.tolist() == np.asarray(ref_flag)[0].tolist() == equal
    assert _ints(got) == _ints_t(ref)
    got_aff = C.jacobian_to_affine(spec, got)
    assert [g for g, e in zip(got_aff, equal) if not e] == [curve.add(a, b) for a, b, e in zip(ps, qs, equal) if not e]


@pytest.mark.parametrize("name", sorted(CURVES))
def test_mixed_complete_matches_jax(name):
    curve = CURVES[name]
    spec = L.FieldSpec.make(curve.base.modulus)
    ps, qs = _cases(curve, 3)
    ps[0] = qs[0]
    acc = C.affine_to_jacobian(spec, ps, "cpu")
    table = C.affine_table(spec, qs, "cpu")
    got, flag = C.point_add_mixed_plain(spec, acc, table, complete=True)
    assert not flag.any()
    assert C.jacobian_to_affine(spec, got) == [curve.add(a, b) for a, b in zip(ps, qs)]
    jspec = JL.FieldSpec.make(curve.base.modulus)
    x, y, z = (JL.ints_to_limbs(v) for v in _ints(acc))
    qx, qy = (JL.ints_to_limbs(L.limbs_to_ints(table[:, i])) for i in range(2))
    ref = JC.point_add_mixed(jspec, JC.JacobianPoint(x, y, z), qx, qy, jnp.asarray([q is None for q in qs]))
    assert _ints(got) == [JL.limbs_to_ints(np.asarray(c)) for c in ref]


def test_affine_table_and_lift():
    spec = L.FQ_SPEC
    pts = [VESTA.generator, None, VESTA.mul(VESTA.generator, 9)]
    table = C.affine_table(spec, pts, "cpu")
    assert not table[1].any()
    lifted = C.lift_plain(spec, table)
    assert C.jacobian_to_affine(spec, lifted) == pts
    assert torch.equal(C.affine_to_jacobian(spec, pts, "cpu")[1], C.infinity(spec, (1,), "cpu")[0])


def _plane_cases(curve, spec):
    """Jacobian (p, q) with non-trivial Z: generic lanes, P == Q with the same
    and with different Z, P == -Q, P + O, O + Q and O + O."""
    ps, qs = _cases(curve, 4)
    p, q = C.affine_to_jacobian(spec, ps, "cpu"), C.affine_to_jacobian(spec, qs, "cpu")
    p2 = C.point_add(spec, p, q)
    q2 = C.point_add(spec, q, p)  # the same points as p2, Z negated: P == Q
    q2[:4] = C.point_add(spec, q, p.roll(1, 0))[:4]  # generic
    q2[4] = p2[4]  # P == Q, same coordinates
    q2[5] = p2[5]
    q2[5, 1] = L.neg(spec, p2[5, 1])  # P == -Q
    q2[7] = C.infinity(spec, (1,), "cpu")[0]  # P + O (lane 8: O + O)
    p2[9] = C.infinity(spec, (1,), "cpu")[0]  # O + Q
    return p2, q2


@pytest.mark.parametrize("name", sorted(CURVES))
def test_point_add_planes_matches_k3(name):
    """K6 on coordinate planes equals K3 coordinate for coordinate (plain
    versions) and the host group law, also when the output aliases an
    input."""
    curve = CURVES[name]
    spec = L.FieldSpec.make(curve.base.modulus)
    p, q = _plane_cases(curve, spec)
    aff_p, aff_q = C.jacobian_to_affine(spec, p), C.jacobian_to_affine(spec, q)
    assert aff_p[4] == aff_q[4] and aff_p[6] == aff_q[6] and aff_p[5] == curve.neg(aff_q[5])
    assert aff_p[8] is aff_q[8] is aff_p[9] is aff_q[7] is None
    planes = [t.movedim(-2, 0).contiguous() for t in (p, q)]
    got = C.point_add_planes(spec, *planes)
    assert torch.equal(got.movedim(0, -2), C.point_add(spec, p, q))
    assert C.jacobian_to_affine(spec, got.movedim(0, -2)) == [curve.add(a, b) for a, b in zip(aff_p, aff_q)]
    into = planes[0].clone()
    C.point_add_planes(spec, into, planes[1], out=into)
    assert torch.equal(into, got)


def test_point_add_planes_matches_jax_pallas():
    """K6's plain version equals the reference's row-layout Pallas point add
    (interpret mode) coordinate for coordinate, on Vesta (one curve: each
    modulus compiles the interpreted kernel anew, ~30 s)."""
    spec = L.FQ_SPEC
    p, q = _plane_cases(VESTA, spec)
    got = C.point_add_planes(spec, *(t.movedim(-2, 0).contiguous() for t in (p, q)))
    jspec = JL.FieldSpec.make(VESTA.base.modulus)
    ref = PK.point_add_rows(
        jspec, *(JC.JacobianPoint(*(JL.ints_to_limbs(v) for v in _ints(t))) for t in (p, q)), interpret=True
    )
    assert [L.limbs_to_ints(c) for c in got] == [JL.limbs_to_ints(np.asarray(c)) for c in ref]



@pytest.mark.parametrize("d", [2, 3, 4])
@pytest.mark.parametrize("name", sorted(CURVES))
def test_point_fold_matches_jax_left_to_right(name, d):
    """K3's fold (its plain version on the CPU) equals the JAX package's
    left-to-right loop of curves/limb.py::point_add over the stack
    (battlezips_halo2_tpu/parallel/msm.py's fold) in Jacobian coordinates,
    and the host group law's sum in affine ones."""
    curve = CURVES[name]
    spec = L.FieldSpec.make(curve.base.modulus)
    stack = fold_stack(curve, spec, d, seed=40 + d)
    got = C.point_fold(spec, stack)
    assert torch.equal(got, C.point_fold_plain(spec, stack))
    jspec = JL.FieldSpec.make(curve.base.modulus)
    layers = [JC.JacobianPoint(*(JL.ints_to_limbs(v) for v in _ints(stack[k]))) for k in range(d)]
    ref = layers[0]
    for layer in layers[1:]:
        ref = JC.point_add(jspec, ref, layer)
    assert _ints(got) == [JL.limbs_to_ints(np.asarray(c)) for c in ref]
    want = []
    for lane in zip(*(C.jacobian_to_affine(spec, stack[k]) for k in range(d))):
        acc = None
        for p in lane:
            acc = curve.add(acc, p)
        want.append(acc)
    assert C.jacobian_to_affine(spec, got) == want
    assert want[1] is not None and want[0] is not None


def test_point_fold_of_one_layer_is_a_copy():
    spec = L.FQ_SPEC
    stack = fold_stack(VESTA, spec, 2, seed=7)[:1]
    got = C.point_fold(spec, stack)
    assert torch.equal(got, stack[0]) and got.data_ptr() != stack.data_ptr()
    with pytest.raises(ValueError):
        C.point_fold(spec, stack[0, 0])
