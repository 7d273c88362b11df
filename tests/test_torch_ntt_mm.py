"""The port's matrix-product NTT (battlezips_halo2_tpu_torch/ops/ntt_mm.py,
kernel M1 through its plain version on the CPU) against the JAX package's
ops/ntt_mm.py, case for case with tests/test_ntt_mm.py, on the same seeded
inputs: exact comparisons (tolerance 0). The JAX functions run under
``jax.jit`` as the JAX package's own tests run them; values cross between
the packages as Python ints (the JAX package's limbs are 16 x 16 bits, the
port's 8 x 32). Also: the ``BZ_NTT_MM`` routing of ``ops/ntt.py::ntt`` and
of everything that reaches it (counted calls of the M1 wrapper, none of
K4's), the reference's split of n and its limit of 1024 terms, and a k=5
proof under ``BZ_NTT_MM=on`` with tests/golden/mul_k5.json's bytes."""

import json
import random
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from battlezips_halo2_tpu.config import FrameworkConfig as RefFrameworkConfig
from battlezips_halo2_tpu.fields import limb as JL
from battlezips_halo2_tpu.ops import ntt_mm as JMM
from battlezips_halo2_tpu.poly.domain import EvaluationDomain as RefDomain
from battlezips_halo2_tpu.poly.domain import ntt_host
from battlezips_halo2_tpu_torch.config import FrameworkConfig
from battlezips_halo2_tpu_torch.fields import limb as L
from battlezips_halo2_tpu_torch.fields.host import FP
from battlezips_halo2_tpu_torch.ops import ntt as D
from battlezips_halo2_tpu_torch.ops import ntt_mm as MM

P = FP.modulus
R = L.FP_SPEC.r_mod_p
GOLDEN = json.loads((Path(__file__).resolve().parent / "golden" / "mul_k5.json").read_text())


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mont(vals: list) -> list:
    return [v * R % P for v in vals]


def _unmont(vals: list) -> list:
    r_inv = pow(R, -1, P)
    return [v * r_inv % P for v in vals]


def _jax_ints(fn, vals: list, shape: tuple) -> list:
    """jax.jit(fn) on the JAX package's limbs of ``vals`` in ``shape`` ->
    the output's values as ints, row-major."""
    x = JL.ints_to_limbs(vals).reshape(shape + (16,))
    return JL.limbs_to_ints(np.asarray(jax.jit(fn)(x)).reshape(-1, 16))


def _port_ints(t: torch.Tensor) -> list:
    return L.limbs_to_ints(t)


def _omega(logn: int) -> int:
    return RefDomain(logn, 2).omega


def _matmul_case(w, a_vals: list, k: int, m: int, mont: bool):
    """The port's and the JAX package's fp_const_matmul of the same (K', K)
    matrix and (K, M) operand (``a_vals`` as given), and the exact sums."""
    a = L.ints_to_limbs(a_vals, "cpu").view(k, m, 8)
    got = _port_ints(MM.fp_const_matmul(L.FP_SPEC, w, a, mont=mont))
    ref = _jax_ints(lambda x: JMM.fp_const_matmul(JL.FP_SPEC, w, x, mont=mont), a_vals, (k, m))
    r_inv = 1 if mont else pow(R, -1, P)
    want = [sum(int(w[j][i]) * a_vals[i * m + c] for i in range(k)) * r_inv % P
            for j in range(len(w)) for c in range(m)]
    return got, ref, want


@pytest.mark.parametrize("mont", [True, False], ids=["mont", "as_given"])
def test_fp_const_matmul_matches_jax(mont):
    """K = 16, K' = 12, M = 5 (tests/test_ntt_mm.py::test_fp_const_matmul_exact),
    the operand in Montgomery form: W a in Montgomery form under ``mont``,
    W a R^-1 otherwise."""
    rng = random.Random(11)
    k, kp, m = 16, 12, 5
    w = np.array([[rng.randrange(P) for _ in range(k)] for _ in range(kp)], dtype=object)
    a_vals = _mont([rng.randrange(P) for _ in range(k * m)])
    got, ref, want = _matmul_case(w, a_vals, k, m, mont)
    assert got == ref == want


@pytest.mark.parametrize("mont", [True, False], ids=["mont", "as_given"])
def test_fp_const_matmul_edge_matrix_matches_jax(mont):
    """The all-(p - 1) matrix on p - 1, 0, 1, p - 2 operands
    (tests/test_ntt_mm.py::test_fp_const_matmul_edge_values)."""
    k = 8
    w = np.full((k, k), P - 1, dtype=object)
    a_vals = _mont([P - 1, 0, 1, P - 2, P - 1, P - 1, 1, 0])
    got, ref, want = _matmul_case(w, a_vals, k, 1, mont)
    assert got == ref == want
    assert len(set(got)) == 1


@pytest.mark.parametrize("logn", [6, 9, 11])
def test_ntt_mm_matches_jax_and_host(logn):
    n = 1 << logn
    rng = random.Random(100 + logn)
    vals = [rng.randrange(P) for _ in range(n)]
    x = L.ints_to_limbs(_mont(vals), "cpu")
    plan = MM.mm_plan_for(P, n, _omega(logn), "cpu")
    got = _port_ints(MM.ntt_mm(plan, x))
    ref_plan = JMM.mm_plan_for(P, n, _omega(logn))
    assert got == _jax_ints(lambda t: JMM.ntt_mm(ref_plan, t), _mont(vals), (n,))
    assert _unmont(got) == ntt_host(vals, _omega(logn))


def test_ntt_mm_batched_matches_single_and_jax():
    logn, b = 8, 3
    n = 1 << logn
    rng = random.Random(5)
    vals = [[rng.randrange(P) for _ in range(n)] for _ in range(b)]
    flat = _mont(sum(vals, []))
    plan = MM.mm_plan_for(P, n, _omega(logn), "cpu")
    got = _port_ints(MM.ntt_mm(plan, L.ints_to_limbs(flat, "cpu").view(b, n, 8)))
    single = [_port_ints(MM.ntt_mm(plan, L.ints_to_limbs(_mont(v), "cpu"))) for v in vals]
    assert got == sum(single, [])
    ref_plan = JMM.mm_plan_for(P, n, _omega(logn))
    assert got == _jax_ints(lambda t: JMM.ntt_mm(ref_plan, t), flat, (b, n))
    assert [_unmont(s) for s in single] == [ntt_host(v, _omega(logn)) for v in vals]


def test_ntt_mm_inverse_round_trip_matches_jax():
    logn = 8
    n = 1 << logn
    rng = random.Random(6)
    vals = [rng.randrange(P) for _ in range(n)]
    omega = _omega(logn)
    n_inv = pow(n, -1, P) * R % P
    fwd, inv = MM.mm_plan_for(P, n, omega, "cpu"), MM.mm_plan_for(P, n, pow(omega, -1, P), "cpu")
    y = MM.ntt_mm(inv, MM.ntt_mm(fwd, L.ints_to_limbs(_mont(vals), "cpu")))
    got = _port_ints(L.mont_mul(L.FP_SPEC, y, L.ints_to_limbs([n_inv], "cpu")))
    assert _unmont(got) == vals
    rf, ri = JMM.mm_plan_for(P, n, omega), JMM.mm_plan_for(P, n, pow(omega, -1, P))

    def round_trip(t):
        z = JMM.ntt_mm(ri, JMM.ntt_mm(rf, t))
        return JL.mont_mul(JL.FP_SPEC, z, jax.numpy.broadcast_to(jax.numpy.asarray(JL.int_to_limbs(n_inv)), z.shape))

    assert got == _jax_ints(round_trip, _mont(vals), (n,))


@pytest.fixture
def counted(monkeypatch):
    """Counts of the M1 wrapper's calls (one M1 launch each on the card)
    and of K4's stage calls, since the fixture was made."""
    calls = {"M1": 0, "K4": 0}
    real_mm, real_stage = MM.fp_const_matmul, D.butterfly_stage

    def mm(*args, **kwargs):
        calls["M1"] += 1
        return real_mm(*args, **kwargs)

    def stage(*args, **kwargs):
        calls["K4"] += 1
        return real_stage(*args, **kwargs)

    monkeypatch.setattr(MM, "fp_const_matmul", mm)
    monkeypatch.setattr(D, "butterfly_stage", stage)
    return calls


def test_ntt_route_flag_matches(monkeypatch, counted):
    """BZ_NTT_MM=on routes ops/ntt.py::ntt (and intt) through the matrix
    product, two M1 calls an NTT and no K4 stage, with the bytes of off and
    auto, which take K4 (tests/test_ntt_mm.py::test_ntt_route_flag_matches,
    ::test_ntt_mm_matches_butterfly_path)."""
    logn = 8
    n = 1 << logn
    rng = random.Random(8)
    x = L.ints_to_limbs(_mont([rng.randrange(P) for _ in range(2 * n)]), "cpu").view(2, n, 8)
    plan = D.plan_for(P, n, _omega(logn), "cpu")
    plan_inv = D.plan_for(P, n, pow(_omega(logn), -1, P), "cpu")
    n_inv = L.ints_to_limbs([pow(n, -1, P) * R % P], "cpu")
    outs = {}
    for mode in ("off", "auto", "on"):
        monkeypatch.setenv("BZ_NTT_MM", mode)
        counted.update(M1=0, K4=0)
        outs[mode] = (D.ntt(plan, x), D.intt(plan_inv, x, n_inv))
        assert counted == ({"M1": 4, "K4": 0} if mode == "on" else {"M1": 0, "K4": 2 * logn})
    for mode in ("auto", "on"):
        assert all(torch.equal(a, b) for a, b in zip(outs[mode], outs["off"]))
    monkeypatch.setenv("BZ_NTT_MM", "yes")
    with pytest.raises(ValueError, match="BZ_NTT_MM"):
        D.ntt(plan, x)
    # the reference's default, auto, is off here: one setting
    assert FrameworkConfig().ntt_mm is False and RefFrameworkConfig().ntt_mm == "auto"


def test_transforms_and_sharded_ntt_follow_the_flag(monkeypatch, counted):
    """The basis transforms (poly/transforms.py) and the sharded 4-step NTT
    (parallel/ntt.py, its local NTT_D and NTT_C) reach ops/ntt.py::ntt, so
    under BZ_NTT_MM=on they run on M1 with no K4 stage and the bytes of the
    butterfly route."""
    from battlezips_halo2_tpu_torch.parallel import distributed_ntt
    from battlezips_halo2_tpu_torch.parallel.collectives import mesh_from_devices
    from battlezips_halo2_tpu_torch.poly import transforms as T
    from battlezips_halo2_tpu_torch.poly.domain import EvaluationDomain

    domain = EvaluationDomain(5, 3)
    rng = random.Random(9)
    cols = [[rng.randrange(P) for _ in range(domain.n)] for _ in range(2)]
    mesh = mesh_from_devices(["cpu"] * 2)
    n = 1 << 6
    shards = L.ints_to_limbs(_mont([rng.randrange(P) for _ in range(n)]), "cpu").view(2, n // 2, 8).unbind(0)
    outs = {}
    for mode in ("off", "on"):
        monkeypatch.setenv("BZ_NTT_MM", mode)
        counted.update(M1=0, K4=0)
        outs[mode] = (T.batch_coeff_to_extended(domain, cols, "cpu"), T.batch_lagrange_to_coeff(domain, cols, "cpu"),
                      [_port_ints(s) for s in distributed_ntt(mesh, n, _omega(6), list(shards))])
        if mode == "on":  # two transforms and two shards' NTT_D and NTT_C, two M1 calls each
            assert counted == {"M1": 2 * (2 + 2 * 2), "K4": 0}
        else:
            assert counted["M1"] == 0 and counted["K4"] > 0
    assert outs["on"] == outs["off"]


class _Unbuilt:
    """Stands for a limb array that was never built."""

    def reshape(self, *shape):
        return self


def test_plan_split_matches_the_reference(monkeypatch):
    """n1 / n2 equal the reference plan's for log n = 6 to 21, read from its
    NttMMPlan with its matrices not built; at 2^21 the reference's row
    product would contract over 2048 terms, and the port's plan refuses it
    before building anything."""
    monkeypatch.setattr(JMM, "_w_matrix", lambda *args: None)
    monkeypatch.setattr(JL, "ints_to_limbs", lambda vals: _Unbuilt())  # the twiddle grid's limbs
    for logn in range(6, 22):
        n = 1 << logn
        ref = JMM.NttMMPlan(JL.FP_SPEC, n, 1)  # omega = 1 keeps the twiddle loop's products trivial
        if ref.n1 <= MM.MAX_CONTRACTION:
            assert MM.NttMMPlan.split(n) == (ref.n1, ref.n2)
        else:
            assert logn == 21 and ref.n1 == 2048
            with pytest.raises(ValueError, match="1024"):
                MM.NttMMPlan.split(n)
            with pytest.raises(ValueError, match="1024"):
                MM.NttMMPlan(L.FP_SPEC, n, _omega(logn), "cpu")


def test_contraction_limit_matches_the_reference():
    """A (1, 1025) matrix: the reference's fp_const_matmul asserts, the
    port's raises ValueError naming the limit; 1024 terms pass in both."""
    k = MM.MAX_CONTRACTION + 1
    w = np.ones((1, k), dtype=object)
    with pytest.raises(AssertionError, match="1024"):
        JMM.fp_const_matmul(JL.FP_SPEC, w, np.zeros((k, 1, 16), dtype=np.uint32))
    with pytest.raises(ValueError, match="1024"):
        MM.fp_const_matmul(L.FP_SPEC, w, torch.zeros((k, 1, 8), dtype=torch.int32))
    ones = L.ints_to_limbs([R] * (k - 1), "cpu").view(k - 1, 1, 8)
    out = MM.fp_const_matmul(L.FP_SPEC, w[:, 1:], ones)
    assert _unmont(_port_ints(out)) == [k - 1]


def test_k5_proof_under_ntt_mm_matches_golden(monkeypatch, counted):
    """Keygen and a k=5 MulCircuit proof under BZ_NTT_MM=on, every NTT on
    M1 and none on K4: the bytes and vk digest of tests/golden/mul_k5.json."""
    from battlezips_halo2_tpu_torch.pcs.ipa import Params
    from battlezips_halo2_tpu_torch.plonk import create_proof, keygen
    from test_torch_inputs import MulCircuit

    monkeypatch.setenv("BZ_NTT_MM", "on")
    params = Params.new(5, device="cpu")
    pk = keygen(params, MulCircuit(1, 1, 1))
    assert hex(pk.vk.digest) == GOLDEN["vk_digest"]
    counted.update(M1=0, K4=0)
    proof = create_proof(params, pk, MulCircuit(3, 5, 15), [[15]], random.Random(GOLDEN["seed"]))
    assert proof.hex() == GOLDEN["proof_hex"]
    assert counted["M1"] > 0 and counted["M1"] % 2 == 0 and counted["K4"] == 0
