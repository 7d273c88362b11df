"""The port's folded basis transforms (poly/transforms.py: one NTT between
at most two K1 products by cached scale vectors) against the JAX package's
poly/transforms.py, and the K1 launches they save, on the CPU (plain
versions of the kernels).

Inputs are made from numpy seeds; the arithmetic is exact, so every
comparison is equality (tolerance 0)."""

import json
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from battlezips_halo2_tpu.pcs.ipa import cached_params as ref_cached_params
from battlezips_halo2_tpu.plonk import keygen as ref_keygen
from battlezips_halo2_tpu.poly import transforms as REF_T
from battlezips_halo2_tpu.poly.domain import EvaluationDomain as RefDomain
from battlezips_halo2_tpu_torch import convert
from battlezips_halo2_tpu_torch.fields import limb as L
from battlezips_halo2_tpu_torch.fields.host import FP
from battlezips_halo2_tpu_torch.ops import ntt as D
from battlezips_halo2_tpu_torch.plonk import create_proof
from battlezips_halo2_tpu_torch.poly import transforms as T
from battlezips_halo2_tpu_torch.poly.domain import EvaluationDomain
from test_prover import MulCircuit as RefMulCircuit
from test_torch_inputs import MulCircuit

P = FP.modulus
R = L.FP_SPEC.r_mod_p
GOLDEN = json.loads((Path(__file__).resolve().parent / "golden" / "mul_k5.json").read_text())
NAMES = ("lagrange_to_coeff", "coeff_to_lagrange", "coeff_to_extended", "extended_to_coeff")


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _columns(seed: int, count: int, n: int) -> list[list[int]]:
    """count columns of n field elements from a numpy seed, the edge values
    0, 1, p - 1 and p - 2 first."""
    rng = np.random.default_rng(seed)
    cols = []
    for _ in range(count):
        words = rng.integers(0, 1 << 32, size=(n, 8), dtype=np.uint64)
        cols.append([int.from_bytes(w.astype("<u4").tobytes(), "little") % P for w in words])
    cols[0][:4] = [0, 1, P - 1, P - 2]
    return cols


def _ints(cols) -> list[list[int]]:
    return [[int(v) for v in c] for c in cols]


def _limbs(cols: list[list[int]], mont: bool = False) -> torch.Tensor:
    flat = [v * R % P if mont else v for c in cols for v in c]
    return L.ints_to_limbs(flat, "cpu").view(len(cols), len(cols[0]), 8)


def _rows(t: torch.Tensor, mont: bool = False) -> list[list[int]]:
    if mont:
        t = L.from_mont(L.FP_SPEC, t)
    flat = L.limbs_to_ints(t)
    n = t.shape[1]
    return [flat[i : i + n] for i in range(0, len(flat), n)]


@pytest.fixture(scope="module", params=[(5, 5), (6, 3)], ids=["k5", "k6"])
def domains(request):
    """A port domain and the JAX package's, and per batch size (1, 3) the
    JAX package's four batch transforms of seeded columns."""
    k, degree = request.param
    dom, ref_dom = EvaluationDomain(k, degree), RefDomain(k, degree)
    cases = {}
    for batch in (1, 3):
        cols = _columns(10 * k + batch, batch, dom.n)
        coeff = _ints(REF_T.batch_lagrange_to_coeff(ref_dom, cols))
        ext = _ints(REF_T.batch_coeff_to_extended(ref_dom, coeff))
        cases[batch] = {
            "lagrange_to_coeff": (cols, coeff),
            "coeff_to_lagrange": (coeff, _ints(REF_T.batch_coeff_to_lagrange(ref_dom, coeff))),
            "coeff_to_extended": (coeff, ext),
            "extended_to_coeff": (ext, _ints(REF_T.batch_extended_to_coeff(ref_dom, ext))),
        }
    return dom, cases


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("name", NAMES)
def test_batch_transforms_match_jax(domains, name, batch):
    """Each unsharded batch_* transform equals the JAX package's, twice (the
    second call on the cached scale vectors)."""
    dom, cases = domains
    given, want = cases[batch][name]
    for _ in range(2):
        assert [list(c) for c in getattr(T, f"batch_{name}")(dom, given, "cpu")] == want


@pytest.mark.parametrize("batch", [1, 3])
def test_montgomery_in_and_out_forms_match_jax(domains, batch):
    """coeff_to_extended_limbs(mont_out=True) gives the Montgomery form of
    the JAX package's extension, also from unpadded coefficients;
    extended_to_coeff_limbs(mont_in=True) takes it back to the JAX
    package's coefficients; the canonical forms are unchanged."""
    dom, cases = domains
    coeff, ext = cases[batch]["coeff_to_extended"]
    _, back = cases[batch]["extended_to_coeff"]
    unpadded = _limbs([c[: dom.n] for c in coeff])
    for x in (_limbs(coeff), unpadded):
        got = T.coeff_to_extended_limbs(dom, x, mont_out=True)
        assert _rows(got, mont=True) == ext
        assert L.limbs_to_ints(got) == [v * R % P for c in ext for v in c]
        assert _rows(T.coeff_to_extended_limbs(dom, x)) == ext
    assert _rows(T.extended_to_coeff_limbs(dom, _limbs(ext, mont=True), mont_in=True)) == back
    assert _rows(T.extended_to_coeff_limbs(dom, _limbs(ext))) == back


def test_scale_vectors_are_built_once(monkeypatch):
    """After the first call for a size and device, the unsharded transforms
    (and the quotient's Montgomery forms) build no scale vector in Python:
    ops/ntt.py::geometric_limbs is not called again."""
    built = []
    real = D.geometric_limbs
    monkeypatch.setattr(D, "geometric_limbs", lambda *a: built.append(a[1:4]) or real(*a))
    D._cached_scale_vector.cache_clear()
    dom = EvaluationDomain(5, 5)
    cols = _columns(1, 2, dom.n)
    counts = []
    for _ in range(3):
        coeff = T.batch_lagrange_to_coeff(dom, cols, "cpu")
        T.batch_coeff_to_lagrange(dom, coeff, "cpu")
        ext = T.batch_coeff_to_extended(dom, coeff, "cpu")
        T.batch_extended_to_coeff(dom, ext, "cpu")
        mont = T.coeff_to_extended_limbs(dom, _limbs(coeff), mont_out=True)
        T.extended_to_coeff_limbs(dom, mont, mont_in=True)
        counts.append(len(built))
    # 1/n (one row), the coset pre-scale (canonical and Montgomery out) and
    # the coset and 1/ext post-scale (canonical and Montgomery in)
    assert counts == [5, 5, 5]
    assert sorted(n for _, _, n in built) == [1, dom.extended_n, dom.extended_n, dom.extended_n, dom.extended_n]


def test_make_scale_vector_comes_from_the_cache():
    a = D.make_scale_vector(FP, 5, 16, L.FP_SPEC, "cpu")
    assert a is D.make_scale_vector(FP, 5, 16, L.FP_SPEC, "cpu")
    assert L.limbs_to_ints(a) == [pow(5, i, P) * R % P for i in range(16)]


def test_k5_proof_launches_fewer_field_ops(monkeypatch):
    """A k = 5 proof counts its fields/limb.py::field_op calls (each a K1
    elementwise launch on the card): 6 in the first proof of a key (23
    before the transforms were folded: to_mont, scale, 1/n and from_mont
    passes) and 5 in a steady one (19 before): one per commitment batch's
    iNTT (3) and two for the quotient (its extension's coset pre-scale and
    h's post-scale), plus the key's constant extensions once. The bytes
    stay tests/golden/mul_k5.json's."""
    ref_params = ref_cached_params(5)
    ref_pk = ref_keygen(ref_params, RefMulCircuit(1, 1, 1))
    params = convert.params_from_reference(ref_params, device="cpu")
    pk = convert.proving_key_from_reference(ref_pk, MulCircuit(1, 1, 1))
    calls = []
    real = L.field_op
    monkeypatch.setattr(L, "field_op", lambda op, spec, a, b, out=None: calls.append(op) or real(op, spec, a, b, out))
    counts = []
    for _ in range(2):
        calls.clear()
        proof = create_proof(params, pk, MulCircuit(3, 5, 15), [[15]], random.Random(GOLDEN["seed"]))
        assert proof.hex() == GOLDEN["proof_hex"]
        counts.append(len(calls))
    assert counts == [6, 5] and counts[0] < 23 and counts[1] < 19
    assert set(calls) == {L.OP_MUL}
