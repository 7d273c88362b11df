"""The port's quotient VM (ops/gate_eval.py) on the CPU against the JAX
package's QuotientEvaluator, with the same keys (convert.py), polynomials
and challenges: the plain version of K1's VM kernel (the pins read through
their descriptors into a register file, one field op per instruction), on
the k=5 MulCircuit and, at B=2, on the k=6 LookupCircuit. Exact."""

import random

import numpy as np
import pytest
import torch

from battlezips_halo2_tpu.ops.gate_eval import QuotientEvaluator as RefQuotientEvaluator
from battlezips_halo2_tpu.ops.gate_eval import emit_vm as ref_emit_vm
from battlezips_halo2_tpu.pcs.ipa import Params as RefParams
from battlezips_halo2_tpu.plonk import keygen as ref_keygen
from battlezips_halo2_tpu.plonk.arguments import ProofSchedule as RefProofSchedule
from battlezips_halo2_tpu_torch import convert
from battlezips_halo2_tpu_torch.fields import limb as L
from battlezips_halo2_tpu_torch.fields.host import FP
from battlezips_halo2_tpu_torch.ops import gate_eval as G
from battlezips_halo2_tpu_torch.ops.gate_eval import QuotientEvaluator, emit_vm, quotient_constants
from battlezips_halo2_tpu_torch.plonk.arguments import ProofSchedule
from battlezips_halo2_tpu_torch.poly.transforms import extended_to_coeff_limbs
from test_prover import MulCircuit as RefMulCircuit
from test_torch_batch_prover import _lookup_keys
from test_torch_inputs import in_place_program
from test_torch_slice import MulCircuit

P = FP.modulus


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mul_keys():
    """The k=5 MulCircuit's JAX proving key, its conversion and the JAX
    evaluator (compiled once for the module's tests)."""
    ref_pk = ref_keygen(RefParams.new(5), RefMulCircuit(1, 1, 1))
    ref_ev = RefQuotientEvaluator(ref_pk.vk, RefProofSchedule.build(ref_pk.vk.cs))
    return ref_pk, convert.proving_key_from_reference(ref_pk, MulCircuit(1, 1, 1)), ref_ev


def test_quotient_vm_matches_jax(mul_keys):
    ref_params = RefParams.new(5)
    ref_pk, pk, ref_ev = mul_keys
    ref_schedule = RefProofSchedule.build(ref_pk.vk.cs)
    schedule = ProofSchedule.build(pk.vk.cs)

    prog, pins, n_regs = emit_vm(pk.vk, schedule)
    ref_prog, ref_pins, ref_n_regs = ref_emit_vm(ref_pk.vk, ref_schedule)
    assert (n_regs, pins) == (ref_n_regs, ref_pins)
    assert np.array_equal(prog, ref_prog)

    ev = QuotientEvaluator(pk.vk, schedule, "cpu")
    assert ev.keys == ref_ev.keys and ev.vm_size == ref_ev.vm_size
    rng = random.Random(21)
    polys = {k: [rng.randrange(P) for _ in range(ref_params.n)] for k in ref_ev.keys}
    chals = tuple(rng.randrange(P) for _ in range(4))
    assert ev(polys, chals) == ref_ev(polys, chals)


def test_quotient_constants_vanish_where_expected():
    ref_params = RefParams.new(5)
    pk = convert.proving_key_from_reference(ref_keygen(ref_params, RefMulCircuit(1, 1, 1)), MulCircuit(1, 1, 1))
    consts = quotient_constants(pk.vk)
    t = pk.vk.domain.t_extended()
    assert [a * b % P for a, b in zip(consts["t_inv"], t)] == [1] * len(t)
    assert consts["x"][0] == pk.vk.domain.g_coset


def _h_coeffs(ev, h_ext) -> list:
    ext = ev.domain.extended_n
    ints = L.limbs_to_ints(extended_to_coeff_limbs(ev.domain, L.from_mont(L.FP_SPEC, h_ext)))
    return [ints[i : i + ext] for i in range(0, len(ints), ext)]


def _descriptor_vm(ev, per, ch):
    return G.quotient_vm(L.FP_SPEC, ev.prog_t, ev.desc, ev.sources(per, ch), ev.t_inv, per.shape[0], ev.n_regs)


@pytest.mark.parametrize("circuit,nb", [("mul", 1), ("lookup", 2)])
def test_descriptor_vm_matches_jax(circuit, nb, mul_keys):
    """The plain version of K1's VM kernel, reading every pin through its
    descriptor (rotations 0, +1, the usable row and, in the lookup, -1
    wrapping mod ext), equals the JAX package's evaluator proof by proof,
    with shared (fixed, sigma) polynomials and per-proof ones."""
    if circuit == "mul":
        _, pk, ref_ev = mul_keys
    else:
        _, ref_pk, _, pk = _lookup_keys()
        ref_ev = RefQuotientEvaluator(ref_pk.vk, RefProofSchedule.build(ref_pk.vk.cs))
    ev = G.BatchQuotientEvaluator(pk.vk, ProofSchedule.build(pk.vk.cs), "cpu")
    rng = random.Random(70 + nb)
    n = pk.vk.domain.n
    shared = {k: [rng.randrange(P) for _ in range(n)] for k in ev.shared_keys}
    polys = [{**shared, **{k: [rng.randrange(P) for _ in range(n)] for k in ev.per_keys}} for _ in range(nb)]
    chals = [tuple(rng.randrange(P) for _ in range(4)) for _ in range(nb)]
    per, ch = ev.inputs(polys, chals)
    got = _descriptor_vm(ev, per, ch)
    assert got.shape == (nb, pk.vk.domain.extended_n, L.NLIMBS)
    assert _h_coeffs(ev, got) == [ref_ev(p, c) for p, c in zip(polys, chals)]


def test_pin_descriptors_address_every_source():
    """Each kind of pin gets its source, first row and strides: shared
    extensions without a B stride, per-proof ones with K_p ext, rotations
    mod ext, challenges after the constants with a B stride of 4, "one" a
    constant."""
    keys = [("inp", "fixed", 1, 0), ("inp", "advice", 0, -1), ("chal", "beta"), ("const", 5), ("named", "one"),
            ("named", "x"), ("inp", "perm_z", 0, 3)]
    shared, per = [("fixed", 0), ("fixed", 1)], [("advice", 0), ("perm_z", 0)]
    desc, scalars = G.pin_descriptors(keys, shared, per, 16, 4)
    r = L.FP_SPEC.r_mod_p
    assert scalars == [5 * r % P, r]
    assert desc.tolist() == [
        [G.SRC_SHARED, 16, 0, 1, 0],
        [G.SRC_PER, 0, 32, 1, 12],
        [G.SRC_SCALARS, 2 + 1, 4, 0, 0],
        [G.SRC_SCALARS, 0, 0, 0, 0],
        [G.SRC_SCALARS, 1, 0, 0, 0],
        [G.SRC_NAMED, 3 * 16, 0, 1, 0],
        [G.SRC_PER, 16, 32, 1, 12 % 16],
    ]


def test_vm_in_place_destinations():
    """A destination that is also an operand (t = t * t, agg = agg * y + t)
    reads its operands before it is written, on a hand-made program."""
    args, want = in_place_program("cpu")
    assert L.limbs_to_ints(L.from_mont(L.FP_SPEC, G.quotient_vm(L.FP_SPEC, *args))) == want
