"""The port's whole slice at k=5: keygen, create_proof and verify_proof of
battlezips_halo2_tpu_torch against the JAX package, on the CPU (plain
versions of the kernels).

The port reproduces tests/golden/mul_k5.json byte for byte, its proof equals
the JAX package's for the same keys (handed over by convert.py) and the same
seeded rng, and each package verifies the other's proof."""

import json
import random
from pathlib import Path

import pytest
import torch

from battlezips_halo2_tpu.pcs.ipa import cached_params as ref_cached_params
from battlezips_halo2_tpu.plonk import create_proof as ref_create_proof
from battlezips_halo2_tpu.plonk import keygen as ref_keygen
from battlezips_halo2_tpu.plonk import verify_proof as ref_verify_proof
from battlezips_halo2_tpu_torch import convert
from battlezips_halo2_tpu_torch.pcs.ipa import Params
from battlezips_halo2_tpu_torch.plonk import create_proof, keygen, verify_proof
from test_prover import MulCircuit as RefMulCircuit
from test_torch_inputs import MulCircuit

GOLDEN = json.loads((Path(__file__).resolve().parent / "golden" / "mul_k5.json").read_text())


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def reference_keys():
    ref_params = ref_cached_params(5)
    return ref_params, ref_keygen(ref_params, RefMulCircuit(1, 1, 1))


def test_keygen_matches_reference():
    """The port's own SRS (hash-to-curve) and keygen give the reference's
    SRS, commitments and vk digest."""
    ref_params, ref_pk = reference_keys()
    params = Params.new(5, device="cpu")
    assert (params.g, params.u, params.w) == (ref_params.g, ref_params.u, ref_params.w)
    pk = keygen(params, MulCircuit(1, 1, 1))
    assert hex(pk.vk.digest) == GOLDEN["vk_digest"]
    assert pk.vk.fixed_commitments == ref_pk.vk.fixed_commitments
    assert pk.vk.permutation.sigma_commitments == ref_pk.vk.permutation.sigma_commitments
    assert pk.fixed_polys == [list(p) for p in ref_pk.fixed_polys]


def test_proof_matches_golden_and_jax_and_cross_verifies():
    ref_params, ref_pk = reference_keys()
    params = convert.params_from_reference(ref_params, device="cpu")
    pk = convert.proving_key_from_reference(ref_pk, MulCircuit(1, 1, 1))
    seed, instance = GOLDEN["seed"], [[15]]
    proof = create_proof(params, pk, MulCircuit(3, 5, 15), instance, random.Random(seed))
    assert proof.hex() == GOLDEN["proof_hex"]
    ref_proof = ref_create_proof(ref_params, ref_pk, RefMulCircuit(3, 5, 15), instance, random.Random(seed))
    assert proof == ref_proof
    assert verify_proof(params, pk.vk, ref_proof, instance)
    assert ref_verify_proof(ref_params, ref_pk.vk, proof, instance)
    tampered = bytearray(proof)
    tampered[len(proof) // 2] ^= 1
    assert not verify_proof(params, pk.vk, bytes(tampered), instance)
    assert not verify_proof(params, pk.vk, proof, [[16]])


def test_proof_under_row_flags_matches_golden(monkeypatch):
    """Under BZ_ROW_NTT and BZ_ROW_MSM (the reference's row-layout
    configuration: kernels K5, K6 and K7 in place of K2, K3 and K4, K6's
    window kernel once per bucket pass) the proof is still the golden one,
    and verifies."""
    from battlezips_halo2_tpu_torch.curves import limb as C
    from battlezips_halo2_tpu_torch.ops import msm as M
    from battlezips_halo2_tpu_torch.ops import ntt as D

    calls = {}

    def spy(module, name):
        fn = getattr(module, name)

        def wrapped(*args, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*args, **kw)

        monkeypatch.setattr(module, name, wrapped)

    for module, name in ((D, "butterfly_rows_plain"), (D, "butterfly_stage_plain"), (M, "window_sums_planes"),
                         (C, "point_add"), (M, "bucket_sums_plain")):
        spy(module, name)
    monkeypatch.setenv("BZ_ROW_NTT", "1")
    monkeypatch.setenv("BZ_ROW_MSM", "1")
    ref_params, ref_pk = reference_keys()
    params = convert.params_from_reference(ref_params, device="cpu")
    pk = convert.proving_key_from_reference(ref_pk, MulCircuit(1, 1, 1))
    instance = [[15]]
    proof = create_proof(params, pk, MulCircuit(3, 5, 15), instance, random.Random(GOLDEN["seed"]))
    assert proof.hex() == GOLDEN["proof_hex"]
    assert verify_proof(params, pk.vk, proof, instance)
    assert calls.get("butterfly_stage_plain", 0) == 0 and calls.get("point_add", 0) == 0
    assert min(calls["butterfly_rows_plain"], calls["bucket_sums_plain"]) > 0
    assert calls["window_sums_planes"] == calls["bucket_sums_plain"]  # one window launch per bucket pass
