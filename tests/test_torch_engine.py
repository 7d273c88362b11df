"""The port's engine routing (BZ_PROOF_ENGINE, BZ_BATCH_ENGINE) against the
JAX package, on the CPU.

Under ``host`` and ``auto`` the k=5 proof equals tests/golden/mul_k5.json
and the JAX package's host-engine proof, each package verifies it, and no
device route runs (the MSM bucket pass, the NTT and the quotient VM are
spied on); the batch prover under ``BZ_BATCH_ENGINE=host``, and under the
reference's hybrid (``BZ_BATCH_ENGINE=device`` + ``BZ_PROOF_ENGINE=auto``:
commitments and quotient on the device path, the tail native), equals the
sequential proofs; the k=11 shot proof under ``host``, with the JAX
package's keys handed over by convert.py, equals tests/golden/shot_k11.json.
Exact comparisons (tolerance 0)."""

import json
import random
from pathlib import Path

import pytest
import torch

from battlezips_halo2_tpu.config import FrameworkConfig as RefFrameworkConfig
from battlezips_halo2_tpu.pcs.ipa import cached_params as ref_cached_params
from battlezips_halo2_tpu.plonk import create_proof as ref_create_proof
from battlezips_halo2_tpu.plonk import keygen as ref_keygen
from battlezips_halo2_tpu.plonk import verify_proof as ref_verify_proof
from battlezips_halo2_tpu_torch import convert, native
from battlezips_halo2_tpu_torch.config import FrameworkConfig, config
from battlezips_halo2_tpu_torch.ops import gate_eval as GE
from battlezips_halo2_tpu_torch.ops import msm as M
from battlezips_halo2_tpu_torch.ops import ntt as D
from battlezips_halo2_tpu_torch.ops.engine import use_host_engine
from battlezips_halo2_tpu_torch.plonk import create_proof, create_proofs_batched, verify_proof
from test_prover import MulCircuit as RefMulCircuit
from test_torch_slice import GOLDEN, MulCircuit

GOLDEN_SHOT = json.loads((Path(__file__).resolve().parent / "golden" / "shot_k11.json").read_text())
GOLDEN_PLACEMENTS = [(3, 3, True), (5, 4, False), (0, 1, False), (0, 5, True), (6, 1, False)]
ENGINE_FLAGS = ("BZ_PROOF_ENGINE", "BZ_LATENCY_N_MAX", "BZ_BATCH_ENGINE", "BZ_BATCH_TAIL_WORKERS")


@pytest.fixture(autouse=True)
def _clean_env(monkeypatch):
    for flag in ENGINE_FLAGS:
        monkeypatch.delenv(flag, raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mul_keys():
    ref_params = ref_cached_params(5)
    ref_pk = ref_keygen(ref_params, RefMulCircuit(1, 1, 1))
    params = convert.params_from_reference(ref_params, device="cpu")
    return ref_params, ref_pk, params, convert.proving_key_from_reference(ref_pk, MulCircuit(1, 1, 1))


@pytest.fixture
def device_routes(monkeypatch):
    """Counts of the device routes' entry points: the MSM bucket pass
    (K2 / K7), the NTT (K4 / K5) and the quotient VM (K1)."""
    calls = {"msm": 0, "ntt": 0, "vm": 0}

    def spy(module, name, key):
        fn = getattr(module, name)

        def wrapped(*args, **kw):
            calls[key] += 1
            return fn(*args, **kw)

        monkeypatch.setattr(module, name, wrapped)

    spy(M, "msm_wsums", "msm")
    spy(D, "ntt", "ntt")
    spy(D, "intt", "ntt")
    spy(GE, "quotient_vm", "vm")
    return calls


def test_engine_config_defaults_and_env(monkeypatch):
    """The port defaults to ``device`` (the reference to ``auto``: a
    deliberate deviation); latency_n_max is the reference's; both are read
    on every call; an unknown engine raises."""
    assert (FrameworkConfig().proof_engine, RefFrameworkConfig().proof_engine) == ("device", "auto")
    assert config().proof_engine == "device"
    assert FrameworkConfig().latency_n_max == RefFrameworkConfig().latency_n_max == 1 << 14
    monkeypatch.setenv("BZ_PROOF_ENGINE", "auto")
    monkeypatch.setenv("BZ_LATENCY_N_MAX", "4096")
    c, ref = config(), RefFrameworkConfig.from_env()
    assert (c.proof_engine, c.latency_n_max) == (ref.proof_engine, ref.latency_n_max) == ("auto", 4096)
    monkeypatch.setenv("BZ_PROOF_ENGINE", "tpu")
    with pytest.raises(ValueError, match="BZ_PROOF_ENGINE"):
        config()


def test_use_host_engine_routes_by_size(monkeypatch):
    """device never asks for the library (a compiler that cannot be found
    goes unnoticed); auto routes domains of at most latency_n_max rows to
    the host; host routes every size there."""
    monkeypatch.setattr(native, "CXX", "/nonexistent/g++")
    monkeypatch.setattr(native, "_lib", None)
    assert not use_host_engine(1 << 5) and not native.enabled() and native._lib is None
    monkeypatch.undo()
    monkeypatch.setenv("BZ_PROOF_ENGINE", "auto")
    monkeypatch.setenv("BZ_LATENCY_N_MAX", str(1 << 11))
    assert use_host_engine(1 << 11) and not use_host_engine(1 << 12) and native.enabled()
    monkeypatch.setenv("BZ_PROOF_ENGINE", "host")
    assert use_host_engine(1 << 20)


@pytest.mark.parametrize("engine", ["host", "auto"])
def test_mul_proof_on_host_engine_matches_golden_and_jax(mul_keys, monkeypatch, device_routes, engine):
    """The k=5 proof under ``engine`` is the golden one, equals the JAX
    package's proof under its host engine, and verifies on both packages
    and under both of the port's engines; proving and verifying natively
    run no device route. A tampered proof is refused."""
    ref_params, ref_pk, params, pk = mul_keys
    instance = [[15]]
    monkeypatch.setenv("BZ_PROOF_ENGINE", engine)
    proof = create_proof(params, pk, MulCircuit(3, 5, 15), instance, random.Random(GOLDEN["seed"]))
    assert verify_proof(params, pk.vk, proof, instance)
    assert not verify_proof(params, pk.vk, proof[:100] + bytes([proof[100] ^ 1]) + proof[101:], instance)
    assert device_routes == {"msm": 0, "ntt": 0, "vm": 0}
    assert proof.hex() == GOLDEN["proof_hex"]
    ref_proof = ref_create_proof(ref_params, ref_pk, RefMulCircuit(3, 5, 15), instance, random.Random(GOLDEN["seed"]))
    assert proof == ref_proof
    assert ref_verify_proof(ref_params, ref_pk.vk, proof, instance)
    monkeypatch.setenv("BZ_PROOF_ENGINE", "device")
    assert verify_proof(params, pk.vk, proof, instance)


WITNESSES = [(3, 5, 15), (2, 7, 14), (4, 4, 16)]
SEEDS = [GOLDEN["seed"], 101, 7]


def _batch(params, pk, **kw):
    return create_proofs_batched(params, pk, [MulCircuit(*w) for w in WITNESSES], [[[w[2]]] for w in WITNESSES],
                                 [random.Random(s) for s in SEEDS], **kw)


@pytest.mark.parametrize("env", [
    {"BZ_BATCH_ENGINE": "host"},
    {"BZ_BATCH_ENGINE": "host", "BZ_BATCH_TAIL_WORKERS": "2"},
    {"BZ_BATCH_ENGINE": "device", "BZ_PROOF_ENGINE": "auto"},
    {"BZ_BATCH_ENGINE": "device", "BZ_PROOF_ENGINE": "auto", "BZ_BATCH_TAIL_WORKERS": "2"},
], ids=["host", "host, tail workers=2", "hybrid", "hybrid, tail workers=2"])
def test_batch_engines_match_sequential(mul_keys, monkeypatch, device_routes, env):
    """Three k=5 proofs through the batch prover equal the sequential
    proofs (the golden one first). ``host`` runs no device route; the
    hybrid runs its five commitment batches and one quotient on the device
    path (at k = 5 the commitment table is small enough for K7's complete
    law), and the tail natively: no other MSM."""
    _, _, params, pk = mul_keys
    monkeypatch.setenv("BZ_PROOF_ENGINE", "host")
    want = [create_proof(params, pk, MulCircuit(*w), [[w[2]]], random.Random(s)) for w, s in zip(WITNESSES, SEEDS)]
    assert want[0].hex() == GOLDEN["proof_hex"]
    monkeypatch.delenv("BZ_PROOF_ENGINE")
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    for key in device_routes:
        device_routes[key] = 0
    assert _batch(params, pk) == want
    if env["BZ_BATCH_ENGINE"] == "host":
        assert device_routes == {"msm": 0, "ntt": 0, "vm": 0}
    else:  # instance, advice, z, random and h commitments
        assert device_routes["msm"] == 5 and device_routes["vm"] == 1 and device_routes["ntt"] > 0


def test_shot_golden_on_host_engine_with_converted_keys(monkeypatch):
    """The golden shot proof (k = 11) under BZ_PROOF_ENGINE=host with the JAX
    package's SRS and key handed over by convert.py; it verifies, and the
    port's native and device verifiers refuse a tampered copy."""
    from battlezips_halo2_tpu.circuits import ShotCircuit as RefShotCircuit
    from battlezips_halo2_tpu.utils import BinaryValue as RefBinaryValue
    from battlezips_halo2_tpu_torch.circuits import ShotCircuit
    from battlezips_halo2_tpu_torch.utils import BinaryValue, Board, Deck, serialize

    ref_params = ref_cached_params(11)
    ref_pk = ref_keygen(ref_params, RefShotCircuit(RefBinaryValue(1), 1, RefBinaryValue(1), RefBinaryValue(1)))
    params = convert.params_from_reference(ref_params, device="cpu")
    pk = convert.proving_key_from_reference(ref_pk, ShotCircuit(BinaryValue(1), 1, BinaryValue(1), BinaryValue(1)))
    assert hex(pk.vk.digest) == GOLDEN_SHOT["vk_digest"]
    board = Board.from_deck(Deck.from_placements(GOLDEN_PLACEMENTS))
    circuit = ShotCircuit(board.state(), 0xBEEF, serialize([3], [3]), BinaryValue(1))
    instance = [circuit.public_instance()]
    assert instance == [[int(v, 16) for v in col] for col in GOLDEN_SHOT["instance"]]
    monkeypatch.setenv("BZ_PROOF_ENGINE", "host")
    proof = create_proof(params, pk, circuit, instance, random.Random(GOLDEN_SHOT["seed"]))
    assert proof.hex() == GOLDEN_SHOT["proof_hex"]
    assert verify_proof(params, pk.vk, proof, instance)
    tampered = proof[:-40] + bytes([proof[-40] ^ 1]) + proof[-39:]
    assert not verify_proof(params, pk.vk, tampered, instance)
