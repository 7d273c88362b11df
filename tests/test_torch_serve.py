"""The port's proving server (tools/torch_serve.py) in process on the CPU,
under BZ_PROOF_ENGINE=host (and BZ_BATCH_ENGINE=host for a batched
session), on an artifact home under tmp_path.

The home is primed with the JAX package's SRS and keys (shot k=11, board
k=12), handed over by convert.py and written by the port's own save (as
tests/test_torch_engine.py hands them over), so the server's start loads
them and derives nothing. Every proof from the server verifies with the
port's api and a tampered one does not; verify_board answers for a good
and a tampered proof; a session's proofs verify against the commitments the
response carries; status counts the proofs; an unknown op and a request
that raises get ``ok: false`` and the server keeps serving, also over a
pipe through run_stdio; the warm-up's error is kept, reported and raised by
the next request that needs the card."""

import importlib.util
import json
import os
import threading
from pathlib import Path

import pytest
import torch

from battlezips_halo2_tpu.circuits import BoardCircuit as RefBoardCircuit
from battlezips_halo2_tpu.circuits import ShotCircuit as RefShotCircuit
from battlezips_halo2_tpu.pcs.ipa import Params as RefParams
from battlezips_halo2_tpu.plonk import keygen as ref_keygen
from battlezips_halo2_tpu.utils import BinaryValue as RefBinaryValue
from battlezips_halo2_tpu_torch import api, artifacts, convert
from battlezips_halo2_tpu_torch.circuits import BoardCircuit, ShotCircuit
from battlezips_halo2_tpu_torch.curves import hashtocurve
from battlezips_halo2_tpu_torch.pcs.ipa import Params
from battlezips_halo2_tpu_torch.utils import BinaryValue, Board, Deck

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = {name: json.loads((ROOT / "tests" / "golden" / f"{name}.json").read_text())
          for name in ("shot_k11", "board_k12")}
PLACEMENTS = [(3, 3, True), (5, 4, False), (0, 1, False), (0, 5, True), (6, 1, False)]


def _load_serve():
    spec = importlib.util.spec_from_file_location("torch_serve", ROOT / "tools" / "torch_serve.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


serve = _load_serve()


@pytest.fixture(scope="module")
def handover():
    """The JAX package's SRS and keys of both circuits, in the port's types:
    k -> (Params, ProvingKey)."""
    keys = {}
    for ref_circuit, circuit, golden in (
        (RefShotCircuit(RefBinaryValue(1), 1, RefBinaryValue(1), RefBinaryValue(1)),
         ShotCircuit(BinaryValue(1), 1, BinaryValue(1), BinaryValue(1)), "shot_k11"),
        (RefBoardCircuit([RefBinaryValue(1)] + [RefBinaryValue.empty()] * 9, RefBinaryValue(1), 1),
         BoardCircuit([BinaryValue(1)] + [BinaryValue.empty()] * 9, BinaryValue(1), 1), "board_k12"),
    ):
        ref_params = RefParams.new(type(circuit).K)
        pk = convert.proving_key_from_reference(ref_keygen(ref_params, ref_circuit), circuit)
        assert hex(pk.vk.digest) == GOLDEN[golden]["vk_digest"]
        keys[ref_params.k] = (convert.params_from_reference(ref_params, device="cpu"), pk)
    return keys


def _refuse(*args, **kwargs):
    raise AssertionError("derived instead of loading the artifact store")


def _clear_keys():
    artifacts.forget()
    api._shot_keys.cache_clear()
    api._board_keys.cache_clear()


@pytest.fixture
def server(tmp_path, monkeypatch, handover):
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setattr(artifacts, "directory", lambda: tmp_path / "torch")
    _clear_keys()
    # prime the store: the handed-over values go through the port's own save
    with monkeypatch.context() as m:
        m.setattr(Params, "new", staticmethod(lambda k, device=None: handover[k][0]))
        m.setattr(api, "keygen", lambda params, circuit: handover[params.k][1])
        api.shot_keys("cpu")
        api.board_keys("cpu")
    assert len(list((tmp_path / "torch").iterdir())) == 4
    _clear_keys()
    monkeypatch.setattr(hashtocurve, "hash_to_curve", _refuse)
    monkeypatch.setattr(api, "keygen", _refuse)
    monkeypatch.setenv("BZ_PROOF_ENGINE", "host")
    yield serve.Server(device="cpu")
    _clear_keys()
    torch.set_num_threads(threads)


def shot_request(x=3, y=3):
    state = Board.from_deck(Deck.from_placements(PLACEMENTS)).state()
    return {"op": "prove_shot", "state_hex": hex(state.value), "trapdoor": 0xBEEF, "shot": [x, y],
            "hit": bool(state.bit(y * 10 + x))}


def shot_proof(resp) -> api.ShotProof:
    return api.ShotProof(tuple(resp["commitment"]), resp["shot"], resp["hit"], bytes.fromhex(resp["proof_hex"]))


def test_prove_shot_from_loaded_keys_verifies(server):
    assert server.device == torch.device("cpu") and server.ready_s > 0
    resp = server.handle(shot_request())
    assert resp["ok"] and resp["hit"] == 1 and resp["latency_s"] > 0
    proof = shot_proof(resp)
    assert api.verify_shot(proof, device="cpu")
    tampered = bytearray(proof.proof)
    tampered[len(tampered) // 2] ^= 1
    assert not api.verify_shot(api.ShotProof(proof.commitment, proof.shot, proof.hit, bytes(tampered)), device="cpu")
    miss = server.handle(shot_request(9, 9))
    assert miss["ok"] and miss["hit"] == 0 and api.verify_shot(shot_proof(miss), device="cpu")


def test_board_ops_and_a_batched_session_verify(server, monkeypatch):
    board = server.handle({"op": "prove_board", "ships": [list(p) for p in PLACEMENTS], "trapdoor": 0xBEEF})
    assert board["ok"]
    proof = api.BoardProof(tuple(board["commitment"]), bytes.fromhex(board["proof_hex"]))
    assert api.verify_board(proof, device="cpu")
    good = {"op": "verify_board", "commitment": board["commitment"], "proof_hex": board["proof_hex"]}
    assert server.handle(good)["valid"] is True
    tampered = bytearray(proof.proof)
    tampered[len(tampered) // 2] ^= 1
    assert server.handle({**good, "proof_hex": bytes(tampered).hex()})["valid"] is False

    monkeypatch.setenv("BZ_BATCH_ENGINE", "host")
    session = server.handle({"op": "prove_session", "games": [[list(p) for p in PLACEMENTS]], "shots_per_game": 2,
                             "batched": True})
    assert session["ok"] and len(session["board_proofs"]) == 1 and len(session["shot_proofs"]) == 2
    commitment = tuple(session["commitments"][0])
    assert api.verify_board(api.BoardProof(commitment, bytes.fromhex(session["board_proofs"][0])), device="cpu")
    state = Board.from_deck(Deck.from_placements(PLACEMENTS)).state()
    for i, proof_hex in enumerate(session["shot_proofs"]):  # shot i of game 0 at (i, 3 i), as api.prove_session
        x, y = i % 10, (i * 3) % 10
        shot = api.ShotProof(commitment, 1 << (y * 10 + x), int(state.bit(y * 10 + x)), bytes.fromhex(proof_hex))
        assert api.verify_shot(shot, device="cpu")
    assert server.handle({"op": "status"})["proofs_served"] == 4


def test_status_counts_proofs_and_unknown_op_is_refused(server):
    status = server.handle({"op": "status"})
    assert status["ok"] and status["proofs_served"] == 0 and status["latency_s"] == {}
    assert status["device"] == "cpu" and status["device_error"] is None and not status["device_ready"]
    server.handle(shot_request())
    status = server.handle({"op": "status"})
    assert status["proofs_served"] == 1 and set(status["latency_s"]) == {"prove_shot"}
    assert server.handle({"op": "verify_shot"}) == {"ok": False, "error": "unknown op 'verify_shot'"}
    assert server.handle({"op": "shutdown"}) == {"ok": True, "bye": True}


def test_run_stdio_over_a_pipe_keeps_serving_after_a_failed_request(server):
    read_in, write_in = os.pipe()
    read_out, write_out = os.pipe()
    with open(read_in) as inp, open(write_out, "w") as out:
        worker = threading.Thread(target=serve.run_stdio, args=(server, inp, out))
        worker.start()
        with open(write_in, "w") as to_server, open(read_out) as from_server:
            ready = json.loads(from_server.readline())
            assert ready["ok"] and ready["ready"]
            replies = []
            for req in [{**shot_request(), "state_hex": "not hex"}, {"op": "nope"}, shot_request(), {"op": "status"},
                        {"op": "shutdown"}]:
                to_server.write(json.dumps(req) + "\n\n")  # blank lines are skipped
                to_server.flush()
                replies.append(json.loads(from_server.readline()))
            worker.join(timeout=120)
            assert not worker.is_alive()
    bad, unknown, good, status, bye = replies
    assert not bad["ok"] and bad["error"].startswith("ValueError")
    assert unknown == {"ok": False, "error": "unknown op 'nope'"}
    assert good["ok"] and api.verify_shot(shot_proof(good), device="cpu")
    assert status["proofs_served"] == 1 and bye == {"ok": True, "bye": True}


def test_warm_up_error_is_kept_reported_and_raised_on_the_card(server, monkeypatch):
    """A failed warm-up keeps its error: status reports it; a request that
    needs the card raises it, one the engine keeps on the host does not
    (the server never switches engine)."""
    failure = RuntimeError("nvcc: not found")

    def fail(*args, **kwargs):
        raise failure

    monkeypatch.setattr(api, "prove_session", fail)
    server._warm_device()
    assert server.device_error is failure and not server.device_ready
    assert "nvcc: not found" in server.handle({"op": "status"})["device_error"]
    assert server.handle(shot_request())["ok"]  # on the cpu nothing needs the card
    server.device = torch.device("cuda", 0)  # as if served on a card: only the routing is asked, nothing runs
    monkeypatch.setenv("BZ_PROOF_ENGINE", "device")
    with pytest.raises(RuntimeError, match="warm-up") as info:
        server.handle(shot_request())
    assert info.value.__cause__ is failure
    monkeypatch.setenv("BZ_PROOF_ENGINE", "host")
    assert not server._needs_card("prove_shot", shot_request())
    assert server._needs_card("prove_session", {"batched": True})
    monkeypatch.setenv("BZ_BATCH_ENGINE", "host")
    assert not server._needs_card("prove_session", {"batched": True})
