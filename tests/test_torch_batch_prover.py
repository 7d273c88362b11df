"""The port's batch prover (battlezips_halo2_tpu_torch/plonk/batch_prover.py)
and its session options against the JAX package, on the CPU (plain
versions of the kernels). Every comparison is exact (tolerance 0): proof
bytes, h coefficients as ints, configuration values.

A k=5 proof through the plain versions takes tens of seconds on one core,
so the tier-1 tests here make three port proofs; the lookup circuit's
batch and a batched session at production size are marked ``slow``."""

import inspect
import random

import pytest
import torch

from battlezips_halo2_tpu import api as ref_api
from battlezips_halo2_tpu.config import FrameworkConfig as RefFrameworkConfig
from battlezips_halo2_tpu.pcs.ipa import cached_params as ref_cached_params
from battlezips_halo2_tpu.plonk import create_proofs_batched as ref_create_proofs_batched
from battlezips_halo2_tpu.plonk import keygen as ref_keygen
from battlezips_halo2_tpu_torch import api, convert
from battlezips_halo2_tpu_torch.config import FrameworkConfig, config
from battlezips_halo2_tpu_torch.fields import limb as L
from battlezips_halo2_tpu_torch.fields.host import FP
from battlezips_halo2_tpu_torch.ops.gate_eval import BatchQuotientEvaluator, QuotientEvaluator
from battlezips_halo2_tpu_torch.plonk import Circuit, create_proofs_batched, verify_proof
from battlezips_halo2_tpu_torch.plonk.arguments import ProofSchedule
from test_prover import LookupCircuit as RefLookupCircuit
from test_prover import MulCircuit as RefMulCircuit
from test_torch_slice import GOLDEN, MulCircuit

P = FP.modulus
SESSION_FLAGS = (
    "BZ_SESSION_WORKERS", "BZ_SESSION_DP", "BZ_SESSION_BATCHED", "BZ_BATCH_ENGINE",
    "BZ_BATCH_CHUNK", "BZ_BATCH_QUOTIENT_CHUNK", "BZ_BATCH_TAIL_WORKERS",
)


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


class LookupCircuit(Circuit):
    """tests/test_prover.py::LookupCircuit on the port's plonk layer."""

    def __init__(self, values):
        self.values = values

    @classmethod
    def configure(cls, cs):
        a = cs.advice_column()
        cs.enable_equality(a)
        table = cs.lookup_table_column()
        s = cs.selector()
        cs.lookup("in-table", [(s.expr() * a.cur(), table.inner.cur())])
        return (a, table, s)

    def synthesize(self, config, layouter):
        a, table, s = config

        def table_fn(t):
            for i in range(16):
                t.assign_cell(f"t{i}", table, i, i)

        layouter.assign_table("table", table_fn)

        def region(r):
            for i, v in enumerate(self.values):
                r.enable_selector("lk", s, i)
                r.assign_advice("a", a, i, v)

        layouter.assign_region("values", region)

    def without_witnesses(self):
        return LookupCircuit([0] * len(self.values))


def _mul_keys():
    ref_params = ref_cached_params(5)
    ref_pk = ref_keygen(ref_params, RefMulCircuit(1, 1, 1))
    params = convert.params_from_reference(ref_params, device="cpu")
    return ref_params, ref_pk, params, convert.proving_key_from_reference(ref_pk, MulCircuit(1, 1, 1))


def _lookup_keys():
    ref_params = ref_cached_params(6)
    ref_pk = ref_keygen(ref_params, RefLookupCircuit([0] * 4))
    params = convert.params_from_reference(ref_params, device="cpu")
    return ref_params, ref_pk, params, convert.proving_key_from_reference(ref_pk, LookupCircuit([0] * 4))


def test_mul_batch_matches_jax_batch_and_verifies():
    """Two k=5 proofs through the port's device engine equal the JAX
    package's batch prover (its host engine) for the same rngs; the first
    is the golden proof; the port's verifier accepts both."""
    ref_params, ref_pk, params, pk = _mul_keys()
    witnesses = [(3, 5, 15), (2, 7, 14)]
    seeds = [GOLDEN["seed"], 101]
    instances = [[[w[2]]] for w in witnesses]
    proofs = create_proofs_batched(
        params, pk, [MulCircuit(*w) for w in witnesses], instances, [random.Random(s) for s in seeds],
        engine="device",
    )
    ref_proofs = ref_create_proofs_batched(
        ref_params, ref_pk, [RefMulCircuit(*w) for w in witnesses], instances, [random.Random(s) for s in seeds],
        engine="host",
    )
    assert proofs == ref_proofs
    assert proofs[0].hex() == GOLDEN["proof_hex"]
    for proof, inst in zip(proofs, instances):
        assert verify_proof(params, pk.vk, proof, inst)


def test_singleton_batch_is_the_golden_proof(monkeypatch):
    """A batch of one, under BZ_BATCH_ENGINE=auto, is create_proof's golden
    proof (tests/golden/mul_k5.json); an empty batch proves nothing."""
    _, _, params, pk = _mul_keys()
    monkeypatch.setenv("BZ_BATCH_ENGINE", "auto")
    (proof,) = create_proofs_batched(params, pk, [MulCircuit(3, 5, 15)], [[[15]]], [random.Random(GOLDEN["seed"])])
    assert proof.hex() == GOLDEN["proof_hex"]
    assert create_proofs_batched(params, pk, [], [], []) == []


def test_create_proof_is_a_batch_of_one_on_the_device_engine(monkeypatch):
    """create_proof runs the batch prover on one proof, on the device
    engine whatever BZ_BATCH_ENGINE says."""
    from battlezips_halo2_tpu_torch.plonk import batch_prover, create_proof

    calls = []
    monkeypatch.setattr(batch_prover, "create_proofs_batched", lambda *a, **kw: calls.append((a, kw)) or [b"p"])
    monkeypatch.setenv("BZ_BATCH_ENGINE", "host")
    assert create_proof("params", "pk", "circuit", [[15]], "rng") == b"p"
    assert calls == [(("params", "pk", ["circuit"], [[[15]]], ["rng"]), {"engine": "device"})]


def test_commit_chunks_do_not_change_commitments():
    """BZ_BATCH_CHUNK only groups the columns of a batched commitment."""
    from battlezips_halo2_tpu_torch.pcs.ipa import commit_lagrange_many, commit_many

    _, _, params, pk = _mul_keys()
    rng = random.Random(5)
    cols = [[rng.randrange(P) for _ in range(params.n)] for _ in range(3)]
    blinds = [rng.randrange(P) for _ in cols]
    whole = commit_lagrange_many(params, pk.vk.domain, cols, blinds)
    assert commit_lagrange_many(params, pk.vk.domain, cols, blinds, chunk=2) == whole
    assert commit_many(params, whole[0], blinds, chunk=1) == whole[1]
    with pytest.raises(ValueError):
        commit_many(params, whole[0], blinds, chunk=0)


def test_batch_quotient_matches_sequential_on_lookup_keys(monkeypatch):
    """BatchQuotientEvaluator at B=2 on the k=6 LookupCircuit keys (lookup,
    permutation and gate terms) equals QuotientEvaluator (a batch of one)
    and the JAX package's QuotientEvaluator per proof on seeded random
    polynomials, and runs the VM program once for both."""
    from battlezips_halo2_tpu.ops.gate_eval import QuotientEvaluator as RefQuotientEvaluator
    from battlezips_halo2_tpu.plonk.arguments import ProofSchedule as RefProofSchedule

    _, ref_pk, _, pk = _lookup_keys()
    vk = pk.vk
    schedule = ProofSchedule.build(vk.cs)
    seq = QuotientEvaluator(vk, schedule, "cpu")
    batch = BatchQuotientEvaluator(vk, schedule, "cpu")
    assert batch.keys == seq.keys and batch.vm_size == seq.vm_size
    assert {k[0] for k in batch.per_keys} >= {"advice", "perm_z", "lk_a", "lk_s", "lk_z"}
    rng = random.Random(61)
    shared = {k: [rng.randrange(P) for _ in range(vk.domain.n)] for k in batch.shared_keys}
    polys = [{**shared, **{k: [rng.randrange(P) for _ in range(vk.domain.n)] for k in batch.per_keys}}
             for _ in range(2)]
    chals = [tuple(rng.randrange(P) for _ in range(4)) for _ in range(2)]

    calls = []
    field_op = L.field_op

    def counting(*args, **kw):
        calls.append(tuple(args[3].shape))
        return field_op(*args, **kw)

    monkeypatch.setattr(L, "field_op", counting)
    got = batch(polys, chals)
    # a VM instruction is the one call whose second operand is a register
    # of the whole batch: exactly one per instruction
    assert calls.count((2, vk.domain.extended_n, L.NLIMBS)) == len(batch.prog)
    assert got == [seq(p, c) for p, c in zip(polys, chals)]
    ref = RefQuotientEvaluator(ref_pk.vk, RefProofSchedule.build(ref_pk.vk.cs))
    assert got == [ref(p, c) for p, c in zip(polys, chals)]
    # the pk-constant polynomials are extended once and kept
    assert got[::-1] == batch(polys[::-1], chals[::-1])


def test_batch_engine_host_raises_and_unknown_engine(monkeypatch):
    _, _, params, pk = _mul_keys()
    args = (params, pk, [MulCircuit(3, 5, 15)], [[[15]]], [random.Random(1)])
    with pytest.raises(NotImplementedError, match="queue 1 item 5"):
        create_proofs_batched(*args, engine="host")
    monkeypatch.setenv("BZ_BATCH_ENGINE", "host")
    with pytest.raises(NotImplementedError, match="native"):
        create_proofs_batched(*args)
    with pytest.raises(ValueError):
        create_proofs_batched(*args, engine="tpu")


def test_session_config_defaults_match_jax(monkeypatch):
    for flag in SESSION_FLAGS:
        monkeypatch.delenv(flag, raising=False)
    fields = ("session_workers", "session_dp", "session_batched", "batch_engine", "batch_chunk",
              "batch_quotient_chunk", "batch_tail_workers")
    ours, ref = FrameworkConfig(), RefFrameworkConfig()
    assert {f: getattr(ours, f) for f in fields} == {f: getattr(ref, f) for f in fields}
    assert (ours.session_workers, ours.batch_engine, ours.batch_chunk) == (1, "auto", 256)
    assert config() == FrameworkConfig.from_env()


def test_session_config_env_population(monkeypatch):
    values = {"BZ_SESSION_WORKERS": "3", "BZ_SESSION_DP": "2", "BZ_SESSION_BATCHED": "1",
              "BZ_BATCH_ENGINE": "device", "BZ_BATCH_CHUNK": "64", "BZ_BATCH_QUOTIENT_CHUNK": "4",
              "BZ_BATCH_TAIL_WORKERS": "2"}
    for flag, value in values.items():
        monkeypatch.setenv(flag, value)
    c = config()
    assert (c.session_workers, c.session_dp, c.session_batched) == (3, 2, True)
    assert (c.batch_engine, c.batch_chunk, c.batch_quotient_chunk, c.batch_tail_workers) == ("device", 64, 4, 2)
    ref = RefFrameworkConfig.from_env()
    for f in ("session_workers", "session_dp", "session_batched", "batch_engine", "batch_chunk",
              "batch_quotient_chunk", "batch_tail_workers"):
        assert getattr(c, f) == getattr(ref, f), f


def test_prove_session_signature_matches_reference():
    """Every parameter of the reference's prove_session, with its default,
    plus the port's device."""
    ours = inspect.signature(api.prove_session).parameters
    ref = inspect.signature(ref_api.prove_session).parameters
    for name, param in ref.items():
        assert name in ours, name
        assert ours[name].default == param.default, name
    assert set(ours) - set(ref) == {"device"}
    assert ours["device"].default is None


def test_dp_devices_resolve_to_cuda_cards():
    from battlezips_halo2_tpu_torch.api import _dp_devices

    assert _dp_devices(None) is None
    assert _dp_devices(["cpu", torch.device("cpu")]) == [torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            _dp_devices(1)


@pytest.mark.parametrize("workers, spans", [(1, [4]), (2, [2, 2]), (3, [4])])
def test_batched_session_routes_the_sequential_jobs(monkeypatch, workers, spans):
    """prove_session(batched=True) hands the batch prover the sequential
    session's jobs: the same instances and the same per-job rngs, the board
    batch first, the shots in sub-batches of workers (when there are at
    least two shots per worker); batch_engine is passed on."""
    from test_torch_board import GOLDEN_PLACEMENTS

    batches = []

    def fake_batched(params, pk, circuits, instances, rngs, engine=None):
        batches.append((params, instances, [r.random() for r in rngs], engine))
        return [b"proof %d" % i for i in range(len(circuits))]

    monkeypatch.setattr(api, "board_keys", lambda device=None: (torch.device(device), None))
    monkeypatch.setattr(api, "shot_keys", lambda device=None: (torch.device(device), None))
    monkeypatch.setattr(api, "create_proofs_batched", fake_batched)
    session = api.prove_session([GOLDEN_PLACEMENTS], shots_per_game=4, trapdoors=[0xBEEF], seed=5,
                                batched=True, workers=workers, batch_engine="device", device="cpu")
    board, shots = batches[0], batches[1:]
    assert [len(b[1]) for b in shots] == spans
    assert all(b[0] == torch.device("cpu") and b[3] == "device" for b in batches)
    assert board[2] == [random.Random("bz-session:5:0").random()]
    assert [x for b in shots for x in b[2]] == [random.Random(f"bz-session:5:{1_000_000 + i}").random()
                                                for i in range(4)]
    assert board[1] == [[list(session.board_proofs[0].commitment)]]
    for proof, inst in zip(session.shot_proofs, [i for b in shots for i in b[1]]):
        assert inst == [[proof.commitment[0], proof.commitment[1], proof.shot, proof.hit]]
    assert [p.proof for p in session.shot_proofs] == [b"proof %d" % i for b in shots for i in range(len(b[1]))]


@pytest.mark.slow
def test_lookup_batch_matches_jax_batch():
    ref_params, ref_pk, params, pk = _lookup_keys()
    values = [[1, 3, 3, 15], [0, 2, 4, 8]]
    proofs = create_proofs_batched(
        params, pk, [LookupCircuit(v) for v in values], [[], []], [random.Random(7 + i) for i in range(2)]
    )
    ref_proofs = ref_create_proofs_batched(
        ref_params, ref_pk, [RefLookupCircuit(v) for v in values], [[], []],
        [random.Random(7 + i) for i in range(2)], engine="host",
    )
    assert proofs == ref_proofs
    assert all(verify_proof(params, pk.vk, p, []) for p in proofs)


@pytest.mark.slow
def test_batched_session_on_cpu_matches_sequential():
    """prove_session(batched=True), with and without sub-batches, gives the
    sequential session's bytes (k=11 and k=12 proofs through the plain
    versions: hours on one core)."""
    placements = [(3, 3, True), (5, 4, False), (0, 1, False), (0, 5, True), (6, 1, False)]
    kw = dict(shots_per_game=4, trapdoors=[0x77], seed=5, device="cpu")
    seq = api.prove_session([placements], batched=False, **kw)
    for workers in (1, 2):
        bat = api.prove_session([placements], batched=True, workers=workers, **kw)
        assert [p.proof for p in bat.board_proofs] == [p.proof for p in seq.board_proofs]
        assert [p.proof for p in bat.shot_proofs] == [p.proof for p in seq.shot_proofs]
    assert api.verify_session(seq, device="cpu")
