"""Public proving API of the port: board and shot proofs, game sessions.

Semantic mirror of the reference's WASM bindings (``prove_board`` /
``verify_board`` / ``prove_shot`` / ``verify_shot`` over plain Python data)
and of its ``prove_session`` / ``verify_session``. Params and keys are built
once per device and cached for the process. ``device=None`` means the CUDA
card; pass ``device="cpu"`` to run the plain PyTorch versions of the
kernels.
"""

from __future__ import annotations

import random
import secrets
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from functools import lru_cache

import torch

from .circuits import BoardCircuit, ShotCircuit
from .config import config
from .fields.host import FQ
from .ops.cuda import resolve_device
from .pcs.ipa import Params
from .plonk import create_proof, create_proofs_batched, keygen, verify_proof
from .utils import BinaryValue, Board, Deck, pedersen_commit, serialize


@dataclass
class BoardProof:
    commitment: tuple  # (x, y) of the board's Pedersen commitment
    proof: bytes


@dataclass
class ShotProof:
    commitment: tuple  # board commitment (x, y)
    shot: int  # serialized shot bitfield
    hit: int  # 0/1
    proof: bytes


@dataclass
class GameSession:
    """One board proof per game, then the shot proofs against each board."""

    board_proofs: list
    shot_proofs: list


def board_keys(device=None):
    """(Params, ProvingKey) of the board circuit on ``device``: the SRS by
    hash-to-curve and keygen, built once per device."""
    return _board_keys(str(resolve_device(device)))


@lru_cache(maxsize=None)
def _board_keys(device: str):
    params = Params.new(BoardCircuit.K, device)
    pk = keygen(params, BoardCircuit([BinaryValue(1)] + [BinaryValue.empty()] * 9, BinaryValue(1), 1))
    return params, pk


def shot_keys(device=None):
    """(Params, ProvingKey) of the shot circuit on ``device``: the SRS by
    hash-to-curve and keygen, built once per device."""
    return _shot_keys(str(resolve_device(device)))


@lru_cache(maxsize=None)
def _shot_keys(device: str):
    params = Params.new(ShotCircuit.K, device)
    pk = keygen(params, ShotCircuit(BinaryValue(1), 1, BinaryValue(1), BinaryValue(1)))
    return params, pk


def _rng():
    class _SecretsRng:
        def randrange(self, n):
            return secrets.randbelow(n)

    return _SecretsRng()


def prove_board(ships: list, trapdoor: int | None = None, rng=None, device=None) -> BoardProof:
    """Prove that 5 ships, given as optional (x, y, vertical) tuples, are
    legally placed, and commit to the board. ``trapdoor`` defaults to a
    random Fq element, ``rng`` (blinding randomness) to a secrets-backed
    source; a seeded ``random.Random`` gives reproducible bytes."""
    params, pk = board_keys(device)
    board = Board.from_deck(Deck.from_placements(ships))
    if trapdoor is None:
        trapdoor = FQ.random()
    state = board.state()
    commitment = pedersen_commit(state.to_fp(), trapdoor)
    circuit = BoardCircuit(board.witness(), state, trapdoor)
    proof = create_proof(params, pk, circuit, [[commitment[0], commitment[1]]], rng or _rng())
    return BoardProof(commitment=commitment, proof=proof)


def verify_board(proof: BoardProof, device=None) -> bool:
    params, pk = board_keys(device)
    return verify_proof(params, pk.vk, proof.proof, [[proof.commitment[0], proof.commitment[1]]])


def prove_shot(
    board_state: BinaryValue, trapdoor: int, shot_xy: tuple, hit: bool, rng=None, device=None
) -> ShotProof:
    """Prove a hit/miss assertion against a committed board. ``rng``
    (blinding randomness) defaults to a secrets-backed source; a seeded
    ``random.Random`` gives reproducible bytes."""
    shot = serialize([shot_xy[0]], [shot_xy[1]])
    circuit = ShotCircuit(board_state, trapdoor, shot, BinaryValue(1 if hit else 0))
    params, pk = shot_keys(device)
    instance = circuit.public_instance()
    proof = create_proof(params, pk, circuit, [instance], rng or _rng())
    return ShotProof(
        commitment=(instance[0], instance[1]), shot=instance[2], hit=instance[3], proof=proof
    )


def verify_shot(proof: ShotProof, device=None) -> bool:
    params, pk = shot_keys(device)
    instance = [proof.commitment[0], proof.commitment[1], proof.shot, proof.hit]
    return verify_proof(params, pk.vk, proof.proof, [instance])


def _dp_devices(dp_devices) -> list | None:
    """dp_devices as torch devices (None when not given): an int N means the
    first N CUDA cards, a list names its devices; each goes through
    resolve_device."""
    if not dp_devices:
        return None
    if isinstance(dp_devices, int):
        if torch.cuda.is_available() and dp_devices > torch.cuda.device_count():
            raise ValueError(f"dp_devices={dp_devices}, but {torch.cuda.device_count()} CUDA devices are visible")
        return [resolve_device(f"cuda:{i}") for i in range(dp_devices)]
    return [resolve_device(d) for d in dp_devices]


def prove_session(
    games: list,
    shots_per_game: int = 8,
    trapdoors: list | None = None,
    workers: int | None = None,
    dp_devices: list | int | None = None,
    seed: int | None = None,
    batched: bool | None = None,
    batch_engine: str | None = None,
    device=None,
) -> GameSession:
    """games: list of 5-ship placement lists. Proves one board per game,
    then ``shots_per_game`` shots against each committed board (shot i of
    game j at (i mod 10, (3 i + j) mod 10), as the reference's session).
    The bytes depend on ``seed`` only, never on the options below.

    * ``batched`` (default ``BZ_SESSION_BATCHED``) routes the session
      through the batch prover (plonk/batch_prover.py): the board proofs
      advance through the Fiat-Shamir phases as one batch, then the shot
      proofs, with one batched device pass per phase instead of one per
      proof. ``batch_engine`` is passed on to it (device / host / auto).
    * ``workers`` (default ``BZ_SESSION_WORKERS``) > 1 proves on a thread
      pool; with ``batched`` it instead splits the shots into sub-batches
      advanced concurrently, once there are at least two shots per worker.
    * ``dp_devices`` (default ``BZ_SESSION_DP``): a list of torch devices,
      or an int N for the first N CUDA cards; job i (sub-batch i when
      batched) runs on ``dp_devices[i % len]``, and there are at least as
      many workers as devices. Without it every job runs on ``device``.
    * ``seed`` derives each proof's blinding rng, as the reference does, so
      a seeded session is reproducible; None keeps secrets-backed blinding.
    """
    cfg = config()
    dev = resolve_device(device)
    if batched is None:
        batched = cfg.session_batched
    if workers is None:
        workers = cfg.session_workers
    if dp_devices is None and cfg.session_dp:
        dp_devices = cfg.session_dp
    devices = _dp_devices(dp_devices)
    if devices:
        workers = max(workers, len(devices))
    else:
        devices = [dev]

    def job_rng(idx: int):
        return random.Random(f"bz-session:{seed}:{idx}") if seed is not None else _rng()

    board_jobs, shot_jobs = [], []
    for gi, ships in enumerate(games):
        trapdoor = trapdoors[gi] if trapdoors else FQ.random()
        board_jobs.append((ships, trapdoor))
        state = Board.from_deck(Deck.from_placements(ships)).state()
        for si in range(shots_per_game):
            x, y = si % 10, (si * 3 + gi) % 10
            shot_jobs.append((state, trapdoor, (x, y), bool(state.bit(y * 10 + x))))

    # keys first, serially: keygen is not a pipeline stage
    for d in devices:
        if board_jobs:
            board_keys(d)
        if shot_jobs:
            shot_keys(d)

    if batched:
        return GameSession(
            _board_batch(board_jobs, job_rng, devices[0], batch_engine),
            _shot_batches(shot_jobs, job_rng, devices, workers, batch_engine),
        )

    def run_board(idx: int, job) -> BoardProof:
        return prove_board(*job, rng=job_rng(idx), device=devices[idx % len(devices)])

    def run_shot(idx: int, job) -> ShotProof:
        return prove_shot(*job, rng=job_rng(1_000_000 + idx), device=devices[idx % len(devices)])

    if workers <= 1:
        board_proofs = [run_board(i, j) for i, j in enumerate(board_jobs)]
        shot_proofs = [run_shot(i, j) for i, j in enumerate(shot_jobs)]
    else:
        with ThreadPoolExecutor(max_workers=workers) as pool:
            bf = [pool.submit(run_board, i, j) for i, j in enumerate(board_jobs)]
            sf = [pool.submit(run_shot, i, j) for i, j in enumerate(shot_jobs)]
            board_proofs = [f.result() for f in bf]
            shot_proofs = [f.result() for f in sf]
    return GameSession(board_proofs, shot_proofs)


def _board_batch(jobs: list, job_rng, device, engine) -> list:
    """The board proofs of a session as one batch (job i takes rng i)."""
    if not jobs:
        return []
    params, pk = board_keys(device)
    circuits, instances, commitments = [], [], []
    for ships, trapdoor in jobs:
        board = Board.from_deck(Deck.from_placements(ships))
        state = board.state()
        commitment = pedersen_commit(state.to_fp(), trapdoor)
        circuits.append(BoardCircuit(board.witness(), state, trapdoor))
        instances.append([[commitment[0], commitment[1]]])
        commitments.append(commitment)
    rngs = [job_rng(i) for i in range(len(jobs))]
    proofs = create_proofs_batched(params, pk, circuits, instances, rngs, engine=engine)
    return [BoardProof(commitment=c, proof=p) for c, p in zip(commitments, proofs)]


def _shot_batches(jobs: list, job_rng, devices: list, workers: int, engine) -> list:
    """The shot proofs of a session as batches (job i takes rng 1e6 + i).
    With workers > 1 and at least two shots per worker, the shots split
    into one sub-batch per worker, proved concurrently (sub-batch i on
    devices[i % len]): one sub-batch's host phases overlap another's device
    work. Each proof's transcript and rng are its own, so the bytes do not
    change."""
    if not jobs:
        return []
    circuits = [
        ShotCircuit(state, trapdoor, serialize([xy[0]], [xy[1]]), BinaryValue(1 if hit else 0))
        for state, trapdoor, xy, hit in jobs
    ]
    instances = [[c.public_instance()] for c in circuits]
    rngs = [job_rng(1_000_000 + i) for i in range(len(jobs))]

    def prove(span, device):
        a, b = span
        params, pk = shot_keys(device)
        return create_proofs_batched(params, pk, circuits[a:b], instances[a:b], rngs[a:b], engine=engine)

    if workers > 1 and len(jobs) >= 2 * workers:
        step = (len(jobs) + workers - 1) // workers
        spans = [(i, min(i + step, len(jobs))) for i in range(0, len(jobs), step)]
        with ThreadPoolExecutor(max_workers=workers) as pool:
            futures = [pool.submit(prove, span, devices[i % len(devices)]) for i, span in enumerate(spans)]
            proofs = [p for f in futures for p in f.result()]
    else:
        proofs = prove((0, len(jobs)), devices[0])
    return [
        ShotProof(commitment=(inst[0][0], inst[0][1]), shot=inst[0][2], hit=inst[0][3], proof=p)
        for inst, p in zip(instances, proofs)
    ]


def verify_session(session: GameSession, device=None) -> bool:
    return all(verify_board(p, device) for p in session.board_proofs) and all(
        verify_shot(p, device) for p in session.shot_proofs
    )
