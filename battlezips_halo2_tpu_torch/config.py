"""Runtime flags of the port, read from the environment on every call.

| Flag | Field | Effect |
|---|---|---|
| BZ_TORCH_TRACE | trace_prover | per-phase prover span logs |
| BZ_VERIFY_TRACE | trace_verifier | verifier failure-point logs |
| BZ_NO_SELECTOR_COMPRESS | selector_compression (inverted) | keygen opt-out |
| BZ_ROW_NTT | row_ntt | NTT stages as gathers around kernel K5 (out-of-place butterfly) instead of K4 |
| BZ_ROW_MSM | row_msm | MSM buckets by the complete law (K7) only, window aggregation on K6 (coordinate planes) instead of K3 |
| BZ_NTT_MM | ntt_mm | on routes every NTT through the 4-step matrix-product NTT (ops/ntt_mm.py, kernel M1); auto (default) and off are accepted as the reference's names and leave it off: the reference's auto takes it only on a TPU |
| BZ_SESSION_WORKERS / BZ_SESSION_DP | session_workers / session_dp | api.prove_session threads (default 1) / data-parallel cards (first N) |
| BZ_SESSION_BATCHED | session_batched | route sessions through the batch prover (plonk/batch_prover.py) |
| BZ_PROOF_ENGINE | proof_engine | device (default) / auto / host: where a proof's work runs (ops/engine.py) |
| BZ_LATENCY_N_MAX | latency_n_max | under auto, domains of at most this many rows run on the native host engine (1 << 14) |
| BZ_BATCH_ENGINE | batch_engine | batch prover executor: auto / device (both the card path; the proof tail follows BZ_PROOF_ENGINE) / host (the native engine end to end) |
| BZ_BATCH_CHUNK / BZ_BATCH_QUOTIENT_CHUNK | batch_chunk / batch_quotient_chunk | columns per batched commit (256) / proofs per batched quotient (16) |
| BZ_BATCH_TAIL_WORKERS | batch_tail_workers | threads for the per-proof evaluations + multiopen + IPA tail (1) |
| BZ_DISPATCH_RETRIES / BZ_DISPATCH_BACKOFF_S | dispatch_retries / dispatch_backoff_s | attempts of a device call on a busy or unavailable card (3) / first backoff, doubled each retry (2.0 s) (ops/dispatch.py) |
| BZ_MESH_DP / BZ_MESH_TP | mesh.dp / mesh.tp | shape of parallel/context.py::mesh_from_config |
| BZ_NUM_PROCS / BZ_PROC_ID / BZ_COORDINATOR | procs / proc_id / coordinator | torch.distributed wiring of parallel/distributed.py (1 / 0 / 127.0.0.1:12807) |

``BZ_PROOF_ENGINE`` deviates from the reference on purpose: the reference
defaults to ``auto``, which runs every phase of a proof on a domain of at
most ``latency_n_max`` rows (both game circuits, k = 11 and 12) in its
native C++ engine (``native/``); the port's entry points run on the card
unless the caller asks otherwise, so its default is ``device``, and
``BZ_PROOF_ENGINE=auto`` gives the reference's routing exactly. Under
``device`` the native library is never loaded, unless ``BZ_BATCH_ENGINE=host``
asks for it.

The two row flags select the port's counterparts of the reference's
row-layout kernels (its ``BZ_PALLAS_NTT`` / ``BZ_PALLAS_MSM``). Both paths
give the same bits as the default one.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


PROOF_ENGINES = ("device", "auto", "host")
NTT_MM_MODES = ("auto", "on", "off")


def _flag(name: str) -> bool:
    return os.environ.get(name, "") not in ("", "0")


def _choice(name: str, choices: tuple) -> str:
    """The variable's value, one of ``choices`` (unset: the first)."""
    value = os.environ.get(name, "") or choices[0]
    if value not in choices:
        raise ValueError(f"{name} must be one of {choices}, got {value!r}")
    return value


@dataclass(frozen=True)
class MeshConfig:
    """Shape of the parallel layer's mesh: data-parallel (dp) by
    tensor-parallel (tp) shards. None = inferred from the visible cards
    (parallel/context.py::mesh_from_config)."""

    dp: int | None = None
    tp: int | None = None
    axis_names: tuple = ("dp", "tp")


@dataclass(frozen=True)
class FrameworkConfig:
    selector_compression: bool = True
    trace_prover: bool = False
    trace_verifier: bool = False
    row_ntt: bool = False
    row_msm: bool = False
    ntt_mm: bool = False  # BZ_NTT_MM=on
    proof_engine: str = "device"  # "device" | "auto" | "host"
    latency_n_max: int = 1 << 14
    session_workers: int = 1
    session_dp: int | None = None
    session_batched: bool = False
    batch_engine: str = "auto"  # "auto" | "device" | "host"
    batch_chunk: int = 256
    batch_quotient_chunk: int = 16
    batch_tail_workers: int = 1
    dispatch_retries: int = 3
    dispatch_backoff_s: float = 2.0
    mesh: MeshConfig = field(default_factory=MeshConfig)
    procs: int = 1
    proc_id: int = 0
    coordinator: str = "127.0.0.1:12807"

    @staticmethod
    def from_env() -> "FrameworkConfig":
        return FrameworkConfig(
            selector_compression=not _flag("BZ_NO_SELECTOR_COMPRESS"),
            trace_prover=_flag("BZ_TORCH_TRACE"),
            trace_verifier=_flag("BZ_VERIFY_TRACE"),
            row_ntt=_flag("BZ_ROW_NTT"),
            row_msm=_flag("BZ_ROW_MSM"),
            ntt_mm=_choice("BZ_NTT_MM", NTT_MM_MODES) == "on",
            proof_engine=_choice("BZ_PROOF_ENGINE", PROOF_ENGINES),
            latency_n_max=int(os.environ.get("BZ_LATENCY_N_MAX", str(1 << 14))),
            session_workers=int(os.environ.get("BZ_SESSION_WORKERS", "1")),
            session_dp=int(os.environ["BZ_SESSION_DP"]) if os.environ.get("BZ_SESSION_DP") else None,
            session_batched=_flag("BZ_SESSION_BATCHED"),
            batch_engine=os.environ.get("BZ_BATCH_ENGINE", "auto"),
            batch_chunk=int(os.environ.get("BZ_BATCH_CHUNK", "256")),
            batch_quotient_chunk=int(os.environ.get("BZ_BATCH_QUOTIENT_CHUNK", "16")),
            batch_tail_workers=int(os.environ.get("BZ_BATCH_TAIL_WORKERS", "1")),
            dispatch_retries=int(os.environ.get("BZ_DISPATCH_RETRIES", "3")),
            dispatch_backoff_s=float(os.environ.get("BZ_DISPATCH_BACKOFF_S", "2.0")),
            mesh=MeshConfig(
                dp=int(os.environ["BZ_MESH_DP"]) if "BZ_MESH_DP" in os.environ else None,
                tp=int(os.environ["BZ_MESH_TP"]) if "BZ_MESH_TP" in os.environ else None,
            ),
            procs=int(os.environ.get("BZ_NUM_PROCS", "1")),
            proc_id=int(os.environ.get("BZ_PROC_ID", "0")),
            coordinator=os.environ.get("BZ_COORDINATOR", "127.0.0.1:12807"),
        )


def config() -> FrameworkConfig:
    """Current configuration (re-read from the environment each call)."""
    return FrameworkConfig.from_env()
