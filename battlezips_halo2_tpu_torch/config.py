"""Runtime flags of the port, read from the environment on every call.

| Flag | Field | Effect |
|---|---|---|
| BZ_TORCH_TRACE | trace_prover | per-phase prover span logs |
| BZ_VERIFY_TRACE | trace_verifier | verifier failure-point logs |
| BZ_NO_SELECTOR_COMPRESS | selector_compression (inverted) | keygen opt-out |
| BZ_ROW_NTT | row_ntt | NTT stages as gathers around kernel K5 (out-of-place butterfly) instead of K4 |
| BZ_ROW_MSM | row_msm | MSM buckets by the complete law (K7) only, window aggregation on K6 (coordinate planes) instead of K3 |
| BZ_SESSION_WORKERS / BZ_SESSION_DP | session_workers / session_dp | api.prove_session threads (default 1) / data-parallel cards (first N) |
| BZ_SESSION_BATCHED | session_batched | route sessions through the batch prover (plonk/batch_prover.py) |
| BZ_BATCH_ENGINE | batch_engine | batch prover executor: auto / device (both the card path) / host (the native engine, not ported: raises) |
| BZ_BATCH_CHUNK / BZ_BATCH_QUOTIENT_CHUNK | batch_chunk / batch_quotient_chunk | columns per batched commit (256) / proofs per batched quotient (16) |
| BZ_BATCH_TAIL_WORKERS | batch_tail_workers | threads for the per-proof evaluations + multiopen + IPA tail (1) |

The two row flags select the port's counterparts of the reference's
row-layout kernels (its ``BZ_PALLAS_NTT`` / ``BZ_PALLAS_MSM``). Both paths
give the same bits as the default one.
"""

from __future__ import annotations

import os
from dataclasses import dataclass


def _flag(name: str) -> bool:
    return os.environ.get(name, "") not in ("", "0")


@dataclass(frozen=True)
class FrameworkConfig:
    selector_compression: bool = True
    trace_prover: bool = False
    trace_verifier: bool = False
    row_ntt: bool = False
    row_msm: bool = False
    session_workers: int = 1
    session_dp: int | None = None
    session_batched: bool = False
    batch_engine: str = "auto"  # "auto" | "device" | "host"
    batch_chunk: int = 256
    batch_quotient_chunk: int = 16
    batch_tail_workers: int = 1

    @staticmethod
    def from_env() -> "FrameworkConfig":
        return FrameworkConfig(
            selector_compression=not _flag("BZ_NO_SELECTOR_COMPRESS"),
            trace_prover=_flag("BZ_TORCH_TRACE"),
            trace_verifier=_flag("BZ_VERIFY_TRACE"),
            row_ntt=_flag("BZ_ROW_NTT"),
            row_msm=_flag("BZ_ROW_MSM"),
            session_workers=int(os.environ.get("BZ_SESSION_WORKERS", "1")),
            session_dp=int(os.environ["BZ_SESSION_DP"]) if os.environ.get("BZ_SESSION_DP") else None,
            session_batched=_flag("BZ_SESSION_BATCHED"),
            batch_engine=os.environ.get("BZ_BATCH_ENGINE", "auto"),
            batch_chunk=int(os.environ.get("BZ_BATCH_CHUNK", "256")),
            batch_quotient_chunk=int(os.environ.get("BZ_BATCH_QUOTIENT_CHUNK", "16")),
            batch_tail_workers=int(os.environ.get("BZ_BATCH_TAIL_WORKERS", "1")),
        )


def config() -> FrameworkConfig:
    """Current configuration (re-read from the environment each call)."""
    return FrameworkConfig.from_env()
