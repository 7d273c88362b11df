"""Proof-engine routing (``BZ_PROOF_ENGINE``, config.proof_engine).

The port has two executors for a proof's polynomial work:

* the **device engine**, the CUDA kernels of ``csrc/*.cu`` on the card
  (ops/ntt.py, ops/msm.py, ops/gate_eval.py): the port's default;
* the **native host engine**, the C++ library of ``native/`` (batch NTT,
  the quotient bytecode VM, Pippenger, the multiopen and IPA folds): the
  reference's latency engine.

``device`` (the port's default) keeps every phase on the card and never
loads the native library; ``host`` sends every phase to the native engine;
``auto`` (the reference's default) sends a phase on a domain of at most
``latency_n_max`` rows to the native engine, so both game circuits
(k = 11 and 12) run wholly on the host. Both engines do the same exact
field arithmetic, so the proof bytes are the same.

Where the engine is decided:

* a proof: ``plonk/prover.py::create_proof`` asks :func:`use_host_engine`
  once and gives the batch prover that engine; ``create_proofs_batched``
  resolves its engine (``BZ_BATCH_ENGINE``) and its tail's once and passes
  both down as ``engine=`` / ``host=``;
* a verification: ``plonk/verifier.py`` asks ``native.enabled()`` once and
  passes ``host`` to its MSMs and the IPA check;
* callers that name no engine (keygen, the verifier's dense commitments):
  ``pcs/ipa.py::commit_many`` / ``commit_lagrange_many`` and
  ``poly/transforms.py`` route the domain by :func:`use_host_engine`;
* host math at the leaves (batch inversion, Pippenger, point decoding,
  ``find_z``, the quotient constants, the MSM window fold) asks
  ``native.enabled()``.

Only native routes make a ``poly/polyints.py::PolyInts``;
``poly/domain.py::eval_poly_coeffs`` evaluates one on the native engine.
"""

from __future__ import annotations

from .. import native
from ..config import config


def use_host_engine(n: int) -> bool:
    """True if work on a size-n domain runs on the native host engine.
    Under ``host`` and ``auto`` the library is built and loaded here first,
    so a failed build raises (with the compiler's output) rather than
    sending the work elsewhere."""
    cfg = config()
    if cfg.proof_engine == "device":
        return False
    native.load()
    return cfg.proof_engine == "host" or n <= cfg.latency_n_max
