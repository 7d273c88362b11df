"""Device calls with bounded retries while the card is busy or unavailable.

``device_call(fn, *args)`` runs a device pass that is a pure function of its
inputs (a batched MSM, a group of fused commitments), so that running it
again is safe. It retries only the CUDA status of a card that is busy or
unavailable, ``cudaErrorDevicesUnavailable`` (a card in exclusive mode held
by another process), with exponential backoff (``BZ_DISPATCH_RETRIES``
attempts, ``BZ_DISPATCH_BACKOFF_S`` first wait), and raises
:class:`DeviceUnavailable` when the card stays busy. Everything else raises
at once: the sticky errors that end the CUDA context
(``cudaErrorIllegalAddress``, ``cudaErrorLaunchFailure``, ...), which no
retry in this process can mend, and any other error.

The reference (``battlezips_halo2_tpu/ops/dispatch.py``) retries the error
texts of a TPU behind a network relay; a local card has no relay, so none of
them is carried over. Calls nest (a commitment group runs the batched MSM):
only the outermost one retries.
"""

from __future__ import annotations

import sys
import threading
import time

from ..config import config
from .cuda import CudaError

# cudaError_t values of a card that is busy or unavailable
BUSY_CODES = frozenset({46})  # cudaErrorDevicesUnavailable

_depth = threading.local()


class DeviceUnavailable(RuntimeError):
    """The card stayed busy or unavailable through every attempt."""


def device_call(fn, *args, what: str = "device call"):
    """``fn(*args)``, again after a backoff while the card is busy."""
    if getattr(_depth, "active", False):  # nested in a device_call: the outer one retries
        return fn(*args)
    cfg = config()
    attempts, backoff_s = max(1, cfg.dispatch_retries), cfg.dispatch_backoff_s
    _depth.active = True
    try:
        for attempt in range(attempts):
            try:
                return fn(*args)
            except CudaError as exc:
                if exc.code not in BUSY_CODES:
                    raise
                last = exc
            if attempt < attempts - 1:
                delay = backoff_s * 2**attempt
                print(f"[dispatch] {what}: {last} (attempt {attempt + 1}/{attempts}, retrying in {delay:g} s)",
                      file=sys.stderr, flush=True)
                time.sleep(delay)
    finally:
        _depth.active = False
    raise DeviceUnavailable(f"{what}: the card stayed busy or unavailable through {attempts} attempts") from last
