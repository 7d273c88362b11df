"""The active mesh: one switch that reroutes the prover's commitments and
basis transforms onto a mesh of shards.

Under ``use_mesh(mesh)`` every commitment of ``pcs/ipa.py`` (``commit``,
``commit_many``, ``commit_lagrange_many``) runs the tensor-parallel MSM of
parallel/msm.py, and the four ``batch_*`` basis transforms of
``poly/transforms.py`` (and the iNTT of ``commit_lagrange_many``) the 4-step
NTT of parallel/ntt.py, ahead of the engine routing (ops/engine.py). The
proof's bytes do not change.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager

from ..config import config
from .collectives import Mesh, cuda_devices

_state = threading.local()


def get_mesh() -> Mesh | None:
    """The active mesh, or None. Thread-local: session worker threads can
    pin different meshes (or none) independently."""
    return getattr(_state, "mesh", None)


def set_mesh(mesh: Mesh | None) -> None:
    _state.mesh = mesh


@contextmanager
def use_mesh(mesh: Mesh | None):
    prev = get_mesh()
    set_mesh(mesh)
    try:
        yield mesh
    finally:
        set_mesh(prev)


def mesh_is_active() -> bool:
    m = get_mesh()
    return m is not None and m.size > 1


def mesh_from_config(devices=None) -> Mesh | None:
    """The 2-D (dp, tp) mesh of config().mesh (BZ_MESH_DP / BZ_MESH_TP)
    over ``devices`` (default: every visible CUDA card). A missing size is
    inferred: tp defaults to all remaining devices, dp to 1. None when at
    most one device is visible and no shape was asked for.

    The axes are named ("dp", "tp") as in the reference, whose sharded MSM
    and NTT run over the axis "shard": under ``use_mesh`` such a mesh makes
    them raise ValueError naming its axes (collectives.Mesh.require_axis),
    as the reference's shard_map does."""
    mc = config().mesh
    devices = list(devices) if devices is not None else cuda_devices()
    n = len(devices)
    dp, tp = mc.dp, mc.tp
    if dp is None and tp is None:
        if n <= 1:
            return None
        dp, tp = 1, n
    elif dp is None:
        dp = max(1, n // tp)
    elif tp is None:
        tp = max(1, n // dp)
    if dp * tp > n:
        raise ValueError(f"mesh {dp}x{tp} needs {dp * tp} devices, have {n}")
    return Mesh(devices[: dp * tp], mc.axis_names, shape=(dp, tp))
