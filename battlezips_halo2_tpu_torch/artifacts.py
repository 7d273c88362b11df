"""The port's artifact store: the SRS, the proving keys and the fixed-base z
tables, kept on disk so that a process loads them instead of deriving them
(hash-to-curve, keygen, the z search).

Every file lies under :func:`directory`, ``.artifacts/torch/`` at the root
of the checkout: a home of its own, with file names of its own, so the port
never reads or writes a file of the JAX package (``.artifacts/srs_h2c_{k}.json``,
``pk_h2c_{name}_{k}_v5.pkl``, ``fixed_base_zs_{name}.json``). ``.artifacts/``
is ignored by git and left out of a chip copy, so a fresh checkout starts
cold.

:func:`cached` gives each file's value once a process: it loads the file,
or builds the value and writes the file. A file that fails to load prints
one line naming it and the error on stderr, is rebuilt and rewritten; a
write that fails prints one line and the process goes on. Writes go to a
temporary name and are renamed into place, so a process never reads a
partial file that another one is writing.
"""

from __future__ import annotations

import os
import sys
import threading
from pathlib import Path

_lock = threading.RLock()  # a build may itself ask for another artifact
_loaded: dict = {}  # path -> value, once a process


def directory() -> Path:
    """The port's artifact home."""
    return Path(__file__).resolve().parent.parent / ".artifacts" / "torch"


def report(path: Path, what: str, exc: BaseException) -> None:
    """One line on stderr (stdout may carry a protocol, tools/torch_serve.py)."""
    print(f"[artifacts] {path}: {what}: {type(exc).__name__}: {exc}", file=sys.stderr, flush=True)


def write_atomic(path: Path, data: bytes) -> None:
    """Write ``data`` to ``path`` through a temporary name and a rename."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f".{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    try:
        tmp.write_bytes(data)
        os.replace(tmp, path)
    finally:
        tmp.unlink(missing_ok=True)


def cached(path: Path, load, build, save):
    """The value of ``path``, once a process: ``load(path)`` if the file is
    there and loads, else ``build()``, written with ``save(value, path)``."""
    with _lock:
        if path not in _loaded:
            _loaded[path] = _load_or_build(path, load, build, save)
        return _loaded[path]


def _load_or_build(path: Path, load, build, save):
    if path.exists():
        try:
            return load(path)
        except Exception as exc:  # any fault of the file: report it, rebuild, rewrite
            report(path, "load failed, rebuilding", exc)
    value = build()
    try:
        save(value, path)
    except Exception as exc:  # the value is good; only the cache is lost
        report(path, "save failed", exc)
    return value


def forget() -> None:
    """Drop the values :func:`cached` holds: the next call loads again."""
    with _lock:
        _loaded.clear()
