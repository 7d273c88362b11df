"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

The kernels compile with ``nvcc`` (one process per source, in parallel) and
link into one shared library with a plain C interface, bound with
``ctypes``: no PyTorch headers, so a build takes seconds. The library goes
into ``csrc/build/<hash of the sources>/`` at first use; a build writes to
temporary names and renames the library into place, so an interrupted
build leaves nothing that a later one waits on.

Every C entry launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` calls one with the tensors' device
current and raises on anything but 0.

``launches`` counts, per kernel, the launches made since the last
:func:`reset_launches`. Each wrapper adds one exactly where it launches,
under a lock, so the counts stay exact when several threads prove at once
(``api.prove_session(workers > 1)``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = CSRC / "build"
LIB_NAME = "libbz_kernels.so"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9")
launches = {name: 0 for name in KERNELS}

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int
_SIGNATURES = {
    # op, consts, a, b, out, n, nb, stream
    "bz_field_op": (_INT, _P, _P, _P, _P, _I64, _I64, _P),
    # consts, x, tw, batch, logn, stage, stream
    "bz_ntt_stage": (_P, _P, _P, _I64, _INT, _INT, _P),
    # consts, p, q, out, n, stream
    "bz_point_add": (_P, _P, _P, _P, _I64, _P),
    # consts, u, v, tw, out0, out1, batch, n2, stream
    "bz_butterfly_rows": (_P, _P, _P, _P, _P, _P, _I64, _I64, _P),
    # consts, p planes, q planes, out planes, n, stream
    "bz_point_add_planes": (_P, _P, _P, _P, _I64, _P),
    # consts, complete, table, src, starts, out, flags, nb, stream
    "bz_msm_buckets": (_P, _INT, _P, _P, _P, _P, _P, _I64, _P),
    # consts, acc (in place), pxy, heads, n, first step, end step, stream
    "bz_step_chain": (_P, _P, _P, _P, _I64, _INT, _INT, _P),
    # op, consts, a, b, out, n, reps, stream
    "bz_op_chain": (_INT, _P, _P, _P, _P, _I64, _INT, _P),
}


def reset_launches() -> None:
    with _count_lock:
        for name in KERNELS:
            launches[name] = 0


def count(name: str) -> None:
    with _count_lock:
        launches[name] += 1


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build() -> Path:
    """Compile csrc/*.cu (if this source hash is not built yet), one nvcc
    per source, all started together, then link them; -> .so path."""
    out_dir = BUILD_ROOT / _source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    jobs = []
    for src in sorted(CSRC.glob("*.cu")):
        obj = out_dir / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(out)
    if not failed:
        tmp = out_dir / f"{LIB_NAME}.{tag}"
        cmd = [nvcc, "-shared", "-o", str(tmp), *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, check=False)
        log.append(" ".join(cmd) + "\n" + proc.stdout)
        if proc.returncode != 0:
            failed.append(proc.stdout)
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(f[-4000:] for f in failed))
    os.replace(tmp, lib)
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")


def ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def launch(kernel: str, entry: str, on: torch.Tensor, *args) -> None:
    """Call the C entry ``entry(*args, stream)`` on the current stream of
    ``on``'s device, with that device current: the library's CUDA runtime
    launches on the calling thread's current device, which is cuda:0 in a
    new thread whatever device the tensors are on. Raises on a CUDA error
    and counts one launch of ``kernel``."""
    with torch.cuda.device(on.device):
        status = getattr(library(), entry)(*args, stream(on))
    check(status, f"{kernel} {entry}")
    count(kernel)


def require(t: torch.Tensor, dtype: torch.dtype, what: str) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` whose data
    is 16-byte aligned (the kernels move rows with 16-byte accesses)."""
    if not t.is_cuda:
        raise ValueError(f"{what}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: data not 16-byte aligned")


def resolve_device(device=None) -> torch.device:
    """The device of an entry point: None means the CUDA card. A CUDA device
    without a card raises; pass device="cpu" to run the plain versions. A
    CUDA device gets its index ("cuda" is the current card), so that the
    per-device key caches see one name per card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
