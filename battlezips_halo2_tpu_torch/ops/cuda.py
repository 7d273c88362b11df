"""Build, load and launch the port's CUDA kernels (``csrc/*.cu``).

The kernels compile with ``nvcc`` (one process per source, in parallel) and
link into one shared library with a plain C interface, bound with
``ctypes``: no PyTorch headers, so a build takes seconds. The library goes
into ``csrc/build/<hash of the sources>/`` at first use; a build writes to
temporary names and renames the library into place, so an interrupted
build leaves nothing that a later one waits on.

Every C entry launches on the stream it is given and returns
``cudaGetLastError()``; :func:`launch` calls one with the tensors' device
current and raises :class:`CudaError` (the code and its name) on anything
but 0.

``launches`` counts, per kernel, the launches made since the last
:func:`reset_launches`, and ``entry_launches`` per C entry (K3's window
kernel ``bz_window_sums`` apart from its lane-wise ``bz_point_add`` and
``bz_point_fold``). Each
wrapper adds one exactly where it launches, under a lock, so the counts
stay exact when several threads prove at once
(``api.prove_session(workers > 1)``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
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

# K1-K9 replace the reference's TPU kernels; M1 (csrc/fp_matmul.cu) its
# constant Fp matrix product, which ran on the MXU outside Pallas
KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "K8", "K9", "M1")
launches = {name: 0 for name in KERNELS}
entry_launches: dict = {}

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_INT = ctypes.c_int
_SIGNATURES = {
    # op, consts, a, b, out, n, nb, threads a block, stream
    "bz_field_op": (_INT, _P, _P, _P, _P, _I64, _I64, _INT, _P),
    # consts, x, tw, batch, logn, stage, stream
    "bz_ntt_stage": (_P, _P, _P, _I64, _INT, _INT, _P),
    # consts, p, q, out, n, threads a block, stream
    "bz_point_add": (_P, _P, _P, _P, _I64, _INT, _P),
    # consts, stack, out, d, lanes, threads a block, stream
    "bz_point_fold": (_P, _P, _P, _INT, _I64, _INT, _P),
    # consts, u, v, tw, out0, out1, batch, n2, stream
    "bz_butterfly_rows": (_P, _P, _P, _P, _P, _P, _I64, _I64, _P),
    # consts, p planes, q planes, out planes, n, threads a block, stream
    "bz_point_add_planes": (_P, _P, _P, _P, _I64, _INT, _P),
    # consts, w, a, out, batch, kp, k, m, stream
    "bz_fp_const_matmul": (_P, _P, _P, _P, _I64, _INT, _INT, _INT, _P),
    # consts, complete, table, src, bid, starts, out, flags, carry, carry flags, layout, nb, resident,
    # threads, stream
    "bz_msm_buckets": (_P, _INT, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _I64, _I64, _P),
    # complete, resident threads of the bucket pass's phase A on the current card (out)
    "bz_msm_bucket_resident": (_INT, ctypes.POINTER(_I64)),
    # consts, acc (in place), pxy, heads, n, first step, end step, threads a block, stream
    "bz_step_chain": (_P, _P, _P, _P, _I64, _INT, _INT, _INT, _P),
    # op, consts, a, b, out, n, reps, threads a block, stream
    "bz_op_chain": (_INT, _P, _P, _P, _P, _I64, _INT, _INT, _P),
    # consts, buckets, out, rows, nbuck, log2 threads per row, segment, stream
    "bz_window_sums": (_P, _P, _P, _I64, _INT, _INT, _INT, _P),
    # resident threads of K3's window kernel on the current card (out)
    "bz_window_resident": (ctypes.POINTER(_I64),),
    # consts, bucket planes, out planes, rows, nbuck, log2 threads per row, segment, stream
    "bz_window_sums_planes": (_P, _P, _P, _I64, _INT, _INT, _INT, _P),
    # resident threads of K6's window kernel on the current card (out)
    "bz_window_planes_resident": (ctypes.POINTER(_I64),),
    # consts, prog, n_instr, desc, n_pins, 4 sources, t_inv, out, log2 ext, lanes, n_temps, stream
    "bz_quotient_vm": (_P, _P, _INT, _P, _INT, _P, _P, _P, _P, _P, _P, _INT, _I64, _INT, _P),
    # status -> cudaGetErrorName (returns a C string, not a status)
    "bz_error_name": (_INT,),
}


def reset_launches() -> None:
    with _count_lock:
        for name in KERNELS:
            launches[name] = 0
        entry_launches.clear()


def count(name: str, entry: str | None = None) -> None:
    with _count_lock:
        launches[name] += 1
        if entry is not None:
            entry_launches[entry] = entry_launches.get(entry, 0) + 1


def _source_hash(src: Path, flags: tuple) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + tuple(flags)).encode())
    for path in sorted(src.glob("*.cu")) + sorted(src.glob("*.cuh")):
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


def build(src: Path = CSRC, flags: tuple = ()) -> Path:
    """Compile src/*.cu with ``flags`` beside NVCC_FLAGS (if this source
    hash is not built yet), one nvcc per source, all started together, then
    link them; -> .so path. The defaults build the port's kernels; a tool
    that compares two builds passes a copy of the sources."""
    out_dir = BUILD_ROOT / _source_hash(src, flags)
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f"{os.getpid()}.tmp"
    jobs = []
    for cu in sorted(src.glob("*.cu")):
        obj = out_dir / f"{cu.stem}.{tag}.o"
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-c", "-o", str(obj), str(cu)]
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


def load(path: Path) -> ctypes.CDLL:
    """A built kernel library with the argument types of the entries it has."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_char_p if name == "bz_error_name" else ctypes.c_int
    return lib


def ptxas_report(lib: Path) -> list[str]:
    """"kernel: registers ...; stack frame ..." for each kernel of a built
    library, as ``-Xptxas -v`` printed them into its build log."""
    lines, entry, frame = [], None, None
    for line in (lib.parent / "build.log").read_text().splitlines():
        if "Compiling entry function" in line:
            entry, frame = line.split("'")[1], None
        elif "stack frame" in line:
            frame = line.strip()
        elif "Used" in line and "registers" in line and entry:
            lines.append(f"{entry}: {line.split(':', 1)[1].strip()}; {frame}")
    return lines


def sass_counts(lib: Path) -> dict[str, tuple[int, int, int]]:
    """kernel -> (SASS instructions, multiply instructions, 32-bit multiply
    results) of a built library, from ``cuobjdump -sass``: IMAD.WIDE is a
    64-bit product (two results), IMAD.HI and IMAD one; IMAD.X, IMAD.MOV,
    IMAD.SHL and IMAD.IADD multiply nothing."""
    cuobjdump = Path(_nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts = {}
    for block in sass.split("Function : ")[1:]:
        name, body = block.split("\n", 1)
        ops = re.findall(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", body)
        wide = sum(op.startswith("IMAD.WIDE") for op in ops)
        single = sum(op == "IMAD" or op.startswith("IMAD.HI") for op in ops)
        counts[name.strip()] = (len(ops), wide + single, 2 * wide + single)
    return counts


def require_entries(lib: ctypes.CDLL, path) -> ctypes.CDLL:
    """``lib`` if it has every entry of ``_SIGNATURES``; else raise naming
    the entries it lacks."""
    missing = [name for name in _SIGNATURES if not hasattr(lib, name)]
    if missing:
        raise RuntimeError(f"{path} lacks the kernel entries {missing}")
    return lib


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use), which must have
    every entry of ``_SIGNATURES``."""
    global _lib
    with _lock:
        if _lib is None:
            path = build()
            _lib = require_entries(load(path), path)
    return _lib


class CudaError(RuntimeError):
    """A kernel entry returned a status other than cudaSuccess: ``code`` is
    the cudaError_t value, ``name`` the runtime's name of it
    (ops/dispatch.py classifies by the code)."""

    def __init__(self, code: int, name: str, what: str):
        super().__init__(f"{what}: CUDA error {code} ({name})")
        self.code, self.name = code, name


def check(status: int, what: str) -> None:
    """Raise CudaError, named by cudaGetErrorName, unless ``status`` is 0."""
    if status != 0:
        raise CudaError(status, library().bz_error_name(status).decode(), what)


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
    count(kernel, entry)


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def chain_grid(n: int, sms: int) -> tuple[int, int]:
    """(threads a block, blocks) of a chain kernel (K8, K9, K3's fold, K3's
    and K6's lane-wise additions) over n lanes, one lane a thread: the
    largest power of two from 256 down to 32 whose blocks still reach all
    ``sms`` SMs (2^15 lanes in blocks of 256 are 128 blocks, which leave 4 of the
    H100's 132 SMs idle; the fold's 352 lanes take 11 blocks of 32)."""
    block = 256
    while block > 32 and -(-n // block) < sms:
        block //= 2
    return block, -(-n // block)


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
