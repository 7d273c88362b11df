"""The native host engine: this package's ``pasta.cpp``
(``battlezips_halo2_tpu_torch/csrc/pasta.cpp``), bound with ctypes.

A C++ library of 4 x 64-bit Montgomery Pasta arithmetic with OpenMP: batch
NTT and coset scaling, the quotient bytecode VM, Pippenger MSM, batch
inversion, the multiopen and IPA vector ops, point decompression. It is the
port's counterpart of the reference's latency engine, and runs a proof's
work on the host when ``BZ_PROOF_ENGINE`` (``auto`` / ``host``) or
``BZ_BATCH_ENGINE=host`` selects it (``ops/engine.py``). Under the default
``BZ_PROOF_ENGINE=device`` nothing loads it: every site that routes here
asks :func:`enabled` first.

The library builds at first use with ``g++ -O3 -march=native -fopenmp
-shared -fPIC`` into ``csrc/build/host-<hash>/``, where the hash covers the
source, the compiler command and the host CPU's model name (a
``-march=native`` binary is never reused on another CPU). A build writes a
temporary name and renames it into place, so processes that race for the
first build never load a partial file. :func:`load` binds every entry of
``_SIGNATURES`` or raises; a failed build raises with the compiler's
output. Nothing falls back to Python.

Elements cross the ABI as 32-byte little-endian canonical reprs (callers
reduce mod p first), points as 64 bytes x || y with the identity all zero.
``which`` selects the field of the numbers a call computes in: Vesta points
have coordinates in Fq (``which_for(VESTA.base.modulus)``), scalars and
polynomials live in Fp (``which_for(FP.modulus)``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path

import numpy as np

from ..config import config

PACKAGE = Path(__file__).resolve().parent.parent
SOURCE = PACKAGE / "csrc" / "pasta.cpp"
BUILD_ROOT = PACKAGE / "csrc" / "build"
LIB_NAME = "libbz_pasta.so"
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")

FIELD_FP = 0  # Pallas base / Vesta scalar
FIELD_FQ = 1  # Vesta base / Pallas scalar
FP_MODULUS = 0x40000000000000000000000000000000224698FC094CF91B992D30ED00000001
FQ_MODULUS = 0x40000000000000000000000000000000224698FC0994A8DD8C46EB2100000001

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_INT = ctypes.c_int
_SIGNATURES = {  # entry: (result type, argument types)
    "pasta_mul_batch": (None, (_INT, _P, _P, _P, _I64)),
    "pasta_inv_batch": (None, (_INT, _P, _P, _I64)),
    "pasta_msm": (None, (_INT, _P, _P, _P, _I64)),
    "pasta_find_z": (_I64, (_INT, _P, _I64)),
    "pasta_ntt_batch": (None, (_INT, _P, _I64, _I64, _P)),
    "pasta_scale_batch": (None, (_INT, _P, _I64, _I64, _P, _P)),
    "pasta_vm_exec": (None, (_INT, _P, _I64, _P, _I64, _I64, _P)),
    "pasta_mul_vec": (None, (_INT, _P, _P, _P, _I64)),
    "pasta_axpy": (None, (_INT, _P, _P, _P, _P, _I64)),
    "pasta_horner": (None, (_INT, _P, _I64, _P, _P)),
    "pasta_inner": (None, (_INT, _P, _P, _I64, _P)),
    "pasta_div_linear": (None, (_INT, _P, _I64, _P, _P)),
    "pasta_point_decompress": (_I64, (_INT, _P, _P, _P, _I64)),
    "pasta_ipa_s": (None, (_INT, _P, _P, _P, _I64, _I64)),
    "pasta_grand_product": (None, (_INT, _P, _P, _P, _P, _I64)),
    "pasta_window_fold": (None, (_INT, _P, _P, _I64, _I64, _I64)),
}

_lib = None
_lock = threading.Lock()


def enabled() -> bool:
    """True iff ``BZ_PROOF_ENGINE`` is not ``device``: the routing sites ask
    this before they touch the library, so the default never loads it."""
    return config().proof_engine != "device"


def which_for(modulus: int) -> int:
    """The field selector of a modulus (guards against the Fp / Fq mixup:
    Vesta POINTS live over Fq)."""
    if modulus == FP_MODULUS:
        return FIELD_FP
    if modulus == FQ_MODULUS:
        return FIELD_FQ
    raise ValueError(f"not a Pasta modulus: {hex(modulus)}")


def _cpu_model() -> str:
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                return line.split(":", 1)[1].strip()
    except OSError:
        pass
    return platform.processor() or platform.machine()


def build_command(out: Path) -> list[str]:
    return [CXX, *CXX_FLAGS, str(SOURCE), "-o", str(out)]


def library_path() -> Path:
    """Where this source, compiler command and CPU build to."""
    h = hashlib.sha256(" ".join(build_command(Path(LIB_NAME))).encode())
    h.update(_cpu_model().encode())
    h.update(SOURCE.read_bytes())
    return BUILD_ROOT / f"host-{h.hexdigest()[:16]}" / LIB_NAME


def build() -> Path:
    """Compile the library unless this hash is built; -> its path. Raises
    RuntimeError with the compiler's output when the build fails."""
    lib = library_path()
    if lib.exists():
        return lib
    # compile beside the hash directories and make this one only once the
    # library exists, so a failed build leaves nothing behind
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_ROOT / f".{LIB_NAME}.{os.getpid()}.{threading.get_ident()}.tmp"
    cmd = build_command(tmp)
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600, check=False)
    except OSError as e:
        raise RuntimeError(f"the native host engine does not build: {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"the native host engine does not build (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stderr[-4000:]}"
        )
    lib.parent.mkdir(parents=True, exist_ok=True)
    (lib.parent / "build.log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def bind(path: Path) -> ctypes.CDLL:
    """Load a built library with every entry of ``_SIGNATURES`` typed;
    raises naming the entries it lacks."""
    lib = ctypes.CDLL(str(path))
    missing = [name for name in _SIGNATURES if not hasattr(lib, name)]
    if missing:
        raise RuntimeError(f"{path} lacks the entries {missing}")
    for name, (restype, argtypes) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def load() -> ctypes.CDLL:
    """The library, built and bound at first use; raises if it does not
    build or lacks an entry."""
    global _lib
    if _lib is None:
        with _lock:
            if _lib is None:
                _lib = bind(build())
    return _lib


# --- marshalling ------------------------------------------------------------

def ints_to_bytes_arr(xs) -> np.ndarray:
    """Canonical ints -> (len, 32) uint8 array of their LE reprs."""
    buf = b"".join(int(x).to_bytes(32, "little") for x in xs)
    return np.frombuffer(buf, dtype=np.uint8).reshape(len(xs), 32).copy()


def bytes_arr_to_ints(arr) -> list[int]:
    """(N, 32) uint8 array -> list of ints."""
    data = np.ascontiguousarray(arr).tobytes()
    return [int.from_bytes(data[i * 32 : (i + 1) * 32], "little") for i in range(arr.shape[0])]


def _le(v: int) -> bytes:
    return int(v).to_bytes(32, "little")


def _ptr(arr: np.ndarray) -> ctypes.c_void_p:
    assert arr.dtype == np.uint8 and arr.flags["C_CONTIGUOUS"]
    return arr.ctypes.data_as(ctypes.c_void_p)


def _point(raw: bytes):
    x, y = int.from_bytes(raw[:32], "little"), int.from_bytes(raw[32:64], "little")
    return None if x == 0 and y == 0 else (x, y)


def points_buffer(points) -> bytes:
    """Affine (x, y) tuples / None -> the 64-byte-per-point MSM buffer."""
    return b"".join(b"\x00" * 64 if p is None else _le(p[0]) + _le(p[1]) for p in points)


# --- field ops ----------------------------------------------------------------

def mul_batch(which: int, xs: list[int], ys: list[int]) -> list[int]:
    """Elementwise products of two lists of canonical ints."""
    n = len(xs)
    out = ctypes.create_string_buffer(32 * n)
    load().pasta_mul_batch(which, b"".join(map(_le, xs)), b"".join(map(_le, ys)), out, n)
    return [int.from_bytes(out.raw[32 * i : 32 * (i + 1)], "little") for i in range(n)]


def inv_batch(which: int, xs: list[int]) -> list[int]:
    """Inverses of nonzero canonical ints (one batch inversion)."""
    n = len(xs)
    out = ctypes.create_string_buffer(32 * n)
    load().pasta_inv_batch(which, b"".join(map(_le, xs)), out, n)
    return [int.from_bytes(out.raw[32 * i : 32 * (i + 1)], "little") for i in range(n)]


def inv_vec(which: int, a) -> np.ndarray:
    """Inverses of the nonzero elements of an (n, 32) array."""
    a = np.ascontiguousarray(a)
    out = np.empty_like(a)
    load().pasta_inv_batch(which, _ptr(a), _ptr(out), a.shape[0])
    return out


def find_z(which: int, ys: list[int], z_max: int = 1 << 24) -> int | None:
    """Smallest z < z_max with every y + z a square and every -y + z a
    non-residue (the fixed-base canonicity witness); None if there is none."""
    assert len(ys) == 8
    z = load().pasta_find_z(which, b"".join(map(_le, ys)), z_max)
    return None if z < 0 else int(z)


def ntt_batch(which: int, data: np.ndarray, omega: int) -> None:
    """In-place forward NTT of a (b, n, 32) canonical-bytes batch with the
    order-n root ``omega``. The inverse is ntt_batch(omega^-1) then
    scale_batch(1, n^-1)."""
    b, n = data.shape[0], data.shape[1]
    load().pasta_ntt_batch(which, _ptr(data), b, n, _le(omega))


def scale_batch(which: int, data: np.ndarray, g: int, mult: int) -> None:
    """In place, data[j][i] *= mult * g^i over a (b, n, 32) batch."""
    b, n = data.shape[0], data.shape[1]
    load().pasta_scale_batch(which, _ptr(data), b, n, _le(g), _le(mult))


def vm_exec(which: int, prog, regs: np.ndarray) -> np.ndarray:
    """Run the quotient bytecode (ops/gate_eval.py's (I, 4) instructions)
    over an (n_regs, ext, 32) register file; -> register 0, (ext, 32)."""
    prog = np.ascontiguousarray(prog, dtype=np.int32)
    n_regs, ext = regs.shape[0], regs.shape[1]
    out = np.empty((ext, 32), dtype=np.uint8)
    load().pasta_vm_exec(which, prog.ctypes.data_as(ctypes.c_void_p), prog.shape[0], _ptr(regs), n_regs, ext,
                         _ptr(out))
    return out


def mul_vec(which: int, a, b) -> np.ndarray:
    """Elementwise product of two (n, 32) arrays."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    out = np.empty((a.shape[0], 32), dtype=np.uint8)
    load().pasta_mul_vec(which, _ptr(a), _ptr(b), _ptr(out), a.shape[0])
    return out


def axpy(which: int, a, s: int, b) -> np.ndarray:
    """a * s + b over (n, 32) arrays, s a canonical scalar."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    out = np.empty((a.shape[0], 32), dtype=np.uint8)
    load().pasta_axpy(which, _ptr(a), _le(s), _ptr(b), _ptr(out), a.shape[0])
    return out


def horner(which: int, coeffs, x: int) -> int:
    """The (n, 32) polynomial's value at canonical x."""
    coeffs = np.ascontiguousarray(coeffs)
    out = ctypes.create_string_buffer(32)
    load().pasta_horner(which, _ptr(coeffs), coeffs.shape[0], _le(x), out)
    return int.from_bytes(out.raw, "little")


def inner(which: int, a, b) -> int:
    """<a, b> over (n, 32) arrays."""
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    out = ctypes.create_string_buffer(32)
    load().pasta_inner(which, _ptr(a), _ptr(b), a.shape[0], out)
    return int.from_bytes(out.raw, "little")


def div_linear(which: int, poly: np.ndarray, point: int) -> int:
    """In place, divide the (n, 32) polynomial by (X - point); -> the
    remainder (the caller asserts it is zero)."""
    rem = ctypes.create_string_buffer(32)
    load().pasta_div_linear(which, _ptr(poly), poly.shape[0], _le(point), rem)
    return int.from_bytes(rem.raw, "little")


def point_decompress(which: int, data) -> tuple:
    """Batch decode of compressed points, (n, 32) uint8 or 32n bytes ->
    ((n, 64) affine x || y, (n,) status 0 point / 1 identity / 2 malformed,
    index of the first malformed encoding or -1). Coordinates in field
    ``which``."""
    if isinstance(data, (bytes, bytearray)):
        data = np.frombuffer(bytes(data), dtype=np.uint8).reshape(-1, 32)
    data = np.ascontiguousarray(data)
    n = data.shape[0]
    out = np.empty((n, 64), dtype=np.uint8)
    status = np.empty(n, dtype=np.uint8)
    bad = load().pasta_point_decompress(which, _ptr(data), _ptr(out), _ptr(status), n)
    return out, status, int(bad)


def ipa_s_vector(which: int, us: list[int], a0: int, n: int) -> np.ndarray:
    """The IPA verifier's (n, 32) s-vector: s_i = a0 * prod over the set bits
    (k-1-j) of i of u_j."""
    k = len(us)
    assert n == 1 << k
    out = np.empty((n, 32), dtype=np.uint8)
    load().pasta_ipa_s(which, b"".join(map(_le, us)), _le(a0), _ptr(out), n, k)
    return out


def grand_product(which: int, nums, dens, carry: int) -> np.ndarray:
    """z[0] = carry, z[i+1] = z[i] nums[i] / dens[i], one batch inversion;
    (usable, 32) arrays -> (usable + 1, 32)."""
    nums, dens = np.ascontiguousarray(nums), np.ascontiguousarray(dens)
    usable = nums.shape[0]
    out = np.empty((usable + 1, 32), dtype=np.uint8)
    load().pasta_grand_product(which, _ptr(nums), _ptr(dens), _le(carry), _ptr(out), usable)
    return out


# --- curve ops ------------------------------------------------------------------

def window_fold_batch(which: int, points_flat: list, b: int, n_windows: int, c_bits: int) -> list:
    """sum_w 2^(c w) T_w for b results at once: points_flat holds b runs of
    n_windows affine window sums (None = identity), LSB window first; ->
    b affine points."""
    out = ctypes.create_string_buffer(64 * b)
    load().pasta_window_fold(which, points_buffer(points_flat), out, b, n_windows, c_bits)
    return [_point(out.raw[64 * i : 64 * (i + 1)]) for i in range(b)]


def msm_buf_scalars(which: int, pbuf: bytes, sarr) -> tuple | None:
    """MSM over a prebuilt point buffer with an (n, 32) scalar array."""
    sarr = np.ascontiguousarray(sarr)
    n = len(pbuf) // 64
    assert sarr.shape[0] == n
    out = ctypes.create_string_buffer(64)
    load().pasta_msm(which, pbuf, _ptr(sarr), out, n)
    return _point(out.raw)


def msm_buf(which: int, pbuf: bytes, scalars) -> tuple | None:
    """MSM over a prebuilt point buffer with canonical int scalars (callers
    cache the buffer of a point set they reuse, such as the SRS)."""
    n = len(pbuf) // 64
    assert len(scalars) == n
    out = ctypes.create_string_buffer(64)
    load().pasta_msm(which, pbuf, b"".join(map(_le, scalars)), out, n)
    return _point(out.raw)


def msm(which: int, points, scalars) -> tuple | None:
    """points: affine (x, y) tuples or None; scalars: canonical ints."""
    return msm_buf(which, points_buffer(points), scalars)
