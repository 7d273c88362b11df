"""Device Pasta field arithmetic on 8 x 32-bit limb tensors.

An element is a ``(..., 8)`` ``torch.int32`` tensor holding the eight 32-bit
words of a 256-bit little-endian integer (bit patterns: the CUDA kernels
read them as ``uint32``). Elements are always canonical (< p). Products are
Montgomery products with R = 2^256, so field values in Montgomery form
multiply with :func:`mont_mul`; :func:`to_mont` / :func:`from_mont` convert.

Kernel K1 (``csrc/field_ops.cu``) computes ``out[i] = a[i] op b[i % nb]``
for op in (Montgomery product, add, sub). :func:`field_op` launches it for a
CUDA tensor and runs the plain PyTorch version (:func:`plain_field_op`) for
a CPU tensor. The plain version splits each limb into 16-bit halves held in
int64, so every partial product and column sum stays exact; it computes
the same canonical values as the kernel, bit for bit.

Kernel K9 (``csrc/op_chain.cu``), :func:`op_chain`, applies one op ``reps``
times per element, ``x = op(x, b)``: a latency probe of the field ops,
with :func:`plain_op_chain` beside it.

This module merges the reference's fields/limb.py and fields/limb_t.py; the
host-exact counterpart is fields/host.py.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, field

import numpy as np
import torch

from .host import FP, FQ, Field

NLIMBS = 8
OP_MUL, OP_ADD, OP_SUB = 0, 1, 2
_M16 = 0xFFFF


def int_to_limbs(x: int) -> np.ndarray:
    """Python int -> (8,) uint32 limb array."""
    return np.frombuffer(int(x).to_bytes(32, "little"), dtype="<u4").copy()


def ints_to_limbs(xs, device) -> torch.Tensor:
    """Sequence of ints in [0, 2^256) -> (N, 8) int32 limb tensor on ``device``."""
    buf = b"".join(int(x).to_bytes(32, "little") for x in xs)
    arr = np.frombuffer(buf, dtype="<i4").reshape(-1, NLIMBS).copy()
    return torch.from_numpy(arr).to(device)


def limbs_to_ints(t: torch.Tensor) -> list[int]:
    """(..., 8) limb tensor -> flat list of ints (row-major)."""
    data = t.detach().to("cpu").contiguous().numpy().astype("<i4", copy=False).tobytes()
    return [int.from_bytes(data[i : i + 32], "little") for i in range(0, len(data), 32)]


def limbs_to_int(t: torch.Tensor) -> int:
    (v,) = limbs_to_ints(t.reshape(1, NLIMBS))
    return v


@dataclass(frozen=True, eq=False)
class FieldSpec:
    """Constants of one Pasta field, for the kernels and their plain versions."""

    name: str
    modulus: int
    host: Field
    r_mod_p: int  # R = 2^256 mod p: Montgomery one
    r2: int  # R^2 mod p, for to_mont
    nprime: int  # -p^-1 mod 2^256 (the plain version's REDC factor)
    kernel_consts: ctypes.Array  # p[8], one[8], n0 (-p^-1 mod 2^32) for csrc/field.cuh
    _on_device: dict = field(default_factory=dict, repr=False)

    @staticmethod
    @functools.lru_cache(maxsize=None)
    def make(modulus: int) -> "FieldSpec":
        host = {FP.modulus: FP, FQ.modulus: FQ}[modulus]
        r = (1 << 256) % modulus
        words = list(int_to_limbs(modulus)) + list(int_to_limbs(r))
        words.append((-pow(modulus, -1, 1 << 32)) % (1 << 32))
        return FieldSpec(
            name=host.name,
            modulus=modulus,
            host=host,
            r_mod_p=r,
            r2=r * r % modulus,
            nprime=(-pow(modulus, -1, 1 << 256)) % (1 << 256),
            kernel_consts=(ctypes.c_uint32 * 17)(*words),
        )

    def const(self, name: str, device) -> torch.Tensor:
        """Cached constant tensors: the plain version's int64 16-bit word
        vectors ("p16", "nprime16", "not_p18", "unit16") and the (1, 8) limb
        rows "r2", "one_plain", "one_mont"."""
        device = torch.device(device)
        key = (name, device)
        if key not in self._on_device:
            words16 = {
                "p16": [(self.modulus >> (16 * i)) & _M16 for i in range(17)],
                "nprime16": [(self.nprime >> (16 * i)) & _M16 for i in range(16)],
                "not_p18": [_M16 - ((self.modulus >> (16 * i)) & _M16) + (i == 0) for i in range(17)] + [0],
                "unit16": [1] + [0] * 15,
            }
            if name in words16:
                val = torch.tensor(words16[name], dtype=torch.int64, device=device)
            else:
                v = {"r2": self.r2, "one_plain": 1, "one_mont": self.r_mod_p}[name]
                val = ints_to_limbs([v], device)
            self._on_device[key] = val
        return self._on_device[key]


FP_SPEC = FieldSpec.make(FP.modulus)
FQ_SPEC = FieldSpec.make(FQ.modulus)


# ------------------------------------------------------------ plain version
#
# Values are held as 16-bit columns in int64 with the column axis FIRST, so
# that shifting a carry to the next column is a slice of whole rows.
# Columns collect partial products unnormalised (all bounds stay below
# 2^63); every step is a whole-tensor op, the only loops are carry passes.


def _halves(a: torch.Tensor) -> torch.Tensor:
    """(..., 8) int32 limbs -> (16, ...) int64 16-bit columns."""
    w = (a.to(torch.int64) & 0xFFFFFFFF).movedim(-1, 0)
    return torch.stack((w & _M16, w >> 16), dim=1).flatten(0, 1)


def _limbs(t: torch.Tensor) -> torch.Tensor:
    """(16, ...) int64 16-bit columns -> (..., 8) int32 limbs."""
    w = t[0::2] | (t[1::2] << 16)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32).movedim(0, -1)


def _col(v: torch.Tensor, batch_dims: int) -> torch.Tensor:
    """A (k,) constant as a (k, 1, ..., 1) column vector."""
    return v.view((-1,) + (1,) * batch_dims)


def _normalize(t: torch.Tensor, bound: int) -> torch.Tensor:
    """Columns (k, ...) of int64 values in [0, bound] -> the k 16-bit words
    of their sum mod 2^(16 k). Each pass moves every column's high part one
    column up; once the bound is down to 2^16, the passes continue only
    while a carry is left (a carry ripples through 0xFFFF columns)."""
    while bound > 1 << 16 or bool((t > _M16).any()):
        hi = t >> 16
        t = t & _M16
        t[1:] += hi[:-1]
        bound = _M16 + (bound >> 16)
    return t


def _columns(a16: torch.Tensor, b16: torch.Tensor, ncols: int) -> torch.Tensor:
    """Schoolbook product columns sum_{i+j=k} a_i b_j, k < ncols, of two
    (16, ...) operands (of 16-bit words, each column is < 2^36). Row i of
    the products is laid out shifted by i (rows of 33 read as rows of 32),
    then the rows are summed."""
    prod = a16.unsqueeze(1) * b16.unsqueeze(0)  # (16, 16, ...)
    rows = prod.new_zeros((16, 33) + prod.shape[2:])
    rows[:, :16] = prod
    return rows.flatten(0, 1)[: 16 * 32].unflatten(0, (16, 32)).sum(dim=0)[:ncols]


_PROD_BOUND = 16 * _M16 * _M16


def _reduce_once(spec: FieldSpec, t17: torch.Tensor) -> torch.Tensor:
    """17 columns of a value t < 2p -> 16 columns of t mod p. t - p is
    formed as t + ~p + 1 over 18 columns; its carry into column 17 means
    t >= p."""
    s = t17.new_zeros((18,) + t17.shape[1:])
    s[:17] = t17
    s = _normalize(s + _col(spec.const("not_p18", t17.device), t17.dim() - 1), 1 << 17)
    return torch.where(s[17] == 1, s[:16], t17[:16])


def mont_mul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a b R^-1 mod p by Montgomery's REDC on whole numbers: T = a b,
    m = (T mod R) (-p^-1) mod R, result = (T + m p) / R, reduced once."""
    a16, b16 = (_halves(x) for x in torch.broadcast_tensors(a, b))
    nd = a16.dim() - 1
    t = _columns(a16, b16, 32)
    # the unnormalised low columns already sum to T mod R (mod R), and their
    # products with the 16-bit words of -p^-1 stay below 2^56
    m = _normalize(_columns(t[:16], _col(spec.const("nprime16", a.device), nd), 16), 1 << 56)
    u = t.new_zeros((33,) + t.shape[1:])
    u[:32] = t + _columns(m, _col(spec.const("p16", a.device)[:16], nd), 32)
    u = _normalize(u, 2 * _PROD_BOUND)
    return _limbs(_reduce_once(spec, u[16:]))


def add_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a16, b16 = (_halves(x) for x in torch.broadcast_tensors(a, b))
    s16 = a16 + b16
    s = s16.new_zeros((17,) + s16.shape[1:])
    s[:16] = s16
    return _limbs(_reduce_once(spec, _normalize(s, 2 * _M16)))


def sub_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a - b + p, formed as a + ~b + 1 + p - 2^256 (all columns >= 0)."""
    a16, b16 = (_halves(x) for x in torch.broadcast_tensors(a, b))
    nd = a16.dim() - 1
    p = _col(spec.const("p16", a.device)[:16], nd)
    s16 = _normalize(a16 + (_M16 - b16) + p + _col(spec.const("unit16", a.device), nd), 3 * _M16 + 1)
    s = s16.new_zeros((17,) + s16.shape[1:])
    s[:16] = s16
    return _limbs(_reduce_once(spec, s))


_PLAIN = {OP_MUL: mont_mul_plain, OP_ADD: add_plain, OP_SUB: sub_plain}


def _rows(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int]:
    if a.shape[-1] != NLIMBS or b.shape[-1] != NLIMBS:
        raise ValueError(f"limb tensors must end in {NLIMBS}: {tuple(a.shape)}, {tuple(b.shape)}")
    n, nb = a.numel() // NLIMBS, b.numel() // NLIMBS
    if nb == 0 or n % nb:
        raise ValueError(f"b's {nb} rows must divide a's {n} rows")
    return n, nb


def plain_field_op(op: int, spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version of K1: ``a[i] op b[i % nb]``, shape of a."""
    n, nb = _rows(a, b)
    r = _PLAIN[op](spec, a.reshape(n // nb, nb, NLIMBS), b.reshape(nb, NLIMBS))
    return r.reshape(a.shape)


def field_op(op: int, spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, out=None) -> torch.Tensor:
    """K1: ``out[i] = a[i] op b[i % nb]`` over rows of limbs (op: OP_MUL for
    the Montgomery product, OP_ADD, OP_SUB). ``out`` may be ``a`` or ``b``.
    A CUDA tensor launches the kernel; a CPU tensor runs the plain version."""
    n, nb = _rows(a, b)
    if out is None:
        out = torch.empty_like(a)
    if not a.is_cuda:
        out.copy_(plain_field_op(op, spec, a, b))
        return out
    from ..ops import cuda

    for t in (a, b, out):
        cuda.require(t, torch.int32, "K1 field op")
    if n:
        cuda.launch("K1", "bz_field_op", a, op, spec.kernel_consts, cuda.ptr(a), cuda.ptr(b), cuda.ptr(out), n, nb)
    return out


def mont_mul(spec: FieldSpec, a, b, out=None):
    """Montgomery product a * b * R^-1 mod p."""
    return field_op(OP_MUL, spec, a, b, out)


def mont_sqr(spec: FieldSpec, a):
    return mont_mul(spec, a, a)


def add(spec: FieldSpec, a, b, out=None):
    return field_op(OP_ADD, spec, a, b, out)


def sub(spec: FieldSpec, a, b, out=None):
    return field_op(OP_SUB, spec, a, b, out)


def neg(spec: FieldSpec, a):
    return sub(spec, torch.zeros_like(a), a)


def to_mont(spec: FieldSpec, a):
    """Canonical limbs -> Montgomery form (a * R^2 * R^-1)."""
    return mont_mul(spec, a, spec.const("r2", a.device))


def from_mont(spec: FieldSpec, a):
    """Montgomery form -> canonical limbs (a * 1 * R^-1)."""
    return mont_mul(spec, a, spec.const("one_plain", a.device))


def is_zero(a: torch.Tensor) -> torch.Tensor:
    return (a == 0).all(dim=-1)


def mont_pow(spec: FieldSpec, a, e: int):
    """a^e for a static exponent, Montgomery form in and out."""
    if e == 0:
        return spec.const("one_mont", a.device).expand(a.shape).contiguous()
    result = a
    for bit in bin(e)[3:]:
        result = mont_sqr(spec, result)
        if bit == "1":
            result = mont_mul(spec, result, a)
    return result


def mont_inv(spec: FieldSpec, a):
    """Inversion by Fermat (a^(p-2)); Montgomery form in and out."""
    return mont_pow(spec, a, spec.modulus - 2)


# ------------------------------------------------------------------- K9

# K9's ops: the field ops with a value (Montgomery product, add, sub and the
# Montgomery reduction x -> x R^-1), then a wrapping limb-wise 32-bit add
# and no op, which time the memory floor and the launch floor.
CHAIN_OPS = {"mul": 0, "add": 1, "sub": 2, "redc": 3, "raw": 4, "noop": 5}
VALUED_CHAIN_OPS = ("mul", "add", "sub", "redc")


def _raw_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    w = ((a.to(torch.int64) & 0xFFFFFFFF) + (b.to(torch.int64) & 0xFFFFFFFF)) & 0xFFFFFFFF
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(torch.int32)


def plain_op_chain(op: str, spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, reps: int = 32) -> torch.Tensor:
    """The plain PyTorch version of K9: x = a, then ``reps`` times
    x = op(x, b), elementwise over rows of limbs."""
    step = {
        "mul": lambda x: mont_mul_plain(spec, x, b),
        "add": lambda x: add_plain(spec, x, b),
        "sub": lambda x: sub_plain(spec, x, b),
        "redc": lambda x: mont_mul_plain(spec, x, spec.const("one_plain", x.device)),
        "raw": lambda x: _raw_add(x, b),
        "noop": lambda x: x,
    }[op]
    x = a.clone()
    for _ in range(reps):
        x = step(x)
    return x


def op_chain(op: str, spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, reps: int = 32) -> torch.Tensor:
    """K9: ``reps`` chained ``x = op(x, b)`` per row of limbs (op in
    :data:`CHAIN_OPS`; a and b canonical for the field ops), one thread per
    row. A CUDA tensor launches the kernel; a CPU tensor runs
    :func:`plain_op_chain`."""
    if op not in CHAIN_OPS:
        raise ValueError(f"unknown chain op {op!r}: expected one of {sorted(CHAIN_OPS)}")
    if a.shape != b.shape or a.shape[-1] != NLIMBS:
        raise ValueError(f"operands must match as (..., 8): {tuple(a.shape)}, {tuple(b.shape)}")
    if reps < 0:
        raise ValueError(f"reps must be >= 0, got {reps}")
    if not a.is_cuda:
        return plain_op_chain(op, spec, a, b, reps)
    from ..ops import cuda

    out = torch.empty_like(a)
    for t in (a, b, out):
        cuda.require(t, torch.int32, "K9 op chain")
    n = a.numel() // NLIMBS
    if n:
        cuda.launch(
            "K9", "bz_op_chain", a, CHAIN_OPS[op], spec.kernel_consts, cuda.ptr(a), cuda.ptr(b), cuda.ptr(out), n, reps
        )
    return out
