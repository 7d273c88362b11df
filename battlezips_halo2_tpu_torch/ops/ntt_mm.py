"""The NTT as two constant matrix products over Fp (4-step / Bailey).

The reference's ``ops/ntt_mm.py`` casts the NTT for the TPU's MXU: with
n = n1 n2, each batch of small DFTs is one product by a constant n2 x n2
(or n1 x n1) matrix over Fp,

    X[k2 + n2 k1] = sum_{i1} w^(i1 k2) (w^n2)^(i1 k1) sum_{i2} x[i1 + n1 i2] (w^n1)^(i2 k2)

    step 1  column DFTs: W2 @ M       (contract i2, n2 x n2 constant)
    step 2  twiddle:     * w^(i1 k2)  (elementwise Montgomery product, K1)
    step 3  row DFTs:    @ W1^T       (contract i1, n1 x n1 constant)
    step 4  transpose    (k2, k1) -> (k1, k2)

with n1 = 2^((log n + 1) // 2). Here each matrix product is kernel M1
(``csrc/fp_matmul.cu``): a term is one Montgomery product by W R (the
matrix in Montgomery form) and the sum is kept canonical, so rows in
Montgomery form come out in Montgomery form, the same values as the
reference's chunk-plane product with one REDC. :func:`fp_const_matmul`
launches it for a CUDA tensor and runs :func:`fp_const_matmul_plain` for a
CPU tensor.

``ops/ntt.py::ntt`` takes this route for every NTT under ``BZ_NTT_MM=on``;
the reference's ``auto`` takes it only on a TPU, so on this port ``auto``
and ``off`` are one setting. On the H100 the butterfly route is the faster one (PERF.md).

The reference asserts that a product contracts over at most 1024 terms
(its i32 diagonal accumulator), so its n = 2^21 (n1 = 2048) fails after
two of the four steps; here the plan and :func:`fp_const_matmul` raise a
``ValueError`` for the same inputs before any work.
"""

from __future__ import annotations

import functools

import torch

from ..fields import limb as L
from ..fields.limb import NLIMBS, FieldSpec, geometric_limbs, ints_to_limbs

# the reference's fp_const_matmul asserts k <= 1024 (battlezips_halo2_tpu/ops/ntt_mm.py:127)
MAX_CONTRACTION = 1024
# products a step of the plain version forms at once (its int64 column
# tensors take ~4 KiB an element)
PLAIN_CHUNK = 1 << 14


def _check_contraction(k: int) -> None:
    if k > MAX_CONTRACTION:
        raise ValueError(f"fp_const_matmul contracts over at most {MAX_CONTRACTION} terms (the reference's i32 "
                         f"diagonal accumulator), got {k}")


def matrix_limbs(spec: FieldSpec, w_ints, device, mont: bool = True) -> torch.Tensor:
    """A (K', K) matrix of field elements (Python ints: a numpy object array
    or nested sequences) -> (K', K, 8) limbs of W R mod p (``mont``), the
    form in which a term's Montgomery product gives W a, or of W itself."""
    rows = [list(row) for row in w_ints]
    kp, k = len(rows), len(rows[0]) if rows else 0
    r = spec.r_mod_p if mont else 1
    return ints_to_limbs([int(v) * r % spec.modulus for row in rows for v in row], device).view(kp, k, NLIMBS)


def _operands(spec: FieldSpec, w, a: torch.Tensor, mont: bool) -> tuple[torch.Tensor, torch.Tensor, tuple]:
    """(w limbs, a as (B, K, M, 8), the batch shape of a), the contraction
    checked before the matrix is built."""
    kp, k = (w.shape[0], w.shape[1]) if isinstance(w, torch.Tensor) else (len(w), len(w[0]))
    _check_contraction(k)
    if a.dim() < 3 or a.shape[-1] != NLIMBS or a.shape[-3] != k:
        raise ValueError(f"a must be (..., {k}, M, {NLIMBS}) for a ({kp}, {k}) matrix, got {tuple(a.shape)}")
    if not isinstance(w, torch.Tensor):
        w = matrix_limbs(spec, w, a.device, mont)
    if w.shape != (kp, k, NLIMBS):
        raise ValueError(f"w must be (K', K, {NLIMBS}) limbs, got {tuple(w.shape)}")
    batch = tuple(a.shape[:-3])
    return w, a.reshape((-1,) + tuple(a.shape[-3:])), batch


def fp_const_matmul_plain(spec: FieldSpec, w, a: torch.Tensor, mont: bool = True) -> torch.Tensor:
    """The plain PyTorch version of :func:`fp_const_matmul`: the same
    Montgomery products, summed by the plain modular addition of
    fields/limb.py, a chunk of terms at a time so that memory stays
    bounded."""
    w, a3, batch = _operands(spec, w, a, mont)
    b, k, m = a3.shape[:3]
    kp = w.shape[0]
    acc = torch.zeros((b, kp, m, NLIMBS), dtype=torch.int32, device=a.device)
    step = max(1, PLAIN_CHUNK // max(1, b * kp * m))
    for i0 in range(0, k, step):
        i1 = min(k, i0 + step)
        # (terms, 1, K', 1, 8) by (terms, B, 1, M, 8) -> (terms, B, K', M, 8)
        wt, at = w[:, i0:i1].movedim(1, 0), a3[:, i0:i1].movedim(1, 0)
        prods = L.mont_mul_plain(spec, wt[:, None, :, None], at[:, :, None])
        for t in range(i1 - i0):
            acc = L.add_plain(spec, acc, prods[t])
    return acc.reshape(batch + (kp, m, NLIMBS))


def fp_const_matmul(spec: FieldSpec, w, a: torch.Tensor, mont: bool = True) -> torch.Tensor:
    """M1: out[..., j, m, :] = sum_i W[j, i] a[..., i, m, :] over the field.

    ``w``: the constant (K', K) matrix as Python ints (a numpy object array
    or nested sequences), converted by :func:`matrix_limbs`, or already as
    its (K', K, 8) limbs (W R mod p for ``mont``, W otherwise). ``a``:
    (..., K, M, 8) canonical limbs. With ``mont`` and ``a`` in Montgomery
    form the result is W a in Montgomery form; without, it is W a R^-1, as
    the reference's ``mont=False``. K may be at most 1024, as in the
    reference (a ``ValueError`` otherwise). A CUDA tensor launches the
    kernel (``csrc/fp_matmul.cu``) once; a CPU tensor runs
    :func:`fp_const_matmul_plain`."""
    if not a.is_cuda:
        return fp_const_matmul_plain(spec, w, a, mont)
    from . import cuda

    w, a3, batch = _operands(spec, w, a, mont)
    a3 = a3.contiguous()
    b, k, m = a3.shape[:3]
    kp = w.shape[0]
    out = torch.empty((b, kp, m, NLIMBS), dtype=torch.int32, device=a.device)
    for t, what in ((w, "w"), (a3, "a"), (out, "out")):
        cuda.require(t, torch.int32, f"M1 fp_const_matmul {what}")
    if b * kp * m:
        cuda.launch("M1", "bz_fp_const_matmul", a3,
                    spec.kernel_consts, cuda.ptr(w), cuda.ptr(a3), cuda.ptr(out), b, kp, k, m)
    return out.reshape(batch + (kp, m, NLIMBS))


def _dft_matrix(spec: FieldSpec, w: int, size: int, device) -> torch.Tensor:
    """(size, size, 8) Montgomery limbs of W[j, i] = w^(j i) for w of order
    ``size``: the ``size`` powers, gathered by (j i) mod size."""
    powers = geometric_limbs(spec.modulus, spec.r_mod_p, w, size, device)
    j = torch.arange(size, device=device)
    return powers[(j[:, None] * j[None, :]) % size]


class NttMMPlan:
    """Constants of one (n, omega) 4-step matrix-product NTT on one device:
    the column-DFT matrix ``w2`` (n2 x n2), the row-DFT matrix ``w1``
    (n1 x n1) and the (n2, n1) twiddle grid w^(i1 k2) ``twiddle_mont``, all
    in Montgomery limbs, which is how M1 and K1 take them."""

    def __init__(self, spec: FieldSpec, n: int, omega: int, device):
        self.spec, self.n, self.omega = spec, n, omega
        self.n1, self.n2 = self.split(n)  # raises past the reference's limit, before anything is built
        p = spec.modulus
        self.w2 = _dft_matrix(spec, pow(omega, self.n1, p), self.n2, device)  # column DFTs
        self.w1 = _dft_matrix(spec, pow(omega, self.n2, p), self.n1, device)  # row DFTs
        # w^(i1 k2) for i1 < n1, k2 < n2: exponents below n, one power table
        powers = geometric_limbs(p, spec.r_mod_p, omega, n, device)
        k2 = torch.arange(self.n2, device=device)
        i1 = torch.arange(self.n1, device=device)
        self.twiddle_mont = powers[k2[:, None] * i1[None, :]].contiguous()

    @staticmethod
    def split(n: int) -> tuple[int, int]:
        """(n1, n2) of the reference's plan, n1 = 2^((log n + 1) // 2), n2 =
        n / n1; a ``ValueError`` where n1 exceeds the reference's contraction
        limit (n = 2^21 and above)."""
        if n < 1 or n & (n - 1):
            raise ValueError(f"the matrix-product NTT needs a power-of-two size, got {n}")
        n1 = 1 << ((n.bit_length() - 1 + 1) // 2)
        _check_contraction(n1)
        return n1, n // n1


@functools.lru_cache(maxsize=None)
def mm_plan_for(modulus: int, n: int, omega: int, device: str) -> NttMMPlan:
    return NttMMPlan(FieldSpec.make(modulus), n, omega, device)


def ntt_mm(plan: NttMMPlan, a: torch.Tensor) -> torch.Tensor:
    """4-step matrix-product NTT of Montgomery rows (..., n, 8), natural
    order in and out (the contract of ``ops/ntt.py::ntt``): two M1
    launches and one K1 product on the card. -> a new tensor."""
    spec, n1, n2 = plan.spec, plan.n1, plan.n2
    x = a.reshape(-1, n2, n1, NLIMBS)  # M[i2, i1] = x[i1 + n1 i2]
    y = fp_const_matmul(spec, plan.w2, x)  # step 1: (B, k2, i1, 8)
    L.mont_mul(spec, y, plan.twiddle_mont, out=y)  # step 2: w^(i1 k2)
    z = fp_const_matmul(spec, plan.w1, y.transpose(1, 2).contiguous())  # step 3: (B, k1, k2, 8)
    return z.reshape(a.shape)  # step 4: X[k2 + n2 k1], (k1, k2) row-major
